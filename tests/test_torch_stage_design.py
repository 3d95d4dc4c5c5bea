"""Cheap CPU tests of the stage kernels' launch plan (no JAX, no card):
which design ``design`` picks (by dtype alone, at both kernel sizes and
in both directions),
the weight-gradient partition that fixes the reduction order, the 4×4
tensor-core forward's parity-plane tap map, the 4×4 data gradient's phase
fold (its taps, its tile rows, a pure-torch mirror against the twin), and
the C interface's design codes, arities and tile constants
(``csrc/stage_ct.cu``, ``csrc/phase_fold.cuh``) against the Python side."""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from esrganplus_tpu_torch.kernels import build
from esrganplus_tpu_torch.kernels import stage_ct as S

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
CS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CS)

FLAGSHIP = {name: (ks, CS.GAN_BATCH, hw, hw, cin, cout)
            for name, (ks, cin, cout, hw, _, _) in CS.STAGE_SHAPES.items()}
ODD = {f"odd_{ks}_{cin}_{cout}": (ks, *CS.STAGE_ODD, cin, cout)
       for ks in (3, 4) for cin, cout in ((3, 8), (16, 16))}
SHAPES = {**FLAGSHIP, **ODD}
OPS = ("fwd", "bwd")  # the directions the C entries launch
S1 = [n for n, v in SHAPES.items() if v[0] == 3]


@pytest.mark.parametrize("name", S1)
def test_bf16_3x3_runs_on_the_tensor_cores(name):
    ks, _, _, _, cin, cout = SHAPES[name]
    S.require_stage_widths(cin, cout)
    assert S.design(torch.bfloat16) == "mma"
    assert S.design(torch.float32) == "fma"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", [n for n, v in SHAPES.items() if v[0] == 4])
def test_4x4_stays_on_the_cuda_cores(name, dtype):
    """The 4×4 conv stays on the FMA kernels in fp32 only, in both
    directions; in bf16 its forward and its adjoint (the phase-fold data
    gradient and the 16-tap weight gradient) run on the tensor cores."""
    ks, _, _, _, cin, cout = SHAPES[name]
    want = "mma" if dtype == torch.bfloat16 else "fma"
    S.require_stage_widths(cin, cout)
    assert S.design(dtype) == want
    src = (build.CSRC / "stage_ct.cu").read_text()
    route = {"fma": r"kFloat32 && design == kFma\)\s*return ks == 3 \? [^:]*: dispatch_chunk<float, 4>",
             "mma": r"if \(ks == 4\) \{\s*if \(op == kFwd\) return launch_fwd_s2_mma_w[^}]*"
                    r"launch_dgrad_s2_mma_w[^}]*launch_wgrad_mma_w<4>"}[want]
    assert re.search(route, src)  # the C dispatch sends the 4x4 both ways to that design


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_design_is_a_function_of_dtype_kernel_size_and_op(name, dtype, op):
    """bf16 on the tensor cores and fp32 on the CUDA cores, at both kernel
    sizes and in both directions; the widths never decide."""
    ks, _, _, _, cin, cout = SHAPES[name]
    want = "mma" if dtype == torch.bfloat16 else "fma"
    S.require_stage_widths(cin, cout)
    assert S.design(dtype) == want


def test_stage_design_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="cout"):
        S.require_stage_widths(64, 24)
    with pytest.raises(ValueError, match="input channels"):
        S.require_stage_widths(129, 64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        S.design(torch.float16)


@pytest.mark.parametrize("name,design", [(n, d) for n in SHAPES for d in ("fma", "mma")])
def test_wgrad_partition_covers_every_tile_once(name, design):
    """Every pixel tile is summed by exactly one workspace row, rows in
    tile order, none empty, at most 128; and the plan is the same on every
    call (a function of the shapes alone, so the reduction order is)."""
    ks, B, H, W, cin, cout = SHAPES[name]
    Ho, Wo = (H, W) if ks == 3 else (H // 2, W // 2)
    tiles = S.stage_wgrad_tiles(B, Ho, Wo, ks, design)
    parts = S.stage_wgrad_parts(B, Ho, Wo, cin, cout, ks, design)
    ranges = S.stage_wgrad_ranges(B, Ho, Wo, cin, cout, ks, design)
    assert 1 <= parts <= 128 and len(ranges) == parts
    assert ranges[0][0] == 0 and ranges[-1][1] == tiles
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(parts - 1))
    assert ranges == S.stage_wgrad_ranges(B, Ho, Wo, cin, cout, ks, design)


def test_wgrad_tiles_follow_the_design():
    # 8x16 pixel tiles for the FMA 3x3, 4x16 for the mma design and the 4x4
    assert S.stage_wgrad_tiles(2, 36, 52, 3, "fma") == 2 * 5 * 4
    assert S.stage_wgrad_tiles(2, 36, 52, 3, "mma") == 2 * 9 * 4
    assert S.stage_wgrad_tiles(2, 18, 26, 4, "fma") == 2 * 5 * 2
    assert S.stage_wgrad_tiles(2, 18, 26, 4, "mma") == 2 * 5 * 2


@pytest.mark.parametrize("ks", [3, 4])
def test_mma_wgrad_blocks_cover_every_m16_tile(ks):
    """A tensor-core weight-gradient block owns WG_MT[ks] m16 tiles of (16
    input channels, tap) rows: from any block's first tile they span the
    channel chunks it stages (two, 32 channels, at 3×3; one, 16, at 4×4),
    and the partition's block count covers every tile once: at the flagship
    widths (64→64, 128→128) and at the odd 3→8 and 16→16."""
    mt, xc = S.WG_MT[ks], {3: 32, 4: 16}[ks]
    for cin, cout in ((64, 64), (128, 128), (3, 8), (16, 16)):
        mtiles = ks * ks * -(-cin // 16)
        starts = range(0, mtiles, mt)
        for m0 in starts:
            chunks = {m // (ks * ks) for m in range(m0, min(mtiles, m0 + mt))}
            assert min(chunks) == m0 // (ks * ks) and len(chunks) <= xc // 16
        assert len(starts) * mt >= mtiles > (len(starts) - 1) * mt
    src = (build.CSRC / "stage_ct.cu").read_text()
    wg = src[src.index("struct Wg {"):]
    assert "static constexpr int MT = KS == 3 ? %d : %d;" % (S.WG_MT[3], S.WG_MT[4]) in wg
    assert "static constexpr int XC = KS == 3 ? 32 : 16;" in wg
    if ks == 4:  # the flagship 4×4 weight gradients, rows to ~512 blocks: 128
        # m16 tiles (16 taps × 8 chunks) at 128→128 are 8 blocks × 2 groups of
        # 64 output channels, × 32 rows; 64→64's 64 tiles 4 blocks × 128 rows
        assert S.stage_wgrad_parts(16, 32, 32, 128, 128, 4, "mma") == 32
        assert S.stage_wgrad_parts(16, 64, 64, 64, 64, 4, "mma") == 128


def _fold_gather(z: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """The staged pixel each (phase, tap) of a phase-fold block reads, as the
    kernel reads it: per block the haloed tile of z ``[B, H, W, C]`` (origin
    (y0 − 1, x0 − 1), zero outside), flattened to rows, and for every block
    pixel (u, v), phase (a, b) and tap (i, j) the row ``fold_tap_slot``
    names → ``[B, H, W, 2, 2, 2, 2, C]`` (NaN nowhere once every block is
    done)."""
    B, H, W, C = z.shape
    out = torch.full((B, H, W, 2, 2, 2, 2, C), float("nan"))
    ty, tx = np.meshgrid(np.arange(th + 2), np.arange(tw + 2), indexing="ij")
    u, v, a, b, i, j = np.meshgrid(*(np.arange(n) for n in (th, tw, 2, 2, 2, 2)), indexing="ij")
    slots = torch.from_numpy(S.fold_tap_slot(u, v, a, b, i, j, tw).ravel())
    for y0 in range(0, H, th):
        for x0 in range(0, W, tw):
            gy, gx = y0 - 1 + ty, x0 - 1 + tx
            inside = torch.from_numpy((gy >= 0) & (gy < H) & (gx >= 0) & (gx < W))
            tile = z[:, gy.clip(0, H - 1), gx.clip(0, W - 1)] * inside[..., None]
            rows = tile.reshape(B, -1, C)[:, slots].reshape(B, th, tw, 2, 2, 2, 2, C)
            h, w = min(th, H - y0), min(tw, W - x0)  # the ragged edge: stores masked
            out[:, y0:y0 + h, x0:x0 + w] = rows[:, :h, :w]
    return out


@pytest.mark.parametrize("shape", [(2, 18, 26, 3), (1, 8, 16, 5), (2, 3, 35, 2)],
                         ids=["stage-odd", "one-tile", "ragged"])
def test_fold_tap_slot_names_the_staged_pixel(shape):
    """Every tile row the phase fold reads for block pixel (u, v), phase
    (a, b), tap (i, j) holds staged pixel (y + a − 1 + i, x + b − 1 + j)
    of the block's image (zero outside it), bit for bit, at shapes whose
    staged image is not a whole number of 8×16 tiles: the dz pixel that dx
    (2y + a, 2x + b) receives through tap (3 − a − 2i, 3 − b − 2j)."""
    z = torch.from_numpy(np.random.RandomState(0).randn(*shape).astype(np.float32))
    B, H, W, C = shape
    th, tw = S.FOLD_TILE
    got = _fold_gather(z, th, tw)
    zp = F.pad(z, (0, 0, 1, 1, 1, 1))
    for a in range(2):
        for b in range(2):
            for i in range(2):
                for j in range(2):
                    want = zp[:, a + i:a + i + H, b + j:b + j + W]
                    assert torch.equal(got[:, :, :, a, b, i, j], want), (a, b, i, j)


def test_fold_shift_is_the_tile_offset_of_the_tap():
    th, tw = S.FOLD_TILE
    for a, b, i, j in np.ndindex(2, 2, 2, 2):
        assert S.fold_shift(a, b, i, j) == (a + i) * (tw + 2) + b + j
        assert S.fold_tap_slot(3, 5, a, b, i, j) == (3 + a + i) * (tw + 2) + 5 + b + j
        ky, kx = S.s2_dgrad_tap(a, b, i, j)
        # the forward's output row m + a − 1 + i reads input row 2(m + a − 1 + i) + ky − 1
        assert 2 * (a - 1 + i) + ky - 1 == a and 2 * (b - 1 + j) + kx - 1 == b
    taps = sorted(S.s2_dgrad_tap(a, b, i, j) for a, b, i, j in np.ndindex(2, 2, 2, 2))
    assert taps == [(ky, kx) for ky in range(4) for kx in range(4)]  # each tap once


@pytest.mark.parametrize("act", [None, "relu", "lrelu"])
@pytest.mark.parametrize("cin,cout", [(3, 8), (16, 16), (8, 32)])
def test_phase_fold_mirror_equals_the_plain_data_gradient(cin, cout, act):
    """dx as four per-phase 2×2 convs of dz over the slices w[3−a−2i][3−b−2j]
    (``s2_dgrad_fold_plain``) is the twin's dx in fp32, within 1e-5, at the
    odd stage shape (B=2, 36×52 → 18×26); the slices are a permutation of
    the 16 taps."""
    rs = np.random.RandomState(cin + cout)
    t = lambda *s_: torch.from_numpy(rs.randn(*s_).astype(np.float32))
    B, H, W = CS.STAGE_ODD
    x, w, b = t(B, H, W, cin), t(4, 4, cin, cout) * 0.2, t(cout) * 0.1
    out = S.conv_s2_ct_plain(x, w, b, act=act)
    g = t(*out.shape)
    ref = S.conv_s2_ct_bwd_plain(x, w, None if act is None else out, g, act=act,
                                 need_dw=False)["dx"]
    dz = S._act_adj(g, out, act, 0.2)
    got = S.s2_dgrad_fold_plain(dz, w)
    assert got.shape == ref.shape == (B, H, W, cin)
    assert (got - ref).abs().max() <= 1e-5 * max(1.0, ref.abs().max())
    sl = S.s2_dgrad_slices(w)
    assert sl.shape == (2, 2, 2, 2, cout, cin)
    assert torch.equal(sl[0, 0, 0, 0], w[3, 3].T) and torch.equal(sl[1, 0, 1, 1], w[0, 1].T)


def test_fold_smem_matches_the_header():
    """The phase fold's shared-memory constants in ``csrc/phase_fold.cuh``:
    a 3-slot ring of whole taps up to 128 K rows, the port's one opt-in limit
    (``kernels/workbench/rdb.py`` MAX_SMEM), and a tile of all the staged
    channels where the block fits, else of KCH channels restaged in turn, so
    the upconv takes any C."""
    from esrganplus_tpu_torch.kernels.workbench import rdb as R

    hdr = (build.CSRC / "phase_fold.cuh").read_text()
    assert re.search(r"constexpr int NSLOT = 3;", hdr) and re.search(r"constexpr int KCH = 128;", hdr)
    assert int(re.search(r"constexpr int MAX_SMEM = (\d+);", hdr).group(1)) == R.MAX_SMEM
    assert re.search(r"return fold_smem\(np, kp, bt\) <= MAX_SMEM \? kp : KCH;", hdr)
    assert re.search(r"stage_x\(c0, min\(kt, kp - c0\), xp\);", hdr)  # the restage of a slice


def _s2_gather(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """im2col of the 4×4 stride-2 pad-1 conv gathered the way the tensor-core
    forward reads it: per block, the haloed input tile scattered into four
    parity planes by ``s2_plane_slot``, then every tap of every output pixel
    read back at ``s2_tap_slot`` → ``[B, C·16, Ho·Wo]`` (``F.unfold``'s
    layout, channel-major)."""
    B, C, H, W = x.shape
    Ho, Wo = H // 2, W // 2
    cols = torch.full((B, C, 16, Ho, Wo), float("nan"))
    dy, dx = np.meshgrid(np.arange(2 * th + 2), np.arange(2 * tw + 2), indexing="ij")
    ly, lx, ky, kx = np.meshgrid(np.arange(th), np.arange(tw), np.arange(4), np.arange(4),
                                 indexing="ij")
    slots_in = S.s2_plane_slot(dy, dx, th, tw)
    slots_tap = S.s2_tap_slot(ly, lx, ky, kx, th, tw)
    n_slots = 4 * (th + 1) * (tw + 1)
    assert sorted(slots_in.ravel().tolist()) == list(range(n_slots))  # a bijection
    for y0 in range(0, Ho, th):
        for x0 in range(0, Wo, tw):
            gy, gx = 2 * y0 - 1 + dy, 2 * x0 - 1 + dx
            inside = torch.from_numpy((gy >= 0) & (gy < H) & (gx >= 0) & (gx < W))
            tile = x[:, :, gy.clip(0, H - 1), gx.clip(0, W - 1)] * inside
            planes = torch.empty((B, C, n_slots))
            planes[:, :, torch.from_numpy(slots_in.ravel())] = tile.reshape(B, C, -1)
            taps = planes[:, :, torch.from_numpy(slots_tap.ravel())].reshape(B, C, th, tw, 16)
            h, w = min(th, Ho - y0), min(tw, Wo - x0)  # the ragged edge: stores masked
            cols[:, :, :, y0:y0 + h, x0:x0 + w] = taps[:, :, :h, :w].permute(0, 1, 4, 2, 3)
    return cols.reshape(B, C * 16, Ho * Wo)


@pytest.mark.parametrize("shape", [(2, 3, 36, 52), (1, 8, 10, 6), (2, 5, 2, 34)],
                         ids=["stage-odd", "one-ragged-tile", "one-output-row"])
def test_s2_parity_planes_gather_the_stride_2_taps(shape):
    """Every tap the 4×4 tensor-core forward reads from its parity planes is
    the input pixel ``F.unfold(x, 4, stride=2, padding=1)`` names, bit for
    bit, at shapes whose output is not a whole number of 4×16 tiles."""
    x = torch.from_numpy(np.random.RandomState(0).randn(*shape).astype(np.float32))
    th, tw = S.S2_TILE
    assert torch.equal(_s2_gather(x, th, tw), F.unfold(x, 4, stride=2, padding=1))


def test_s2_tap_slot_is_the_plane_slot_of_the_strided_pixel():
    th, tw = S.S2_TILE
    for ly in range(th):
        for lx in range(tw):
            for ky in range(4):
                for kx in range(4):
                    assert S.s2_tap_slot(ly, lx, ky, kx) == S.s2_plane_slot(2 * ly + ky,
                                                                            2 * lx + kx)


def test_s2_tile_matches_the_c_constants():
    src = (build.CSRC / "stage_ct.cu").read_text()
    mk = src[src.index("namespace mk {"):]  # the tensor-core kernels' tile: the shared one
    assert "using esr::tile::TH;" in mk and "using esr::tile::TW;" in mk
    tile = (build.CSRC / "mma_tile.cuh").read_text()
    th, tw = map(int, re.search(r"constexpr int TH = (\d+), TW = (\d+);", tile).groups())
    assert (th, tw) == S.S2_TILE


def _c_params(src: str, fn: str) -> int:
    m = re.search(rf"\bint {fn}\(([^)]*)\)", src)
    return len([p for p in m.group(1).split(",") if p.strip()])


def test_c_interface_matches_the_wrappers():
    src = (build.CSRC / "stage_ct.cu").read_text()
    # one design per dtype: bf16 → mma, fp32 → fma, nothing else
    assert "if (dtype == esr::kBFloat16 && design == kMma) return dispatch_mma" in src
    assert "if (dtype == esr::kFloat32 && design == kFma)" in src
    assert "dispatch_chunk<__nv_bfloat16" not in src  # no bf16 FMA path is left
    enum = dict(re.findall(r"k(Fma|Mma) = (\d)", re.search(r"enum Design[^}]*}", src).group(0)))
    assert {k.lower(): int(v) for k, v in enum.items()} == S.DESIGNS
    for fn, argtypes in build.SIGNATURES["stage_ct"].items():
        assert _c_params(src, fn) == len(argtypes), fn
