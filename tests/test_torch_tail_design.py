"""Cheap CPU tests of the upsample tail's two designs (no JAX, no card):
which design ``upfold_ct``, ``conv_hr_ct`` and ``upfold_ct_bwd`` take by
dtype, a pure-torch mirror of the tensor-core upconv's phase fold (the tile
rows each phase and tap reads) against ``upfold_ct_plain``, a mirror of its
adjoint's 16 (shift, phase) blocks over the phase-stacked cotangent against
``upfold_ct_bwd_plain``, the fixed partitions of its dW and db workspaces,
and the C entries and tile constants against ``csrc/tail_ct.cu``."""

import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from esrganplus_tpu_torch.kernels import build
from esrganplus_tpu_torch.kernels import tail_ct as T

SRC = (build.CSRC / "tail_ct.cu").read_text()
WIDTHS = build.KERNEL_WIDTHS
# (B, H, W) of the LR image: both flagship upconvs at batch 16, odd ones
SHAPES = {"1st": (16, 32, 32), "2nd": (16, 64, 64), "odd": (2, 37, 53), "one-tile": (1, 3, 5),
          "bench-2nd": (1, 256, 256)}


@pytest.mark.parametrize("C", WIDTHS)
@pytest.mark.parametrize("dtype,design", [(torch.bfloat16, "mma"), (torch.float32, "fma")],
                         ids=["bf16", "fp32"])
def test_design_by_dtype_at_every_width(dtype, design, C):
    """bf16 runs every tail function on the tensor cores, fp32 on the CUDA
    cores, whatever the width (one ``design`` for the stage and tail
    modules); the C entries take every width in KERNEL_WIDTHS."""
    assert T.S.design(dtype) == design
    assert re.search(rf"case {C}:", SRC)
    assert T.upfold_phase_width(C) == max(C, 16)


def test_other_dtypes_are_refused():
    for dtype in (torch.float16, torch.float64, torch.int8):
        with pytest.raises(TypeError):
            T.S.design(dtype)


def _case(C, CO, B, H, W, dtype, seed=0):
    rs = np.random.RandomState(seed)
    t = lambda *s, scale=1.0: torch.from_numpy(rs.randn(*s).astype(np.float32) * scale)
    x = t(B, H, W, C).to(dtype)
    wf, bias = T.prepare_upfold_ct(t(3, 3, C, CO, scale=(2 / (9 * C)) ** 0.5), t(CO, scale=0.1),
                                   dtype)
    out = T.upfold_ct_plain(x, wf, bias)
    g = t(B, 2 * H, 2 * W, CO).to(dtype)
    return x, wf, out, g


def _mirror(x, wf, out, g):
    """The tensor-core design's arithmetic in fp32: the gate pass's stacked
    dz, then dx as a sum over the 16 blocks of K and dW as one product per
    block, each block a shifted LR view at its phase's channel offset."""
    B, H, W, C = x.shape
    CO = wf.shape[-1]
    cop = T.upfold_phase_width(CO)
    dz, db = T.upfold_stack_dz(out, g)
    dz = dz.float()
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    dx = torch.zeros((B, H + 2, W + 2, C))
    dwf = torch.zeros(wf.shape)
    for (a, b, i, j), ph, (dy, dx_) in T.upfold_blocks():
        d = dz[..., ph * cop:ph * cop + CO]
        w = wf[a, b, i, j].float()
        # dx[y, x] += d[y - dy, x - dx] w^T: d lands at padded (y + 1, x + 1) + shift
        dx[:, 1 + dy:1 + dy + H, 1 + dx_:1 + dx_ + W] += torch.einsum("nhwo,co->nhwc", d, w)
        dwf[a, b, i, j] = torch.einsum("nhwc,nhwo->co",
                                       xp[:, 1 + dy:1 + dy + H, 1 + dx_:1 + dx_ + W], d)
    return {"dx": dx[:, 1:-1, 1:-1], "wf": dwf, "b": db}


def _fold_mirror(x, wf, bias, th=8, tw=16, slope=0.2):
    """The tensor-core upconv's arithmetic in fp32, read the way
    ``upfold_mma_kernel`` reads it: per 8×16 block the haloed LR tile
    (origin (y0 − 1, x0 − 1), zero outside) as rows, and output phase (a, b)
    of block pixel (u, v) the sum over taps (i, j) of tile row
    ``fold_tap_slot(u, v, a, b, i, j)`` times ``wf[a, b, i, j]``; + bias,
    lrelu, stored at HR pixel (2(y0 + u) + a, 2(x0 + v) + b)."""
    B, H, W, C = x.shape
    CO = wf.shape[-1]
    xf, w = x.float(), wf.float()
    out = torch.full((B, 2 * H, 2 * W, CO), float("nan"))
    ty, tx = np.meshgrid(np.arange(th + 2), np.arange(tw + 2), indexing="ij")
    u, v = np.meshgrid(np.arange(th), np.arange(tw), indexing="ij")
    for y0 in range(0, H, th):
        for x0 in range(0, W, tw):
            gy, gx = y0 - 1 + ty, x0 - 1 + tx
            inside = torch.from_numpy((gy >= 0) & (gy < H) & (gx >= 0) & (gx < W))
            rows = (xf[:, gy.clip(0, H - 1), gx.clip(0, W - 1)] * inside[..., None]).reshape(
                B, -1, C)
            h, wd = min(th, H - y0), min(tw, W - x0)  # the ragged edge: stores masked
            for a in range(2):
                for b in range(2):
                    acc = torch.zeros((B, th, tw, CO))
                    for i in range(2):
                        for j in range(2):
                            sl = torch.from_numpy(T.S.fold_tap_slot(u, v, a, b, i, j, tw))
                            acc += rows[:, sl] @ w[a, b, i, j]
                    y = T._lrelu(acc + bias.float(), slope)
                    out[:, 2 * y0 + a:2 * (y0 + h):2, 2 * x0 + b:2 * (x0 + wd):2] = y[:, :h, :wd]
    return out


@pytest.mark.parametrize("C,CO", [(8, 8), (16, 32), (3, 16)])
@pytest.mark.parametrize("shape", [(2, 37, 53), (1, 8, 16), (1, 3, 5)],
                         ids=["odd", "one-tile", "ragged"])
def test_phase_fold_mirror_equals_the_plain_upconv(C, CO, shape):
    """The phase fold's tile rows (``fold_tap_slot``) with the folded
    weights give the twin's upconv in fp32, within 1e-5, everywhere: every
    HR pixel is written once, at the odd LR shape (B=2, 37×53) and at the
    width edges (C = CO = 8, and C = 3, staged a pixel at a time)."""
    x, wf, out, _ = _case(C, CO, *shape, torch.float32)
    bias = torch.from_numpy(np.random.RandomState(1).randn(CO).astype(np.float32) * 0.1)
    ref = T.upfold_ct_plain(x, wf, bias)
    got = _fold_mirror(x, wf, bias)
    assert got.shape == ref.shape and not got.isnan().any()
    assert (got - ref).abs().max() <= 1e-5 * max(1.0, ref.abs().max())


@pytest.mark.parametrize("C,CO", [(8, 8), (16, 8), (8, 16), (16, 16)])
@pytest.mark.parametrize("shape", [(2, 5, 7), (1, 4, 9)], ids=["odd", "wide"])
def test_block_mirror_equals_the_plain_adjoint(C, CO, shape):
    """In fp32 the 16 blocks of the fold (``upfold_blocks``) over the
    phase-stacked dz give the plain twin's gradients: the block map is
    ``prepare_upfold_ct``'s fold."""
    x, wf, out, g = _case(C, CO, *shape, torch.float32)
    ref = T.upfold_ct_bwd_plain(x, wf, out, g)
    got = _mirror(x, wf, out, g)
    for k in ("dx", "wf", "b"):
        r = ref[k].float()
        assert (got[k] - r).abs().max().item() <= 1e-6 * max(1.0, r.abs().max().item()), k


def test_stacked_dz_is_the_twins_rounded_dz_with_zero_padding():
    """bf16 at CO = 8: each phase's slot holds the twin's rounded dz, then 8
    zero channels (the mma's K of 16); db is the unrounded dz's sum."""
    x, wf, out, g = _case(8, 8, 2, 3, 5, torch.bfloat16)
    dz, db = T.upfold_stack_dz(out, g)
    assert dz.dtype == torch.bfloat16 and dz.shape == (2, 3, 5, 64)
    st = dz.view(2, 3, 5, 2, 2, 16)
    for a in range(2):
        for b in range(2):
            want = T._dlrelu(out[:, a::2, b::2], g[:, a::2, b::2].float(), 0.2)
            assert torch.equal(st[:, :, :, a, b, :8], want.to(torch.bfloat16))
            assert not st[:, :, :, a, b, 8:].any()
    full = T._dlrelu(out, g.float(), 0.2)
    assert torch.allclose(db, full.sum((0, 1, 2)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("CO", [8, 64])
def test_db_partition_covers_every_chunk_once_in_order(name, CO):
    """db's workspace rows take the gate pass's 16-byte chunks in order, each
    once, none empty, a multiple of the block's threads a row (so a thread
    always forms the same channels), at most UPFOLD_DZ_MAX_PARTS; the C
    entry's ``per`` from the row count is the mirror's."""
    B, H, W = SHAPES[name]
    n8 = T.upfold_dz_chunks(B, H, W, CO)
    assert n8 == B * 4 * H * W * max(CO, 16) // 8
    ranges = T.upfold_dz_ranges(B, H, W, CO)
    nt = T.UPFOLD_DZ_THREADS
    assert 1 <= len(ranges) <= T.UPFOLD_DZ_MAX_PARTS
    assert ranges[0][0] == 0 and ranges[-1][1] == n8
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(len(ranges) - 1))
    npart = len(ranges)
    assert npart == T.upfold_dz_parts(B, H, W, CO)
    per = -(-(-(-n8 // npart)) // nt) * nt  # esr_upfold_dz's per, from the row count
    assert ranges == [(p * per, min(n8, (p + 1) * per)) for p in range(npart)]


@pytest.mark.parametrize("name", list(SHAPES))
def test_dw_partition_covers_every_tile_once_in_order(name):
    B, H, W = SHAPES[name]
    tiles = T.upfold_wgrad_tiles(B, H, W)
    assert tiles == B * -(-H // 4) * -(-W // 16)
    ranges = T.upfold_wgrad_ranges(B, H, W)
    assert 1 <= len(ranges) == T.upfold_wgrad_parts(B, H, W) <= T.UPFOLD_WG_MAX_PARTS
    covered = [t for a, b in ranges for t in range(a, b)]
    assert covered == list(range(tiles))
    assert all(a < b for a, b in ranges)
    per = ranges[0][1] - ranges[0][0]
    assert -(-tiles // len(ranges)) == per  # esr_upfold_wgrad's per
    assert ranges == T.upfold_wgrad_ranges(B, H, W)


def test_flagship_partitions():
    # 2nd upconv, batch 16 at 64² LR: 1,024 tiles, 16 a row → 64 rows × 4 phases
    assert len(T.upfold_wgrad_ranges(16, 64, 64)) == 64
    assert T.upfold_wgrad_ranges(16, 64, 64)[1] == (16, 32)
    # its gate pass: 2M chunks in 256 rows of 8,192 (at most two blocks an SM)
    assert T.upfold_dz_parts(16, 64, 64, 64) == 256
    assert T.upfold_dz_ranges(16, 64, 64, 64)[0] == (0, 8192)


def _params(fn):
    m = re.search(rf"\bint {fn}\(([^)]*)\)", SRC)
    return [p.split()[-1].lstrip("*") for p in m.group(1).split(",") if p.strip()]


@pytest.mark.parametrize("fn", ["esr_upfold", "esr_conv_hr", "esr_conv_hr_out", "esr_upfold_dz",
                                "esr_upfold_dgrad", "esr_upfold_wgrad"])
def test_c_entries_take_a_design_code_and_match_the_wrapper(fn):
    """Each entry of a two-design function takes the design code (and refuses
    any other: the checks are in the C source), with one ctypes argument per
    C parameter; ``esr_upfold`` takes both designs, one per dtype."""
    params = _params(fn)
    assert len(params) == len(build.SIGNATURES["tail_ct"][fn])
    assert "design" in params[:2]
    body = SRC[SRC.index(f"int {fn}("):]
    body = body[:body.index("\n}\n")]
    want = {"esr_conv_hr": "kFma",
            "esr_upfold": r"\(dtype == esr::kBFloat16 \? kMma : kFma\)"}.get(fn, "kMma")
    assert re.search(rf"design != {want}", body)


def test_tile_constants_are_the_kernels():
    num = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))
    assert T.UPFOLD_WG_TILE == (num("WG_TH"), 16)
    assert T.UPFOLD_DX_TILE == T.CONV_HR_OUT_TILE == (num("TH"), num("TW"))
    assert T.UPFOLD_DZ_THREADS == num("NT")
    assert "return co < 16 ? 16 : co;" in SRC  # phase_width
    assert T.S.DESIGNS == {"fma": 0, "mma": 1}  # the codes the wrappers pass
    assert re.search(r"enum Design : int \{ kFma = 0, kMma = 1 \}", SRC)


def test_cpu_tensors_take_the_twins_and_count_nothing():
    T.reset_design_counts()
    x, wf, out, g = _case(8, 8, 1, 3, 4, torch.float32)
    got = T.upfold_ct_bwd(x, wf, out, g)
    ref = T.upfold_ct_bwd_plain(x, wf, out, g)
    assert all(torch.equal(got[k], ref[k]) for k in ref)
    bias = torch.zeros(8)
    assert torch.equal(T.upfold_ct(x, wf, bias), T.upfold_ct_plain(x, wf, bias))
    for fn in (T.upfold_ct, T.conv_hr_ct, T.upfold_ct_bwd, T.conv_hr_ct_bwd):
        assert fn.launches == 0 and fn.launches_by_design == {"fma": 0, "mma": 0}
