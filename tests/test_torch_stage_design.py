"""Cheap CPU tests of the stage kernels' launch plan (no JAX, no card):
which design ``stage_design`` picks per dtype, kernel size and direction,
the weight-gradient partition that fixes the reduction order, the 4×4
tensor-core forward's parity-plane tap map, and the C interface's design
codes and arities (``csrc/stage_ct.cu``) against ``kernels/build.py``."""

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
S1 = [n for n, v in SHAPES.items() if v[0] == 3]


@pytest.mark.parametrize("name", S1)
def test_bf16_3x3_runs_on_the_tensor_cores(name):
    ks, _, _, _, cin, cout = SHAPES[name]
    for op in S.OPS:
        assert S.stage_design(torch.bfloat16, ks, cin, cout, op) == "mma"
        assert S.stage_design(torch.float32, ks, cin, cout, op) == "fma"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", [n for n, v in SHAPES.items() if v[0] == 4])
def test_4x4_stays_on_the_cuda_cores(name, dtype):
    """The 4×4 adjoint stays on the FMA kernels in both dtypes, and so does
    the fp32 forward; the bf16 forward runs on the tensor cores."""
    ks, _, _, _, cin, cout = SHAPES[name]
    assert S.stage_design(dtype, ks, cin, cout, "bwd") == "fma"
    assert S.stage_design(dtype, ks, cin, cout, "fwd") == (
        "mma" if dtype == torch.bfloat16 else "fma")


@pytest.mark.parametrize("op", S.OPS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_design_is_a_function_of_dtype_kernel_size_and_op(name, dtype, op):
    """bf16 3×3 (both directions) and the bf16 4×4 forward on the tensor
    cores, everything else on the CUDA cores; the widths never decide."""
    ks, _, _, _, cin, cout = SHAPES[name]
    want = "mma" if dtype == torch.bfloat16 and (ks == 3 or op == "fwd") else "fma"
    assert S.stage_design(dtype, ks, cin, cout, op) == want


def test_stage_design_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="cout"):
        S.stage_design(torch.bfloat16, 3, 64, 24, "fwd")
    with pytest.raises(ValueError, match="input channels"):
        S.stage_design(torch.bfloat16, 3, 129, 64, "bwd")
    with pytest.raises(ValueError, match="op"):
        S.stage_design(torch.bfloat16, 4, 64, 64, "dgrad")


@pytest.mark.parametrize("name,design", [(n, d) for n, v in SHAPES.items()
                                         for d in (("fma", "mma") if v[0] == 3 else ("fma",))])
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
    enum = dict(re.findall(r"k(Fma|Mma) = (\d)", re.search(r"enum Design[^}]*}", src).group(0)))
    assert {k.lower(): int(v) for k, v in enum.items()} == S.DESIGNS
    for fn, argtypes in build.SIGNATURES["stage_ct"].items():
        assert _c_params(src, fn) == len(argtypes), fn
