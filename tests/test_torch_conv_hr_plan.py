"""Cheap CPU tests of the conv_hr adjoint's launch plan (no JAX, no card):
which design ``conv_hr_ct_bwd`` takes, the partition of
``conv_hr_adj_kernel``'s pixel tiles into workspace rows (which fixes the
reduction order of dW1, db1 and db0), and its C entry's arity against
``kernels/build.py``."""

import re

import pytest
import torch

from esrganplus_tpu_torch.kernels import build
from esrganplus_tpu_torch.kernels import tail_ct as T

# (B, H, W): the flagship training shape (batch 16, HR 128) and odd ones
SHAPES = {"flagship": (16, 128, 128), "odd": (2, 37, 53), "one-tile": (1, 5, 9),
          "many-parts": (3, 200, 168), "tall": (1, 300, 16)}


def test_bf16_runs_on_the_tensor_cores_fp32_on_the_cuda_cores():
    assert T.S.design(torch.bfloat16) == "mma"
    assert T.S.design(torch.float32) == "fma"
    with pytest.raises(TypeError):
        T.S.design(torch.float16)


@pytest.mark.parametrize("name", list(SHAPES))
def test_adj_partition_covers_every_tile_once_in_order(name):
    """Every 8×16 pixel tile is summed by exactly one workspace row, rows in
    tile order, none empty, at most CONV_HR_ADJ_MAX_PARTS; and the plan is
    the same on every call (a function of the shapes alone)."""
    B, H, W = SHAPES[name]
    tiles = T.conv_hr_adj_tiles(B, H, W)
    assert tiles == B * -(-H // 8) * -(-W // 16)
    parts = T.conv_hr_adj_parts(B, H, W)
    ranges = T.conv_hr_adj_ranges(B, H, W)
    assert 1 <= parts <= T.CONV_HR_ADJ_MAX_PARTS and len(ranges) == parts
    assert ranges[0][0] == 0 and ranges[-1][1] == tiles
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(parts - 1))
    covered = [t for a, b in ranges for t in range(a, b)]
    assert covered == list(range(tiles))
    assert ranges == T.conv_hr_adj_ranges(B, H, W)


def test_flagship_partition_is_two_blocks_an_sm():
    # 2,048 tiles of the 128² HR batch of 16, 8 a row: 256 blocks on 132 SMs
    assert T.conv_hr_adj_parts(16, 128, 128) == 256
    assert T.conv_hr_adj_ranges(16, 128, 128)[1] == (8, 16)


def test_c_entry_matches_the_wrapper():
    src = (build.CSRC / "tail_ct.cu").read_text()
    for fn, argtypes in build.SIGNATURES["tail_ct"].items():
        m = re.search(rf"\bint {fn}\(([^)]*)\)", src)
        assert len([p for p in m.group(1).split(",") if p.strip()]) == len(argtypes), fn
    # the tile the C kernel walks is the one the mirror counts
    assert re.search(r"constexpr int TH = 8;", src) and re.search(r"constexpr int TW = 16;", src)
    assert T.CONV_HR_ADJ_TILE == (8, 16)


def test_launch_counts_start_at_zero_by_design():
    T.reset_design_counts()
    assert T.conv_hr_ct_bwd.launches == 0
    assert T.conv_hr_ct_bwd.launches_by_design == {"fma": 0, "mma": 0}
