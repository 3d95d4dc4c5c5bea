"""Cheap CPU tests of the stage kernels' launch plan (no JAX, no card):
which design ``stage_design`` picks, the weight-gradient partition that
fixes the reduction order, and the C interface's design codes and arities
(``csrc/stage_ct.cu``) against ``kernels/build.py``."""

import importlib.util
import re
from pathlib import Path

import pytest
import torch

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
    assert S.stage_design(torch.bfloat16, ks, cin, cout) == "mma"
    assert S.stage_design(torch.float32, ks, cin, cout) == "fma"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", [n for n, v in SHAPES.items() if v[0] == 4])
def test_4x4_stays_on_the_cuda_cores(name, dtype):
    ks, _, _, _, cin, cout = SHAPES[name]
    assert S.stage_design(dtype, ks, cin, cout) == "fma"


def test_stage_design_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="cout"):
        S.stage_design(torch.bfloat16, 3, 64, 24)
    with pytest.raises(ValueError, match="input channels"):
        S.stage_design(torch.bfloat16, 3, 129, 64)


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


def _c_params(src: str, fn: str) -> int:
    m = re.search(rf"\bint {fn}\(([^)]*)\)", src)
    return len([p for p in m.group(1).split(",") if p.strip()])


def test_c_interface_matches_the_wrappers():
    src = (build.CSRC / "stage_ct.cu").read_text()
    enum = dict(re.findall(r"k(Fma|Mma) = (\d)", re.search(r"enum Design[^}]*}", src).group(0)))
    assert {k.lower(): int(v) for k, v in enum.items()} == S.DESIGNS
    for fn, argtypes in build.SIGNATURES["stage_ct"].items():
        assert _c_params(src, fn) == len(argtypes), fn
