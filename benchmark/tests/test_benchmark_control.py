"""On the card, at each cell's own size: the control (the plain reference
at the next precision below the configuration's, in the program's place)
fails at least one of the cell's compared numbers on three seeds, and the
program passes them all. Run on a machine with the card:

    python3 -m pytest -m cuda benchmark/tests/test_benchmark_control.py
"""

from __future__ import annotations

import os
import sys

import pytest

sys.path[:0] = [os.path.dirname(os.path.abspath(__file__))]

import readings  # noqa: E402
import tiny  # noqa: E402
from core import harness  # noqa: E402

CELLS = [w["name"] for w in harness.load_json(os.path.join(tiny.REPO, "BENCHMARK.json"))
         ["workloads"]]
SEEDS = (3_100_000_001, 3_100_000_002, 3_100_000_003)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run at their own size on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, cell):
    limits = harness.Cell(cell).limits()
    for seed in SEEDS:
        got = readings.readings(cell, seed, control=True)
        assert any(v > limits[k] for k, v in got.items()), (seed, got, limits)
    got = readings.readings(cell, SEEDS[0], control=False)
    assert all(v <= limits[k] for k, v in got.items()), (got, limits)
