"""Readings of a cell's compared numbers on the card, seed by seed, in one
process: the program's (``--control 0``) or the control's, the reference at
the configuration's control precision in the program's place
(``--control 1``). The limits in ``limits/<cell>.json`` are set from these.

    python3 benchmark/tests/readings.py --workload <cell> --control 0 --seeds 1 2 3
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from core import harness  # noqa: E402


def half_batch(patch=setattr):
    """Plant a fault in the program: the sampler keeps half of each batch,
    so the step's means are taken over the rest (``patch``: how to set the
    attribute, a test's ``monkeypatch.setattr``)."""
    from esrganplus_tpu_torch.data.resident import ResidentCropStore, ResidentSegStore

    for cls in (ResidentCropStore, ResidentSegStore):
        make = cls.make_sampler

        def halved(self, batch_size, make=make):
            sample = make(self, batch_size)
            return lambda key: tuple(t[: t.shape[0] // 2] for t in sample(key))

        patch(cls, "make_sampler", halved)


def readings(name: str, seed: int, control: bool, bench_path=None, device="cuda") -> dict:
    cell = harness.Cell(name, bench_path)
    return {n: v for n, v, _ in cell.driver().readings(cell, seed, control, device)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control", type=int, choices=(0, 1), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=("half_batch",), default=None,
                    help="plant this fault in the program first")
    args = ap.parse_args()
    if args.fault:
        half_batch()
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "control": args.control,
                          "fault": args.fault, "seed": seed,
                          **readings(args.workload, seed, bool(args.control))}), flush=True)


if __name__ == "__main__":
    main()
