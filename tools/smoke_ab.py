"""Run chosen phases of ``chip_smoke.py`` from two or more source trees, in
turn, on one card: an A/B comparison of host and device numbers within one
machine.

    python3 tools/smoke_ab.py --phases train-steady,gan-steady,kernels-noise \
        parent=build/parent change=. change=. parent=build/parent

Each ``label=DIR`` runs in a process of its own from DIR (its own package,
its own ``chip_smoke.py``, its kernels built into ``DIR/build/kernels``),
in the order given, so ``parent change change parent`` puts each tree
before and after the other. Every JSON row the phases print is printed
again with ``"tree": label`` and ``"run": i`` added. The phases are called
as the tree's ``chip_smoke.py`` defines them:

    train-steady   train_steady(failures)
    gan-steady     gan_steady(failures)
    kernels-noise  check_noise_kernels(failures)

and one of this tool's own, on the tree's package:

    eager-host     the PSNR step (bf16, batch 16, HR 128, input noise) by
                   ``SRTrainer.train_step`` on one batch already on the
                   card: ms a step over 8 steps queued back to back (host
                   clock, one synchronisation at the end), then the same 8
                   under ``cProfile``: Python calls a step and the 20
                   functions with the most own time

Exits 1 if any run fails or reports a failed gate.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PHASES = {"train-steady": "train_steady", "gan-steady": "gan_steady",
          "kernels-noise": "check_noise_kernels", "eager-host": "eager_host"}

# what runs inside each tree's process: build its kernels, call the phases
CHILD = """
import cProfile, json, os, pstats, sys, time
sys.path.insert(0, ".")
import chip_smoke
import torch
from esrganplus_tpu_torch.kernels import build


def eager_host(failures):
    from esrganplus_tpu_torch.models.rrdb import RRDBNetConfig
    from esrganplus_tpu_torch.train import SRTrainConfig, SRTrainer

    B, H, W = chip_smoke.TRAIN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(9)
    batch = (torch.rand((B, H, W, 3), generator=gen, device="cuda"),
             torch.rand((B, 4 * H, 4 * W, 3), generator=gen, device="cuda"))
    t = SRTrainer(RRDBNetConfig(), SRTrainConfig(compute_dtype="bfloat16"), device="cuda")
    st = [t.init_state(0)]
    n = 8

    def steps():
        for _ in range(n):
            st[0] = t.train_step(st[0], batch, 1)[0]
        torch.cuda.synchronize()

    steps()
    t0 = time.perf_counter()
    steps()
    ms = (time.perf_counter() - t0) / n * 1e3
    prof = cProfile.Profile()
    prof.runcall(steps)
    stats = pstats.Stats(prof).stats
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:20]
    chip_smoke.emit({
        "phase": "eager-host", "ms_per_step": ms,
        "python_calls_per_step": sum(v[1] for v in stats.values()) / n,
        "top": [{"fn": f"{os.path.basename(k[0])}:{k[1]}:{k[2]}", "calls_per_step": v[1] / n,
                 "own_ms_per_step": v[2] / n * 1e3} for k, v in top]})


build.build()
failures = []
for fn in sys.argv[1:]:
    (eager_host if fn == "eager_host" else getattr(chip_smoke, fn))(failures)
print(json.dumps({"failures": failures}), flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated, of: " + ", ".join(PHASES))
    ap.add_argument("trees", nargs="+", metavar="label=DIR")
    args = ap.parse_args(argv)
    fns = [PHASES[p] for p in args.phases.split(",")]
    bad = 0
    for i, spec in enumerate(args.trees):
        label, _, tree = spec.partition("=")
        proc = subprocess.run([sys.executable, "-c", CHILD, *fns], cwd=os.path.abspath(tree),
                              capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            if not line.startswith("{"):
                continue
            row = json.loads(line)
            if row.get("failures"):
                bad += 1
            print(json.dumps({"tree": label, "run": i, **row}), flush=True)
        if proc.returncode:
            bad += 1
            print(f"{label} (run {i}) exited {proc.returncode}:\n{proc.stderr[-4000:]}",
                  file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
