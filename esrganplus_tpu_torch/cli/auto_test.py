"""Checkpoint-sweep harness (reference ``codes/auto_test.py``).

    python -m esrganplus_tpu_torch.cli.auto_test -opt test_options.json \
        --models-root experiments --names EXP1 EXP2 --iters 5000 10000 latest [--device cuda|cpu]

Counterpart of ``esrganplus_tpu/cli/auto_test.py``: rewrites a test option
JSON per (experiment, iteration) and runs this package's evaluator
(``cli/test.py``) in-process for each, on ``--device`` (the card by
default). A missing checkpoint is skipped and says so.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-opt", required=True, help="base test option JSON")
    ap.add_argument("--models-root", default="experiments")
    ap.add_argument("--names", nargs="+", required=True, help="experiment names to sweep")
    ap.add_argument("--iters", nargs="+", required=True, help="iterations (or 'latest')")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from esrganplus_tpu_torch.cli.test import main as test_main
    from esrganplus_tpu_torch.options.options import _strip_comments

    with open(args.opt) as f:
        base = json.loads(_strip_comments(f.read()))
    for name in args.names:
        for it in args.iters:
            opt = dict(base)
            opt["name"] = f"{name}_{it}"
            opt["path"] = {**base.get("path", {}), "pretrain_model_G": os.path.join(
                args.models_root, name, "models", f"{it}_G.pth")}
            if not os.path.exists(opt["path"]["pretrain_model_G"]):
                print(f"skip {name}@{it}: no checkpoint at {opt['path']['pretrain_model_G']}")
                continue
            with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
                json.dump(opt, f)
                tmp = f.name
            print(f"=== testing {name} @ {it} ===")
            try:
                test_main(["-opt", tmp, "--device", args.device])
            finally:
                os.unlink(tmp)


if __name__ == "__main__":
    main()
