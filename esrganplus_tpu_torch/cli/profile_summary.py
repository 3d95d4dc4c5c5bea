"""Summarise a ``torch.profiler`` trace into a per-op-family time table.

    python -m esrganplus_tpu_torch.cli.train -opt <opt.json> --profile /tmp/tr --profile-steps 10
    python -m esrganplus_tpu_torch.cli.profile_summary /tmp/tr --steps 10

prints the exclusive time of each kernel family on the card (each CPU op
family for a trace of a CPU run) per step (``utils/trace.py``); the whole
timeline opens in Perfetto or TensorBoard's profiler plugin. Counterpart of
``esrganplus_tpu/cli/profile_summary.py``, with the same arguments.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    from esrganplus_tpu_torch.utils.trace import (aggregate_exclusive, find_trace_file,
                                                  format_table, load_trace_events)

    ap = argparse.ArgumentParser()
    ap.add_argument("trace_dir", help="directory passed to --profile (or a trace file)")
    ap.add_argument("--steps", type=int, default=1,
                    help="number of steps captured in the trace; per-step "
                         "numbers are totals divided by this")
    ap.add_argument("--top", type=int, default=25, help="rows to print")
    ap.add_argument("--min-ms", type=float, default=0.0,
                    help="stop printing below this per-step time")
    args = ap.parse_args(argv)

    path = find_trace_file(args.trace_dir)
    total, agg = aggregate_exclusive(load_trace_events(path), steps=args.steps)
    print(f"trace: {path}")
    print(format_table(total, agg, top=args.top, min_ms=args.min_ms))


if __name__ == "__main__":
    main()
