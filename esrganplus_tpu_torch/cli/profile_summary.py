"""Summarise a ``torch.profiler`` trace into a per-op-family time table.

    python -m esrganplus_tpu_torch.cli.train -opt <opt.json> --profile /tmp/tr --profile-steps 10
    python -m esrganplus_tpu_torch.cli.profile_summary /tmp/tr --steps 10

prints the exclusive time of each kernel family on the card (each CPU op
family for a trace of a CPU run) per step (``utils/trace.py``), then the
host ms a step under each of the program's spans (``utils/trace.span``, the
eager step's phases; inclusive, a replay's ``exec.replay:<id>`` as
``exec.replay``) and, where the train CLI wrote the captured steps' kernels
by phase beside the trace (``phases.json``), the device ms, kernels and idle
ms a step of each phase of the replayed steps (``utils/trace.phase_times``).
The whole timeline opens in Perfetto or TensorBoard's profiler plugin.
Counterpart of ``esrganplus_tpu/cli/profile_summary.py``, with the same
arguments.
"""

from __future__ import annotations

import argparse
import collections
import json
import os


def span_table(events, steps: int) -> list:
    """[(span, host ms a step)] of the trace's spans, largest first."""
    from esrganplus_tpu_torch.utils.trace import REPLAY, is_span

    ms = collections.Counter()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "cpu_op" and is_span(e["name"]):
            name = REPLAY[:-1] if e["name"].startswith(REPLAY) else e["name"]
            ms[name] += e.get("dur", 0) / 1e3 / steps
    return ms.most_common()


def phase_table(events, lists: dict, steps: int):
    """{phase: {"ms", "kernels", "idle_ms"}} a step of the trace's replays
    (:func:`utils.trace.phase_times`), or None where they do not match."""
    from esrganplus_tpu_torch.utils.trace import is_span, op_family, phase_times

    rows, spans = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        end = e["ts"] + e.get("dur", 0)
        # CUDA runs a graph's copy and set nodes as kernels of its own
        # (memcpy32_post, memset32): no kernel node of the graph
        if e.get("cat") == "kernel" and not e["name"].lower().startswith(("memcpy", "memset")):
            rows.append((op_family(e["name"]), e["ts"], end))
        elif e.get("cat") == "cpu_op" and is_span(e["name"]):
            spans.append((e["name"], e["ts"], end))
    got = phase_times(rows, spans, lists)
    if got is None:
        return None
    return {k: {f: v / steps for f, v in t.items()} for k, t in got.items()}


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
    events = load_trace_events(path)
    total, agg = aggregate_exclusive(events, steps=args.steps)
    print(f"trace: {path}")
    print(format_table(total, agg, top=args.top, min_ms=args.min_ms))
    spans = span_table(events, args.steps)
    if spans:
        print("host ms/step by span:")
        for name, ms in spans[:args.top]:
            print(f"{ms:9.3f} ms  {name}")
    phases_path = os.path.join(os.path.dirname(path), "phases.json")
    if os.path.isfile(phases_path):
        with open(phases_path) as f:
            table = phase_table(events, json.load(f), args.steps)
        if table is None:
            print("phases: the trace's replays do not match phases.json")
        else:
            print("device ms/step by phase (kernels, idle ms before them):")
            for name, t in sorted(table.items(), key=lambda kv: -kv[1]["ms"]):
                print(f"{t['ms']:9.3f} ms  x{t['kernels']:<7g} idle {t['idle_ms']:8.3f} ms  "
                      f"{name}")


if __name__ == "__main__":
    main()
