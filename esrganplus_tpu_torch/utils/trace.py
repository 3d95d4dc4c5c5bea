"""Profiler-trace analysis: exclusive time by op family.

Counterpart of ``esrganplus_tpu/utils/trace.py`` for the traces
``torch.profiler`` writes (``--profile`` of ``cli/train.py``, through
``tensorboard_trace_handler``: ``<host>_<pid>.<ts>.pt.trace.json[.gz]``, or
any path ``export_chrome_trace`` was given). The table is built from the
trace's GPU kernel rows (``"cat": "kernel"``) when it has any, so it sums to
the card's busy time; a trace of a CPU run has none, and then its CPU op rows
(``"cat": "cpu_op"``) are used, with nested ops charged to themselves, not
to their parent.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
from typing import Dict, List, Tuple

TRACE_PATTERNS = ("*.pt.trace.json", "*.pt.trace.json.gz", "*.json.gz", "*.trace.json")


def find_trace_file(trace_dir: str) -> str:
    """The newest trace file under ``trace_dir`` (recursive), or the path
    itself when it is a file."""
    if os.path.isfile(trace_dir):
        return trace_dir
    paths = {p for pat in TRACE_PATTERNS
             for p in glob.glob(os.path.join(trace_dir, "**", pat), recursive=True)}
    if not paths:
        raise FileNotFoundError(f"no profiler trace ({', '.join(TRACE_PATTERNS)}) "
                                f"under {trace_dir}")
    return max(paths, key=os.path.getmtime)


def load_trace_events(path: str) -> List[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def op_family(name: str) -> str:
    """A kernel or op name without its return type, template arguments,
    parameter list and namespaces: ``void (anonymous namespace)::
    dense_mma_kernel<64, 1, 8, 2>(Args)`` → ``dense_mma_kernel``,
    ``aten::conv2d`` → ``conv2d``."""
    fam = re.sub(r"\(anonymous namespace\)::|^void ", "", name)
    fam = re.split(r"[<(]", fam)[0].split("::")[-1].strip()
    return fam or name


def device_rows(events) -> Tuple[str, List[dict]]:
    """("kernel", the GPU kernel rows) or, when there are none,
    ("cpu_op", the CPU op rows); each event once."""
    for cat in ("kernel", "cpu_op"):
        seen, rows = set(), []
        for e in events:
            if e.get("ph") == "X" and e.get("cat") == cat:
                key = (e.get("pid"), e.get("tid"), e["ts"], e.get("dur", 0), e["name"])
                if key not in seen:
                    seen.add(key)
                    rows.append(e)
        if rows:
            return cat, rows
    return "kernel", []


def aggregate_exclusive(events, steps: int = 1,
                        family=op_family) -> Tuple[float, Dict[str, Tuple[float, float]]]:
    """→ (busy ms per step, {family: (exclusive ms per step, count per step)}).

    The rows of each (pid, tid) are a nested interval forest (sorted by
    start, ties longest first); a child's span is taken from its innermost
    enclosing parent's exclusive time, so the table sums to the busy total.
    Kernels on one stream do not nest, and each counts whole."""
    per_thread: Dict[tuple, list] = {}
    for e in device_rows(events)[1]:
        per_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    agg: Dict[str, Tuple[float, int]] = {}
    total = 0.0
    for evs in per_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack: List[Tuple[float, str]] = []  # (end ts, family)
        for e in evs:
            ts, dur = e["ts"], e.get("dur", 0)
            while stack and stack[-1][0] <= ts:
                stack.pop()
            fam = family(e["name"])
            excl = dur / 1e3  # µs → ms
            if stack:
                d, c = agg[stack[-1][1]]
                agg[stack[-1][1]] = (d - excl, c)
            else:
                total += excl
            d, c = agg.get(fam, (0.0, 0))
            agg[fam] = (d + excl, c + 1)
            stack.append((ts + dur, fam))
    return total / steps, {k: (d / steps, c / steps) for k, (d, c) in agg.items()}


def format_table(total_ms: float, agg: Dict[str, Tuple[float, float]],
                 top: int = 25, min_ms: float = 0.0) -> str:
    lines = [f"device total: {total_ms:.3f} ms/step"]
    for fam, (dur, cnt) in sorted(agg.items(), key=lambda kv: -kv[1][0])[:top]:
        if dur < min_ms:
            break
        lines.append(f"{dur:9.3f} ms  x{cnt:<7g} {fam}")
    return "\n".join(lines)
