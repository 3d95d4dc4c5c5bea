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

import collections
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


LEAD_IN = 32  # throwaway kernels that open a window of kernel_counts


def kernel_counts(fn, names) -> collections.Counter:
    """Run ``fn()`` under ``torch.profiler`` (host and device activity, the
    device's work waited for) → the kernels the card ran whose
    :func:`op_family` is in ``names``, counted by family. A captured graph's
    replays show here, where no Python wrapper runs. One of the first device
    activities after the profiler starts is at times missing from its trace,
    so LEAD_IN throwaway kernels open the window; with the host's activity
    off, many more go missing. Empty without a CUDA device."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        fn()
        return collections.Counter()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        lead = torch.zeros(1, device="cuda")
        for _ in range(LEAD_IN):
            lead.add_(1)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    return collections.Counter(
        f for f in (op_family(e.name) for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA) if f in names)


def mangled_family(name: str) -> str:
    """A kernel's family from its mangled (Itanium) name, as :func:`op_family`
    gives it from the demangled one: the last name of the nested name, before
    its template arguments (``_ZN12_GLOBAL__N_116dense_mma_kernelILi64E...``
    → ``dense_mma_kernel``); a name that is not mangled goes to
    :func:`op_family`."""
    m = re.match(r"_Z(N?)", name)
    if not m:
        return op_family(name)
    i, last = m.end(), None
    while i < len(name) and name[i].isdigit():
        j = i
        while name[j].isdigit():
            j += 1
        n = int(name[i:j])
        last, i = name[j:j + n], j + n
        if not m.group(1):  # an unnested name is one identifier
            break
    return last or name


def graph_kernels(graph) -> collections.Counter:
    """The kernel nodes of a captured ``torch.cuda.CUDAGraph`` (made with
    ``keep_graph=True``), counted by family: what each replay of it
    launches, read from the graph through libcuda (``cuGraphGetNodes``,
    ``cuGraphKernelNodeGetParams``, ``cuFuncGetName``)."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")

    class Params(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p)] + [(f, ctypes.c_uint) for f in (
            "gx", "gy", "gz", "bx", "by", "bz", "smem")] + [
            ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
            ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]

    def check(code, what):
        if code:
            raise RuntimeError(f"{what} failed with CUresult {code}")

    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    out = collections.Counter()
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
              "cuGraphNodeGetType")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        p, name = Params(), ctypes.c_char_p()
        check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(p)),
              "cuGraphKernelNodeGetParams")
        if p.func:
            check(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(p.func)), "cuFuncGetName")
        else:
            check(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(p.kern)),
                  "cuKernelGetName")
        out[mangled_family(name.value.decode())] += 1
    return out


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
