"""Profiler-trace analysis: exclusive time by op family.

Counterpart of ``esrganplus_tpu/utils/trace.py`` for the traces
``torch.profiler`` writes (``--profile`` of ``cli/train.py``, through
``tensorboard_trace_handler``: ``<host>_<pid>.<ts>.pt.trace.json[.gz]``, or
any path ``export_chrome_trace`` was given). The table is built from the
trace's GPU kernel rows (``"cat": "kernel"``) when it has any, so it sums to
the card's busy time; a trace of a CPU run has none, and then its CPU op rows
(``"cat": "cpu_op"``) are used, with nested ops charged to themselves, not
to their parent.

It also holds the program's own tracing, whose sink is whatever
``torch.profiler`` records (the benchmark's ``--trace 1``, ``cli/train.py
--profile``): :func:`span` around host work, and :func:`phase` marks where
a training step's phases begin. A captured step's marks record which of its
graph's kernel nodes each phase added (:func:`capture_marks`,
:func:`node_phases`), so that :func:`phase_times` can charge each kernel row
of a trace of its replays to its phase; nothing runs at a replay.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import glob
import gzip
import json
import os
import re
from typing import Dict, List, Optional, Tuple

import torch

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
    → ``dense_mma_kernel``, also behind nvcc's ``__nv_static_..._`` prefix);
    a name that is not mangled goes to
    :func:`op_family`."""
    # a kernel of a file-static namespace (NCCL's) carries nvcc's prefix
    name = re.sub(r"^__nv_static_\w*?_(?=_Z)", "", name)
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


@functools.lru_cache(maxsize=None)
def _libcuda():
    import ctypes

    return ctypes.CDLL("libcuda.so.1")


def _check(code, what):
    if code:
        raise RuntimeError(f"{what} failed with CUresult {code}")


def _graph_nodes(cu, raw) -> list:
    """The nodes of the CUDA graph ``raw`` (a ``CUgraph``), in the order the
    graph holds them: the order its capture added them."""
    import ctypes

    n = ctypes.c_size_t(0)
    _check(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    return list(nodes)


def graph_node_families(graph) -> list:
    """Every node of a captured ``torch.cuda.CUDAGraph`` (made with
    ``keep_graph=True``) in the graph's order: a kernel node's family
    (:func:`mangled_family`), None for any other node. Read through libcuda
    (``cuGraphGetNodes``, ``cuGraphKernelNodeGetParams``, ``cuFuncGetName``)."""
    import ctypes

    cu = _libcuda()

    class Params(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p)] + [(f, ctypes.c_uint) for f in (
            "gx", "gy", "gz", "bx", "by", "bz", "smem")] + [
            ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
            ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]

    out, names = [], {}
    for node in _graph_nodes(cu, ctypes.c_void_p(graph.raw_cuda_graph())):
        kind = ctypes.c_int(-1)
        _check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
               "cuGraphNodeGetType")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            out.append(None)
            continue
        p = Params()
        _check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(p)),
               "cuGraphKernelNodeGetParams")
        key = (p.func, p.kern)
        if key not in names:
            name = ctypes.c_char_p()
            if p.func:
                _check(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(p.func)),
                       "cuFuncGetName")
            else:
                _check(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(p.kern)),
                       "cuKernelGetName")
            names[key] = mangled_family(name.value.decode())
        out.append(names[key])
    return out


def graph_kernels(graph) -> collections.Counter:
    """The kernel nodes of a captured ``torch.cuda.CUDAGraph`` (made with
    ``keep_graph=True``), counted by family: what each replay of it
    launches (:func:`graph_node_families`)."""
    return collections.Counter(f for f in graph_node_families(graph) if f is not None)


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


# ---------------------------------------------------------------------------
# Spans and the phases of a step, on the profiler's clock
# ---------------------------------------------------------------------------

recording = torch._C._autograd._profiler_enabled  # whether a profiler records
# a span's host row: a record function of the profiler's op scope, not
# ``torch.profiler.record_function``'s user annotation, which the profiler
# also lays over the device's timeline as a row spanning the span's kernels
record = torch._C._profiler._RecordFunctionFast

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A host span ``name``: while a ``torch.profiler`` records, a host row
    on the clock of the device rows (:data:`record`); otherwise nothing but
    the one check of whether one records."""
    if not recording():
        return _NO_SPAN
    return record(name)


def mark(name: str) -> None:
    """A host row ``name`` of no length where the program passes it (while
    a profiler records; otherwise the one check). The executor marks each
    replay so, just before its launch: a span around the launch makes the
    profiler link every kernel of the graph to it, and reading the trace
    (``prof.events()``) then took 2 to 10 times as long on the card."""
    if recording():
        with record(name):
            pass


PHASES = ("sample", "g.fwd", "f.fwd", "d.fwd", "loss", "d.bwd", "f.bwd", "g.bwd",
          "g.opt", "d.opt", "bn", "logs")  # the marks a step body makes
EXEC = "exec"  # a replay's nodes before the first mark, and rows between replays
REPLAY = "exec.replay:"  # a replay's launch mark; the captured graph's id follows


def is_span(name: str) -> bool:
    """Whether a host row is one of the program's spans: a phase, or a
    span of the front end (``sr.``), the executor (``exec.``) or the store
    (``store.``)."""
    return name in PHASES or name.startswith(("sr.", "exec.", "store."))


_capture = None  # (stream, [(phase, graph nodes before it)]) while a step is captured
_open = []  # the phase span open outside a capture: [(name, its record)]


def phase(name: str) -> None:
    """Mark where the step's phase ``name`` (:data:`PHASES`) begins; it
    lasts to the next mark. While a step is captured as a CUDA graph
    (:func:`capture_marks`) the mark records the graph's node count; outside
    a capture, while a profiler records, it closes the open phase span and
    opens one named ``name``; otherwise it is the two checks."""
    cap = _capture
    if cap is not None:
        stream, marks = cap
        if not marks or marks[-1][0] != name:
            marks.append((name, _capture_node_count(stream)))
    elif recording():
        if _open and _open[0][0] == name:
            return
        end_phase()
        rf = record(name)
        rf.__enter__()
        _open.append((name, rf))


def phase_at_grad(t: torch.Tensor, name: str) -> torch.Tensor:
    """``t``, with the phase ``name`` marked when the backward pass computes
    its gradient (a backward phase inside one ``torch.autograd.grad``: the
    engine's order decides which opens first)."""
    if t.requires_grad and (_capture is not None or recording()):
        t.register_hook(lambda g: phase(name))
    return t


def end_phase() -> None:
    """Close the phase span a step's body left open (a no-op in a capture
    and while no profiler records)."""
    while _open:
        _open.pop()[1].__exit__(None, None, None)


@contextlib.contextmanager
def capture_marks(stream):
    """Around the capture of a step on ``stream`` (a ``torch.cuda.Stream``)
    → the list the step's :func:`phase` marks fill, each (phase, the number
    of nodes the graph held when it was made)."""
    global _capture
    marks = []
    _capture = (stream.cuda_stream, marks)
    try:
        yield marks
    finally:
        _capture = None


def _capture_node_count(stream: int) -> int:
    """The nodes the graph under capture on the ``cudaStream_t`` ``stream``
    holds so far (``cuStreamGetCaptureInfo``, ``cuGraphGetNodes``: a graph
    being captured may be read)."""
    import ctypes

    cu = _libcuda()
    status, cid, graph = ctypes.c_int(0), ctypes.c_ulonglong(0), ctypes.c_void_p()
    deps, ndeps = ctypes.c_void_p(), ctypes.c_size_t(0)
    if hasattr(cu, "cuStreamGetCaptureInfo_v2"):
        code = cu.cuStreamGetCaptureInfo_v2(
            ctypes.c_void_p(stream), ctypes.byref(status), ctypes.byref(cid),
            ctypes.byref(graph), ctypes.byref(deps), ctypes.byref(ndeps))
    else:  # a libcuda with the v3 entry alone (edge data before the count)
        code = cu.cuStreamGetCaptureInfo_v3(
            ctypes.c_void_p(stream), ctypes.byref(status), ctypes.byref(cid),
            ctypes.byref(graph), ctypes.byref(deps), None, ctypes.byref(ndeps))
    _check(code, "cuStreamGetCaptureInfo")
    if status.value != 1:  # CU_STREAM_CAPTURE_STATUS_ACTIVE
        raise RuntimeError(f"stream {stream:#x} is not capturing (status {status.value})")
    n = ctypes.c_size_t(0)
    _check(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    return n.value


def node_phases(families: list, marks: list) -> List[Tuple[str, str]]:
    """The (phase, family) of each kernel node of a captured step, in the
    graph's order (``families``: :func:`graph_node_families`), each node in
    the phase whose mark (``marks``: :func:`capture_marks`) came last before
    the capture added it; nodes before the first mark are :data:`EXEC`'s."""
    out, k, cur = [], 0, EXEC
    for i, fam in enumerate(families):
        while k < len(marks) and marks[k][1] <= i:
            cur = marks[k][0]
            k += 1
        if fam is not None:
            out.append((cur, fam))
    return out


_PHASE_LISTS: Dict[str, List[Tuple[str, str]]] = {}  # graph id → its (phase, family) list


def register_phases(graph_id: str, nodes: List[Tuple[str, str]]) -> None:
    """Keep what a replay of the captured graph ``graph_id`` launches, in
    order, for a reader of its ``exec.replay:<graph_id>`` marks."""
    _PHASE_LISTS[str(graph_id)] = list(nodes)


def phase_lists() -> Dict[str, List[Tuple[str, str]]]:
    """{graph id: [(phase, kernel family)]} of every step this process
    captured (the registry itself: read it, do not change it)."""
    return _PHASE_LISTS


MATCH_SLACK = 4096  # rows of the executor's own a replay's first row may follow


def phase_times(kernel_rows, host_spans, lists: Optional[dict] = None,
                own=None) -> Optional[Dict[str, dict]]:
    """Device time by phase of a trace of replayed steps.

    ``kernel_rows``: (family, start, end) of the trace's kernel rows, µs on
    the profiler's clock; ``host_spans``: (name, start, end) of its host rows,
    of which the ``exec.replay:<id>`` marks are read; ``lists``: {id: [(phase,
    family)]} (:func:`phase_lists` by default). The rows are walked in time
    order: each replay's rows are the first run of rows that matches its
    list, each of the program's own kernels (``own``: ``kernels/build
    .kernel_names()`` by default) by family and any other kernel by being
    one (a library kernel may be named otherwise in a graph node than in a
    trace row: cuBLAS's by its return type, cuDNN's mangled); rows before
    it, between replays and after the last are :data:`EXEC`'s. → {phase:
    {"ms": device ms, "kernels": rows, "idle_ms": the gaps before its rows
    since the end of the rows before them}}; None where a replay's list is
    unknown or its rows do not match within :data:`MATCH_SLACK` rows."""
    if own is None:
        from esrganplus_tpu_torch.kernels.build import kernel_names

        own = kernel_names()
    lists = _PHASE_LISTS if lists is None else lists
    rows = sorted(kernel_rows, key=lambda r: r[1])
    replays = sorted((s, n[len(REPLAY):]) for n, s, _ in host_spans if n.startswith(REPLAY))
    same = lambda got, want: got == want or (got not in own and want not in own)
    out: Dict[str, dict] = {}
    last_end = None

    def charge(ph, row):
        nonlocal last_end
        t = out.setdefault(ph, {"ms": 0.0, "kernels": 0, "idle_ms": 0.0})
        t["ms"] += (row[2] - row[1]) / 1e3
        t["kernels"] += 1
        if last_end is not None and row[1] > last_end:
            t["idle_ms"] += (row[1] - last_end) / 1e3
        last_end = row[2] if last_end is None else max(last_end, row[2])

    i = 0
    for _, gid in replays:
        want = lists.get(gid)
        if not want:
            return None
        n, k = len(want), i
        while True:
            if k + n > len(rows) or k - i > MATCH_SLACK:
                return None
            if all(same(rows[k + j][0], want[j][1]) for j in range(n)):
                break
            k += 1
        for r in rows[i:k]:
            charge(EXEC, r)
        for (ph, _), r in zip(want, rows[k:k + n]):
            charge(ph, r)
        i = k + n
    for r in rows[i:]:
        charge(EXEC, r)
    return out
