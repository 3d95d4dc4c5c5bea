"""A traced slice of a run: ``torch.profiler`` around a fixed piece of the
window, reduced to device intervals, by-name families and host activity.

The family of a kernel is its name less return type, namespaces, template
arguments and parameters (a copy of the program's ``utils/trace``
``op_family`` and ``mangled_family``, so that a trace row and a kernel node
read from a captured CUDA graph name one kernel alike). The device's busy
time is the union of its kernel, copy and memset intervals inside the slice,
not their sum: two streams working at once are busy once.
"""

from __future__ import annotations

import collections
import re
import time
from dataclasses import dataclass, field

LEAD_IN = 32  # throwaway kernels first: the first device rows of a trace may go missing


def op_family(name: str) -> str:
    fam = re.sub(r"\(anonymous namespace\)::|^void ", "", name)
    fam = re.split(r"[<(]", fam)[0].split("::")[-1].strip()
    return fam or name


def mangled_family(name: str) -> str:
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
        if not m.group(1):
            break
    return last or name


def kind_of(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "copy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


@dataclass
class DeviceEvent:
    name: str
    start: float  # µs, the profiler's clock
    end: float

    @property
    def family(self) -> str:
        return op_family(self.name)

    @property
    def kind(self) -> str:
        return kind_of(self.name)


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """The idle (start, end) stretches of [lo, hi] outside the intervals."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [g for g in out if g[1] > g[0]]


@dataclass
class Slice:
    """What the per-layer readers read."""

    wall_s: float                 # the slice's host-clock seconds (it ends in a synchronize)
    lo: float                     # its bounds on the profiler's clock, µs
    hi: float
    device: list                  # DeviceEvent inside [lo, hi]
    host: list                    # (name, start, end) of host ops inside it
    work: list                    # per step or per image: what the flops module counts
    complete: bool = True         # no kernel row missing against the captured graphs
    missing: dict = field(default_factory=dict)  # what is missing (:func:`shortfall`)
    context: dict = field(default_factory=dict)  # config, flops module, port kernels, peak

    @property
    def own_complete(self) -> bool:
        """No row of the program's own kernels is missing (a library row may
        be): enough for a metric of those kernels alone."""
        return "own_short" not in self.missing

    def busy_us(self, kinds=("kernel", "copy", "memset")) -> float:
        return union_us([(e.start, e.end) for e in self.device if e.kind in kinds])

    def device_ms_by_family(self) -> collections.Counter:
        c = collections.Counter()
        for e in self.device:
            c[e.family] += (e.end - e.start) / 1e3
        return c

    def breakdown(self, top: int = 10) -> dict:
        ops = self.device_ms_by_family().most_common(top)
        idle = []
        for s, e in gaps([(d.start, d.end) for d in self.device], self.lo, self.hi):
            over = [(min(e, he) - max(s, hs), n) for n, hs, he in self.host if he > s and hs < e]
            idle.append(((e - s) / 1e6, max(over)[1] if over else "host idle"))
        idle.sort(reverse=True)
        return {"device_ops": [[n, ms / 1e3] for n, ms in ops],
                "idle_gaps": [[n, s] for s, n in idle[:top]]}


def shortfall(want: dict, got: dict, own=frozenset()) -> dict:
    """What a slice's kernel rows (``got``, by family) lack against the
    captured graphs' nodes (``want``): each of the program's own kernels
    (``own``, named alike in a trace row and a graph node) family by
    family, so that rows of other kernels cannot stand in for missing ones;
    the library's kernels by their count alone (a library kernel may be
    named otherwise in a graph node than in a trace row). Empty where
    nothing is missing."""
    out = {}
    short = {k: n - got.get(k, 0) for k, n in want.items() if k in own and got.get(k, 0) < n}
    if short:
        out["own_short"] = short
    lib_want = sum(n for k, n in want.items() if k not in own)
    lib_got = sum(n for k, n in got.items() if k not in own)
    if lib_got < lib_want:
        out["library"] = {"rows": lib_got, "graph_nodes": lib_want}
    return out


def profile_slice(fn, work: list, expected_kernels=None, own=frozenset(),
                  tries: int = 5, retry_s: float = 90.0) -> Slice:
    """Run ``fn()`` (which ends in a synchronize) under ``torch.profiler``
    with the host's and the device's activity → a :class:`Slice`.
    ``expected_kernels()`` gives the kernels by family that the slice must
    hold at least (a captured graph's nodes times its replays; ``own``: the
    program's kernel names, see :func:`shortfall`); a trace that misses any
    is taken again, up to ``tries`` times in all and while the tries so
    far took under ``retry_s`` seconds, and is marked incomplete if it
    still misses them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    start = time.perf_counter()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            lead = torch.zeros(1, device="cuda")
            for _ in range(LEAD_IN):
                lead.add_(1)
            torch.cuda.synchronize()
            with record_function("benchmark_slice"):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        evs = prof.events()
        mark = [e for e in evs if e.name == "benchmark_slice"][0]
        lo, hi = mark.time_range.start, mark.time_range.end
        device, host = [], []
        for e in evs:
            s, t = e.time_range.start, e.time_range.end
            if t <= lo or s >= hi or e.name == "benchmark_slice":
                continue
            if e.device_type == DeviceType.CUDA:
                device.append(DeviceEvent(e.name, max(s, lo), min(t, hi)))
            else:
                host.append((e.name, s, t))
        missing = {}
        if expected_kernels is not None:
            got = collections.Counter(d.family for d in device if d.kind == "kernel")
            missing = shortfall(expected_kernels(), got, own)
        sl = Slice(wall, lo, hi, device, host, work, not missing, missing)
        if sl.complete or time.perf_counter() - start > retry_s:
            break
    return sl
