"""What the program's own spans say about a traced slice: the device time
of each phase of its replayed training steps, and the device's idle time
under each of its front end's spans.

The spans are ``torch.profiler`` host rows on the clock of the device rows
(the program's ``utils/trace.span`` and ``phase``). A replay of a captured
step runs no host code, so its phases come from the program's record of
what each captured graph launches, phase by phase (``utils/trace
.phase_lists``), matched against the slice's kernel rows
(``utils/trace.phase_times``). A program without these (no span, no such
function) gives None, as does a slice with a row missing.
"""

from __future__ import annotations

import collections

from core import trace

REPLAY = "exec.replay:"  # the program's mark of a replay's launch, the graph's id after it
OUTSIDE = "outside"  # idle under none of the spans read


def replays(s) -> list:
    """The graph ids of the slice's replays, in order."""
    return [n[len(REPLAY):] for n, _, _ in sorted(s.host, key=lambda h: h[1])
            if n.startswith(REPLAY)]


def phase_lists():
    """{graph id: [(phase, kernel family)]} of the program's captured steps,
    or None where the program keeps no such record."""
    try:
        from esrganplus_tpu_torch.utils.trace import phase_lists as lists
    except ImportError:
        return None
    return lists()


def phase_times(s):
    """{phase: {"ms", "kernels", "idle_ms"}} over the slice's replays (the
    program's ``utils/trace.phase_times``), or None: an incomplete slice, no
    replay span, no such function, or rows that do not match."""
    if not s.complete or not replays(s):
        return None
    if "phase_times" not in s.context:
        try:
            from esrganplus_tpu_torch.utils.trace import phase_times as times
        except ImportError:
            times = None
        rows = [(e.family, e.start, e.end) for e in s.device if e.kind == "kernel"]
        s.context["phase_times"] = times and times(rows, s.host,
                                                   own=s.context.get("port_kernels"))
    return s.context["phase_times"]


def phase_ms(s, phases) -> float:
    """Device ms a step in ``phases`` (None as :func:`phase_times`)."""
    t = phase_times(s)
    if t is None:
        return None
    return sum(t[p]["ms"] for p in phases if p in t) / len(s.work)


def idle_by_span(s, prefix: str):
    """{span: device-idle µs of the slice while it is the innermost open span
    whose name starts with ``prefix``; OUTSIDE: under none}, or None where no
    such span is in the slice. Sums to the slice's idle time."""
    spans = [(n, a, b) for n, a, b in s.host if n.startswith(prefix)]
    if not spans:
        return None
    cuts = sorted({t for _, a, b in spans for t in (a, b)})
    out = collections.Counter()
    for a, b in trace.gaps([(d.start, d.end) for d in s.device], s.lo, s.hi):
        pts = [a] + [t for t in cuts if a < t < b] + [b]
        for x, y in zip(pts, pts[1:]):
            mid = (x + y) / 2
            inner = max(((sa, n) for n, sa, sb in spans if sa <= mid < sb), default=None)
            out[inner[1] if inner else OUTSIDE] += y - x
    return out
