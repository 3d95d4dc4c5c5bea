"""Which dead objects, freed by a cyclic garbage collection on the thread
that is capturing a CUDA graph, invalidate that capture?

Each case builds a dead reference cycle holding CUDA resources, starts a
``torch.cuda.graph`` capture (``thread_local``, as the resident executor
captures), runs ``gc.collect()`` inside it and reports whether the capture
ended cleanly. Cases: ``none`` (no collection), ``plain`` (device tensors),
``graph`` (an instantiated, replayed ``CUDAGraph``), ``pinned`` (a pinned
buffer that fed a non-blocking copy, and its event), ``all``.

    python3 tools/capture_gc_probe.py          # every case, one process each
    python3 tools/capture_gc_probe.py graph    # one case

Needs one CUDA device; prints one line a case.
"""

import gc
import subprocess
import sys

CASES = ("none", "plain", "graph", "pinned", "all")


class _Holder:
    pass


def _make_dead(case, dev):
    import torch

    h = _Holder()
    h.self = h  # a cycle: only the cyclic collection frees it
    x = torch.randn(1024, device=dev)
    if case in ("graph", "all"):
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            x * 2
        torch.cuda.current_stream(dev).wait_stream(side)
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(g, pool=torch.cuda.graph_pool_handle(),
                              capture_error_mode="thread_local"):
            y = x * 2 + 1
        g.instantiate()
        g.replay()
        h.g, h.y = g, y
    if case in ("pinned", "all"):
        buf = torch.empty(4096, dtype=torch.int32).pin_memory()
        d = torch.empty(4096, dtype=torch.int32, device=dev)
        d.copy_(buf, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        h.buf, h.d, h.ev = buf, d, ev
    h.x = x
    torch.cuda.synchronize()


def run_case(case: str) -> str:
    import torch

    dev = torch.device("cuda", 0)
    gc.disable()
    _make_dead(case, dev)
    x = torch.randn(1 << 20, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        (x * 3).sum()
    torch.cuda.current_stream(dev).wait_stream(side)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    try:
        with torch.cuda.graph(g, pool=torch.cuda.graph_pool_handle(),
                              capture_error_mode="thread_local"):
            a = x * 3
            n = gc.collect() if case != "none" else 0
            y = a.sum()
        g.instantiate()
        g.replay()
        torch.cuda.synchronize()
        return f"case={case} collected={n} capture ok"
    except RuntimeError as e:
        return f"case={case} capture FAILED: {str(e).splitlines()[0]}"


def main() -> int:
    if len(sys.argv) > 1:
        print(run_case(sys.argv[1]), flush=True)
        return 0
    for case in CASES:
        out = subprocess.run([sys.executable, __file__, case], capture_output=True, text=True)
        lines = out.stdout.strip().splitlines()
        print(lines[-1] if lines else f"case={case} no result (rc {out.returncode})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
