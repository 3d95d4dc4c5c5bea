"""Run one cell of the port's benchmark on the machine it starts on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It sets the cell up from the seed (the kernels built into the checkout's
``build/`` on a first run), measures for ``--seconds`` seconds, checks what
the timed path produced against the plain reference, and prints one JSON
line last: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
and, traced, ``breakdown``; the numbers compared, each with its limit, come
last there and on standard error. It exits with another code than 0, and
prints no result, without the cards the cell asks for, or when a JAX
module was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:0] = [HERE, REPO]
# the program's build caches stay inside the checkout, at fixed paths
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(REPO, "build", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(REPO, "build", "triton"))

from core import harness  # noqa: E402


def context(cell, sl) -> dict:
    """What the per-layer readers need beside the trace."""
    from esrganplus_tpu_torch.kernels.build import kernel_names

    if cell.traffic["kind"] == "train":
        dtype = cell.config["recipes"][cell.traffic["recipe"]]["train"].get("compute_dtype")
    else:
        dtype = cell.config["infer"]["compute_dtype"]
    dtype = dtype or "float32"
    if dtype == "float32" and any("tf32" in e.name.lower() for e in sl.device):
        dtype = "tf32"  # cuDNN ran some of the fp32 work on the tensor cores
    return {"config": cell.config, "traffic": cell.traffic, "flops": cell.flops(),
            "dtype": dtype, "port_kernels": kernel_names()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    phases = harness.Phases(T0)
    cell = harness.Cell(args.workload)
    try:
        harness.require_devices(cell.chips)
    except harness.Unsupported as e:
        print(f"cannot run {cell.name}: {e}", file=sys.stderr)
        return 2
    import torch

    phases.mark("torch")  # the interpreter's imports, torch's, the device count
    res = cell.driver().run(cell, args, phases)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules that must not load here were loaded: {bad}", file=sys.stderr)
        return 3
    print(f"module check: none of {list(harness.FORBIDDEN)} loaded", flush=True)

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    # seconds of set-up spent compiling the kernels (0 where a run found
    # them built): part of setup_s, as in any run that compiles
    out = {"correct": bool(res["correct"]), "attempted": res["attempted"],
           "failed": res["failed"], "build_s": res["build_s"]}
    if args.trace:
        sl = res["slice"]
        sl.context = context(cell, sl)
        units = {m["name"]: m["unit"] for m in cell.per_layer}
        metrics = {}
        for name, reader in cell.readers().items():
            v = reader.read(sl)
            if v is not None:
                metrics[name] = harness.metric(v, units[name])
        if not sl.complete:
            print(f"trace rows missing against the captured graphs: {sl.missing}",
                  file=sys.stderr)
        device["busy_s"] = sl.busy_us() / 1e6
        device["window_s"] = (sl.hi - sl.lo) / 1e6
        out["metrics"] = metrics
        out["device"] = device
        out["breakdown"] = sl.breakdown()
    else:
        names = {m["name"] for m in cell.end_to_end}
        out["metrics"] = {k: v for k, v in res["metrics"].items() if k in names}
        out["device"] = device
    harness.emit_result(out, res["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
