"""What every run shares: finding a cell's files by name, the device
checks, the modules that must stay out of the process, and the result.

A cell of ``BENCHMARK.json`` joins a configuration (``configs/<name>.json``),
a traffic mix (``traffic/<name>.json``, whose ``kind`` names the driver
``drivers/<kind>.py``) and the per-layer metrics that list it (each a
reader ``metrics/<name>.py``); the FLOP and byte counts of a configuration
are ``flops/<config>.py``. A recipe's ``model`` names its trainer's
bindings ``trainers/<model>.py`` and its reference steps
``reference/steps_<model>.py``; a configuration's ``weights`` entry names
its network ``reference/nets/<net>.py``. Nothing here names a cell, a
configuration, a trainer, a network or a metric.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # benchmark/
REPO = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "esrganplus_tpu")  # top-level module names


class Unsupported(RuntimeError):
    """The machine cannot run the cell (no card, too few cards)."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module of the benchmark's own, loaded from its file (its name may
    hold dots, as a metric's does)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``BENCHMARK.json``'s ``workloads`` with its files."""

    def __init__(self, name: str, bench_path: str = None):
        bench_path = bench_path or os.path.join(REPO, "BENCHMARK.json")
        bench = load_json(bench_path)
        # the cell's files lie beside BENCHMARK.json, under this folder's name
        self.root = os.path.join(os.path.dirname(os.path.abspath(bench_path)),
                                 os.path.basename(HERE))
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.entry = found[0]
        self.name = name
        cfg = next(c for c in bench["configs"] if c["name"] == self.entry["config"])
        self.config_name = cfg["name"]
        self.config = load_json(os.path.join(os.path.dirname(self.root), cfg["file"]))
        self.traffic_name = self.entry["traffic"]
        self.traffic = load_json(os.path.join(self.root, "traffic", f"{self.traffic_name}.json"))
        self.chips = int(self.entry["chips"])
        listed = lambda m: "workloads" not in m or name in m["workloads"]
        self.end_to_end = [m for m in bench["end_to_end"] if listed(m)]
        self.per_layer = [m for m in bench["per_layer"] if listed(m)]

    def limits(self) -> dict:
        """The limits of the numbers this cell's runs compare
        (``limits/<cell>.json``)."""
        return load_json(os.path.join(self.root, "limits", f"{self.name}.json"))

    def driver(self):
        kind = self.traffic["kind"]
        return load_module(os.path.join(self.root, "drivers", f"{kind}.py"), f"driver_{kind}")

    def flops(self):
        return load_module(os.path.join(self.root, "flops", f"{self.config_name}.py"),
                           f"flops_{self.config_name}")

    def trainer(self, model: str):
        """The program's trainer of recipe kind ``model`` (``trainers/``)."""
        return load_module(os.path.join(self.root, "trainers", f"{model}.py"), f"trainer_{model}")

    def steps(self, model: str):
        """The reference's training steps of recipe kind ``model``."""
        return load_module(os.path.join(self.root, "reference", f"steps_{model}.py"),
                           f"reference_steps_{model}")

    def network(self, net: str):
        """The reference network ``net`` (``reference/nets/``): its weight
        tree ``spec`` and its forward."""
        from reference import layers

        return layers.net(net, os.path.join(self.root, "reference"))

    def readers(self) -> dict:
        """{metric name: its reader module} of the cell's per-layer metrics."""
        return {m["name"]: load_module(os.path.join(self.root, "metrics", f"{m['name']}.py"),
                                       "metric_" + m["name"].replace(".", "_"))
                for m in self.per_layer}


def derive_seeds(seed: int, names) -> dict:
    """{name: a seed of its own} for the parts of a run, from ``--seed``."""
    return {name: (int(seed) * 0x9E3779B1 + (k + 1) * 0x632BE5AB) % (2 ** 62)
            for k, name in enumerate(names)}


def build_kernels() -> bool:
    """The port's kernels, built into the checkout's ``build/`` where
    missing or older than their sources (all at once; a later run finds
    them) → whether anything was compiled."""
    from esrganplus_tpu_torch.kernels import build

    return bool(build.build([n for n in build.SOURCES if not n.startswith("workbench")]))


class Phases:
    """The seconds of each phase of set-up, from the top of ``run.py``."""

    def __init__(self, t0: float):
        self.t0 = self.t = t0
        self.seconds = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.t
        self.t = now

    def total(self) -> float:
        return self.t - self.t0

    def report(self) -> None:
        print(f"setup {self.total():.2f} s: " + ", ".join(f"{k} {v:.2f}" for k, v in
                                                           self.seconds.items()),
              file=sys.stderr)


def require_devices(n: int):
    """The cell's cards, or :class:`Unsupported`."""
    import torch

    if not torch.cuda.is_available():
        raise Unsupported("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < n:
        raise Unsupported(f"{torch.cuda.device_count()} CUDA devices, the cell asks for {n}")


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is one that must not run
    here (compared whole: ``esrganplus_tpu_torch`` is not ``esrganplus_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def metric(value: float, unit: str) -> dict:
    return {"value": value, "unit": unit}


def emit_result(result: dict, checks: list) -> None:
    """The checks (each name, value, limit) as the last lines of standard
    error and under ``checks``, the last key of the result's line, which
    is the last line of standard output."""
    result = dict(result)
    result["checks"] = [{"name": n, "value": v, "limit": lim} for n, v, lim in checks]
    for n, v, lim in checks:
        print(f"check {n}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
