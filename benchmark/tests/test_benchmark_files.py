"""A configuration, a traffic mix, a per-layer metric, a cell, a trainer and
a network dropped in as new files run with no edit to any file already
there."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys

import pytest

sys.path[:0] = [os.path.dirname(os.path.abspath(__file__))]

import tiny  # noqa: E402
from core import harness, trace  # noqa: E402

METRIC = '''"""A metric added as a file: device ms of the slice's copies."""

from core import trace

LAYER = "Front end"
UNIT = "ms"
MOVES = "sr_mpix_per_s"


def read(s):
    return sum(e.end - e.start for e in s.device if trace.kind_of(e.name) == "copy") / 1e3
'''


def _digest(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        if "__pycache__" in d:
            continue
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_new_cell_config_mix_and_metric_are_files_only(tmp_path):
    before = _digest(tiny.HERE)
    bench = tiny.make_tree(str(tmp_path))
    copied = _digest(os.path.join(tmp_path, os.path.basename(tiny.HERE)))
    assert all(copied[k] == v for k, v in before.items())  # nothing there was edited
    root = os.path.join(tmp_path, os.path.basename(tiny.HERE))
    with open(os.path.join(root, "metrics", "copy_ms.tiny.py"), "w") as f:
        f.write(METRIC)
    b = json.load(open(bench))
    b["per_layer"].append({"name": "copy_ms.tiny", "unit": "ms", "better": "lower",
                           "source": "device_trace", "layer": "Front end",
                           "moves": "sr_mpix_per_s", "workloads": ["tiny.tiny_sr"]})
    json.dump(b, open(bench, "w"))

    res = tiny.run(bench, "tiny.tiny_sr")
    assert res["correct"] and res["attempted"] > 0
    cell = harness.Cell("tiny.tiny_sr", bench)
    readers = cell.readers()
    assert set(readers) == {"copy_ms.tiny"}  # the others list the full cells
    sl = trace.Slice(0.01, 0, 1000, [trace.DeviceEvent("Memcpy HtoD", 0, 250)], [],
                     [{"h": 12, "w": 16}])
    assert readers["copy_ms.tiny"].read(sl) == 0.25
    res = tiny.run(bench, "tiny.psnr_train")
    assert res["correct"] and res["attempted"] > 0
    assert _digest(tiny.HERE) == before


DROPIN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dropin")


def _drop_in(tmp_path) -> str:
    """The small tree with an SRGAN configuration added as new files: its
    trainer kind (``trainers/srgan.py``), its network
    (``reference/nets/srresnet.py``), its reference steps, its
    configuration and its cell's limits; → the tree's BENCHMARK.json."""
    bench = tiny.make_tree(str(tmp_path))
    root = os.path.join(tmp_path, os.path.basename(tiny.HERE))
    for d, _, files in os.walk(DROPIN):
        for f in files:
            if f.endswith(".pyc"):
                continue
            dst = os.path.join(root, os.path.relpath(os.path.join(d, f), DROPIN))
            assert not os.path.exists(dst), dst  # new files only
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copy(os.path.join(d, f), dst)
    b = json.load(open(bench))
    b["configs"].append({"name": "tiny_srgan", "source": "benchmark/tests/dropin",
                         "file": f"{os.path.basename(tiny.HERE)}/configs/tiny_srgan.json",
                         "reduced": ["network_G"], "why": "CPU tests"})
    b["workloads"].append({"name": "tiny_srgan.gan_train", "config": "tiny_srgan",
                           "traffic": "gan_train", "chips": 1, "why": "tests"})
    json.dump(b, open(bench, "w"))
    return bench


def _state_unchanged(monkeypatch):
    import esrganplus_tpu_torch.train.gan_model as gm

    monkeypatch.setattr(gm, "apply_updates", lambda params, updates, lr: None)


@pytest.mark.parametrize("fault", [None, _state_unchanged])
def test_new_trainer_and_network_are_files_only(tmp_path, monkeypatch, fault):
    before = _digest(tiny.HERE)
    bench = _drop_in(tmp_path)
    cell = harness.Cell("tiny_srgan.gan_train", bench)
    assert cell.trainer("srgan").GROUPS and cell.network("srresnet").spec(nf=8, nb=1)
    if fault:
        fault(monkeypatch)
    res = tiny.run(bench, "tiny_srgan.gan_train")
    assert res["attempted"] > 0
    assert res["correct"] is (fault is None), res["checks"]
    assert _digest(tiny.HERE) == before


def test_metric_files_match_benchmark_json():
    bench = harness.load_json(os.path.join(tiny.REPO, "BENCHMARK.json"))
    for m in bench["per_layer"]:
        mod = harness.load_module(os.path.join(tiny.HERE, "metrics", f"{m['name']}.py"), "m")
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == (m["layer"], m["unit"], m["moves"])
    for w in bench["workloads"]:
        cell = harness.Cell(w["name"])
        assert cell.limits() and cell.driver() and cell.traffic["kind"] in ("train", "infer")
