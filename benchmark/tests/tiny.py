"""A copy of the benchmark with small cells of its own, for the CPU tests:
the ESRGAN+ configuration cut to nf 8, nb 1, gc 4 on batches of 2 crops of
96², its two training recipes and a ×4 inference on two small shapes, each
cell held to the limits of the full cell it stands for."""

from __future__ import annotations

import copy
import json
import os
import shutil
import sys
import time
import types

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HERE)
sys.path[:0] = [HERE, REPO]

from core import harness  # noqa: E402

STANDS_FOR = {"tiny.psnr_train": "esrganplus_x4.psnr_train",
              "tiny.gan_train": "esrganplus_x4.gan_train",
              "tiny.tiny_sr": "esrganplus_x4.div2k_sr"}


def make_tree(root: str) -> str:
    """Copy the benchmark under ``root`` with the small cells added as new
    files; → the copy's BENCHMARK.json."""
    dst = os.path.join(root, os.path.basename(HERE))
    shutil.copytree(HERE, dst, ignore=shutil.ignore_patterns("__pycache__"))
    c = copy.deepcopy(harness.load_json(os.path.join(HERE, "configs", "esrganplus_x4.json")))
    c["name"] = "tiny"
    for r in c["recipes"].values():
        r["network_G"].update(nf=8, nb=1, gc=4)
        r["datasets"]["train"].update(batch_size=2, HR_size=96, resident_crops=16)
        r["train"].pop("compute_dtype", None)
    c["recipes"]["gan"]["network_D"].update(which_model_D="discriminator_vgg_96", nf=8)
    for k in ("g", "g_finetune"):
        c["weights"][k]["args"] = {"nf": 8, "nb": 1, "gc": 4}
    c["weights"]["d"]["args"] = {"input_size": 96, "base_nf": 8}
    c["infer"]["compute_dtype"] = "float32"
    c["data"] = {"sources": 8, "tile": 128}
    with open(os.path.join(dst, "configs", "tiny.json"), "w") as f:
        json.dump(c, f)
    with open(os.path.join(dst, "traffic", "tiny_sr.json"), "w") as f:
        json.dump({"kind": "infer", "shapes": [[12, 16], [16, 12]], "check_images": 2,
                   "check_from": 4, "trace_images": 2}, f)
    bench = harness.load_json(os.path.join(REPO, "BENCHMARK.json"))
    bench["configs"].append({"name": "tiny", "source": "benchmark/tests/tiny.py",
                             "file": f"{os.path.basename(HERE)}/configs/tiny.json",
                             "reduced": ["network_G"], "why": "CPU tests"})
    for name, full in STANDS_FOR.items():
        bench["workloads"].append({"name": name, "config": "tiny",
                                   "traffic": name.split(".", 1)[1], "chips": 1, "why": "tests"})
        shutil.copy(os.path.join(HERE, "limits", f"{full}.json"),
                    os.path.join(dst, "limits", f"{name}.json"))
    path = os.path.join(root, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f)
    return path


def run(bench_path: str, name: str, seconds: float = 0.5, seed: int = 2 ** 31 + 7) -> dict:
    """A run of a small cell on the CPU, the look for a card skipped."""
    cell = harness.Cell(name, bench_path)
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=0)
    return cell.driver().run(cell, args, harness.Phases(time.perf_counter()), device="cpu")
