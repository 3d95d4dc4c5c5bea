"""What the harness and the reference load: no module whose top-level name
is ``jax``, ``jaxlib``, ``flax`` or ``esrganplus_tpu`` (compared whole), and
the reference nothing of the program (``esrganplus_tpu_torch``)."""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HERE)


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=300, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _modules(sub: str) -> list:
    """The dotted names of every module under ``sub``, its folders too."""
    paths = glob.glob(os.path.join(HERE, sub, "**", "*.py"), recursive=True)
    return sorted(os.path.splitext(os.path.relpath(p, HERE))[0].replace(os.sep, ".")
                  for p in paths)


def test_reference_loads_nothing_of_the_program():
    mods = _modules("reference")
    assert "reference.nets.rrdbnet" in mods and "reference.steps_sr" in mods
    top = _loaded(f"import sys, json; sys.path[:0] = [{HERE!r}]; import {', '.join(mods)}; "
                  "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not top & {"jax", "jaxlib", "flax", "esrganplus_tpu", "esrganplus_tpu_torch"}
    for path in glob.glob(os.path.join(HERE, "reference", "**", "*.py"), recursive=True):
        assert "esrganplus_tpu" not in open(path).read(), path


def test_harness_and_drivers_load_no_jax():
    code = (f"import sys, json; sys.path[:0] = [{HERE!r}, {REPO!r}]; "
            "from core import harness, trace, counting, data, weights; "
            "cell = harness.Cell('esrganplus_x4.gan_train'); cell.driver(); cell.flops(); "
            "cell.readers(); harness.Cell('esrganplus_x4.div2k_sr').driver(); "
            "harness.Cell('sftgan_x4.gan_train').flops(); "
            "[cell.trainer(m) for m in ('sr', 'srragan', 'sftgan')]; "
            "import esrganplus_tpu_torch.train, esrganplus_tpu_torch.infer, "
            "esrganplus_tpu_torch.data.resident, esrganplus_tpu_torch.cli.train; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    top = _loaded(code)
    assert "esrganplus_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "esrganplus_tpu"}


def test_forbidden_names_are_compared_whole():
    sys.path[:0] = [HERE]
    from core import harness

    before = dict(sys.modules)
    try:
        sys.modules["esrganplus_tpu_torch_fake.x"] = object()
        sys.modules["jaxlibrary"] = object()
        assert harness.forbidden_modules() == sorted(
            {m.split(".")[0] for m in before} & set(harness.FORBIDDEN))
        sys.modules["jax.numpy"] = object()
        assert "jax" in harness.forbidden_modules()
    finally:
        for k in ("esrganplus_tpu_torch_fake.x", "jaxlibrary", "jax.numpy"):
            if k not in before:
                sys.modules.pop(k, None)
