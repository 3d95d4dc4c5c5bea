"""The port's checkpoint conversion (esrganplus_tpu_torch/convert) against the
golden reference checkpoints and the JAX package's converter, and the port's
import boundary (no JAX, no esrganplus_tpu)."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from esrganplus_tpu import convert as jconv
from esrganplus_tpu.models import rrdb as jrrdb
from esrganplus_tpu_torch.convert import (
    from_jax_params,
    generator_from_state_dict,
    infer_rrdbnet_config,
    load_state_dict,
    rrdbnet_from_state_dict,
    rrdbnet_to_state_dict,
)
from esrganplus_tpu_torch.models.rrdb import RRDBNetConfig, prep_trunk_ct, rrdbnet_forward

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = ["rrdb_small_x4", "rrdb_small_x2", "rrdb_small_x4_vanilla"]


def _golden(name):
    sd = load_state_dict(os.path.join(GOLDEN, name + ".pth"))
    io = np.load(os.path.join(GOLDEN, name + "_io.npz"))
    return sd, io["x"].transpose(0, 2, 3, 1), io["y"].transpose(0, 2, 3, 1)


@pytest.mark.parametrize("path", ["plain", "cuda"])
@pytest.mark.parametrize("name", GOLDENS)
def test_golden_checkpoint_output(name, path):
    """The reference torch output at the JAX suite's bar (tests/test_rrdb.py:
    1e-5), through the plain graph and through the kernel path's chain."""
    sd, x, y = _golden(name)
    cfg = None
    if name.endswith("vanilla"):  # the ESRGAN+ graph with the missing 1×1s zeroed
        cfg = RRDBNetConfig(nf=32, nb=3, gc=32, upscale=4, conv1x1=True)
    params, cfg, info = rrdbnet_from_state_dict(sd, cfg)
    cfg = dataclasses.replace(cfg, trunk_kernel=path, tail_kernel=path)
    assert len(info["missing_conv1x1_blocks"]) == (9 if name.endswith("vanilla") else 0)
    if path == "cuda":
        params = prep_trunk_ct(params, cfg, torch.float32)
    got = rrdbnet_forward(params, torch.from_numpy(np.ascontiguousarray(x)), cfg).numpy()
    assert got.shape == y.shape
    assert np.abs(got - y).max() < 1e-5


@pytest.mark.parametrize("name", GOLDENS)
def test_infer_config_agrees_with_jax(name):
    sd = load_state_dict(os.path.join(GOLDEN, name + ".pth"))
    want = jconv.infer_rrdbnet_config(jconv.load_state_dict(os.path.join(GOLDEN, name + ".pth")))
    got = infer_rrdbnet_config(sd)
    for f in ("in_nc", "out_nc", "nf", "nb", "gc", "upscale", "conv1x1"):
        assert getattr(got, f) == getattr(want, f), f


def test_missing_conv1x1_error_mode():
    sd, _, _ = _golden("rrdb_small_x4_vanilla")
    cfg = RRDBNetConfig(nf=32, nb=3, gc=32, upscale=4, conv1x1=True)
    with pytest.raises(ValueError):
        rrdbnet_from_state_dict(sd, cfg, missing_conv1x1="error")


def test_one_upconv_checkpoint_reads_as_x2_and_takes_explicit_x3():
    """A ×2 and a ×3 net both have one upconv: the keys say ×2; an explicit
    ×3 config is accepted, a config with another stage count is not."""
    sd, _, _ = _golden("rrdb_small_x2")
    assert infer_rrdbnet_config(sd).upscale == 2
    base = infer_rrdbnet_config(sd)
    _, cfg3, _ = rrdbnet_from_state_dict(sd, dataclasses.replace(base, upscale=3))
    assert cfg3.upscale == 3
    with pytest.raises(ValueError):
        rrdbnet_from_state_dict(sd, dataclasses.replace(base, upscale=4))


def test_state_dict_roundtrip_matches_reference_keys():
    sd, _, _ = _golden("rrdb_small_x4")
    params, cfg, _ = rrdbnet_from_state_dict(sd)
    sd2 = rrdbnet_to_state_dict(params, cfg)
    assert set(sd2) == set(sd)
    for k in sd:
        assert torch.equal(sd2[k], sd[k].float()), k


@pytest.mark.parametrize("conv1x1", [True, False])
def test_from_jax_params_roundtrip(conv1x1):
    """JAX params → the port → the reference state dict equals the JAX
    converter's export exactly, and loads back to the same params."""
    jcfg = jrrdb.RRDBNetConfig(nf=16, nb=2, gc=8, upscale=4, conv1x1=conv1x1)
    jp = jrrdb.init_rrdbnet(jax.random.PRNGKey(3), jcfg)
    pcfg = RRDBNetConfig(nf=16, nb=2, gc=8, upscale=4, conv1x1=conv1x1)
    pp = from_jax_params(jax.tree.map(np.asarray, jp), pcfg)
    want = jconv.rrdbnet_to_state_dict(jp, jcfg)
    got = rrdbnet_to_state_dict(pp, pcfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    back, _, _ = rrdbnet_from_state_dict(got, pcfg)
    np.testing.assert_array_equal(back["trunk"]["rdb2"]["conv3"]["w"].numpy(),
                                  np.asarray(jp["trunk"]["rdb2"]["conv3"]["w"]))


def test_from_jax_params_rejects_mismatched_config():
    jp = jrrdb.init_rrdbnet(jax.random.PRNGKey(0), jrrdb.RRDBNetConfig(nf=16, nb=2, gc=8))
    with pytest.raises(ValueError):
        from_jax_params(jax.tree.map(np.asarray, jp), RRDBNetConfig(nf=16, nb=3, gc=8))


def test_unported_generators_are_refused():
    """No generator family is refused any more: SRResNet checkpoints load
    (tests/test_torch_srresnet.py holds them against the reference) and so
    do SFT_Net ones, recognised by their ``sft_branch.`` keys
    (tests/test_torch_sft.py holds them against the JAX package)."""
    from esrganplus_tpu_torch.models.sft import SFTNetConfig, init_sftnet, sftnet_to_state_dict

    sd = load_state_dict(os.path.join(GOLDEN, "srresnet_small_x4.pth"))
    _, cfg, _ = generator_from_state_dict(sd)
    assert type(cfg).__name__ == "SRResNetConfig"
    small = SFTNetConfig(nb=1, nf=8, cond_nf=4)
    sft_sd = sftnet_to_state_dict(init_sftnet(small), small)
    _, cfg, info = generator_from_state_dict(sft_sd, SFTNetConfig(nf=8, cond_nf=4))
    assert cfg == small and info == {}


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, and chip_smoke.py, imports without pulling
    in ``jax`` or ``esrganplus_tpu``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import esrganplus_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "assert len(mods) >= 12, mods\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'esrganplus_tpu' or m.startswith('esrganplus_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
