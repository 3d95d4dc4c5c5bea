"""The port's inference front end (esrganplus_tpu_torch/infer.py and
cli/test_image.py) against the JAX package's, on the CPU, with the golden
×4 reference checkpoint."""

import os

import cv2
import numpy as np
import pytest
import torch

from esrganplus_tpu import infer as jinfer
from esrganplus_tpu.cli import test_image as jcli
from esrganplus_tpu_torch import infer as pinfer
from esrganplus_tpu_torch.cli import test_image as pcli
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CKPT = os.path.join(GOLDEN, "rrdb_small_x4.pth")


@pytest.fixture(scope="module")
def pair():
    jp, jcfg, _ = jinfer.load_generator(CKPT)
    pp, pcfg, _ = pinfer.load_generator(CKPT, device="cpu")
    return jinfer.SRInferencer(jp, jcfg), pinfer.SRInferencer(pp, pcfg, device="cpu")


def _img(h, w, seed=0):
    return np.random.RandomState(seed).rand(h, w, 3).astype(np.float32)


@pytest.mark.parametrize("pad_multiple", [None, 8])
def test_upscale_matches_jax(pair, pad_multiple):
    j, p = pair
    j.pad_multiple = p.pad_multiple = pad_multiple
    try:
        img = _img(9, 13)
        want, got = j.upscale(img), p.upscale(img)
        assert got.shape == want.shape == (36, 52, 3)
        assert np.abs(got - want).max() < 1e-5
        batch = np.stack([img, _img(9, 13, seed=1)])
        assert np.abs(p.upscale(batch) - j.upscale(batch)).max() < 1e-5
    finally:
        j.pad_multiple = p.pad_multiple = None


@pytest.mark.parametrize("batched", [True, False])
def test_upscale_x8_matches_jax(pair, batched):
    j, p = pair
    img = _img(9, 7, seed=2)
    want, got = j.upscale_x8(img, batched=batched), p.upscale_x8(img, batched=batched)
    assert got.shape == want.shape == (36, 28, 3)
    assert np.abs(got - want).max() < 1e-5


def test_upscale_tiled_matches_jax(pair):
    j, p = pair
    assert p.derive_halo() == j.derive_halo()
    img = _img(40, 29, seed=3)
    want = j.upscale_tiled(img, tile=24, tile_batch=4)
    got = p.upscale_tiled(img, tile=24, tile_batch=4)
    assert got.shape == want.shape == (160, 116, 3)
    assert np.abs(got - want).max() < 1e-5


def test_upscale_bgr_to_png_matches_jax(pair):
    j, p = pair
    img = _img(11, 10, seed=4)
    diff = np.abs(p.upscale_bgr_to_png(img).astype(int) - j.upscale_bgr_to_png(img).astype(int))
    assert diff.max() <= 1


def test_entry_points_need_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    pp, pcfg, _ = pinfer.load_generator(CKPT, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        pinfer.SRInferencer(pp, pcfg)
    with pytest.raises(RuntimeError, match="cuda"):
        pinfer.load_generator(CKPT)
    with pytest.raises(RuntimeError, match="cuda"):
        pcli.main([CKPT, "--input", GOLDEN, "--output", "unused"])


def _jax_noise(rng, nb, shape):
    """The tensors JAX's train-mode forward draws: ``split(rng, nb)`` →
    ``split(key, 4)`` → ``normal(ks[i], (B, H, W, nf))`` (models/rrdb.py)."""
    import jax

    return [[np.asarray(jax.random.normal(k, shape, np.float32))
             for k in jax.random.split(bk, 4)] for bk in jax.random.split(rng, nb)]


def test_noise_mode_is_not_ported_yet(tmp_path):
    """The Tarsier mode (was: refused as not ported; the name is kept).
    ``noise_rng`` given: with JAX's noise realisation fed in, the port's
    output meets the JAX package's ≤1e-5; with its own seeded draw it is
    deterministic, differs from the noise-free output, and the CLI's
    ``--noise-seed`` runs."""
    import jax

    jp, jcfg, _ = jinfer.load_generator(CKPT)
    pp, pcfg, _ = pinfer.load_generator(CKPT, device="cpu")
    key = jax.random.PRNGKey(11)
    img = _img(9, 13, seed=6)
    want = jinfer.SRInferencer(jp, jcfg, noise_rng=key).upscale(img)
    p = pinfer.SRInferencer(pp, pcfg, noise_rng=3, device="cpu")
    assert p.noise_active
    noise = [[None if (n is None or (i == 3 and not pcfg.rrdb_noise)
                       or (i < 3 and not pcfg.rdb_noise)) else torch.from_numpy(n)
              for i, n in enumerate(sites)]
             for sites in _jax_noise(key, pcfg.nb, (1, 9, 13, pcfg.nf))]
    got = p.upscale(img, noise=noise)
    assert got.shape == want.shape == (36, 52, 3)
    assert np.abs(got - want).max() < 1e-5
    own = p.upscale(img)
    assert np.array_equal(own, p.upscale(img))  # the seed fixes the realisation
    quiet = pinfer.SRInferencer(pp, pcfg, device="cpu").upscale(img)
    assert np.abs(own - quiet).max() > 1e-4
    lr = str(tmp_path / "LR")
    _write_pngs(lr)
    pcli.main([CKPT, "--input", lr, "--output", str(tmp_path / "out"), "--noise-seed", "3",
               "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "out")) == ["a_rlt.png", "b_rlt.png"]


def test_noise_mode_upscale_x8_is_per_variant():
    """In the noise mode the batched self-ensemble is the per-variant one, bit
    for bit (a batch would change the noise shapes each variant sees), as in
    the JAX package."""
    pp, pcfg, _ = pinfer.load_generator(CKPT, device="cpu")
    p = pinfer.SRInferencer(pp, pcfg, noise_rng=3, device="cpu")
    img = _img(9, 7, seed=2)
    assert np.array_equal(p.upscale_x8(img, batched=True), p.upscale_x8(img, batched=False))


def test_noise_mode_runs_a_fused_noise_config():
    """A ``noise_kernel="fused"`` config in the noise mode applies the noise
    between kernel calls (threefry, as JAX's inferencer key) and gives the
    image of the same config with ``noise_kernel="xla"``."""
    import dataclasses

    pp, pcfg, _ = pinfer.load_generator(CKPT, device="cpu")
    img = _img(9, 13, seed=6)
    out = {kind: pinfer.SRInferencer(pp, dataclasses.replace(pcfg, noise_kernel=kind),
                                     noise_rng=3, device="cpu").upscale(img)
           for kind in ("fused", "xla")}
    assert out["fused"].shape == (36, 52, 3)
    assert np.array_equal(out["fused"], out["xla"])


def _write_pngs(d):
    os.makedirs(d)
    rs = np.random.RandomState(5)
    for name, (h, w) in {"a": (12, 9), "b": (8, 14)}.items():
        cv2.imwrite(os.path.join(d, name + ".png"), (rs.rand(h, w, 3) * 255).astype(np.uint8))


def test_cli_pngs_match_jax_cli(tmp_path):
    lr = str(tmp_path / "LR")
    _write_pngs(lr)
    jcli.main([CKPT, "--input", lr, "--output", str(tmp_path / "jax")])
    pcli.main([CKPT, "--input", lr, "--output", str(tmp_path / "port"), "--device", "cpu"])
    for name, (h, w) in {"a": (12, 9), "b": (8, 14)}.items():
        want = cv2.imread(str(tmp_path / "jax" / f"{name}_rlt.png")).astype(int)
        got = cv2.imread(str(tmp_path / "port" / f"{name}_rlt.png")).astype(int)
        assert got.shape == want.shape == (4 * h, 4 * w, 3)
        assert np.abs(got - want).max() <= 1


def test_activation_dump_and_compare_roundtrip(tmp_path):
    lr = str(tmp_path / "LR")
    _write_pngs(lr)
    jdump, pdump = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jcli.main([CKPT, "--input", lr, "--output", str(tmp_path / "j"),
               "--dump-activations", jdump])
    pcli.main([CKPT, "--input", lr, "--output", str(tmp_path / "p"), "--device", "cpu",
               "--dump-activations", pdump])
    for ref in (pdump, jdump):  # against itself, and against the JAX package's dump
        with pytest.raises(SystemExit) as e:
            pcli.main([CKPT, "--input", lr, "--output", str(tmp_path / "p"), "--device",
                       "cpu", "--dump-activations", str(tmp_path / "again.json"),
                       "--compare-activations", ref])
        assert e.value.code == 0
    # a perturbed reference is reported as diverging
    import json

    with open(pdump) as f:
        bad = json.load(f)
    bad["images"]["a"]["rrdb_01"]["rms"] *= 1.01
    with open(pdump, "w") as f:
        json.dump(bad, f)
    with pytest.raises(SystemExit) as e:
        pcli.main([CKPT, "--input", lr, "--output", str(tmp_path / "p"), "--device", "cpu",
                   "--dump-activations", str(tmp_path / "again.json"),
                   "--compare-activations", pdump])
    assert e.value.code == 1
