"""The port's SRResNet (esrganplus_tpu_torch/models/srresnet.py and what
dispatches to it) against the JAX package's on the CPU:

  (a) the golden ``srresnet_small_x4`` through the port within 1e-5 of the
      reference output (the JAX test's bar);
  (b) ``srresnet_forward`` on the same numpy params at ×2, ×3 and ×4: fp32
      within 1e-5, bf16 within 2e-2 of max(1, max|ref|);
  (c) the state-dict round trip, keys and values equal to JAX's export;
  (d) the options build equals JAX's, field by field;
  (e) three ``SRTrainer`` steps with ``pixel_criterion: l2`` and one
      ``srgan`` step with an SRResNet G, each from the JAX state converted at
      that step: every logged term and every updated parameter leaf within
      1e-5 of max|ref|;
  (f) ``cli.test_image`` on a tiny SRResNet ``.pth`` writes the PNG JAX's
      inferencer gives; the halo derived from the weights and the
      halo-tiled upscale equal JAX's.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrganplus_tpu import infer as jinfer
from esrganplus_tpu.convert import pth as jpth
from esrganplus_tpu.models import srresnet as jsr
from esrganplus_tpu.options import options as jopt
from esrganplus_tpu_torch import infer as pinfer
from esrganplus_tpu_torch.cli import test_image as pcli
from esrganplus_tpu_torch.convert import (gan_trainer_state_from_jax, generator_from_state_dict,
                                          generator_to_state_dict, load_state_dict,
                                          srresnet_from_jax, trainer_state_from_jax)
from esrganplus_tpu_torch.models import SRResNetConfig, generator_forward
from esrganplus_tpu_torch.options import options as popt
from esrganplus_tpu_torch.train.sr_model import tree_leaves

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
OPTDIR = os.path.join(os.path.dirname(__file__), "..", "esrganplus_tpu", "options")
NET = dict(nf=8, nb=2)
FP32_TOL = 1e-5
BF16_TOL = 2e-2  # of max(1, max|ref|), the bf16 bar of ROADMAP.md


def _nhwc(x):
    return np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1)))


def _jparams(scale, seed=0, init_scale=0.5):
    cfg = jsr.SRResNetConfig(upscale=scale, **NET)
    return cfg, jax.tree.map(np.asarray, jsr.init_srresnet(jax.random.PRNGKey(seed), cfg,
                                                           init_scale=init_scale))


@pytest.fixture(scope="module")
def jax_forwards():
    """{scale: (numpy params, input, {dtype name: JAX output})}."""
    out = {}
    x = np.random.RandomState(1).rand(2, 9, 11, 3).astype(np.float32)
    for scale in (2, 3, 4):
        cfg, p = _jparams(scale)
        ys = {d: np.asarray(jsr.srresnet_forward(p, jnp.asarray(x), cfg, dtype=dt))
              for d, dt in (("float32", None), ("bfloat16", jnp.bfloat16))}
        out[scale] = (p, x, ys)
    return out


def test_golden_srresnet_through_the_port():
    params, cfg, info = generator_from_state_dict(
        load_state_dict(os.path.join(GOLDEN, "srresnet_small_x4.pth")))
    assert isinstance(cfg, SRResNetConfig) and info == {"missing_conv1x1_blocks": []}
    assert (cfg.nb, cfg.nf, cfg.upscale) == (2, 16, 4)
    io = np.load(os.path.join(GOLDEN, "srresnet_small_x4_io.npz"))
    y = generator_forward(params, torch.from_numpy(_nhwc(io["x"])), cfg).numpy()
    want = _nhwc(io["y"])
    assert y.shape == want.shape
    assert np.abs(y - want).max() < FP32_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [2, 3, 4])
def test_forward_matches_jax(jax_forwards, scale, dtype):
    p, x, ys = jax_forwards[scale]
    cfg = SRResNetConfig(upscale=scale, **NET)
    got = generator_forward(srresnet_from_jax(p, cfg), torch.from_numpy(x), cfg,
                            dtype=torch.bfloat16 if dtype == "bfloat16" else None).numpy()
    want = ys[dtype]
    assert got.shape == want.shape == (2, 9 * scale, 11 * scale, 3)
    err = np.abs(got - want).max()
    if dtype == "float32":
        assert err <= FP32_TOL * max(1.0, np.abs(want).max()), err
    else:
        assert err <= BF16_TOL * max(1.0, np.abs(want).max()), err


def test_state_dict_round_trip_matches_jax_export():
    for scale in (3, 4):
        jcfg, p = _jparams(scale)
        cfg = SRResNetConfig(upscale=scale, **NET)
        want = jpth.generator_to_state_dict(p, jcfg)
        got = generator_to_state_dict(srresnet_from_jax(p, cfg), cfg)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
        back, bcfg, _ = generator_from_state_dict(got)
        assert bcfg == cfg  # ×3 read back from the 9·nf upconv
        for a, b in zip(tree_leaves(back), tree_leaves(srresnet_from_jax(p, cfg))):
            assert torch.equal(a, b)
    sd = load_state_dict(os.path.join(GOLDEN, "srresnet_small_x4.pth"))
    params, cfg, _ = generator_from_state_dict(sd)
    sd2 = generator_to_state_dict(params, cfg)
    assert set(sd2) == set(sd)
    for k in sd:  # the reference's model.5/8/10 tail indices at ×4
        assert torch.equal(sd2[k], sd[k]), k


def test_options_build_matches_jax(tmp_path):
    for name in ("train/train_SRResNet.json", "test/test_SRResNet.json"):
        src = json.loads(jopt._strip_comments(open(os.path.join(OPTDIR, name)).read()))
        src["path"]["root"] = str(tmp_path)
        path = tmp_path / "o.json"
        path.write_text(json.dumps(src))
        is_train = name.startswith("train/")
        got = popt.build_net_g_config(popt.parse(str(path), is_train=is_train))
        want = jopt.build_net_g_config(jopt.parse(str(path), is_train=is_train))
        assert isinstance(got, SRResNetConfig)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _rel_close(got, want, where):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= FP32_TOL * scale, (where, np.abs(got - want).max(), scale)


def _leaves_close(ptree, jtree, where):
    jl = jax.tree.leaves(jtree)
    pl = tree_leaves(ptree)
    assert len(pl) == len(jl)
    for i, (a, b) in enumerate(zip(pl, jl)):
        _rel_close(a.detach().numpy(), np.asarray(b), f"{where} leaf {i}")


def test_sr_trainer_l2_steps_match_jax():
    from esrganplus_tpu.parallel import make_mesh, shard_batch
    from esrganplus_tpu.train import SRTrainConfig as JTrainCfg
    from esrganplus_tpu.train import SRTrainer as JTrainer
    from esrganplus_tpu_torch.train import SRTrainConfig, SRTrainer

    kw = dict(lr=1e-3, milestones=(2,), pixel_criterion="l2", init_scale=0.5)
    mesh = make_mesh(devices=jax.devices()[:1])
    jt = JTrainer(jsr.SRResNetConfig(**NET), JTrainCfg(**kw), mesh=mesh)
    pt = SRTrainer(SRResNetConfig(**NET), SRTrainConfig(**kw), device="cpu")
    rs = np.random.RandomState(0)
    batch = (rs.rand(4, 8, 8, 3).astype(np.float32), rs.rand(4, 32, 32, 3).astype(np.float32))
    jstate = jt.init_state(jax.random.PRNGKey(0))
    for i in range(3):
        carried = trainer_state_from_jax(jax.tree.map(np.asarray, jstate), pt.net_cfg)
        pstate = {"params": pt.ingest_params(carried["params"]),
                  "opt_state": carried["opt_state"], "step": carried["step"]}
        jstate, jlogs = jt.train_step(jstate, shard_batch(mesh, batch), jax.random.PRNGKey(i))
        pstate, plogs = pt.train_step(pstate, batch, i)
        for k in ("l_pix", "grad_norm", "lr"):
            _rel_close(float(plogs[k]), float(jlogs[k]), f"step {i} {k}")
        _leaves_close(pstate["params"], jstate["params"], f"step {i} params")
    assert pstate["step"] == int(jstate["step"]) == 3


def test_srgan_step_with_srresnet_g_matches_jax():
    from esrganplus_tpu.models.discriminator import DiscriminatorVGGConfig as JDCfg
    from esrganplus_tpu.models.vgg import VGGFeatConfig as JVCfg
    from esrganplus_tpu.parallel import make_mesh, shard_batch
    from esrganplus_tpu.train.gan_model import GANTrainConfig as JTrainCfg
    from esrganplus_tpu.train.gan_model import GANTrainer as JTrainer
    from esrganplus_tpu_torch.models.discriminator import DiscriminatorVGGConfig as PDCfg
    from esrganplus_tpu_torch.models.vgg import VGGFeatConfig as PVCfg
    from esrganplus_tpu_torch.train import GANTrainConfig, GANTrainer

    vgg = dict(feature_layer=20, layout=(8, 8, "M", 16, 16, "M", 32, 32, "M", 32, 32))
    kw = dict(variant="srgan", lr_g=1e-4, lr_d=1e-4, milestones=(2,), init_scale_g=0.5)
    mesh = make_mesh(devices=jax.devices()[:1])
    jt = JTrainer(jsr.SRResNetConfig(**NET), JDCfg(input_size=96, base_nf=8, stage_kernel="xla"),
                  JTrainCfg(**kw), mesh=mesh, vgg_cfg=JVCfg(stage_kernel="xla", **vgg))
    pt = GANTrainer(SRResNetConfig(**NET), PDCfg(input_size=96, base_nf=8, stage_kernel="plain"),
                    GANTrainConfig(**kw), device="cpu",
                    vgg_cfg=PVCfg(stage_kernel="plain", **vgg))
    rs = np.random.RandomState(0)
    batch = (rs.rand(2, 24, 24, 3).astype(np.float32), rs.rand(2, 96, 96, 3).astype(np.float32))
    jstate = jt.init_state(jax.random.PRNGKey(0))
    carried = gan_trainer_state_from_jax(jax.tree.map(np.asarray, jstate), pt.net_g, pt.net_d)
    pt.f_params = carried["f_params"]
    pstate = {"g_params": pt.ingest_params(carried["g_params"]),
              "d_params": pt.ingest_d_params(carried["d_params"]),
              "g_opt": carried["g_opt"], "d_opt": carried["d_opt"], "step": carried["step"]}
    jstate, jlogs = jt.train_step(jstate, shard_batch(mesh, batch), jax.random.PRNGKey(0))
    pstate, plogs = pt.train_step(pstate, batch, 0)
    assert set(plogs) == set(jlogs)
    for k in plogs:
        _rel_close(float(plogs[k]), float(jlogs[k]), k)
    _leaves_close(pstate["g_params"], jstate["g_params"], "G")


def test_cli_test_image_matches_jax(tmp_path):
    jcfg, p = _jparams(4, seed=3, init_scale=0.3)
    model = str(tmp_path / "srresnet.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                jpth.generator_to_state_dict(p, jcfg).items()}, model)
    lr_dir, out_dir = tmp_path / "LR", tmp_path / "out"
    os.makedirs(lr_dir)
    from esrganplus_tpu_torch.ops.image_io import read_img, save_img

    img = (np.random.RandomState(2).rand(12, 10, 3) * 255).astype(np.uint8)
    save_img(img, str(lr_dir / "a.png"))
    pcli.main([model, "--input", str(lr_dir), "--output", str(out_dir), "--device", "cpu"])
    got = read_img(str(out_dir / "a_rlt.png"))
    jparams, jc, _ = jinfer.load_generator(model)
    want = jinfer.SRInferencer(jparams, jc).upscale_bgr_to_png(read_img(str(lr_dir / "a.png")))
    assert got.shape == (48, 40, 3)
    np.testing.assert_array_equal((got * 255).round().astype(np.uint8), want)


def test_tiled_upscale_and_halo_match_jax(jax_forwards):
    """SRInferencer on an SRResNet: the halo derived from the weights and the
    halo-tiled result equal JAX's."""
    p, _, _ = jax_forwards[2]
    jcfg = jsr.SRResNetConfig(upscale=2, **NET)
    pinf = pinfer.SRInferencer(srresnet_from_jax(p, SRResNetConfig(upscale=2, **NET)),
                               SRResNetConfig(upscale=2, **NET), device="cpu")
    jinf = jinfer.SRInferencer(p, jcfg)
    assert pinf.derive_halo(probe=24) == jinf.derive_halo(probe=24)
    img = np.random.RandomState(4).rand(30, 26, 3).astype(np.float32)
    got = pinf.upscale_tiled(img, tile=16, halo=4, tile_batch=4)
    want = jinf.upscale_tiled(img, tile=16, halo=4, tile_batch=4)
    assert got.shape == want.shape == (60, 52, 3)
    assert np.abs(got - want).max() <= FP32_TOL
