"""The port's GAN trainer (esrganplus_tpu_torch/train/gan_model.py) against
the JAX package's ``GANTrainer`` on the CPU.

Small nets (G nf=8 nb=1 gc=4, ``discriminator_vgg_96`` at base_nf=8, a
width-reduced VGG layout), one batch of two 96×96 crops from a numpy seed,
the port's state converted from the JAX trainer's (``gan_trainer_state_from_jax``,
``vgg_feat_from_jax``), noise off as in tests/test_torch_trainer.py (the two
packages draw different noise from the same seed):

The JAX trainer runs on a one-device mesh, so a batch of two is enough.

  (a) three ``srragan`` steps, each from the JAX state converted at that
      step: every logged term ≤1e-4 (relative; of max(1, |ref|) for the mean
      logits), 99.9 % of G's and of D's updated parameter entries within
      0.05·lr of the JAX trainer's, D's BN running statistics ≤1e-5. Adam
      turns the sign of a near-zero gradient into ±lr, so a max-abs bar would
      test rounding noise; the leaves whose gradient is exactly 0 (the biases
      in front of D's batch norms; the last bias under the relativistic loss)
      move by rounding noise over eps and are left out of the share. The
      port's own free run from the first state is held loosely (terms
      5e-2, no parameter bar): those ±lr flips on G's small weights move D's
      logits, which change by O(1) per step here, by percents within two
      steps;
  (b) the same through the port's kernel route (the stage twins) against its
      plain route;
  (c) gating by ``D_update_ratio`` / ``D_init_iters`` on the 1-based step, and
      ``srgan``;
  (d) lr milestones follow the global step, not Adam's update count;
  (e) ``wgan-gp`` runs on ``plain`` / ``auto`` and ``cuda`` raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrganplus_tpu.models import RRDBNetConfig as JGCfg
from esrganplus_tpu.models.discriminator import DiscriminatorVGGConfig as JDCfg
from esrganplus_tpu.models.vgg import VGGFeatConfig as JVCfg
from esrganplus_tpu.parallel import make_mesh, shard_batch
from esrganplus_tpu.train.gan_model import GANTrainConfig as JTrainCfg
from esrganplus_tpu.train.gan_model import GANTrainer as JTrainer
from esrganplus_tpu_torch.convert import gan_trainer_state_from_jax
from esrganplus_tpu_torch.models import RRDBNetConfig as PGCfg
from esrganplus_tpu_torch.models.discriminator import DiscriminatorVGGConfig as PDCfg
from esrganplus_tpu_torch.models.vgg import VGGFeatConfig as PVCfg
from esrganplus_tpu_torch.train import GANTrainConfig, GANTrainer
from esrganplus_tpu_torch.train.sr_model import tree_leaves, tree_map

NET_G = dict(nf=8, nb=1, gc=4, upscale=4, rdb_noise=False)
NET_D = dict(input_size=96, base_nf=8)
VGG = dict(feature_layer=20, layout=(8, 8, "M", 16, 16, "M", 32, 32, "M", 32, 32))
LR = 1e-4  # Adam turns the sign of a near-zero gradient into ±lr: a larger lr shows in the next logits
TERMS = ("l_g_pix", "l_g_fea", "l_g_gan", "l_g_total", "l_d_total", "D_real", "D_fake", "lr")


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.rand(2, 24, 24, 3).astype(np.float32), rs.rand(2, 96, 96, 3).astype(np.float32))


def _pair(stage_kernel="plain", **train):
    kw = dict(lr_g=LR, lr_d=LR, milestones=(2,), **train)
    jt = JTrainer(JGCfg(**NET_G), JDCfg(stage_kernel="xla", **NET_D), JTrainCfg(**kw),
                  mesh=make_mesh(devices=jax.devices()[:1]), vgg_cfg=JVCfg(stage_kernel="xla", **VGG))
    pt = GANTrainer(PGCfg(**NET_G), PDCfg(stage_kernel=stage_kernel, **NET_D),
                    GANTrainConfig(**kw), device="cpu",
                    vgg_cfg=PVCfg(stage_kernel=stage_kernel, **VGG))
    return jt, pt


def _carry(jt, pt, jstate):
    """The JAX trainer's state → the port's (parameters, both Adam states,
    step, and the perceptual net)."""
    carried = gan_trainer_state_from_jax(jax.tree.map(np.asarray, jstate), pt.net_g, pt.net_d)
    if "f_params" in carried:
        pt.f_params = carried["f_params"]
    return {"g_params": pt.ingest_params(carried["g_params"]),
            "d_params": pt.ingest_d_params(carried["d_params"]),
            "g_opt": carried["g_opt"], "d_opt": carried["d_opt"], "step": carried["step"]}


def _term_close(plogs, jlogs, where, tol=1e-4):
    assert set(plogs) == set(jlogs)
    for k in plogs:
        got, want = float(plogs[k]), float(jlogs[k])
        denom = max(1.0, abs(want)) if k.startswith("D_") else abs(want)
        assert abs(got - want) <= tol * denom, (where, k, got, want)


def _named_leaves(tree, prefix=""):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _named_leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _named_leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _zero_gradient_leaf(name, variant):
    """A bias in front of a batch norm, or the last bias under the
    relativistic pairing: the loss does not depend on it."""
    if name == "/fc1/b":
        return variant == "srragan"
    return name.startswith("/convs/") and name.endswith("/b") and name != "/convs/0/a/b"


def _share_close(ptree, jtree, steps, variant=None):
    """Share of the parameter entries within 0.05·lr·steps; for D (``variant``
    given) without the zero-gradient leaves and the BN running statistics."""
    named = _named_leaves(ptree)
    jl = jax.tree.leaves(jtree)
    assert len(named) == len(jl)
    keep = [(a, b) for (n, a), b in zip(named, jl)
            if variant is None or not (_zero_gradient_leaf(n, variant)
                                       or n.endswith(("/mean", "/var")))]
    a = np.concatenate([l.detach().numpy().ravel() for l, _ in keep])
    b = np.concatenate([np.asarray(l).ravel() for _, l in keep])
    assert a.shape == b.shape
    return np.mean(np.abs(a - b) <= 0.05 * LR * steps)


def _bn_stats_close(pd_params, jd_params):
    for pe, je in zip(pd_params["bn"], jd_params["bn"]):
        for side in ("a", "b"):
            if pe[side] is not None:
                for k in ("mean", "var"):
                    want = np.asarray(je[side][k])
                    assert np.abs(pe[side][k].detach().numpy() - want).max() \
                        <= 1e-5 * max(1.0, np.abs(want).max()), (side, k)


def _run_both(jt, pt, steps, seed=0, batch_seed=0, each_step=None):
    """``steps`` steps of both trainers from one JAX state. Each step of the
    port is made from the JAX state converted at that step and held against
    the JAX trainer's step (terms, updated parameters, running statistics);
    beside it the port runs free from the first state, held loosely (see the
    module docstring). Returns (JAX state, the free run's state, its logs)."""
    variant = pt.cfg.variant
    jstate = jt.init_state(jax.random.PRNGKey(seed))
    pstate = _carry(jt, pt, jstate)
    batch = _batch(batch_seed)
    jbatch = shard_batch(jt.mesh, tuple(jnp.asarray(a) for a in batch))
    logs = []
    for step in range(steps):
        synced = _carry(jt, pt, jstate)
        jstate, jlogs = jt.train_step(jstate, jbatch, jax.random.PRNGKey(0))
        synced, slogs = pt.train_step(synced, batch, 0)
        _term_close(slogs, jlogs, ("synced", step))
        assert _share_close(synced["g_params"], jstate["g_params"], 1) >= 0.999, step
        assert _share_close(synced["d_params"], jstate["d_params"], 1, variant) >= 0.999, step
        _bn_stats_close(synced["d_params"], jstate["d_params"])
        assert synced["step"] == int(jstate["step"])
        adam = jstate["g_opt"]
        assert synced["g_opt"]["count"] == int(adam.count)
        before = [l.detach().clone() for l in tree_leaves(pstate["g_params"])]
        pstate, plogs = pt.train_step(pstate, batch, 0)
        _term_close(plogs, jlogs, ("free", step), tol=5e-2)
        if each_step is not None:
            each_step(step + 1, before, pstate, plogs)
        logs.append({k: float(v) for k, v in plogs.items()})
    assert pstate["step"] == int(jstate["step"]) == steps
    return jstate, pstate, logs


def test_three_srragan_steps_match_jax():
    jt, pt = _pair()
    jstate, pstate, logs = _run_both(jt, pt, 3)
    assert set(logs[0]) == set(TERMS)
    # the milestone at the 1-based step 2 (the logs hold fp32 values)
    assert np.isclose(logs[0]["lr"], LR) and np.isclose(logs[2]["lr"], LR / 2)
    assert pstate["g_opt"]["count"] == pstate["d_opt"]["count"] == 3
    assert float(pstate["d_params"]["bn"][1]["a"]["mean"].abs().max()) > 0


def test_kernel_route_matches_plain_route():
    """The same three steps through the stage twins (``stage_kernel="cuda"``
    on the CPU) and the generator's kernel twins: every term within 1e-4 of
    the plain route's."""
    runs = []
    for kernel in ("plain", "cuda"):
        g = PGCfg(**NET_G, trunk_kernel=kernel, tail_kernel=kernel)
        pt = GANTrainer(g, PDCfg(stage_kernel=kernel, **NET_D),
                        GANTrainConfig(lr_g=LR, lr_d=LR), device="cpu",
                        vgg_cfg=PVCfg(stage_kernel=kernel, **VGG))
        state = pt.init_state(0)
        runs.append([{k: float(v) for k, v in pt.train_step(state, _batch(), 0)[1].items()}
                     for _ in range(3)])
    for a, b in zip(*runs):
        _term_close(b, a, "kernel vs plain")


def test_gating_by_d_update_ratio_and_d_init_iters_matches_jax():
    """D_update_ratio=2, D_init_iters=1: G updates on the 1-based steps 2 and
    4 only; the G terms of a gated step are logged as 0; ``srgan`` pairing."""
    jt, pt = _pair(variant="srgan", d_update_ratio=2, d_init_iters=1, feature_weight=0.0)

    def each_step(gstep, before, pstate, plogs):
        assert "l_g_fea" not in plogs
        moved = any(not torch.equal(a, b.detach())
                    for a, b in zip(before, tree_leaves(pstate["g_params"])))
        assert moved == (gstep % 2 == 0), gstep
        assert (float(plogs["l_g_total"]) != 0) == (gstep % 2 == 0)

    jstate, pstate, _ = _run_both(jt, pt, 4, seed=1, batch_seed=1, each_step=each_step)
    assert pstate["g_opt"]["count"] == 2 and pstate["d_opt"]["count"] == 4


def test_lr_milestones_follow_the_global_step():
    """With G gated off until step 3, its first update already runs at the
    lr past the milestone at step 2 (the schedule is driven by the global
    step, not by Adam's update count)."""
    pt = GANTrainer(PGCfg(**NET_G), PDCfg(**NET_D),
                    GANTrainConfig(lr_g=LR, lr_d=LR, milestones=(2,), d_init_iters=2,
                                   feature_weight=0.0), device="cpu")
    state = pt.init_state(0)
    for _ in range(2):
        state, logs = pt.train_step(state, _batch(), 0)
    assert state["g_opt"]["count"] == 0 and np.isclose(float(logs["lr"]), LR / 2)
    before = [l.detach().clone() for l in tree_leaves(state["g_params"])]
    state, logs = pt.train_step(state, _batch(), 0)
    step = max((a - b.detach()).abs().max().item()
               for a, b in zip(before, tree_leaves(state["g_params"])))
    # Adam's first update moves every entry by about lr: here lr/2
    assert state["g_opt"]["count"] == 1 and 0.4 * LR <= step <= 0.55 * LR


def test_wgan_gp_runs_on_plain_and_auto_and_cuda_raises():
    jt, pt = _pair(stage_kernel="auto", gan_type="wgan-gp", feature_weight=0.0)
    assert pt.net_d.stage_kernel == "plain"  # auto: D takes the plain graph
    jstate = jt.init_state(jax.random.PRNGKey(2))
    pstate = _carry(jt, pt, jstate)
    batch = _batch(2)
    state, logs = pt.train_step(pstate, batch, 0)
    assert all(np.isfinite(float(v)) for v in logs.values())
    # the penalty's interpolates come from each package's own generator, so
    # only the terms that do not contain it are held against the JAX trainer
    jstate, jlogs = jt.train_step(jstate, shard_batch(jt.mesh, tuple(jnp.asarray(a) for a in batch)),
                                  jax.random.PRNGKey(0))
    for k in ("l_g_pix", "l_g_gan", "D_real", "D_fake"):
        assert abs(float(logs[k]) - float(jlogs[k])) <= 1e-4 * max(1.0, abs(float(jlogs[k]))), k
    assert float(logs["l_d_total"]) != float(logs["D_fake"]) - float(logs["D_real"])  # + penalty
    plain = GANTrainer(PGCfg(**NET_G), PDCfg(stage_kernel="plain", **NET_D),
                       GANTrainConfig(gan_type="wgan-gp", feature_weight=0.0), device="cpu")
    plain.train_step(plain.init_state(0), batch, 0)
    with pytest.raises(ValueError, match="second-order"):
        GANTrainer(PGCfg(**NET_G), PDCfg(stage_kernel="cuda", **NET_D),
                   GANTrainConfig(gan_type="wgan-gp"), device="cpu")
    with pytest.raises(ValueError, match="second-order"):
        GANTrainer(PGCfg(**NET_G), PDCfg(stage_kernel="pallas", **NET_D),
                   GANTrainConfig(gan_type="wgan-gp"), device="cpu")


def test_bf16_step_runs_and_keeps_fp32_masters():
    pt = GANTrainer(PGCfg(**NET_G, trunk_kernel="cuda", tail_kernel="cuda"),
                    PDCfg(stage_kernel="cuda", **NET_D),
                    GANTrainConfig(compute_dtype="bfloat16"), device="cpu",
                    vgg_cfg=PVCfg(stage_kernel="cuda", **VGG))
    state = pt.init_state(0)
    for _ in range(2):
        state, logs = pt.train_step(state, _batch(), 3)
    assert all(np.isfinite(float(v)) for v in logs.values())
    for key in ("g_params", "d_params"):
        assert all(l.dtype == torch.float32 and torch.isfinite(l).all()
                   for l in tree_leaves(state[key]))
    y = pt.predict(state["g_params"], _batch()[0][:1])
    assert y.shape == (1, 96, 96, 3) and y.dtype == torch.float32


def test_two_runs_from_one_seed_agree_bit_for_bit():
    runs = []
    for _ in range(2):
        pt = GANTrainer(PGCfg(**{**NET_G, "rdb_noise": True}), PDCfg(**NET_D),
                        GANTrainConfig(feature_weight=0.0), device="cpu")
        state = pt.init_state(0)
        runs.append([{k: float(v) for k, v in pt.train_step(state, _batch(), 5)[1].items()}
                     for _ in range(3)])
    assert runs[0] == runs[1]


def test_prepared_trunk_state_is_refused_and_f_params_cross():
    jt, pt = _pair()
    jstate = jax.tree.map(np.asarray, jt.init_state(jax.random.PRNGKey(0)))
    carried = gan_trainer_state_from_jax(jstate, pt.net_g, pt.net_d)
    assert carried["f_params"]["pretrained"] is False
    assert len(carried["f_params"]["layers"]) == 19 and carried["d_opt"]["count"] == 0
    bad = dict(jstate, g_params={**jstate["g_params"], "trunk_ct": {}})
    with pytest.raises(ValueError, match="unprep_trunk_ct"):
        gan_trainer_state_from_jax(bad, pt.net_g, pt.net_d)


def test_gan_trainer_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        GANTrainer(PGCfg(**NET_G), PDCfg(**NET_D))
