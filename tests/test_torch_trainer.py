"""The port's PSNR trainer (esrganplus_tpu_torch/train) against the JAX
package's ``SRTrainer`` and optax.

  (a) the optimizer alone: identical numpy gradients through
      ``make_optimizer`` of both packages for 6 steps across a milestone, with
      weight decay and clip; parameters ≤1e-6;
  (b) ``SRTrainer``, three steps, noise off, same batch and init: ``l_pix``
      and ``grad_norm`` of each step ≤1e-4 relative, and 99.9 % of the
      parameter entries within 0.05·lr·steps. Adam turns a sign flip of a
      near-zero gradient into ±lr, so a max-abs bar would test rounding
      noise;
  (c) the loss falls over 20 steps on one batch;
  (d) bf16 compute runs and stays finite;
  (e) a JAX trainer state converted mid-run (``trainer_state_from_jax``),
      then one more step in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from esrganplus_tpu.models import RRDBNetConfig as JCfg
from esrganplus_tpu.parallel import make_mesh, shard_batch
from esrganplus_tpu.train import SRTrainConfig as JTrainCfg
from esrganplus_tpu.train import SRTrainer as JTrainer
from esrganplus_tpu.train import make_optimizer as j_make_optimizer
from esrganplus_tpu_torch.convert import from_jax_params, trainer_state_from_jax
from esrganplus_tpu_torch.models import RRDBNetConfig as PCfg
from esrganplus_tpu_torch.train import SRTrainConfig, SRTrainer, make_optimizer, multistep_lr
from esrganplus_tpu_torch.train.sr_model import tree_leaves, tree_map

NET = dict(nf=16, nb=2, gc=8, upscale=4)
LR = 1e-3


def _batch(n=8, size=8, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, size, size, 3).astype(np.float32),
            rs.rand(n, 4 * size, 4 * size, 3).astype(np.float32))


def test_multistep_lr_matches_jax():
    from esrganplus_tpu.train.schedule import multistep_lr as jsched

    a, b = multistep_lr(1e-4, [10, 20], 0.5), jsched(1e-4, [10, 20], 0.5)
    for step in (0, 9, 10, 19, 20, 25):
        np.testing.assert_allclose(a(step), float(b(step)), rtol=1e-6)


def test_optimizer_alone_matches_optax():
    kw = dict(lr=LR, milestones=(3, 5), lr_gamma=0.5, weight_decay=1e-2, grad_clip=0.5)
    jtx, jsched = j_make_optimizer(JTrainCfg(**kw))
    ptx, psched = make_optimizer(SRTrainConfig(**kw))
    rs = np.random.RandomState(0)
    shapes = {"a": "3 3 4 5", "b": {"c": "7", "d": "2 6"}}
    init = lambda: tree_map(lambda s: rs.randn(*map(int, s.split())).astype(np.float32),
                            shapes)
    p0 = init()
    jp = jax.tree.map(jnp.asarray, p0)
    pp = tree_map(torch.from_numpy, tree_map(np.copy, p0))
    jstate, pstate = jtx.init(jp), ptx.init(pp)
    for step in range(1, 7):
        g = init()
        ju, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, jax.tree.map(lambda u: -jsched(step) * u, ju))
        pu, pstate = ptx.update(tree_map(torch.from_numpy, g), pstate, pp)
        tree_map(lambda p, u: p.add_(u, alpha=-psched(step)), pp, pu)
        np.testing.assert_allclose(psched(step), float(jsched(step)), rtol=1e-6)
    for a, b in zip(tree_leaves(pp), jax.tree.leaves(jp)):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-6
    assert pstate["count"] == 6


def _trainers(compute_dtype=None, **net_kw):
    kw = dict(lr=LR, milestones=(2,), compute_dtype=compute_dtype)
    jt = JTrainer(JCfg(**NET, **net_kw), JTrainCfg(**kw), mesh=make_mesh())
    pt = SRTrainer(PCfg(**NET, **net_kw), SRTrainConfig(**kw), device="cpu")
    return jt, pt


def _rel(a, b):
    return abs(a - b) / abs(b)


def _params_close(pstate, jstate, steps):
    a = np.concatenate([l.detach().numpy().ravel() for l in tree_leaves(pstate["params"])])
    b = np.concatenate([np.asarray(l).ravel() for l in jax.tree.leaves(jstate["params"])])
    assert a.shape == b.shape
    return np.mean(np.abs(a - b) <= 0.05 * LR * steps)


def test_trainer_three_steps_match_jax():
    jt, pt = _trainers(rdb_noise=False)
    jstate = jt.init_state(jax.random.PRNGKey(0))
    pstate = pt.init_state(0)
    pstate["params"] = pt.ingest_params(
        from_jax_params(jax.tree.map(np.asarray, jstate["params"]), pt.net_cfg))
    batch = _batch()
    jbatch = shard_batch(jt.mesh, tuple(jnp.asarray(a) for a in batch))
    for step in range(3):
        jstate, jlogs = jt.train_step(jstate, jbatch, jax.random.PRNGKey(0))
        pstate, plogs = pt.train_step(pstate, batch, 0)
        for k in ("l_pix", "grad_norm", "lr"):
            assert _rel(float(plogs[k]), float(jlogs[k])) <= 1e-4, (step, k)
    assert pstate["step"] == int(jstate["step"]) == 3
    assert _params_close(pstate, jstate, 3) >= 0.999


def test_trainer_loss_falls_on_one_batch():
    _, pt = _trainers()
    state = pt.init_state(0)
    batch = _batch()
    losses = []
    for _ in range(20):
        state, logs = pt.train_step(state, batch, 7)
        losses.append(float(logs["l_pix"]))
    assert state["step"] == 20 and np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_trainer_noise_follows_seed_and_step():
    """The noise of step k depends on (seed, k) alone, so a resumed run draws
    what an uninterrupted one would; another seed draws other noise."""
    _, pt = _trainers()
    batch = _batch()
    run = lambda seed, steps: [float(pt.train_step(s, batch, seed)[1]["l_pix"])
                               for s in [pt.init_state(0)] for _ in range(steps)]
    a, b, c = run(1, 3), run(1, 3), run(2, 3)
    assert a == b and a != c


@pytest.mark.parametrize("kernels", ["plain", "cuda"])
def test_trainer_bf16_runs_and_stays_finite(kernels):
    pt = SRTrainer(PCfg(**NET, trunk_kernel=kernels, tail_kernel=kernels),
                   SRTrainConfig(lr=LR, compute_dtype="bfloat16"), device="cpu")
    state = pt.init_state(0)
    for _ in range(2):
        state, logs = pt.train_step(state, _batch(n=2), 0)
    assert all(np.isfinite(float(v)) for v in logs.values())
    assert all(l.dtype == torch.float32 and torch.isfinite(l).all()
               for l in tree_leaves(state["params"]))
    y = pt.predict(state["params"], _batch(n=1)[0])
    assert y.shape == (1, 32, 32, 3) and y.dtype == torch.float32


def test_jax_trainer_state_converted_mid_run():
    jt, pt = _trainers(rdb_noise=False)
    jstate = jt.init_state(jax.random.PRNGKey(1))
    batch = _batch(seed=3)
    jbatch = shard_batch(jt.mesh, tuple(jnp.asarray(a) for a in batch))
    for _ in range(2):
        jstate, _ = jt.train_step(jstate, jbatch, jax.random.PRNGKey(0))
    carried = trainer_state_from_jax(jax.tree.map(np.asarray, jstate), pt.net_cfg)
    assert carried["step"] == 2 and carried["opt_state"]["count"] == 2
    pstate = {"params": pt.ingest_params(carried["params"]), "step": carried["step"],
              "opt_state": carried["opt_state"]}
    jstate, jlogs = jt.train_step(jstate, jbatch, jax.random.PRNGKey(0))
    pstate, plogs = pt.train_step(pstate, batch, 0)
    for k in ("l_pix", "grad_norm", "lr"):
        assert _rel(float(plogs[k]), float(jlogs[k])) <= 1e-4, k
    assert _params_close(pstate, jstate, 1) >= 0.999


def test_prepared_trunk_state_is_refused():
    jt = JTrainer(JCfg(**NET, trunk_kernel="pallas"), JTrainCfg(prep_trunk=True),
                  mesh=make_mesh())
    jstate = jax.tree.map(np.asarray, jt.init_state(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="unprep_trunk_ct"):
        trainer_state_from_jax(jstate, PCfg(**NET))


def test_trainer_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        SRTrainer(PCfg(**NET))
