"""Resuming the port's trainers from a ``.state.npz`` the JAX package's
trainer wrote (``train/checkpoint.py::load_state_auto``), three kinds of file:

  (a) a canonical JAX ``SRTrainer`` state;
  (b) the same state with the generator masters and both Adam moments in the
      JAX trainers' prepared-trunk layout (``trunk_ct``); the file is written
      by JAX's own conversion (``_toggle_g_repr``, what its ``load_state_auto``
      applies), since a prepared trainer's step in interpret mode costs tens
      of seconds here, and its tree is checked against a prepared trainer's;
  (c) a JAX ``GANTrainer`` state that carries ``f_params``, the frozen VGG19,
      which the port holds on the trainer.

Each is saved after one JAX step (so the moments are not zero), read by the
port, and one port step is held against one JAX step from that state: each
logged term within 1e-5 of its value, every updated parameter (and Adam
moment) leaf within 1e-5 of its tree's max|ref| (in D, the biases the loss
does not reach aside). A
mismatched config still raises the plain restore's error.
"""

import json

import jax
import numpy as np
import pytest

from esrganplus_tpu.models import RRDBNetConfig as JCfg
from esrganplus_tpu.parallel import make_mesh, shard_batch
from esrganplus_tpu.train import SRTrainConfig as JTrainCfg
from esrganplus_tpu.train import SRTrainer as JTrainer
from esrganplus_tpu.train import checkpoint as jckpt
from esrganplus_tpu_torch.models import RRDBNetConfig as PCfg
from esrganplus_tpu_torch.train import SRTrainConfig, SRTrainer
from esrganplus_tpu_torch.train.checkpoint import load_state_auto
from esrganplus_tpu_torch.train.sr_model import tree_leaves

NET = dict(nf=8, nb=1, gc=4, upscale=4, rdb_noise=False)
TOL = 1e-5  # of max|ref|


def _batch(n=2, size=8, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, size, size, 3).astype(np.float32),
            rs.rand(n, 4 * size, 4 * size, 3).astype(np.float32))


def _close(got, want, where):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= TOL * scale, (where, np.abs(got - want).max(), scale)


def _names(tree, prefix=""):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in _names(v, f"{prefix}/{i}")]
    return [prefix]


def _leaves_close(ptree, jtree, where, skip=()):
    """Every leaf (but those indexed in ``skip``) within TOL of the whole
    tree's max|ref|: a bias that started at zero holds a few Adam steps of
    ±lr, whose last digits follow the rounding of g/(√v + eps)."""
    pl, jl = tree_leaves(ptree), jax.tree.leaves(jtree)
    assert len(pl) == len(jl)
    scale = max(float(np.abs(np.asarray(b)).max()) for b in jl)
    for i, (a, b) in enumerate(zip(pl, jl)):
        if i in skip:
            continue
        err = np.abs(a.detach().numpy().astype(np.float64) - np.asarray(b, np.float64)).max()
        assert err <= TOL * scale, (f"{where} leaf {i}", err, scale)


@pytest.fixture(scope="module")
def sr_run(tmp_path_factory):
    """The JAX SR trainer one step in, its state saved canonically and in
    the prepared layout, and the JAX step that follows."""
    d = tmp_path_factory.mktemp("resume")
    mesh = make_mesh(devices=jax.devices()[:1])
    kw = dict(lr=1e-3, milestones=(5,), init_scale=0.5, prep_trunk=False)
    jt = JTrainer(JCfg(**NET), JTrainCfg(**kw), mesh=mesh)
    state, _ = jt.train_step(jt.init_state(jax.random.PRNGKey(0)),
                             shard_batch(mesh, _batch(seed=1)), jax.random.PRNGKey(0))
    canon, prepped = str(d / "1.state.npz"), str(d / "prep_1.state.npz")
    jckpt.save_state(canon, state)
    jckpt.save_state(prepped, jckpt._toggle_g_repr(state, JCfg(**NET)))
    nxt, logs = jt.train_step(state, shard_batch(mesh, _batch(seed=2)), jax.random.PRNGKey(1))
    return {"canonical": canon, "prepared": prepped,
            "next": jax.tree.map(np.asarray, nxt), "logs": jax.tree.map(np.asarray, logs)}


@pytest.mark.parametrize("kind", ["canonical", "prepared"])
def test_sr_state_resumes_and_steps_as_jax(sr_run, kind):
    pt = SRTrainer(PCfg(**NET), SRTrainConfig(lr=1e-3, milestones=(5,)), device="cpu")
    state = load_state_auto(sr_run[kind], pt.init_state(7), pt.net_cfg)
    assert state["step"] == 1 and state["opt_state"]["count"] == 1
    assert all(p.requires_grad and p.is_leaf for p in tree_leaves(state["params"]))
    state, logs = pt.train_step(state, _batch(seed=2), 1)
    for k in ("l_pix", "grad_norm", "lr"):
        _close(float(logs[k]), float(sr_run["logs"][k]), k)
    _leaves_close(state["params"], sr_run["next"]["params"], "params")
    _leaves_close(state["opt_state"]["mu"], sr_run["next"]["opt_state"].mu, "mu")
    _leaves_close(state["opt_state"]["nu"], sr_run["next"]["opt_state"].nu, "nu")


def test_prepared_file_has_a_prepared_trainers_tree(sr_run):
    jt = JTrainer(JCfg(trunk_kernel="pallas", **NET), JTrainCfg(prep_trunk=True),
                  mesh=make_mesh(devices=jax.devices()[:1]))
    with np.load(sr_run["prepared"]) as data:
        saved = json.loads(str(data["__meta__"]))["treedef"]
    assert "trunk_ct" in saved
    assert saved == str(jax.tree_util.tree_structure(jt.init_state(jax.random.PRNGKey(0))))


def test_mismatched_config_raises_the_plain_error(sr_run):
    pt = SRTrainer(PCfg(**{**NET, "nf": 16}), SRTrainConfig(), device="cpu")
    with pytest.raises(ValueError, match="leaves but template has"):
        load_state_auto(sr_run["prepared"], pt.init_state(0), pt.net_cfg)
    with pytest.raises(ValueError, match="shape"):
        load_state_auto(sr_run["canonical"], pt.init_state(0), pt.net_cfg)


def test_gan_state_with_f_params_resumes_and_steps_as_jax(tmp_path):
    from esrganplus_tpu.models.discriminator import DiscriminatorVGGConfig as JDCfg
    from esrganplus_tpu.models.vgg import VGGFeatConfig as JVCfg
    from esrganplus_tpu.train.gan_model import GANTrainConfig as JGanCfg
    from esrganplus_tpu.train.gan_model import GANTrainer as JGan
    from esrganplus_tpu_torch.convert import vgg_feat_from_jax
    from esrganplus_tpu_torch.models.discriminator import DiscriminatorVGGConfig as PDCfg
    from esrganplus_tpu_torch.models.vgg import VGGFeatConfig as PVCfg
    from esrganplus_tpu_torch.train import GANTrainConfig, GANTrainer

    vgg = dict(feature_layer=20, layout=(8, 8, "M", 16, 16, "M", 32, 32, "M", 32, 32))
    kw = dict(lr_g=1e-4, lr_d=1e-4, milestones=(5,), init_scale_g=0.5)
    mesh = make_mesh(devices=jax.devices()[:1])
    jt = JGan(JCfg(**NET), JDCfg(input_size=96, base_nf=8, stage_kernel="xla"), JGanCfg(**kw),
              mesh=mesh, vgg_cfg=JVCfg(stage_kernel="xla", **vgg))
    batch = _batch(size=24)
    state, _ = jt.train_step(jt.init_state(jax.random.PRNGKey(0)), shard_batch(mesh, batch),
                             jax.random.PRNGKey(0))
    assert "f_params" in state
    path = str(tmp_path / "1.state.npz")
    jckpt.save_state(path, state)
    f_params = jax.tree.map(np.asarray, state["f_params"])
    nxt, jlogs = jt.train_step(state, shard_batch(mesh, batch), jax.random.PRNGKey(1))  # donates

    pt = GANTrainer(PCfg(**NET), PDCfg(input_size=96, base_nf=8, stage_kernel="plain"),
                    GANTrainConfig(**kw), device="cpu", vgg_cfg=PVCfg(stage_kernel="plain", **vgg))
    pt.f_params = vgg_feat_from_jax(f_params)
    pstate = load_state_auto(path, pt.init_state(3), pt.net_g)
    assert "f_params" not in pstate and pstate["step"] == 1
    pstate, plogs = pt.train_step(pstate, batch, 1)
    assert set(plogs) == set(jlogs)
    for k in plogs:
        _close(float(plogs[k]), float(jlogs[k]), k)
    _leaves_close(pstate["g_params"], nxt["g_params"], "G")
    # the conv biases in front of D's batch norms and, under the relativistic
    # loss, the last bias get no gradient, and move by Adam's rounding noise
    # over eps (tests/test_torch_gan_trainer.py); every other D leaf is held
    names = _names(pstate["d_params"])
    dead = {i for i, n in enumerate(names) if n == "/fc1/b" or (
        n.startswith("/convs/") and n.endswith("/b") and n != "/convs/0/a/b")}
    assert len(dead) == 2 * 5
    _leaves_close(pstate["d_params"], nxt["d_params"], "D", skip=dead)
