"""The port's GAN stack (esrganplus_tpu_torch/models/{discriminator,vgg}.py,
losses.py, the discriminator converters) against the JAX package on the CPU.

Parameters come from the JAX package's seeded init (BN statistics and affine
terms randomised with numpy so that they matter) and cross through
``discriminator_from_jax`` / ``vgg_feat_from_jax``; inputs come from numpy
seeds. Tolerances: the plain graphs ≤1e-5 of the output's magnitude in fp32;
the kernel early stages (the port's twins on the CPU, the JAX package's
Pallas kernels in interpret mode under ``stage_kernel="pallas"``) ≤1e-4,
gradients included, of each gradient's magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrganplus_tpu import losses as jloss
from esrganplus_tpu.convert import pth as jpth
from esrganplus_tpu.models import discriminator as jd
from esrganplus_tpu.models import vgg as jv
from esrganplus_tpu_torch import losses as ploss
from esrganplus_tpu_torch.convert import (discriminator_from_jax,
                                          discriminator_from_state_dict,
                                          discriminator_sn_from_state_dict,
                                          discriminator_sn_to_state_dict,
                                          discriminator_to_state_dict, vgg_feat_from_jax)
from esrganplus_tpu_torch.models import discriminator as pd
from esrganplus_tpu_torch.models import vgg as pv
from esrganplus_tpu_torch.train.sr_model import tree_leaves

NF = 8
SMALL_VGG = (8, 8, "M", 16, 16, "M", 32, 32, 32, 32, "M", 32, 32, 32, 32, "M", 32, 32, 32, 32, "M")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _d_pair(size=96, seed=0, **kw):
    """(JAX cfg, JAX params, port cfg, port params) of one discriminator."""
    jcfg = jd.DiscriminatorVGGConfig(input_size=size, base_nf=NF, **kw)
    jp = jd.init_discriminator(jax.random.PRNGKey(seed), jcfg)
    rs = np.random.RandomState(seed)
    if jcfg.use_bn:
        for entry in jp["bn"]:
            for side in ("a", "b"):
                if entry[side] is not None:
                    c = entry[side]["scale"].shape[0]
                    entry[side] = {"scale": jnp.asarray(1 + 0.2 * rs.randn(c), jnp.float32),
                                   "bias": jnp.asarray(0.1 * rs.randn(c), jnp.float32),
                                   "mean": jnp.asarray(0.1 * rs.randn(c), jnp.float32),
                                   "var": jnp.asarray(0.5 + rs.rand(c), jnp.float32)}
    kernel = kw.get("stage_kernel", "auto")
    pcfg = pd.DiscriminatorVGGConfig(input_size=size, base_nf=NF, **kw)
    assert pcfg.stage_kernel == {"pallas": "cuda", "xla": "plain"}.get(kernel, kernel)
    return jcfg, jp, pcfg, discriminator_from_jax(_np_tree(jp), pcfg)


def _x(size, seed=1, b=2):
    return np.random.RandomState(seed).rand(b, size, size, 3).astype(np.float32)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("size", [96, 128, 192])
def test_discriminator_eval_matches_jax(size):
    jcfg, jp, pcfg, pp = _d_pair(size)
    x = _x(size)
    want, _ = jd.discriminator_forward(jp, jnp.asarray(x), jcfg, train=False)
    got, _ = pd.discriminator_forward(pp, torch.from_numpy(x), pcfg, train=False)
    assert got.shape == (2, 1) and got.dtype == torch.float32
    _close(got, want, 1e-5)


@pytest.mark.parametrize("size", [96, 128, 192])
def test_discriminator_train_mode_and_running_stats_match_jax(size):
    jcfg, jp, pcfg, pp = _d_pair(size)
    x1, x2 = _x(size, 1), _x(size, 2)
    (jw1, js1), (jw2, js2) = (jd.discriminator_forward(jp, jnp.asarray(x), jcfg, train=True)
                              for x in (x1, x2))
    (pw1, ps1), (pw2, ps2) = (pd.discriminator_forward(pp, torch.from_numpy(x), pcfg, train=True)
                              for x in (x1, x2))
    _close(pw1, jw1, 1e-5)
    _close(pw2, jw2, 1e-5)
    for fold_j, fold_p in (
            (jd.apply_state_updates(jp, js1, jcfg), pd.apply_state_updates(pp, ps1, pcfg)),
            (jd.merge_sequential_bn(jp, js1, js2, jcfg),
             pd.merge_sequential_bn(pp, ps1, ps2, pcfg))):
        leaves_j, leaves_p = jax.tree.leaves(fold_j), tree_leaves(fold_p)
        assert len(leaves_j) == len(leaves_p)
        for a, b in zip(leaves_p, leaves_j):
            _close(a.detach(), b, 1e-5)
    # the running statistics moved, and the merge is the sequential update
    m = 0.9
    old = pp["bn"][1]["a"]["mean"]
    seq = m * (m * old + (1 - m) * ((ps1["bn"][1]["a"]["mean"] - m * old) / (1 - m))) \
        + (ps2["bn"][1]["a"]["mean"] - m * old)
    merged = pd.merge_sequential_bn(pp, ps1, ps2, pcfg)["bn"][1]["a"]["mean"]
    assert (merged - old).abs().max() > 1e-3 and torch.allclose(merged, seq, atol=1e-6)


def _d_loss_and_grads_jax(jcfg, jp, x):
    def loss(p, x_):
        logits, _ = jd.discriminator_forward(p, x_, jcfg, train=True)
        return jnp.sum(jnp.sin(logits))
    val, (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    return float(val), jax.tree.leaves(gp), np.asarray(gx)


def _d_loss_and_grads_port(pcfg, pp, x):
    leaves = [l.requires_grad_() for l in tree_leaves(pp)]
    xt = torch.from_numpy(x).requires_grad_()
    logits, _ = pd.discriminator_forward(pp, xt, pcfg, train=True)
    val = torch.sin(logits).sum()
    grads = torch.autograd.grad(val, leaves + [xt], allow_unused=True)
    return val.item(), grads[:-1], grads[-1].numpy()


def _grads_close(got, want, tol, flips=False):
    """Every gradient leaf within ``tol`` of its own magnitude, or of 5 % of
    the largest gradient for leaves whose true gradient is 0 (a bias in front
    of a batch norm: every graph computes ~1e-6 of cancellation noise there).
    ``flips``: an lrelu gate that flips at a near-zero activation moves the
    entries behind it (a patch of dx, one channel of a bias), so 99.8 % of
    all entries must hold ``tol`` and every one 5e-3."""
    want = [np.asarray(b) for b in want]
    scale = max(np.abs(b).max() for b in want)
    assert len(got) == len(want)
    errs = []
    for a, b in zip(got, want):
        if a is None:  # BN running statistics: no gradient in train mode
            assert np.abs(b).max() == 0
            continue
        errs.append((np.abs(np.asarray(a) - b) / max(np.abs(b).max(), 0.05 * scale)).ravel())
    errs = np.concatenate(errs)
    if flips:
        assert np.mean(errs <= tol) >= 0.998 and errs.max() <= 5e-3
    else:
        assert errs.max() <= tol


@pytest.mark.parametrize("size", [96, 128])
def test_discriminator_kernel_stages_match_jax_pallas_with_gradients(size):
    jcfg, jp, pcfg, pp = _d_pair(size, stage_kernel="pallas")
    assert pd.n_kernel_stages(pcfg, "cpu", size, size) == 2
    x = _x(size, b=1 if size == 96 else 2)
    pv_, pg, pgx = _d_loss_and_grads_port(pcfg, pp, x)
    if size == 96:
        # against the Pallas kernels in interpret mode (slow to trace: one
        # image, this size only). Their own dx differs from the XLA graph's
        # at a few pixels where an lrelu gate flips, hence ``flips``
        jv_, jg, jgx = _d_loss_and_grads_jax(jcfg, jp, x)
        assert abs(pv_ - jv_) <= 1e-4 * max(1.0, abs(jv_))
        _grads_close(list(pg) + [pgx], list(jg) + [jgx], 1e-4, flips=True)
    # against the JAX package's plain graph, everywhere
    kv, kg, kgx = _d_loss_and_grads_jax(dataclasses.replace(jcfg, stage_kernel="xla"), jp, x)
    assert abs(pv_ - kv) <= 1e-4 * max(1.0, abs(kv))
    _grads_close(list(pg) + [pgx], list(kg) + [kgx], 1e-4)
    # and the port's kernel route against its own plain graph
    plain = dataclasses.replace(pcfg, stage_kernel="plain")
    assert pd.n_kernel_stages(plain, "cpu", size, size) == 0
    qv, qg, qgx = _d_loss_and_grads_port(plain, pp, x)
    assert abs(pv_ - qv) <= 1e-4 * max(1.0, abs(qv))
    _grads_close(list(pg) + [pgx], [np.zeros(()) if g is None else g.numpy() for g in qg] + [qgx],
                 1e-4)


def test_discriminator_kernel_route_counts_stage_calls(monkeypatch):
    from esrganplus_tpu_torch.kernels import stage_ct as S

    calls = []
    for name in ("conv_s1_ct_diff", "conv_s2_ct_diff"):
        real = getattr(S, name)
        monkeypatch.setattr(S, name, lambda *a, _n=name, _r=real, **k: (calls.append(_n),
                                                                         _r(*a, **k))[1])
    _, _, pcfg, pp = _d_pair(96, stage_kernel="cuda")
    pd.discriminator_forward(pp, torch.from_numpy(_x(96)), pcfg, train=True)
    assert calls == ["conv_s1_ct_diff", "conv_s2_ct_diff"] * 2


def test_stage_kernel_gate():
    cfg = pd.DiscriminatorVGGConfig()
    assert cfg.stage_kernel == "auto"
    # auto: the kernels on a CUDA device, the plain graph on the CPU
    assert pd.n_kernel_stages(cfg, "cpu", 128, 128) == 0
    assert pd.n_kernel_stages(cfg, "cuda", 128, 128) == 2
    forced = dataclasses.replace(cfg, stage_kernel="cuda")
    assert pd.n_kernel_stages(forced, "cpu", 128, 128) == 2
    # where the JAX package's own gate says no, the plain graph runs
    assert pd.n_kernel_stages(forced, "cuda", 126, 128) == 0
    assert pd.n_kernel_stages(dataclasses.replace(forced, spectral_norm=True), "cuda", 128, 128) == 0
    assert pd.n_kernel_stages(dataclasses.replace(forced, act_type="relu"), "cuda", 128, 128) == 0
    assert pd.n_kernel_stages(dataclasses.replace(forced, base_nf=128), "cuda", 128, 128) == 1
    assert pd.DiscriminatorVGGConfig(stage_kernel="xla").stage_kernel == "plain"
    assert pv.VGGFeatConfig(stage_kernel="pallas").stage_kernel == "cuda"
    with pytest.raises(ValueError, match="stage_kernel"):
        pd.DiscriminatorVGGConfig(stage_kernel="mosaic")
    v = pv.VGGFeatConfig()
    assert not pv.use_stage_kernels(v, "cpu", 128, 128) and pv.use_stage_kernels(v, "cuda", 128, 128)
    assert not pv.use_stage_kernels(dataclasses.replace(v, use_bn=True, stage_kernel="cuda"),
                                    "cuda", 128, 128)
    assert not pv.use_stage_kernels(dataclasses.replace(v, stage_kernel="cuda"), "cuda", 130, 128)


def test_discriminator_spectral_norm_forward_and_u_update_match_jax():
    jcfg, jp, pcfg, pp = _d_pair(128, seed=3, spectral_norm=True)
    assert "bn" not in pp and pp["fc1"]["u"].shape == (1,)
    x = _x(128)
    want, jst = jd.discriminator_forward(jp, jnp.asarray(x), jcfg, train=True)
    got, pst = pd.discriminator_forward(pp, torch.from_numpy(x), pcfg, train=True)
    _close(got, want, 1e-5)
    assert set(pst["u"]) == set(jst["u"])
    for k in jst["u"]:
        _close(pst["u"][k], jst["u"][k], 1e-5)
    new_j, new_p = jd.apply_state_updates(jp, jst, jcfg), pd.apply_state_updates(pp, pst, pcfg)
    for a, b in zip(tree_leaves(new_p), jax.tree.leaves(new_j)):
        _close(a, b, 1e-5)
    assert not torch.equal(new_p["convs"][0]["a"]["u"], pp["convs"][0]["a"]["u"])
    # the power iteration carries no gradient: u gets none, w does
    w = pp["convs"][0]["a"]["w"].requires_grad_()
    u = pp["convs"][0]["a"]["u"].requires_grad_()
    logits, _ = pd.discriminator_forward(pp, torch.from_numpy(x), pcfg)
    gw, gu = torch.autograd.grad(logits.sum(), [w, u], allow_unused=True)
    assert gu is None and gw.abs().max() > 0


def test_vgg_plan_matches_jax():
    for kw in (dict(), dict(use_bn=True, feature_layer=49), dict(layout=SMALL_VGG)):
        assert pv._torchvision_plan(pv.VGGFeatConfig(**kw)) == jv._torchvision_plan(
            jv.VGGFeatConfig(**kw))
    plan = pv._torchvision_plan(pv.VGGFeatConfig())
    assert len(plan) == 37 and plan[34] == ("conv", 512, 512) and plan[35] == ("relu",)
    params = pv.init_vgg_feat(0, pv.VGGFeatConfig(layout=SMALL_VGG))
    assert len(params["layers"]) == 35 and params["pretrained"] is False
    assert params["layers"][34]["w"].shape == (3, 3, 32, 32) and params["layers"][4] is None


def _vgg_pair(feature_layer, kernel="auto", use_bn=False, seed=0):
    kw = dict(feature_layer=feature_layer, layout=SMALL_VGG, use_bn=use_bn)
    jcfg = jv.VGGFeatConfig(stage_kernel=kernel, **kw)
    jp = jv.init_vgg_feat(jax.random.PRNGKey(seed), jcfg)
    np_tree = {"layers": [None if l is None else {k: np.asarray(v) for k, v in l.items()}
                          for l in jp["layers"]], "pretrained": jp["pretrained"]}
    return jcfg, jp, pv.VGGFeatConfig(stage_kernel=kernel, **kw), vgg_feat_from_jax(np_tree)


@pytest.mark.parametrize("feature_layer,use_bn", [(34, False), (7, False), (8, False),
                                                  (22, True)])
def test_vgg_features_match_jax(feature_layer, use_bn):
    """Full depth (34: conv5_4 before its relu), a mid-block truncation at a
    conv (7) and at its relu (8), and the BN variant."""
    jcfg, jp, pcfg, pp = _vgg_pair(feature_layer, use_bn=use_bn)
    x = _x(64)
    want = jv.vgg_feat_forward(jp, jnp.asarray(x), jcfg)
    got = pv.vgg_feat_forward(pp, torch.from_numpy(x), pcfg)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("feature_layer", [34, 7])
def test_vgg_kernel_early_blocks_match_jax_pallas_with_dx(feature_layer):
    """The early segment through the stage kernel (relu fused; the trailing
    conv of a mid-block truncation with act None), value and the gradient
    the perceptual loss sends back to the image."""
    jcfg, jp, pcfg, pp = _vgg_pair(feature_layer, kernel="pallas")
    x = _x(32)
    jval, jgx = jax.value_and_grad(
        lambda x_: jnp.sum(jnp.sin(jv.vgg_feat_forward(jp, x_, jcfg))))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = pv.vgg_feat_forward(pp, xt, pcfg)
    val = torch.sin(out).sum()
    gx, = torch.autograd.grad(val, xt)
    assert abs(val.item() - float(jval)) <= 1e-4 * max(1.0, abs(float(jval)))
    _close(gx, jgx, 1e-4)
    plain = pv.vgg_feat_forward(pp, torch.from_numpy(x),
                                dataclasses.replace(pcfg, stage_kernel="plain"))
    _close(out.detach(), plain, 1e-4)


def test_vgg_state_dict_and_loader(tmp_path):
    cfg = pv.VGGFeatConfig(layout=SMALL_VGG)
    params = pv.init_vgg_feat(3, cfg)
    sd = {}
    for i, l in enumerate(params["layers"]):
        if l is not None:
            sd[f"features.{i}.weight"] = l["w"].permute(3, 2, 0, 1).contiguous()
            sd[f"features.{i}.bias"] = l["b"] + 0.01 * i
    path = str(tmp_path / "vgg.pth")
    torch.save(sd, path)
    back = pv.load_vgg_feat(path, cfg)
    assert back["pretrained"] is True
    jback = jv.vgg_feat_from_state_dict({k: v.numpy() for k, v in sd.items()},
                                        jv.VGGFeatConfig(layout=SMALL_VGG))
    for a, b in zip(back["layers"], jback["layers"]):
        assert (a is None) == (b is None)
        if a is not None:
            _close(a["w"], b["w"], 0)
            _close(a["b"], b["b"], 0)
    assert pv.load_vgg_feat(None, cfg)["pretrained"] is False


@pytest.mark.parametrize("kind", ["vanilla", "lsgan", "wgan-gp"])
def test_gan_losses_match_jax(kind):
    rs = np.random.RandomState(0)
    a, b = (rs.randn(6, 1).astype(np.float32) * 3 for _ in range(2))
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    for real in (True, False):
        _close(ploss.gan_loss(ta, real, kind), jloss.gan_loss(ja, real, kind), 1e-6)
    _close(ploss.ragan_g_loss(ta, tb, kind), jloss.ragan_g_loss(ja, jb, kind), 1e-6)
    _close(ploss.ragan_d_loss(ta, tb, kind), jloss.ragan_d_loss(ja, jb, kind), 1e-6)
    _close(ploss.charbonnier_loss(ta, tb), jloss.charbonnier_loss(ja, jb), 1e-6)
    with pytest.raises(NotImplementedError):
        ploss.gan_loss(ta, True, "hinge")


def test_gradient_penalty_matches_jax():
    """The penalty's value from the same interpolates; its gradient with
    respect to D's parameters exists (second order through the plain graph;
    the trainer test holds a whole wgan-gp step against the JAX trainer)."""
    jcfg, jp, pcfg, pp = _d_pair(96, stage_kernel="xla")
    real, fake = _x(96, 1), _x(96, 2)
    key = jax.random.PRNGKey(4)
    eps = np.array(jax.random.uniform(key, (2, 1, 1, 1), jnp.float32))
    j_apply = lambda p, x: jd.discriminator_forward(p, x, jcfg, train=True)[0]
    jval = jloss.gradient_penalty(j_apply, jp, jnp.asarray(real), jnp.asarray(fake), key)
    leaves = [l.requires_grad_() for l in tree_leaves(pp)]
    p_apply = lambda p, x: pd.discriminator_forward(p, x, pcfg, train=True)[0]
    val = ploss.gradient_penalty(p_apply, pp, torch.from_numpy(real), torch.from_numpy(fake),
                                 torch.from_numpy(eps))
    assert abs(val.item() - float(jval)) <= 1e-4 * max(1.0, abs(float(jval)))
    grads = torch.autograd.grad(val, leaves, allow_unused=True)
    assert grads[-1] is not None and all(torch.isfinite(g).all() for g in grads if g is not None)
    assert max(g.abs().max().item() for g in grads if g is not None) > 0


def test_gradient_penalty_zero_for_unit_slope_critic():
    w = torch.zeros(4, 4, 3)
    w[0, 0, 0] = 1.0  # ‖∇‖ = 1 everywhere
    rs = np.random.RandomState(0)
    real, fake = (torch.from_numpy(rs.rand(3, 4, 4, 3).astype(np.float32)) for _ in range(2))
    gp = ploss.gradient_penalty(lambda p, x: (x * p).sum((1, 2, 3)), w, real, fake,
                                torch.rand(3, 1, 1, 1))
    assert gp.item() <= 1e-6


@pytest.mark.parametrize("size", [96, 192])
def test_discriminator_state_dict_round_trips_through_both_packages(size):
    jcfg, jp, pcfg, pp = _d_pair(size)
    sd_p = discriminator_to_state_dict(pp, pcfg)
    sd_j = jpth.discriminator_to_state_dict(jp, jcfg)
    assert set(sd_p) == set(sd_j)
    for k in sd_j:
        assert tuple(sd_p[k].shape) == tuple(np.shape(sd_j[k])), k
        _close(sd_p[k], sd_j[k], 0)
    # the port's export through the JAX importer and back through the port's
    via_j = jpth.discriminator_from_state_dict({k: v.numpy() for k, v in sd_p.items()}, jcfg)
    back = discriminator_from_state_dict(sd_p, pcfg)
    for a, b, c in zip(tree_leaves(back), jax.tree.leaves(via_j), tree_leaves(pp)):
        _close(a, b, 0)
        assert torch.equal(a, c)
    assert back["bn"][0]["a"] is None and sd_p["features.0.weight"].shape == (NF, 3, 3, 3)


def test_discriminator_sn_state_dict_round_trips_through_both_packages():
    jcfg, jp, pcfg, pp = _d_pair(128, seed=5, spectral_norm=True)
    sd_p = discriminator_sn_to_state_dict(pp, pcfg)
    sd_j = jpth.discriminator_sn_to_state_dict(jp, jcfg)
    assert set(sd_p) == set(sd_j) and "conv0.weight_orig" in sd_p and "linear1.weight_u" in sd_p
    for k in sd_j:
        _close(sd_p[k], sd_j[k], 1e-6)
    via_j = jpth.discriminator_sn_from_state_dict({k: v.numpy() for k, v in sd_p.items()}, jcfg)
    back = discriminator_sn_from_state_dict(sd_p, pcfg)
    for a, b, c in zip(tree_leaves(back), jax.tree.leaves(via_j), tree_leaves(pp)):
        _close(a, b, 0)
        assert torch.equal(a, c)


def test_discriminator_from_jax_checks_the_config():
    _, jp, pcfg, _ = _d_pair(96)
    with pytest.raises(ValueError, match="stages|fc0|weight"):
        discriminator_from_jax(_np_tree(jp), pd.DiscriminatorVGGConfig(input_size=192, base_nf=NF))
    with pytest.raises(ValueError, match="weight"):
        discriminator_from_jax(_np_tree(jp), pd.DiscriminatorVGGConfig(input_size=96, base_nf=16))
    with pytest.raises(ValueError, match="norm"):
        discriminator_from_jax(_np_tree(jp), dataclasses.replace(pcfg, norm_type=None))


def test_port_init_has_the_jax_tree_structure():
    for kw in (dict(), dict(spectral_norm=True), dict(norm_type=None)):
        jcfg = jd.DiscriminatorVGGConfig(input_size=96, base_nf=NF, **kw)
        pcfg = pd.DiscriminatorVGGConfig(input_size=96, base_nf=NF, **kw)
        jp = jd.init_discriminator(jax.random.PRNGKey(0), jcfg)
        pp = pd.init_discriminator(0, pcfg)
        jl, pl = jax.tree.leaves(jp), tree_leaves(pp)
        assert [tuple(a.shape) for a in pl] == [tuple(b.shape) for b in jl]
        assert pd.init_discriminator(0, pcfg)["fc0"]["w"].equal(pp["fc0"]["w"])
    w = pd.init_discriminator(0, pd.DiscriminatorVGGConfig())["convs"][4]["b"]["w"]
    assert abs(w.std().item() / np.sqrt(2.0 / (16 * 512)) - 1) < 0.02  # He-normal, fan-in
