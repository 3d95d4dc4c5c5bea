"""The fused nESRGAN+ noise mode (``noise_kernel="fused"``): the relative noise
of every per-RDB site drawn from the site's two Philox seed words inside the
RDB kernel's epilogue, and regenerated by the backward instead of saved.

The JAX package's fused mode draws from the TPU's hardware PRNG and cannot
run in interpret mode, so the arithmetic around the draw is held against its
``input`` mode fed the port's own draws (``philox_normal``): in fp32 the two
rounding orders (``out·(1 + σn)`` before the one rounding, and
``out + n·(σ·out)`` after it) agree to a rounding. Bars: the RDB value ≤1e-5
relative and every gradient ≤1e-4 of max|ref| against the Pallas kernel in
interpret mode, the JAX suite's own; the whole train-mode net in fused mode
against the port's ``input`` mode fed the same draws ≤1e-6. On the CPU every
kernel wrapper runs its plain twin; the CUDA kernels are held against these
twins on the card (tests/test_torch_cuda.py, ``chip_smoke.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrganplus_tpu.kernels import rdb_ct as jrdb
from esrganplus_tpu.options import options as jopt
from esrganplus_tpu_torch.kernels import rdb_ct as K
from esrganplus_tpu_torch.kernels.philox import philox_normal
from esrganplus_tpu_torch.models import rrdb as prrdb
from esrganplus_tpu_torch.models.discriminator import DiscriminatorVGGConfig
from esrganplus_tpu_torch.options import options as popt
from esrganplus_tpu_torch.train import GANTrainConfig, GANTrainer, SRTrainConfig, SRTrainer
from esrganplus_tpu_torch.train.rng import site_seeds
from esrganplus_tpu_torch.train.sr_model import tree_leaves

NF, GC, B, H, W = 8, 4, 2, 5, 7
SIGMA = 0.1
SEED = (0x1234ABCD, 0x0BADF00D)


def _conv(rs, cin, cout, k=3, bias=True):
    p = {"w": (rs.randn(k, k, cin, cout) * np.sqrt(2.0 / (k * k * cin))).astype(np.float32)}
    if bias:
        p["b"] = (rs.randn(cout) * 0.1).astype(np.float32)
    return p


def _rdb_params(rs):
    p = {f"conv{k}": _conv(rs, NF + (k - 1) * GC, NF if k == 5 else GC) for k in range(1, 6)}
    p["conv1x1"] = _conv(rs, NF, GC, k=1, bias=False)
    return p


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in p.items()}


def _leaves(p):
    if isinstance(p, dict):
        return [l for k in sorted(p) for l in _leaves(p[k])]
    if isinstance(p, (list, tuple)):
        return [l for v in p for l in _leaves(v)]
    return [p]


def _ct(x):
    return x.transpose(3, 0, 1, 2).reshape(x.shape[3], -1)


# ---------------------------------------------------------------------------
# one RDB: the fused epilogue and its replayed adjoint
# ---------------------------------------------------------------------------


def _jax_input_mode(p, x, n, detach):
    def loss(p, x):
        ws = jrdb.prepare_rdb_ct_weights(p, NF, GC, True, dtype=jnp.float32)
        out = jrdb.rdb_ct_diff(_ct(x), *ws, nf=NF, gc=GC, h=H, w=W, n_img=B, interpret=True,
                               noise_seed=_ct(jnp.asarray(n)), noise_sigma=SIGMA,
                               noise_detach=detach, noise_input=True)
        return jnp.sum(jnp.sin(out))

    v, (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1))(_tree(p, jnp.asarray),
                                                           jnp.asarray(x))
    return float(v), _leaves(gp) + [gx]


def _port_fused(p, x, detach):
    pt = _tree(p, lambda a: torch.from_numpy(a).requires_grad_())
    xt = torch.from_numpy(x).requires_grad_()
    out = K.rdb_ct_diff(xt, pt, noise_seed=SEED, noise_sigma=SIGMA, noise_detach=detach)
    loss = torch.sin(out).sum()
    return loss.item(), torch.autograd.grad(loss, _leaves(pt) + [xt])


@pytest.mark.parametrize("detach", [False, True], ids=["noise", "noise_detach"])
def test_fused_rdb_ct_diff_matches_pallas_input_mode_fed_the_same_draws(detach):
    rs = np.random.RandomState(0)
    p = _rdb_params(rs)
    x = rs.rand(B, H, W, NF).astype(np.float32)
    n = philox_normal(SEED, (B, H, W, NF)).numpy()
    v_p, g_p = _port_fused(p, x, detach)
    v_j, g_j = _jax_input_mode(p, x, n, detach)
    assert abs(v_p - v_j) / abs(v_j) <= 1e-5
    assert len(g_p) == len(g_j) == 12
    for i, (a, b) in enumerate(zip(g_p, g_j)):
        b = np.asarray(b)
        assert a.shape == b.shape, i
        assert np.abs(a.numpy() - b).max() / np.abs(b).max() <= 1e-4, i


def _fused_case(rs):
    p = _tree(_rdb_params(rs), torch.from_numpy)
    x = torch.from_numpy(rs.rand(B, H, W, NF).astype(np.float32))
    g = torch.from_numpy(rs.randn(B, H, W, NF).astype(np.float32))
    return p, x, g


def test_fused_backward_twin_matches_autograd_of_its_forward():
    """The explicit backward regenerates the forward's draws from the seed."""
    p, x, g = _fused_case(np.random.RandomState(1))
    w = K.prepare_rdb_ct_weights(p, torch.float32)
    xr = x.clone().requires_grad_()
    wr = {k: (None if v is None else v.clone().requires_grad_()) for k, v in w.items()}
    out, cat, lsv = K._rdb_ct_train_plain(xr, wr, seed=SEED, sigma=SIGMA)
    keys = [k for k in wr if wr[k] is not None]
    want = torch.autograd.grad(out, [xr] + [wr[k] for k in keys], g)
    got = K.rdb_ct_bwd_plain(x, w, cat.detach(), lsv.detach(), g, seed=SEED, sigma=SIGMA)
    for k, b in zip(["dx"] + keys, want):
        a = got[k]
        assert (a - b).abs().max() <= 1e-5 * b.abs().max().clamp_min(1.0), k


def test_fused_forward_draws_per_element_in_fp32_before_the_rounding():
    p, x, _ = _fused_case(np.random.RandomState(2))
    w = K.prepare_rdb_ct_weights(p, torch.float32)
    clean, _, _ = K._rdb_ct_train_plain(x, w)
    fused, _, _ = K._rdb_ct_train_plain(x, w, seed=SEED, sigma=SIGMA)
    n = philox_normal(SEED, x.shape)
    assert torch.equal(fused, clean * (1.0 + SIGMA * n))
    # bf16: the fp32 product is rounded once, not after a rounded clean output
    xb = x.to(torch.bfloat16)
    wb = K.prepare_rdb_ct_weights(p, torch.bfloat16)
    fb, _, _ = K._rdb_ct_train_plain(xb, wb, seed=SEED, sigma=SIGMA)
    inb, _, _ = K._rdb_ct_train_plain(xb, wb, noise=n.to(torch.bfloat16), sigma=SIGMA)
    assert fb.dtype == torch.bfloat16 and not torch.equal(fb, inb)
    assert (fb.float() - inb.float()).abs().max() <= 2e-2 * inb.float().abs().max()


def test_fused_detach_drops_only_the_adjoints_scale():
    """With ``noise_detach`` the forward is the same and the gradients are the
    noiseless block's: the cotangent is not scaled by 1 + σn."""
    p, x, g = _fused_case(np.random.RandomState(3))

    def run(**kw):
        pt = _tree(p, lambda a: a.clone().requires_grad_())
        xt = x.clone().requires_grad_()
        out = K.rdb_ct_diff(xt, pt, noise_sigma=SIGMA, **kw)
        return out.detach(), torch.autograd.grad((out * g).sum(), _leaves(pt) + [xt])

    out_d, g_d = run(noise_seed=SEED, noise_detach=True)
    out_f, g_f = run(noise_seed=SEED)
    _, g_0 = run()
    assert torch.equal(out_d, out_f)
    assert all(torch.equal(a, b) for a, b in zip(g_d, g_0))
    assert not torch.equal(g_f[-1], g_0[-1])
    with pytest.raises(ValueError, match="not both"):
        K.rdb_ct_diff(x, p, g, noise_seed=SEED, noise_sigma=SIGMA)


# ---------------------------------------------------------------------------
# the train-mode net
# ---------------------------------------------------------------------------

NET = dict(nf=NF, nb=2, gc=GC, upscale=4)


def _net(**kw):
    cfg = prrdb.RRDBNetConfig(**NET, **kw)
    return cfg, prrdb.init_rrdbnet(cfg, seed=0, init_scale=0.5)


def _loss_and_grads(params, cfg, x, **kw):
    leaves = [l.detach().clone().requires_grad_() for l in _leaves(params)]
    it = iter(leaves)

    def rebuild(t):
        if isinstance(t, dict):
            return {k: rebuild(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(v) for v in t)
        return next(it)

    p = rebuild(params)
    out = prrdb.rrdbnet_forward(p, x, cfg, train=True, **kw)
    loss = (out - 0.5).abs().mean()
    return loss.item(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("detach", [False, True], ids=["noise", "detach"])
@pytest.mark.parametrize("path", ["plain", "kernel"])
def test_fused_net_equals_input_mode_fed_the_same_draws(path, detach):
    kern = "plain" if path == "plain" else "cuda"
    kw = dict(trunk_kernel=kern, tail_kernel=kern, noise_relative_detach=detach)
    fused, params = _net(noise_kernel="fused", **kw)
    given = dataclasses.replace(fused, noise_kernel="input")
    x = torch.from_numpy(np.random.RandomState(4).rand(B, 6, 6, 3).astype(np.float32))
    seeds = site_seeds(11, 3, NET["nb"])
    noise = [[philox_normal(s, (B, 6, 6, NF)) for s in row] + [None] for row in seeds]
    v_f, g_f = _loss_and_grads(params, fused, x, noise_seeds=seeds)
    v_i, g_i = _loss_and_grads(params, given, x, noise=noise)
    v_0, _ = _loss_and_grads(params, given, x, noise=[[None] * 4] * NET["nb"])
    assert abs(v_f - v_i) <= 1e-6 * abs(v_i) and v_f != v_0
    for i, (a, b) in enumerate(zip(g_f, g_i)):
        assert (a - b).abs().max() <= 1e-6 * b.abs().max().clamp_min(1e-30), i


def test_fused_net_refuses_pre_drawn_per_rdb_noise_and_bad_seeds():
    cfg, params = _net(noise_kernel="fused")
    x = torch.rand(1, 4, 4, 3)
    seeds = site_seeds(0, 0, NET["nb"])
    noise = [[torch.zeros(1, 4, 4, NF)] * 3 + [None]] * NET["nb"]
    with pytest.raises(ValueError, match="fused"):
        prrdb.rrdbnet_forward(params, x, cfg, train=True, noise=noise, noise_seeds=seeds)
    with pytest.raises(ValueError, match="noise_seeds"):
        prrdb.rrdbnet_forward(params, x, cfg, train=True, noise_seeds=seeds[:1])
    # under "rbg" the in-kernel draw needs seeds; nothing falls back to "xla"
    with pytest.raises(ValueError, match="noise_seeds"):
        prrdb.rrdbnet_forward(params, x, cfg, train=True, rng=torch.Generator())
    with pytest.raises(ValueError, match="noise_prng"):
        prrdb.rrdbnet_forward(params, x, cfg, train=True, noise_seeds=seeds, noise_prng="x")
    # under threefry it draws between kernels and needs a generator, as "xla" does
    with pytest.raises(ValueError, match="rng"):
        prrdb.rrdbnet_forward(params, x, cfg, train=True, noise_prng="threefry")


@pytest.mark.parametrize("path", ["plain", "kernel"])
def test_fused_without_seeds_is_the_between_kernels_path(path, monkeypatch):
    """The threefry contract: no seeds are read or reach the kernels, and the
    noise is applied between kernel calls exactly as ``noise_kernel="xla"``
    does."""
    kern = "plain" if path == "plain" else "cuda"
    fused, params = _net(noise_kernel="fused", trunk_kernel=kern, tail_kernel=kern)
    xla = dataclasses.replace(fused, noise_kernel="xla")
    x = torch.rand(B, 4, 4, 3, generator=torch.Generator().manual_seed(0))
    calls = []
    real = K.rdb_ct_diff

    def spy(*a, **kw):
        calls.append((len(a) > 2 and a[2] is not None, kw.get("noise_seed")))
        return real(*a, **kw)

    monkeypatch.setattr(K, "rdb_ct_diff", spy)
    seeds = site_seeds(1, 0, NET["nb"])
    outs = [prrdb.rrdbnet_forward(params, x, c, train=True, noise_prng="threefry",
                                  noise_seeds=seeds, rng=torch.Generator().manual_seed(5))
            for c in (fused, xla)]
    assert torch.equal(outs[0], outs[1])
    assert all(c == (False, None) for c in calls)
    assert len(calls) == (2 * 3 * NET["nb"] if path == "kernel" else 0)
    calls.clear()
    prrdb.rrdbnet_forward(params, x, fused, train=True, noise_seeds=seeds)
    if path == "kernel":  # with seeds every per-RDB site draws in the kernel
        assert [c[1] for c in calls] == [s for row in seeds for s in row]


def test_draw_noise_leaves_the_rdb_sites_to_the_kernel():
    cfg = prrdb.RRDBNetConfig(**NET, rrdb_noise=True)
    sites = prrdb.draw_noise(cfg, (1, 2, 2, NF), torch.Generator().manual_seed(0),
                             torch.float32, "cpu", rdb_sites=False)
    assert all(s[:3] == [None] * 3 and s[3] is not None for s in sites)


# ---------------------------------------------------------------------------
# the trainers and the options
# ---------------------------------------------------------------------------


def _batch(n=2, size=6, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, size, size, 3).astype(np.float32),
            rs.rand(n, 4 * size, 4 * size, 3).astype(np.float32))


@pytest.mark.parametrize("kernels", ["plain", "cuda"])
def test_sr_trainer_fused_steps_repeat_bit_for_bit(kernels):
    def run(seed, prng="rbg", nk="fused"):
        t = SRTrainer(prrdb.RRDBNetConfig(**NET, noise_kernel=nk, trunk_kernel=kernels,
                                          tail_kernel=kernels),
                      SRTrainConfig(lr=1e-3, noise_prng=prng), device="cpu")
        state = t.init_state(0)
        logs = [float(t.train_step(state, _batch(), seed)[1]["l_pix"]) for _ in range(2)]
        return logs, tree_leaves(state["params"])

    (a, pa), (b, pb), (c, _) = run(3), run(3), run(4)
    assert a == b and a != c and all(np.isfinite(a))
    assert all(torch.equal(u, v) for u, v in zip(pa, pb))
    # under threefry the fused mode is the between-kernels path, as "xla";
    # both draw each site from its key (site_seeds), so they differ from the
    # in-kernel draws by the rounding order only
    thr = run(3, "threefry")[0]
    assert thr == run(3, "threefry", "xla")[0]
    np.testing.assert_allclose(thr, a, rtol=1e-5)


def test_sr_trainer_hands_site_seeds_only_under_rbg():
    t = SRTrainer(prrdb.RRDBNetConfig(**NET, noise_kernel="fused"), SRTrainConfig(),
                  device="cpu")
    state = t.init_state(0)
    state["step"] = 5
    sc = t.scalars.view(torch.from_numpy(t.plan(state, 7)[0]))
    want = torch.tensor(site_seeds(7, 5, NET["nb"]), dtype=torch.int64)
    assert torch.equal(t._noise(sc, "rbg")["noise_seeds"].to(torch.int64) & 0xFFFFFFFF, want)
    assert t._noise(sc, "threefry")["noise_seeds"] is None
    t = SRTrainer(prrdb.RRDBNetConfig(**NET), SRTrainConfig(), device="cpu")
    assert t._noise(t.scalars.view(torch.from_numpy(t.plan(t.init_state(0), 7)[0])),
                    "rbg")["noise_seeds"] is None


def test_gan_trainer_fused_step_repeats_bit_for_bit():
    runs = []
    for _ in range(2):
        t = GANTrainer(prrdb.RRDBNetConfig(nf=NF, nb=1, gc=GC, upscale=4, noise_kernel="fused"),
                       DiscriminatorVGGConfig(input_size=96, base_nf=8),
                       GANTrainConfig(feature_weight=0.0), device="cpu")
        state = t.init_state(0)
        runs.append({k: float(v) for k, v in t.train_step(state, _batch(size=24), 5)[1].items()})
    assert runs[0] == runs[1] and all(np.isfinite(list(runs[0].values())))


def test_options_carry_noise_kernel_and_unroll_as_the_jax_package():
    opt = {"network_G": {"which_model_G": "RRDB_net", "nf": 16, "nb": 3, "gc": 8,
                         "noise_kernel": "fused", "unroll": 3}}
    got, want = popt.build_net_g_config(opt), jopt.build_net_g_config(opt)
    assert (got.noise_kernel, got.unroll) == (want.noise_kernel, want.unroll) == ("fused", 3)
    opt["network_G"]["noise_kernel"] = "bogus"
    with pytest.raises(ValueError, match="noise_kernel"):
        popt.build_net_g_config(opt)
