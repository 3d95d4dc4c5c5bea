"""The port's four differentiable kernel wrappers (``*_diff``) against the JAX
package's custom-VJP Pallas kernels run in interpret mode.

On the CPU each ``torch.autograd.Function`` runs its plain twins (forward
and the explicit backward), which is what these tests hold against the TPU
kernels, with the JAX suite's nonuniform cotangent ``sum(sin(out))``
(tests/test_kernels.py, tests/test_tail_ct.py). Bars: fp32 value ≤1e-5
relative and every gradient leaf ``max|a-b| / max|b|`` ≤1e-4, the JAX suite's
own; bf16 every gradient leaf ≤5e-2 of ``max|ref|`` (measured ≤2e-2 here:
both sides round each dz to bf16 before its products, and an fp32
summation-order difference flips some of those roundings). Each explicit
backward is also held against ``torch.autograd`` of its forward twin in fp32
(≤1e-5 relative). The RDB and the trunk conv run at an odd H×W; the tail
kernels at the multiples of the stripe height that the Pallas tail takes.
JAX's ``[C, B·H·W]`` planes are transposed from and to NHWC for the
comparison. The CUDA kernels themselves are held against the twins by
tests/test_torch_cuda.py and ``chip_smoke.py`` on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrganplus_tpu.kernels import rdb_ct as jrdb
from esrganplus_tpu.kernels import tail_ct as jtail
from esrganplus_tpu_torch.kernels import rdb_ct as K
from esrganplus_tpu_torch.kernels import tail_ct as T

NF, GC, CO2, B, H, W = 16, 8, 3, 2, 7, 9
SIGMA = 0.1


def _conv(rs, cin, cout, k=3, bias=True):
    p = {"w": (rs.randn(k, k, cin, cout) * np.sqrt(2.0 / (k * k * cin))).astype(np.float32)}
    if bias:
        p["b"] = (rs.randn(cout) * 0.1).astype(np.float32)
    return p


def _rdb_params(rs, conv1x1=True):
    p = {f"conv{k}": _conv(rs, NF + (k - 1) * GC, NF if k == 5 else GC) for k in range(1, 6)}
    if conv1x1:
        p["conv1x1"] = _conv(rs, NF, GC, k=1, bias=False)
    return p


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in p.items()}


def _leaves(p):
    return [l for k in sorted(p) for l in (_leaves(p[k]) if isinstance(p[k], dict) else [p[k]])]


def _ct(x):
    """NHWC → JAX's [C, B·H·W] plane (differentiable)."""
    return x.transpose(3, 0, 1, 2).reshape(x.shape[3], -1)


def _torch_leaf(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype).requires_grad_()


def _check(v_port, g_port, v_jax, g_jax, tol, vtol=1e-5):
    assert abs(v_port - v_jax) / abs(v_jax) <= vtol
    assert len(g_port) == len(g_jax)
    worst = 0.0
    for i, (a, b) in enumerate(zip(g_port, g_jax)):
        a, b = a.detach().float().numpy(), np.asarray(b, np.float32)
        assert a.shape == b.shape, i
        err = np.abs(a - b).max() / (np.abs(b).max() + 1e-6)
        worst = max(worst, err)
        assert err <= tol, (i, err)
    return worst


# ---------------------------------------------------------------------------
# rdb_ct_diff
# ---------------------------------------------------------------------------


def _jax_rdb_diff(p, x, noise, detach, dtype):
    has11 = "conv1x1" in p

    def loss(p, x):
        ws = jrdb.prepare_rdb_ct_weights(p, NF, GC, has11, dtype=jnp.float32)
        kw = {}
        if noise is not None:
            kw = dict(noise_seed=_ct(jnp.asarray(noise)).astype(dtype), noise_sigma=SIGMA,
                      noise_detach=detach, noise_input=True)
        out = jrdb.rdb_ct_diff(_ct(x).astype(dtype), *ws, nf=NF, gc=GC, h=H, w=W, n_img=B,
                               interpret=True, **kw)
        return jnp.sum(jnp.sin(out.astype(jnp.float32)))

    v, (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1))(_tree(p, jnp.asarray),
                                                           jnp.asarray(x))
    return float(v), _leaves(gp) + [gx]


def _port_rdb_diff(p, x, noise, detach, dtype):
    pt = _tree(p, _torch_leaf)
    xt = _torch_leaf(x)
    n = None if noise is None else torch.from_numpy(noise).to(dtype)
    out = K.rdb_ct_diff(xt.to(dtype), pt, n, noise_sigma=SIGMA, noise_detach=detach)
    loss = torch.sin(out.float()).sum()
    leaves = _leaves(pt) + [xt]
    return loss.item(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("variant", ["1x1", "no1x1", "noise", "noise_detach"])
def test_rdb_ct_diff_matches_pallas(variant):
    rs = np.random.RandomState(3)
    p = _rdb_params(rs, conv1x1=variant != "no1x1")
    x = rs.rand(B, H, W, NF).astype(np.float32)
    noise = rs.randn(B, H, W, NF).astype(np.float32) if "noise" in variant else None
    detach = variant == "noise_detach"
    _check(*_port_rdb_diff(p, x, noise, detach, torch.float32),
           *_jax_rdb_diff(p, x, noise, detach, jnp.float32), tol=1e-4)


def test_rdb_ct_diff_bf16_matches_pallas():
    rs = np.random.RandomState(4)
    p = _rdb_params(rs)
    x = rs.rand(B, H, W, NF).astype(np.float32)
    noise = rs.randn(B, H, W, NF).astype(np.float32)
    worst = _check(*_port_rdb_diff(p, x, noise, False, torch.bfloat16),
                   *_jax_rdb_diff(p, x, noise, False, jnp.bfloat16), tol=5e-2, vtol=1e-2)
    assert worst <= 2e-2  # the measured bar; 5e-2 is the stated limit


@pytest.mark.parametrize("variant", ["1x1", "no1x1", "noise", "noise_detach"])
def test_rdb_ct_bwd_plain_matches_autograd_of_forward_twin(variant):
    rs = np.random.RandomState(5)
    p = _rdb_params(rs, conv1x1=variant != "no1x1")
    x = rs.rand(B, H, W, NF).astype(np.float32)
    noise = torch.from_numpy(rs.randn(B, H, W, NF).astype(np.float32)) \
        if "noise" in variant else None
    detach = variant == "noise_detach"
    v, g = _port_rdb_diff(p, x, None if noise is None else noise.numpy(), detach,
                          torch.float32)
    pt = _tree(p, _torch_leaf)
    xt = _torch_leaf(x)
    out, _, _ = K._rdb_ct_train_plain(xt, K.prepare_rdb_ct_weights(pt, torch.float32))
    if noise is not None:
        out = out + noise * (SIGMA * (out.detach() if detach else out))
    loss = torch.sin(out).sum()
    ref = torch.autograd.grad(loss, _leaves(pt) + [xt])
    _check(v, g, loss.item(), [r.numpy() for r in ref], tol=1e-5)


# ---------------------------------------------------------------------------
# conv3x3_ct_diff
# ---------------------------------------------------------------------------


def test_conv3x3_ct_diff_matches_pallas():
    rs = np.random.RandomState(6)
    c = _conv(rs, NF, NF)
    x = rs.rand(B, H, W, NF).astype(np.float32)
    res = rs.rand(B, H, W, NF).astype(np.float32)

    def loss(w, b, x, res):
        wm, bm = jrdb.prepare_conv_ct_weights(w, b, dtype=jnp.float32)
        out = jrdb.conv3x3_ct_diff(_ct(x), wm, bm, _ct(res), cin=NF, cout=NF, h=H, w=W,
                                   n_img=B, interpret=True)
        return jnp.sum(jnp.sin(out))

    vj, gj = jax.value_and_grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (c["w"], c["b"], x, res)))
    lt = [_torch_leaf(a) for a in (c["w"], c["b"], x, res)]
    out = K.conv3x3_ct_diff(lt[2], lt[0], lt[1], lt[3])
    lp = torch.sin(out).sum()
    gp = torch.autograd.grad(lp, lt)
    _check(lp.item(), gp, float(vj), gj, tol=1e-4)
    # the explicit backward against autograd of the forward twin
    lt2 = [_torch_leaf(a) for a in (c["w"], c["b"], x, res)]
    l2 = torch.sin(K.conv3x3_ct_plain(lt2[2], lt2[0], lt2[1], lt2[3])).sum()
    _check(lp.item(), gp, l2.item(), [g.numpy() for g in torch.autograd.grad(l2, lt2)],
           tol=1e-5)


# ---------------------------------------------------------------------------
# tail: upfold_ct_diff, conv_hr_ct_diff
# ---------------------------------------------------------------------------

TC, TH = 8, 8  # tail channels; LR height the Pallas stripes (R=4) divide


def _jax_planes(x, P):
    """NHWC → the Pallas tail's column-phase planes; P=2 is the packed
    y-phase layout its second stage receives."""
    if P == 1:
        return [x.transpose(3, 0, 1, 2).reshape(x.shape[3], -1)], False
    c = x.shape[3]
    return [jnp.concatenate(
        [x[:, 0::2, q::P, :].transpose(3, 0, 1, 2).reshape(c, -1),
         x[:, 1::2, q::P, :].transpose(3, 0, 1, 2).reshape(c, -1)], 0)
        for q in range(P)], True


@pytest.mark.parametrize("P", [1, 2], ids=["first_stage", "second_stage"])
def test_upfold_ct_diff_matches_pallas(P):
    rs = np.random.RandomState(7 + P)
    wi = 8 * P
    x = rs.randn(B, TH, wi, TC).astype(np.float32)
    c = _conv(rs, TC, TC)

    def loss(wt, b, x):
        planes, packed = _jax_planes(x, P)
        wd, bias = jtail.prepare_upfold_ct(wt, b, P, dtype=jnp.float32)
        out = jtail.upfold_ct_diff(planes, wd, bias, C=TC, P=P, h=TH, w=wi // P, n_img=B,
                                   R=4, packed_in=packed, interpret=True)
        out = jtail.interleave_rows(out, TC, B, TH, wi // P)
        return jnp.sum(jnp.sin(jtail.unphase_columns(out, B, 2 * TH, wi // P)))

    vj, gj = jax.value_and_grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (c["w"], c["b"], x)))

    def port(twin_autograd):
        lt = [_torch_leaf(a) for a in (c["w"], c["b"], x)]
        wf, bf = T.prepare_upfold_ct(lt[0], lt[1], torch.float32)
        fn = T.upfold_ct_plain if twin_autograd else T.upfold_ct_diff
        l = torch.sin(fn(lt[2], wf, bf)).sum()
        return l.item(), torch.autograd.grad(l, lt)

    vp, gp = port(False)
    _check(vp, gp, float(vj), gj, tol=1e-4)
    vt, gt = port(True)
    _check(vp, gp, vt, [g.numpy() for g in gt], tol=1e-5)


def test_conv_hr_ct_diff_matches_pallas():
    rs = np.random.RandomState(9)
    P, wi = 2, 16
    x = rs.randn(B, TH, wi, TC).astype(np.float32)
    h0, h1 = _conv(rs, TC, TC), _conv(rs, TC, CO2)
    raw = (h0["w"], h0["b"], h1["w"], h1["b"], x)

    def loss(w0, b0, w1, b1, x):
        planes = [x[:, :, p::P, :].transpose(3, 0, 1, 2).reshape(TC, -1) for p in range(P)]
        wm0, bb0 = jtail.prepare_convxp_ct(w0, b0, P, dtype=jnp.float32)
        wm1, bb1 = jtail.prepare_convxp_ct(w1, b1, P, dtype=jnp.float32)
        out = jtail.conv_hr_ct_diff(planes, wm0, bb0, wm1, bb1, C=TC, P=P, CO2=CO2, h=TH,
                                    w=wi // P, n_img=B, R=4, interpret=True)
        return jnp.sum(jnp.sin(jtail.unphase_columns(out, B, TH, wi // P)))

    vj, gj = jax.value_and_grad(loss, argnums=tuple(range(5)))(*(jnp.asarray(a) for a in raw))

    def port(fn):
        lt = [_torch_leaf(a) for a in raw]
        l = torch.sin(fn(lt[4], *lt[:4])).sum()
        return l.item(), torch.autograd.grad(l, lt)

    vp, gp = port(T.conv_hr_ct_diff)
    _check(vp, gp, float(vj), gj, tol=1e-4)
    vt, gt = port(T.conv_hr_ct_plain)
    _check(vp, gp, vt, [g.numpy() for g in gt], tol=1e-5)


def test_tail_diff_bf16_matches_pallas_chain():
    """up1 → up2 → hr0+hr1 in bf16, fp32 masters, as the training tail runs
    it: every gradient within 5e-2 of max|ref| of the Pallas chain's."""
    rs = np.random.RandomState(10)
    x = rs.randn(B, TH, 8, TC).astype(np.float32)
    ps = [_conv(rs, TC, TC), _conv(rs, TC, TC), _conv(rs, TC, TC), _conv(rs, TC, CO2)]
    raw = [a for p in ps for a in (p["w"], p["b"])] + [x]
    bf = jnp.bfloat16

    def loss(*a):
        x = a[8]
        planes, Pn, hh, packed = [_ct(x).astype(bf)], 1, TH, False
        for i in (0, 1):
            wd, bias = jtail.prepare_upfold_ct(a[2 * i], a[2 * i + 1], Pn, dtype=jnp.float32)
            planes = jtail.upfold_ct_diff(planes, wd, bias, C=TC, P=Pn, h=hh, w=8, n_img=B,
                                          R=4, packed_in=packed, interpret=True)
            Pn, hh, packed = 2 * Pn, 2 * hh, True
        wm0, b0 = jtail.prepare_convxp_ct(a[4], a[5], Pn, dtype=jnp.float32)
        wm1, b1 = jtail.prepare_convxp_ct(a[6], a[7], Pn, dtype=jnp.float32)
        out = jtail.conv_hr_ct_diff(planes, wm0, b0, wm1, b1, C=TC, P=Pn, CO2=CO2, h=hh, w=8,
                                    n_img=B, R=4, packed_in=packed, interpret=True)
        return jnp.sum(jnp.sin(jtail.unphase_columns(out, B, hh, 8).astype(jnp.float32)))

    vj, gj = jax.value_and_grad(loss, argnums=tuple(range(9)))(*(jnp.asarray(a) for a in raw))
    lt = [_torch_leaf(a) for a in raw]
    fea = lt[8].to(torch.bfloat16)
    for i in (0, 1):
        wf, b = T.prepare_upfold_ct(lt[2 * i], lt[2 * i + 1], torch.float32)
        fea = T.upfold_ct_diff(fea, wf, b)
    lp = torch.sin(T.conv_hr_ct_diff(fea, *lt[4:8]).float()).sum()
    worst = _check(lp.item(), torch.autograd.grad(lp, lt), float(vj), gj, tol=5e-2, vtol=1e-2)
    assert worst <= 3e-2  # measured; 5e-2 is the stated limit
