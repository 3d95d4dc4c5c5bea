"""The port's 9-tap RDB on by-target weights (``kernels/rdb_t.py``) against
the JAX package's ``rdb_t`` / ``rdb_t_diff`` run in interpret mode.

On the CPU ``rdb_t``, ``rdb_t_bwd`` and ``rdb_t_diff`` run their plain twins,
which is what these tests hold against the TPU kernels; the CUDA kernels are
held against the twins on the card (tests/test_torch_cuda.py,
``chip_smoke.py``). Bars: fp32 values ≤1e-5 of max(1, max|ref|), every
gradient ≤1e-4 of its max|ref| (dW in rdb_t's layout, dW11 also without
conv1x1, the packed db), with the JAX suite's nonuniform cotangent
``sum(sin(out))``; bf16 ≤2e-2 of max|ref| (both sides round each stage and
each dz at the same points; an fp32 summation-order difference flips a few
of those roundings). nf=8, gc=4, B=2 at an odd H×W (H ≠ W catches axis
mix-ups). JAX's ``[C, B·H·W]`` planes are transposed from and to NHWC.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrganplus_tpu.kernels import rdb_t as jrdbt
from esrganplus_tpu_torch.convert import rdb_t_weights_from_jax
from esrganplus_tpu_torch.kernels import rdb_ct as K
from esrganplus_tpu_torch.kernels import rdb_t as R

NF, GC, B, H, W = 8, 4, 2, 6, 9
RES_SCALE, RRDB = 0.2, 0.2


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


def _ct(x):
    """NHWC → JAX's [C, B·H·W] plane."""
    return x.transpose(3, 0, 1, 2).reshape(x.shape[3], -1)


def _nhwc(t):
    return np.asarray(t, np.float32).reshape(NF, B, H, W).transpose(1, 2, 3, 0)


def _jax_ws(p, conv1x1, dtype=jnp.float32):
    return jrdbt.prepare_rdb_t_weights(_tree(p, jnp.asarray), NF, GC, conv1x1, dtype=dtype)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= tol, err
    return err


@pytest.mark.parametrize("conv1x1", [True, False], ids=["1x1", "no1x1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weights_carry_across_and_match_the_ports_own_prepare(conv1x1, dtype):
    p = _rdb_params(np.random.RandomState(0), conv1x1)
    jws = [np.asarray(w) for w in _jax_ws(p, conv1x1, getattr(jnp, dtype))]
    got = rdb_t_weights_from_jax(jws)
    own = R.prepare_rdb_t_weights(_tree(p, torch.from_numpy), NF, GC, conv1x1,
                                  getattr(torch, dtype))
    names = ("w1", "w2", "w3", "w4", "w5", "w11", "bias")
    for name, a, b, j in zip(names, got, own, jws):
        assert a.shape == b.shape == j.shape, name
        assert a.dtype == b.dtype == (torch.float32 if name == "bias" else getattr(torch, dtype))
        assert a.is_contiguous() and b.is_contiguous()
        assert torch.equal(a, b), name
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(j, np.float32))
    # the bias column packs b5 | b4 | b3 | b2 | b1
    packed = got[6].flatten().numpy()
    np.testing.assert_array_equal(packed[:NF], p["conv5"]["b"])
    np.testing.assert_array_equal(packed[NF + 3 * GC:], p["conv1"]["b"])
    if not conv1x1:
        assert not got[5].any()
    with pytest.raises(ValueError, match="w3"):
        rdb_t_weights_from_jax(jws[:2] + [jws[2][:, 1:]] + jws[3:])


@pytest.mark.parametrize("fold", [False, True], ids=["plain", "rrdb_fold"])
@pytest.mark.parametrize("conv1x1", [True, False], ids=["1x1", "no1x1"])
def test_rdb_t_plain_matches_pallas(conv1x1, fold):
    rs = np.random.RandomState(1)
    p = _rdb_params(rs, conv1x1)
    x = rs.rand(B, H, W, NF).astype(np.float32)
    res = rs.rand(B, H, W, NF).astype(np.float32)
    jres = dict(res=jnp.asarray(_ct(res)), rrdb_scale=RRDB) if fold else {}
    want = jrdbt.rdb_t(jnp.asarray(_ct(x)), *_jax_ws(p, conv1x1), nf=NF, gc=GC, h=H, w=W,
                       n_img=B, res_scale=RES_SCALE, interpret=True, **jres)
    ws = R.prepare_rdb_t_weights(_tree(p, torch.from_numpy), NF, GC, conv1x1, torch.float32)
    pres = dict(res=torch.from_numpy(res), rrdb_scale=RRDB) if fold else {}
    got = R.rdb_t(torch.from_numpy(x), *ws, res_scale=RES_SCALE, **pres)
    _close(got.numpy(), _nhwc(want), 1e-5)


def _jax_grads(p, x, conv1x1, dtype):
    ws = _jax_ws(p, conv1x1)

    def loss(x, *ws):
        out = jrdbt.rdb_t_diff(_ct(x).astype(dtype), *ws, nf=NF, gc=GC, h=H, w=W, n_img=B,
                               res_scale=RES_SCALE, interpret=True)
        return jnp.sum(jnp.sin(out.astype(jnp.float32)))

    v, g = jax.value_and_grad(loss, argnums=tuple(range(8)))(jnp.asarray(x), *ws)
    return float(v), [np.asarray(t, np.float32) for t in g]


def _port_grads(p, x, conv1x1, dtype):
    ws = [w.requires_grad_() for w in R.prepare_rdb_t_weights(
        _tree(p, torch.from_numpy), NF, GC, conv1x1, torch.float32)]
    xt = torch.from_numpy(x).requires_grad_()
    out = R.rdb_t_diff(xt.to(dtype), *ws, res_scale=RES_SCALE)
    assert out.dtype == dtype
    loss = torch.sin(out.float()).sum()
    g = torch.autograd.grad(loss, [xt, *ws])
    assert all(t.dtype == torch.float32 for t in g)
    return loss.item(), [t.numpy() for t in g]


@pytest.mark.parametrize("conv1x1", [True, False], ids=["1x1", "no1x1"])
def test_rdb_t_diff_grads_match_pallas(conv1x1):
    rs = np.random.RandomState(2)
    p = _rdb_params(rs, conv1x1)
    x = rs.rand(B, H, W, NF).astype(np.float32)
    v_p, g_p = _port_grads(p, x, conv1x1, torch.float32)
    v_j, g_j = _jax_grads(p, x, conv1x1, jnp.float32)
    assert abs(v_p - v_j) / abs(v_j) <= 1e-5
    names = ("dx", "dw1", "dw2", "dw3", "dw4", "dw5", "dw11", "db")
    for name, a, b in zip(names, g_p, g_j):
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() / np.abs(b).max() <= 1e-4, name
    # dW11 is a gradient also where the block has no 1×1 (its weight is zeros)
    assert np.abs(g_p[6]).max() > 0 and g_p[7].shape == (NF + 4 * GC, 1)


def test_rdb_t_bf16_matches_pallas():
    rs = np.random.RandomState(3)
    p = _rdb_params(rs)
    x = rs.rand(B, H, W, NF).astype(np.float32)
    ws_j = _jax_ws(p, True, jnp.bfloat16)
    want = jrdbt.rdb_t(jnp.asarray(_ct(x)).astype(jnp.bfloat16), *ws_j[:6],
                       ws_j[6], nf=NF, gc=GC, h=H, w=W, n_img=B, res_scale=RES_SCALE,
                       interpret=True)
    ws = R.prepare_rdb_t_weights(_tree(p, torch.from_numpy), NF, GC, True, torch.bfloat16)
    got = R.rdb_t(torch.from_numpy(x).to(torch.bfloat16), *ws, res_scale=RES_SCALE)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), _nhwc(want.astype(jnp.float32)), 2e-2)
    _, g_p = _port_grads(p, x, True, torch.bfloat16)
    _, g_j = _jax_grads(p, x, True, jnp.bfloat16)
    for i, (a, b) in enumerate(zip(g_p, g_j)):
        assert np.abs(a - b).max() / np.abs(b).max() <= 2e-2, i


@pytest.mark.parametrize("conv1x1", [True, False], ids=["1x1", "no1x1"])
def test_rdb_t_bwd_plain_matches_autograd_of_forward_twin(conv1x1):
    rs = np.random.RandomState(4)
    p = _rdb_params(rs, conv1x1)
    ws = [w.requires_grad_() for w in R.prepare_rdb_t_weights(
        _tree(p, torch.from_numpy), NF, GC, conv1x1, torch.float32)]
    x = torch.from_numpy(rs.rand(B, H, W, NF).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rs.randn(B, H, W, NF).astype(np.float32))
    out = R.rdb_t_plain(x, *ws, res_scale=RES_SCALE)
    want = torch.autograd.grad(out, [x, *ws], g)
    got = R.rdb_t_bwd_plain(x.detach(), *(w.detach() for w in ws), g, res_scale=RES_SCALE)
    assert len(got) == len(want) == 8
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, i
        assert (a - b).abs().max() <= 1e-5 * b.abs().max().clamp_min(1.0), i


@pytest.mark.parametrize("fold", [False, True], ids=["plain", "rrdb_fold"])
def test_rdb_t_and_rdb_ct_compute_the_same_block(fold):
    """The two weight layouts of one RDB give the same output."""
    rs = np.random.RandomState(5)
    p = _tree(_rdb_params(rs), torch.from_numpy)
    x = torch.from_numpy(rs.rand(B, H, W, NF).astype(np.float32))
    res = torch.from_numpy(rs.rand(B, H, W, NF).astype(np.float32)) if fold else None
    kw = dict(rrdb_scale=RRDB) if fold else {}
    a = R.rdb_t(x, *R.prepare_rdb_t_weights(p, NF, GC, True, torch.float32), res, **kw)
    b = K.rdb_ct_plain(x, K.prepare_rdb_ct_weights(p, torch.float32), res, **kw)
    _close(a.numpy(), b.numpy(), 1e-5)


def test_rdb_t_refuses_a_half_fold_and_counts_only_card_calls():
    rs = np.random.RandomState(6)
    p = _tree(_rdb_params(rs), torch.from_numpy)
    ws = R.prepare_rdb_t_weights(p, NF, GC, True, torch.float32)
    x = torch.from_numpy(rs.rand(B, H, W, NF).astype(np.float32))
    with pytest.raises(ValueError, match="together"):
        R.rdb_t(x, *ws, x)
    before = (R.rdb_t.launches, R.rdb_t_bwd.launches)
    R.rdb_t(x, *ws)
    R.rdb_t_bwd(x, *ws, torch.ones_like(x))
    assert (R.rdb_t.launches, R.rdb_t_bwd.launches) == before  # the CPU runs the twins
