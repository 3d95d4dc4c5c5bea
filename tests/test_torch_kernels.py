"""The port's four kernels (esrganplus_tpu_torch/kernels) against the JAX
package's Pallas kernels run in interpret mode.

On the CPU each wrapper runs its plain PyTorch twin, which is what these
tests hold against the TPU kernels: fp32 at the JAX suite's kernel bar
(atol = rtol = 1e-4, tests/test_kernels.py, tests/test_tail_ct.py), and bf16
at two bf16 ulps of the output's magnitude — the twins round where the TPU
kernels round, so only fp32 summation order differs. JAX's ``[C, B·H·W]``
planes are transposed to NHWC for the comparison. The CUDA kernels
themselves are held against the twins by tests/test_torch_cuda.py and
``chip_smoke.py`` on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrganplus_tpu.kernels import rdb_ct as jrdb
from esrganplus_tpu.kernels import tail_ct as jtail
from esrganplus_tpu_torch.kernels import rdb_ct as K
from esrganplus_tpu_torch.kernels import tail_ct as T

NF, GC, CO2, B, H, W = 16, 8, 3, 2, 7, 10
TOL = dict(atol=1e-4, rtol=1e-4)


def _conv(rs, cin, cout, bias=True, scale=1.0):
    p = {"w": (rs.randn(3, 3, cin, cout) * scale * np.sqrt(2.0 / (9 * cin))).astype(np.float32)}
    if bias:
        p["b"] = (rs.randn(cout) * 0.1).astype(np.float32)
    return p


def _rdb_params(rs, conv1x1=True):
    p = {f"conv{k}": _conv(rs, NF + (k - 1) * GC, NF if k == 5 else GC) for k in range(1, 6)}
    if conv1x1:
        p["conv1x1"] = {"w": (rs.randn(1, 1, NF, GC) * np.sqrt(2.0 / NF)).astype(np.float32)}
    return p


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in p.items()}


def _t(p):
    return _tree(p, torch.from_numpy)


def _j(p):
    return _tree(p, jnp.asarray)


def _ct(x):
    """NHWC numpy → JAX's [C, B·H·W] plane."""
    return jnp.asarray(x.transpose(3, 0, 1, 2).reshape(x.shape[3], -1))


def _nhwc(plane, b, h, w):
    c = plane.shape[0]
    return np.asarray(plane, np.float32).reshape(c, b, h, w).transpose(1, 2, 3, 0)


def _close_bf16(got, want):
    """Same rounding points: within two bf16 ulps (2·2⁻⁸) of the output's
    largest magnitude, and at most 1 % of the outputs differ at all (only
    where fp32 summation order flips a rounding; moving one rounding point
    makes 3-78 % of them differ)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= 2 * 2.0 ** -8 * np.abs(want).max()
    assert np.mean(got != want) <= 0.01


def _rdb_case(variant, seed):
    rs = np.random.RandomState(seed)
    p = _rdb_params(rs, conv1x1=variant != "no1x1")
    x = rs.rand(B, H, W, NF).astype(np.float32)
    res = rs.rand(B, H, W, NF).astype(np.float32) if variant == "fold" else None
    return p, x, res


def _jax_rdb(p, x, res, dtype):
    ws = jrdb.prepare_rdb_ct_weights(_j(p), NF, GC, "conv1x1" in p, dtype=dtype)
    kw = dict(nf=NF, gc=GC, h=H, w=W, n_img=B, interpret=True)
    if res is None:
        out = jrdb.rdb_ct(_ct(x).astype(dtype), *ws, **kw)
    else:  # the inference trunk's RRDB-epilogue call (interleaved kernel)
        out = jrdb.rdb_ct(_ct(x).astype(dtype), *ws, _ct(res).astype(dtype),
                          rrdb_scale=0.2, interleave=2, **kw)
    return _nhwc(out.astype(jnp.float32), B, H, W)


def _port_rdb(p, x, res, dtype):
    w = K.prepare_rdb_ct_weights(_t(p), dtype)
    kw = {} if res is None else dict(rrdb_scale=0.2)
    r = None if res is None else torch.from_numpy(res).to(dtype)
    return K.rdb_ct(torch.from_numpy(x).to(dtype), w, r, **kw).float().numpy()


@pytest.mark.parametrize("variant", ["1x1", "no1x1", "fold"])
def test_rdb_ct_matches_pallas(variant):
    p, x, res = _rdb_case(variant, seed=1)
    np.testing.assert_allclose(_port_rdb(p, x, res, torch.float32),
                               _jax_rdb(p, x, res, jnp.float32), **TOL)


def test_rdb_ct_bf16_rounding_points_match_pallas():
    p, x, res = _rdb_case("fold", seed=2)
    _close_bf16(_port_rdb(p, x, res, torch.bfloat16), _jax_rdb(p, x, res, jnp.bfloat16))


@pytest.mark.parametrize("with_res", [True, False])
def test_conv3x3_ct_matches_pallas(with_res):
    rs = np.random.RandomState(3)
    c = _conv(rs, NF, NF)
    x = rs.rand(B, H, W, NF).astype(np.float32)
    res = rs.rand(B, H, W, NF).astype(np.float32)
    wm, bm = jrdb.prepare_conv_ct_weights(jnp.asarray(c["w"]), jnp.asarray(c["b"]),
                                          dtype=jnp.float32)
    want = jrdb.conv3x3_ct(_ct(x), wm, bm, _ct(res) if with_res else None, cin=NF,
                           cout=NF, h=H, w=W, n_img=B, interpret=True)
    w, b = K.prepare_conv_ct_weights(torch.from_numpy(c["w"]), torch.from_numpy(c["b"]),
                                     torch.float32)
    got = K.conv3x3_ct(torch.from_numpy(x), w, b,
                       torch.from_numpy(res) if with_res else None)
    np.testing.assert_allclose(got.numpy(), _nhwc(want, B, H, W), **TOL)


def _tail_case(seed):
    rs = np.random.RandomState(seed)
    return (rs.rand(B, H, W, NF).astype(np.float32), _conv(rs, NF, NF), _conv(rs, NF, NF),
            _conv(rs, NF, NF), _conv(rs, NF, CO2))


def _jax_tail(x, up1, up2, hr0, hr1, dtype, stages):
    """JAX column-phase tail: returns the NHWC output after `stages` of
    (up1, up2, hr)."""
    planes = [_ct(x).astype(dtype)]
    wd, bd = jtail.prepare_upfold_ct(jnp.asarray(up1["w"]), jnp.asarray(up1["b"]), 1, dtype)
    t = jtail.upfold_ct(planes, wd, bd, C=NF, P=1, h=H, w=W, n_img=B, interpret=True)
    if stages == 1:
        return jtail.unphase_columns(jtail.interleave_rows(t, NF, B, H, W), B, 2 * H, W)
    wd, bd = jtail.prepare_upfold_ct(jnp.asarray(up2["w"]), jnp.asarray(up2["b"]), 2, dtype)
    t = jtail.upfold_ct(t, wd, bd, C=NF, P=2, h=2 * H, w=W, n_img=B, packed_in=True,
                        interpret=True)
    if stages == 2:
        return jtail.unphase_columns(jtail.interleave_rows(t, NF, B, 2 * H, W), B, 4 * H, W)
    w0, b0 = jtail.prepare_convxp_ct(jnp.asarray(hr0["w"]), jnp.asarray(hr0["b"]), 4, dtype)
    w1, b1 = jtail.prepare_convxp_ct(jnp.asarray(hr1["w"]), jnp.asarray(hr1["b"]), 4, dtype)
    t = jtail.conv_hr_ct(t, w0, b0, w1, b1, C=NF, P=4, CO2=CO2, h=4 * H, w=W, n_img=B,
                         packed_in=True, interpret=True)
    return jtail.unphase_columns(t, B, 4 * H, W)


def _port_up(x, up, dtype):
    wf, b = T.prepare_upfold_ct(torch.from_numpy(up["w"]), torch.from_numpy(up["b"]), dtype)
    return T.upfold_ct(x, wf, b)


@pytest.mark.parametrize("stages", [1, 2])
def test_upfold_ct_matches_pallas(stages):
    """P=1 (the first upconv) and chained (the second, on the first's output)."""
    x, up1, up2, _, _ = _tail_case(seed=4)
    want = _jax_tail(x, up1, up2, None, None, jnp.float32, stages)
    got = _port_up(torch.from_numpy(x), up1, torch.float32)
    if stages == 2:
        # feed the second upconv the JAX stage-1 output, so only it is compared
        s1 = _jax_tail(x, up1, up2, None, None, jnp.float32, 1)
        got = _port_up(torch.from_numpy(np.array(s1)), up2, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_conv_hr_ct_on_chained_tail_matches_pallas():
    x, up1, up2, hr0, hr1 = _tail_case(seed=5)
    want = _jax_tail(x, up1, up2, hr0, hr1, jnp.float32, 3)
    s2 = torch.from_numpy(np.array(_jax_tail(x, up1, up2, None, None, jnp.float32, 2)))
    hw = T.prepare_conv_hr_ct(_t(hr0), _t(hr1), torch.float32)
    got = T.conv_hr_ct(s2, *hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_tail_chain_bf16_rounding_points_match_pallas():
    x, up1, up2, hr0, hr1 = _tail_case(seed=6)
    want = _jax_tail(x, up1, up2, hr0, hr1, jnp.bfloat16, 3).astype(jnp.float32)
    t = _port_up(torch.from_numpy(x).bfloat16(), up1, torch.bfloat16)
    t = _port_up(t, up2, torch.bfloat16)
    got = T.conv_hr_ct(t, *T.prepare_conv_hr_ct(_t(hr0), _t(hr1), torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close_bf16(got.float().numpy(), want)


def test_upfold_fold_is_exact_nearest_upsample_conv():
    """The 2×2 dense fold equals nearest-×2 followed by the 3×3 conv."""
    from esrganplus_tpu_torch.models.layers import act, conv2d, upsample_nearest

    x, up1, _, _, _ = _tail_case(seed=7)
    xt, up = torch.from_numpy(x), _t(up1)
    want = act(conv2d(upsample_nearest(xt, 2), up), "leakyrelu", 0.2)
    np.testing.assert_allclose(_port_up(xt, up1, torch.float32).numpy(), want.numpy(), **TOL)


# ---------------------------------------------------------------------------
# wrapper contract: a non-CPU tensor never falls back to the plain twin
# ---------------------------------------------------------------------------


def test_wrappers_reject_bad_inputs_before_launch():
    p = K.prepare_rdb_ct_weights(_t(_rdb_params(np.random.RandomState(8))), torch.float32)
    x = torch.empty(B, H, W, NF, device="meta")
    with pytest.raises(ValueError):
        K.rdb_ct(torch.zeros(B, H, W, NF), p, torch.zeros(B, H, W, NF))  # res w/o scale
    with pytest.raises(TypeError):
        K.rdb_ct(x.to(torch.float16), p)
    with pytest.raises(ValueError):  # weights on another device than x
        K.rdb_ct(x, p)
    with pytest.raises(ValueError):
        T.upfold_ct(torch.empty(B, W, H, NF, device="meta").transpose(1, 2),
                    torch.empty(2, 2, 2, 2, NF, NF, device="meta"),
                    torch.empty(NF, device="meta"))


def test_non_cpu_tensor_never_takes_the_plain_twin(monkeypatch):
    """With every check passed, a device tensor goes to the CUDA build: here
    (no nvcc) that raises instead of silently running the plain twin."""
    from esrganplus_tpu_torch.kernels import build

    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_stale", lambda name: True)
    monkeypatch.setattr(build, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(K, "conv3x3_ct_plain", None)
    monkeypatch.setattr(T, "conv_hr_ct_plain", None)
    meta = lambda *s, dt=torch.float32: torch.empty(*s, dtype=dt, device="meta")
    with pytest.raises(RuntimeError, match="nvcc"):
        K.conv3x3_ct(meta(B, H, W, NF), meta(3, 3, NF, NF), meta(NF))
    with pytest.raises(RuntimeError, match="nvcc"):
        T.conv_hr_ct(meta(B, H, W, NF), meta(3, 3, NF, NF), meta(NF),
                     meta(3, 3, NF, CO2), meta(CO2))
