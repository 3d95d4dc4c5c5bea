"""The port's stage convolutions (esrganplus_tpu_torch/kernels/stage_ct.py)
against the JAX package's plane-layout Pallas kernels in interpret mode.

On the CPU each wrapper runs its plain PyTorch twin, which is what these
tests hold against the TPU kernels (run exactly as tests/test_stage_ct.py
runs them: ``nhwc_to_planes`` → kernel with ``interpret=True`` →
``planes_to_nhwc``):

  * forward twins vs ``conv_s1_ct`` / ``conv_s2_ct``: fp32 ≤1e-5; bf16 within
    two bf16 ulps of the output's magnitude with ≤1 % of the outputs
    differing at all (the twins round where the TPU kernels round, so only
    fp32 summation order differs);
  * ``conv_s{1,2}_ct_diff`` vs the custom-VJP kernels, gradients of
    Σ sin(out): value ≤1e-5, dx / dW / db ≤1e-4 (of max|ref|);
  * the explicit backward twins vs autograd of the forward twins ≤1e-5;
  * a moved rounding point must fail the bf16 bar.

The CUDA kernels themselves are held against the twins on the card
(tests/test_torch_cuda.py, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrganplus_tpu.kernels import stage_ct as J
from esrganplus_tpu_torch.kernels import stage_ct as S

B, H, W = 2, 16, 16


def _mk(seed, c, co, k):
    rs = np.random.RandomState(seed)
    return ((rs.randn(k, k, c, co) * 0.2).astype(np.float32),
            (rs.randn(co) * 0.1).astype(np.float32),
            rs.randn(B, H, W, c).astype(np.float32))


def _jax_fwd(ks, w, b, x, P, act, dtype):
    c, co = w.shape[2], w.shape[3]
    prep, kern = ((J.prepare_convxp_ct, J.conv_s1_ct) if ks == 3 else
                  (J.prepare_conv4s2_ct, J.conv_s2_ct))
    wm, bias = prep(jnp.asarray(w), jnp.asarray(b), P, dtype=dtype)
    out = kern(J.nhwc_to_planes(jnp.asarray(x).astype(dtype), P), wm, bias, C=c, CO=co, P=P,
               h=H, w=W // P, n_img=B, act=act, interpret=True)
    return np.asarray(J.planes_to_nhwc(out, B, H if ks == 3 else H // 2, W // P)
                      .astype(jnp.float32))


def _port_fwd(ks, w, b, x, act, dtype):
    wk, bias = S.prepare_stage_ct(torch.from_numpy(w), torch.from_numpy(b), dtype)
    fn = S.conv_s1_ct if ks == 3 else S.conv_s2_ct
    return fn(torch.from_numpy(x).to(dtype), wk, bias, act=act).float().numpy()


def _close_bf16(got, want):
    """Same rounding points: within two bf16 ulps (2·2⁻⁸) of the output's
    largest magnitude, and at most 1 % of the outputs differ at all."""
    assert np.abs(got - want).max() <= 2 * 2.0 ** -8 * np.abs(want).max()
    assert np.mean(got != want) <= 0.01


S1_CASES = [(1, 8, 8, None), (2, 8, 16, "relu"), (4, 3, 8, "lrelu")]
S2_CASES = [(2, 8, 8, None), (4, 8, 16, "lrelu"), (4, 3, 8, None)]


@pytest.mark.parametrize("P,c,co,act", S1_CASES)
def test_conv_s1_ct_matches_pallas(P, c, co, act):
    w, b, x = _mk(1, c, co, 3)
    got = _port_fwd(3, w, b, x, act, torch.float32)
    assert got.shape == (B, H, W, co)
    assert np.abs(got - _jax_fwd(3, w, b, x, P, act, jnp.float32)).max() <= 1e-5


@pytest.mark.parametrize("P,c,co,act", S2_CASES)
def test_conv_s2_ct_matches_pallas(P, c, co, act):
    w, b, x = _mk(2, c, co, 4)
    got = _port_fwd(4, w, b, x, act, torch.float32)
    assert got.shape == (B, H // 2, W // 2, co)
    assert np.abs(got - _jax_fwd(4, w, b, x, P, act, jnp.float32)).max() <= 1e-5


@pytest.mark.parametrize("ks,P,c,co,act", [(3, 4, 8, 16, "relu"), (3, 2, 8, 8, None),
                                            (4, 4, 8, 16, "lrelu"), (4, 2, 8, 8, None)])
def test_stage_bf16_rounding_points_match_pallas(ks, P, c, co, act):
    w, b, x = _mk(3, c, co, ks)
    _close_bf16(_port_fwd(ks, w, b, x, act, torch.bfloat16),
                _jax_fwd(ks, w, b, x, P, act, jnp.bfloat16))


def test_a_moved_rounding_point_fails_the_bf16_bar():
    """Rounding the conv before the bias and the activation (two roundings
    instead of one) is caught by the share-of-outputs bar."""
    w, b, x = _mk(3, 8, 16, 3)
    want = _jax_fwd(3, w, b, x, 4, "lrelu", jnp.bfloat16)
    bf = torch.bfloat16
    wk, bias = S.prepare_stage_ct(torch.from_numpy(w), torch.from_numpy(b), bf)
    xt = torch.from_numpy(x).to(bf)
    conv = S.conv_s1_ct_plain(xt, wk, torch.zeros_like(bias))  # rounded here already
    moved = S._apply_act(conv.float() + bias, "lrelu", 0.2).to(bf).float().numpy()
    with pytest.raises(AssertionError):
        _close_bf16(moved, want)


def _jax_grads(ks, w, b, x, P, act):
    c, co = w.shape[2], w.shape[3]
    prep, diff = ((J.prepare_convxp_ct, J.conv_s1_ct_diff) if ks == 3 else
                  (J.prepare_conv4s2_ct, J.conv_s2_ct_diff))
    ho = H if ks == 3 else H // 2

    def loss(w_, b_, x_):
        wm, bias = prep(w_, b_, P, dtype=jnp.float32)
        out = diff(J.nhwc_to_planes(x_, P), wm, bias, C=c, CO=co, P=P, h=H, w=W // P,
                   n_img=B, act=act, interpret=True)
        return jnp.sum(jnp.sin(J.planes_to_nhwc(out, B, ho, W // P)))

    val, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(w), jnp.asarray(b), jnp.asarray(x))
    return float(val), [np.asarray(g) for g in grads]


def _port_grads(ks, w, b, x, act):
    wt, bt, xt = (torch.from_numpy(a).requires_grad_() for a in (w, b, x))
    diff = S.conv_s1_ct_diff if ks == 3 else S.conv_s2_ct_diff
    val = torch.sin(diff(xt, wt, bt, act=act)).sum()
    return float(val), [g.numpy() for g in torch.autograd.grad(val, (wt, bt, xt))]


@pytest.mark.parametrize("ks,P,c,co,act", [(3, 2, 8, 8, "relu"), (3, 4, 8, 16, None),
                                            (3, 4, 3, 8, "lrelu"), (4, 2, 8, 8, None),
                                            (4, 4, 8, 16, "lrelu"), (4, 4, 3, 8, "relu")])
def test_stage_diff_grads_match_pallas_vjp(ks, P, c, co, act):
    w, b, x = _mk(4 + ks, c, co, ks)
    jv, jg = _jax_grads(ks, w, b, x, P, act)
    pv, pg = _port_grads(ks, w, b, x, act)
    assert abs(pv - jv) <= 1e-5 * max(1.0, abs(jv))
    for name, got, want in zip(("dW", "db", "dx"), pg, jg):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), name


@pytest.mark.parametrize("ks", [3, 4])
@pytest.mark.parametrize("act", [None, "relu", "lrelu"])
def test_explicit_backward_twin_matches_autograd_of_forward_twin(ks, act):
    w, b, x = _mk(9, 3, 8, ks)
    wt, bt, xt = (torch.from_numpy(a).requires_grad_() for a in (w, b, x))
    fwd, bwd = ((S.conv_s1_ct_plain, S.conv_s1_ct_bwd_plain) if ks == 3 else
                (S.conv_s2_ct_plain, S.conv_s2_ct_bwd_plain))
    out = fwd(xt, wt, bt, act=act)
    g = torch.from_numpy(np.random.RandomState(1).randn(*out.shape).astype(np.float32))
    want = torch.autograd.grad(out, (xt, wt, bt), g)
    saved = None if act is None else out.detach()
    got = bwd(xt.detach(), wt.detach(), saved, g, act=act)
    for key, ref in zip(("dx", "w", "b"), want):
        assert (got[key] - ref).abs().max() <= 1e-5 * max(1.0, ref.abs().max()), key
    # only the half that was asked for is computed
    half = bwd(xt.detach(), wt.detach(), saved, g, act=act, need_dw=False)
    assert half["w"] is None and half["b"] is None and torch.equal(half["dx"], got["dx"])
    half = bwd(xt.detach(), wt.detach(), saved, g, act=act, need_dx=False)
    assert half["dx"] is None and torch.equal(half["w"], got["w"])


def test_bf16_backward_rounds_dz_once_and_sums_db_unrounded():
    """dz is rounded to bf16 for both products, db sums it in fp32 unrounded,
    dW and db leave in fp32, dx in bf16; the gate reads the saved output."""
    bf = torch.bfloat16
    w, b, x = _mk(11, 8, 8, 3)
    wk, bias = S.prepare_stage_ct(torch.from_numpy(w), torch.from_numpy(b), bf)
    xt = torch.from_numpy(x).to(bf)
    out = S.conv_s1_ct(xt, wk, bias, act="lrelu")
    g = torch.from_numpy(np.random.RandomState(2).randn(*out.shape).astype(np.float32)).to(bf)
    r = S.conv_s1_ct_bwd(xt, wk, out, g, act="lrelu")
    assert r["dx"].dtype == bf and r["w"].dtype == r["b"].dtype == torch.float32
    dz = torch.where(out >= 0, g.float(), g.float() * 0.2)
    assert torch.allclose(r["b"], dz.sum((0, 1, 2)), atol=1e-4)
    # db from the ROUNDED dz is measurably different: the bar above is tight
    assert (dz.to(bf).float().sum((0, 1, 2)) - r["b"]).abs().max() > 1e-3
    dw_ref = torch.nn.grad.conv2d_weight(
        xt.float().permute(0, 3, 1, 2), (8, 8, 3, 3), dz.to(bf).float().permute(0, 3, 1, 2),
        padding=1).permute(2, 3, 1, 0)
    assert (r["w"] - dw_ref).abs().max() <= 1e-4 * dw_ref.abs().max()


def test_frozen_weights_launch_no_weight_half(monkeypatch):
    """The autograd Function asks only for what needs a gradient: frozen
    weights (the perceptual net, D in the G phase) → dx only; an image input
    (D's first conv in the D phase) → dW/db only."""
    asked = []
    real = S._bwd_plain

    def spy(ks, x, w, out, g, act, slope, need_dx, need_dw):
        asked.append((need_dx, need_dw))
        return real(ks, x, w, out, g, act, slope, need_dx, need_dw)

    monkeypatch.setattr(S, "_bwd_plain", spy)
    w, b, x = _mk(12, 3, 8, 3)
    wt, bt, xt = (torch.from_numpy(a) for a in (w, b, x))
    S.conv_s1_ct_diff(xt.clone().requires_grad_(), wt, bt, act="relu").sum().backward()
    S.conv_s1_ct_diff(xt, wt.clone().requires_grad_(), bt.clone().requires_grad_()).sum().backward()
    assert asked == [(True, False), (False, True)]


def test_wrappers_validate_their_arguments():
    w, b, x = _mk(13, 3, 8, 4)
    wt, bt = S.prepare_stage_ct(torch.from_numpy(w), torch.from_numpy(b), torch.float32)
    with pytest.raises(ValueError, match="act"):
        S.conv_s1_ct(torch.from_numpy(x), wt, bt, act="tanh")
    with pytest.raises(ValueError, match="even"):
        S.conv_s2_ct(torch.from_numpy(x[:, :15]), wt, bt)
    with pytest.raises(ValueError, match="saved forward output"):
        S.conv_s2_ct_bwd(torch.from_numpy(x), wt, None, torch.zeros(B, 8, 8, 8), act="relu")
    with pytest.raises(ValueError, match="128"):
        S.require_stage_widths(256, 64)
    with pytest.raises(ValueError, match="cout"):
        S.require_stage_widths(64, 24)
    # the weight-gradient split is a function of the shapes alone
    assert S.stage_wgrad_parts(16, 128, 128, 3, 64, 3) == S.stage_wgrad_parts(16, 128, 128, 3, 64, 3)
    assert 1 <= S.stage_wgrad_parts(2, 8, 8, 3, 8, 4) <= 128


@pytest.fixture(scope="module")
def s2_lrelu_vjp():
    """The JAX 4×4 stride-2 kernel's custom VJP (interpret mode) of Σ sin(out)
    at one small shape with an lrelu gate: inputs and (value, [dW, db, dx])."""
    w, b, x = _mk(14, 8, 16, 4)
    return (w, b, x), _jax_grads(4, w, b, x, 4, "lrelu")


def test_phase_fold_dx_matches_pallas_vjp(s2_lrelu_vjp):
    """dx as the tensor-core design folds it (four per-phase 2×2 convs of the
    gated dz over w[3−a−2i][3−b−2j], ``s2_dgrad_fold_plain``) is the TPU
    kernel's data gradient within 1e-4, in fp32."""
    (w, b, x), (_, jg) = s2_lrelu_vjp
    wt, bt, xt = (torch.from_numpy(a) for a in (w, b, x))
    out = S.conv_s2_ct_plain(xt, wt, bt, act="lrelu")
    dz = S._act_adj(torch.cos(out), out, "lrelu", 0.2)
    got = S.s2_dgrad_fold_plain(dz, wt).numpy()
    assert got.shape == jg[2].shape
    assert np.abs(got - jg[2]).max() <= 1e-4 * np.abs(jg[2]).max()


def test_s2_diff_grads_match_pallas_vjp_with_a_gate(s2_lrelu_vjp):
    """The same VJP through the port's ``conv_s2_ct_diff`` (the twins on the
    CPU): value 1e-5, dW / db / dx 1e-4 of max|ref|."""
    (w, b, x), (jv, jg) = s2_lrelu_vjp
    pv, pg = _port_grads(4, w, b, x, "lrelu")
    assert abs(pv - jv) <= 1e-5 * max(1.0, abs(jv))
    for name, got, want in zip(("dW", "db", "dx"), pg, jg):
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), name
