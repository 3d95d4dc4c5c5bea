"""The port's workbench (``kernels/workbench/``: ``conv3x3`` and the fused
RDB ``rdb_fused``) against the JAX package's workbench kernels run in
interpret mode.

On the CPU both wrappers run their plain twins, which is what these tests
hold against the Pallas kernels; the CUDA kernels are held against the twins
on the card (tests/test_torch_cuda.py, ``chip_smoke.py``). Bars, relative to
max(1, max|ref|) in fp32 and to max|ref| in bf16: fp32 ≤1e-5 (the JAX suite's
bar; only the fp32 summation order differs); bf16 ≤2e-2 with at most 1 % of
the outputs differing at all (both sides round at the same points, so an fp32
summation-order difference flips an occasional rounding). Inputs come from a
seeded numpy RandomState; each JAX interpret result is computed once per
module (the fused RDB at tile 16 takes about 2 s a call).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import esrganplus_tpu.kernels.workbench.conv as jconv
import esrganplus_tpu.kernels.workbench.rdb as jrdb
from esrganplus_tpu.models import rrdb as jrrdb
from esrganplus_tpu_torch.convert import rdb_fused_weights_from_jax
from esrganplus_tpu_torch.kernels.workbench import conv as C
from esrganplus_tpu_torch.kernels.workbench import rdb as R
from esrganplus_tpu_torch.models import rrdb as prrdb

BF16_DIFFER = 0.01  # share of bf16 outputs that may differ at all


def _interpret(mod, fn, *args, **kw):
    """``fn`` with the module's ``pallas_call`` in interpret mode → numpy fp32."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        return np.asarray(fn(*args, **kw), np.float32)


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    d = np.abs(got - want).max()
    if dtype == "float32":
        assert d <= 1e-5 * max(1.0, np.abs(want).max()), d
    else:
        assert d <= 2e-2 * np.abs(want).max(), d
        assert (got != want).mean() <= BF16_DIFFER, (got != want).mean()


def _t(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _j(a, dtype="float32"):
    return jnp.asarray(np.asarray(a, np.float32), getattr(jnp, dtype))


# ---------------------------------------------------------------------------
# conv3x3
# ---------------------------------------------------------------------------

# name: (dtype, B, H, W, cin, cout, act_slope, bias, tile)
CONV_CASES = {
    "f32_8_24_lrelu": ("float32", 2, 16, 16, 8, 24, 0.2, True, 8),
    "f32_5_7_linear_nobias": ("float32", 2, 16, 24, 5, 7, None, False, None),
    "f32_8_24_relu": ("float32", 2, 16, 24, 8, 24, 0.0, True, 8),
    "bf16_8_24_lrelu": ("bfloat16", 2, 16, 16, 8, 24, 0.2, True, 8),
    "bf16_5_7_relu_nobias": ("bfloat16", 2, 16, 24, 5, 7, 0.0, False, None),
}


def _conv_inputs(name):
    dtype, B, H, W, cin, cout, slope, bias, tile = CONV_CASES[name]
    rs = np.random.RandomState(sorted(CONV_CASES).index(name))
    x = rs.randn(B, H, W, cin).astype(np.float32)
    w = (rs.randn(3, 3, cin, cout) * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
    b = (rs.randn(cout) * 0.1).astype(np.float32) if bias else None
    return dtype, x, w, b, slope, tile


@pytest.fixture(scope="module")
def conv_ref():
    out = {}
    for name in CONV_CASES:
        dtype, x, w, b, slope, tile = _conv_inputs(name)
        out[name] = _interpret(jconv, jconv.conv3x3, _j(x, dtype), _j(w),
                               None if b is None else _j(b), act_slope=slope, tile=tile)
    return out


@pytest.mark.parametrize("name", sorted(CONV_CASES))
def test_conv3x3_matches_jax(conv_ref, name):
    dtype, x, w, b, slope, tile = _conv_inputs(name)
    got = C.conv3x3(_t(x, dtype), _t(w), None if b is None else _t(b), act_slope=slope,
                    tile=tile)
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), conv_ref[name], dtype)


@pytest.mark.parametrize("hw,tile,want", [((16, 24), None, 8), ((64, 128), None, 64),
                                          ((32, 96), None, 32), ((16, 16), 8, 8)])
def test_conv3x3_tile_pick(hw, tile, want):
    assert C.pick_tile(*hw, tile) == want


@pytest.mark.parametrize("hw,tile", [((20, 20), None), ((20, 16), 8), ((16, 24), 16),
                                     ((16, 16), 0)])
def test_conv3x3_tile_contract_raises(hw, tile):
    """Untileable sizes and explicit tiles that do not divide H and W raise,
    where the JAX kernel leaves the rows past the last whole tile unwritten."""
    x = torch.zeros((1, *hw, 4))
    with pytest.raises(ValueError):
        C.conv3x3(x, torch.zeros((3, 3, 4, 4)), tile=tile)


# ---------------------------------------------------------------------------
# rdb_fused
# ---------------------------------------------------------------------------


def _rdb_params(rs, nf, gc, conv1x1):
    conv = lambda cin, cout, k=3: (rs.randn(k, k, cin, cout)
                                   * np.sqrt(2.0 / (k * k * cin))).astype(np.float32)
    p = {f"conv{k}": {"w": conv(nf + (k - 1) * gc, nf if k == 5 else gc),
                      "b": (rs.randn(nf if k == 5 else gc) * 0.1).astype(np.float32)}
         for k in range(1, 6)}
    if conv1x1:
        p["conv1x1"] = {"w": conv(nf, gc, k=1)}
    return p


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in p.items()}


# name: (x dtype, weight dtype, nf, gc, H, W, conv1x1, slope, res_scale)
RDB_CASES = {
    "f32_1x1_32x32": ("float32", "float32", 8, 4, 32, 32, True, 0.2, 0.2),
    "f32_no1x1_32x16": ("float32", "float32", 8, 4, 32, 16, False, 0.1, 0.3),
    "bf16_1x1_32x32": ("bfloat16", "bfloat16", 16, 8, 32, 32, True, 0.2, 0.2),
    "bf16_no1x1_32x16": ("bfloat16", "bfloat16", 8, 4, 32, 16, False, 0.1, 0.3),
    "f32x_bf16w_1x1_32x16": ("float32", "bfloat16", 8, 4, 32, 16, True, 0.2, 0.2),
}
TILE = 16


def _rdb_inputs(name):
    xd, wd, nf, gc, H, W, conv1x1, slope, res_scale = RDB_CASES[name]
    rs = np.random.RandomState(10 + sorted(RDB_CASES).index(name))
    p = _rdb_params(rs, nf, gc, conv1x1)
    x = rs.randn(2, H, W, nf).astype(np.float32)
    kw = dict(nf=nf, gc=gc, conv1x1=conv1x1, slope=slope, res_scale=res_scale, tile=TILE)
    return xd, wd, p, x, kw


def _jax_weights(p, nf, gc, conv1x1, wd):
    return jrdb.prepare_rdb_weights(_tree(p, jnp.asarray), nf, gc, conv1x1,
                                    dtype=getattr(jnp, wd))


@pytest.fixture(scope="module")
def rdb_ref():
    out = {}
    for name in RDB_CASES:
        xd, wd, p, x, kw = _rdb_inputs(name)
        jws = _jax_weights(p, kw["nf"], kw["gc"], kw["conv1x1"], wd)
        out[name] = (_interpret(jrdb, jrdb.rdb_fused, _j(x, xd), *jws, **kw),
                     [np.asarray(w) for w in jws])
    return out


@pytest.mark.parametrize("name", sorted(RDB_CASES))
def test_rdb_fused_matches_jax(rdb_ref, name):
    """Interior tile seams, image borders and H ≠ W at tile 16."""
    xd, wd, p, x, kw = _rdb_inputs(name)
    want, jws = rdb_ref[name]
    got = R.rdb_fused(_t(x, xd), *rdb_fused_weights_from_jax(jws), **kw)
    assert got.dtype == getattr(torch, xd) and got.shape == x.shape
    _close(got.float().numpy(), want, xd)


@pytest.mark.parametrize("conv1x1", [True, False], ids=["1x1", "no1x1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prepare_rdb_weights_bit_equal_to_jax(conv1x1, dtype):
    nf, gc = 16, 8
    p = _rdb_params(np.random.RandomState(3), nf, gc, conv1x1)
    jws = [np.asarray(w) for w in _jax_weights(p, nf, gc, conv1x1, dtype)]
    own = R.prepare_rdb_weights(_tree(p, torch.from_numpy), nf, gc, conv1x1,
                                getattr(torch, dtype))
    assert [tuple(w.shape) for w in own[:5]] == R.weight_shapes(nf, gc, conv1x1)
    for i, (a, j) in enumerate(zip(own, jws)):
        want_dt = torch.float32 if i == 5 else getattr(torch, dtype)
        assert a.dtype == want_dt and a.is_contiguous(), i
        assert tuple(a.shape) == j.shape, i
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(j, np.float32), err_msg=i)


@pytest.mark.parametrize("conv1x1", [True, False], ids=["1x1", "no1x1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rdb_fused_weights_from_jax_round_trip(conv1x1, dtype):
    nf, gc = 8, 4
    jws = [np.asarray(w) for w in _jax_weights(
        _rdb_params(np.random.RandomState(4), nf, gc, conv1x1), nf, gc, conv1x1, dtype)]
    got = rdb_fused_weights_from_jax(jws)
    for i, (a, j) in enumerate(zip(got, jws)):
        assert a.dtype == (torch.float32 if i == 5 else getattr(torch, dtype)), i
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(j, np.float32), err_msg=i)
        # and back: the same bits as the JAX array
        back = jnp.asarray(a.float().numpy()).astype(j.dtype)
        np.testing.assert_array_equal(np.asarray(back).view(np.uint8),
                                      np.asarray(j).view(np.uint8), err_msg=i)
    with pytest.raises(ValueError):
        rdb_fused_weights_from_jax(jws[:5])


@pytest.mark.parametrize("conv1x1", [True, False], ids=["1x1", "no1x1"])
def test_rdb_fused_plain_matches_literal_rdb_fp32(conv1x1):
    """The by-source twin against the port's literal plain RDB
    (``models/rrdb.py::_rdb_forward``), fp32, non-default slope and β."""
    nf, gc = 8, 4
    rs = np.random.RandomState(5)
    p = _tree(_rdb_params(rs, nf, gc, conv1x1), torch.from_numpy)
    x = torch.from_numpy(rs.randn(2, 24, 40, nf).astype(np.float32))
    cfg = prrdb.RRDBNetConfig(nf=nf, gc=gc, nb=1, conv1x1=conv1x1, act_slope=0.1,
                              res_scale=0.3)
    want = prrdb._rdb_forward(x, p, cfg, None)
    ws = R.prepare_rdb_weights(p, nf, gc, conv1x1, torch.float32)
    got = R.rdb_fused_plain(x, *ws, nf=nf, gc=gc, conv1x1=conv1x1, slope=0.1, res_scale=0.3,
                            tile=8)
    assert np.abs((got - want).numpy()).max() <= 1e-5 * max(1.0, want.abs().max().item())


def test_rdb_fused_is_forward_only():
    nf, gc = 8, 4
    ws = R.prepare_rdb_weights(_tree(_rdb_params(np.random.RandomState(6), nf, gc, True),
                                     torch.from_numpy), nf, gc, True, torch.float32)
    x = torch.zeros((1, 16, 16, nf), requires_grad=True)
    kw = dict(nf=nf, gc=gc, tile=16)
    with pytest.raises(RuntimeError, match="forward only"):
        R.rdb_fused(x, *ws, **kw)
    w0 = ws[0].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="forward only"):
        R.rdb_fused(x.detach(), w0, *ws[1:], **kw)
    with torch.no_grad():
        assert R.rdb_fused(x, *ws, **kw).shape == x.shape


def test_rdb_fused_rejects_bad_tile_and_dtypes():
    nf, gc = 8, 4
    ws = R.prepare_rdb_weights(_tree(_rdb_params(np.random.RandomState(7), nf, gc, True),
                                     torch.from_numpy), nf, gc, True, torch.float32)
    x = torch.zeros((1, 16, 24, nf))
    with pytest.raises(ValueError, match="divisible"):
        R.rdb_fused(x, *ws, nf=nf, gc=gc, tile=16)
    with pytest.raises(TypeError):  # bf16 activations need bf16 weights
        R.rdb_fused(x.bfloat16(), *ws, nf=nf, gc=gc, tile=8)
    with pytest.raises(ValueError, match="w0"):
        R.rdb_fused(x, *ws, nf=nf, gc=gc, conv1x1=False, tile=8)


def test_kernel_tile_fits_shared_memory():
    """The CUDA kernel's own tile holds x with halo 5 and x1..x4 with halos
    4..1 within a block's 227 KB at the flagship widths in fp32 and bf16."""
    assert R.smem_bytes(torch.float32, 64, 32, R.KERNEL_TILE) == 172032 <= R.MAX_SMEM
    assert R.smem_bytes(torch.bfloat16, 64, 32, R.KERNEL_TILE) == 86016
    assert R.smem_bytes(torch.bfloat16, 64, 32, 16) == 200704 <= R.MAX_SMEM
    assert R.smem_bytes(torch.float32, 64, 32, 16) > R.MAX_SMEM


def test_literal_plain_rdb_matches_jax_by_source_graph_bf16():
    """The port's plain RDB stays literal whatever ``cfg.fused`` says, while
    the JAX package's ``fused=True`` XLA graph (``_rdb_forward_fused``)
    rounds per source in bf16: the two agree within the bf16 bar."""
    nf, gc = 16, 8
    rs = np.random.RandomState(8)
    p = _rdb_params(rs, nf, gc, True)
    x = rs.randn(2, 16, 24, nf).astype(np.float32)
    jcfg = jrrdb.RRDBNetConfig(nf=nf, gc=gc, nb=1)
    want = np.asarray(jrrdb._rdb_forward_fused(_j(x, "bfloat16"), _tree(p, jnp.asarray), jcfg,
                                               jax.random.PRNGKey(0), False, jnp.bfloat16),
                      np.float32)
    pcfg = dataclasses.replace(prrdb.RRDBNetConfig(nf=nf, gc=gc, nb=1), fused=True)
    got = prrdb._rdb_forward(_t(x, "bfloat16"), _tree(p, torch.from_numpy), pcfg,
                             torch.bfloat16).float().numpy()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
