"""The port's RRDBNet (esrganplus_tpu_torch/models/rrdb.py) against the JAX
package's ``rrdbnet_forward``, with identical weights carried across by
``from_jax_params``.

Bars are the JAX suite's: fp32 whole-net parity ≤1e-5 (tests/test_rrdb.py),
kernel path ≤1e-4 (the kernel bar), bf16 ≤0.05 against the fp32 output
(tests/test_rrdb.py::test_bf16_compute_close_to_fp32). Weights use init scale
0.5, which keeps outputs O(1) (the default 0.1 makes them ~1e-4, where any
absolute bar is empty).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrganplus_tpu.models import rrdb as jrrdb
from esrganplus_tpu_torch.convert import from_jax_params
from esrganplus_tpu_torch.models import rrdb as prrdb

B, H, W = 2, 7, 10


def _nets(upscale=4, nb=2, nf=16, gc=8, seed=0, **kw):
    jcfg = jrrdb.RRDBNetConfig(nf=nf, nb=nb, gc=gc, upscale=upscale, **kw)
    jp = jrrdb.init_rrdbnet(jax.random.PRNGKey(seed), jcfg, init_scale=0.5)
    pcfg = prrdb.RRDBNetConfig(nf=nf, nb=nb, gc=gc, upscale=upscale, **kw)
    pp = from_jax_params(jax.tree.map(np.asarray, jp), pcfg)
    return jcfg, jp, pcfg, pp


def _x(h=H, w=W, b=B, seed=1):
    return np.random.RandomState(seed).rand(b, h, w, 3).astype(np.float32)


def _port(pp, pcfg, x, dtype=None, path=None, **cfg_kw):
    """The port's forward; ``path`` sets both trunk_kernel and tail_kernel.
    A kernel path gets its weights from ``prep_trunk_ct``, as at load."""
    if path is not None:
        cfg_kw = dict(trunk_kernel=path, tail_kernel=path, **cfg_kw)
    cfg = dataclasses.replace(pcfg, **cfg_kw)
    xt = torch.from_numpy(x)
    if prrdb.needs_kernel_weights(cfg, xt.device, dtype or xt.dtype):
        pp = prrdb.prep_trunk_ct(pp, cfg, dtype or xt.dtype)
    return prrdb.rrdbnet_forward(pp, xt, cfg, dtype=dtype).numpy()


@pytest.mark.parametrize("upscale", [4, 2, 3])
def test_plain_net_matches_jax_fp32(upscale):
    jcfg, jp, pcfg, pp = _nets(upscale=upscale)
    x = _x()
    want = np.asarray(jrrdb.rrdbnet_forward(jp, jnp.asarray(x), jcfg))
    got = _port(pp, pcfg, x)
    assert got.shape == (B, upscale * H, upscale * W, 3) == want.shape
    assert np.abs(want).max() > 0.1
    assert np.abs(got - want).max() <= 1e-5


def test_plain_net_unfused_tail_matches_jax_x3():
    """``fused=False``: nearest-×3 then conv, not the phase-folded conv."""
    jcfg, jp, pcfg, pp = _nets(upscale=3, nb=1, fused=False)
    x = _x()
    want = np.asarray(jrrdb.rrdbnet_forward(jp, jnp.asarray(x), jcfg))
    assert np.abs(_port(pp, pcfg, x) - want).max() <= 1e-5


@pytest.mark.parametrize("upscale", [4, 2])
def test_kernel_path_structure_matches_jax_pallas(upscale):
    """The kernel path's chain (rdb_ct ×3nb with the RRDB fold, conv3x3_ct,
    upfold_ct, conv_hr_ct) on the CPU — the kernels' plain twins — against
    JAX's Pallas trunk and tail in interpret mode."""
    jcfg, jp, pcfg, pp = _nets(upscale=upscale)
    x = _x()
    want = np.asarray(jrrdb.rrdbnet_forward(
        jp, jnp.asarray(x), dataclasses.replace(jcfg, trunk_kernel="pallas")))
    got = _port(pp, pcfg, x, path="cuda")
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_kernel_path_x3_keeps_plain_tail():
    jcfg, jp, pcfg, pp = _nets(upscale=3, nb=1)
    assert not prrdb.use_cuda_tail(pcfg, "cuda", torch.float32)
    with pytest.raises(ValueError, match="upscale=3"):
        prrdb.use_cuda_tail(dataclasses.replace(pcfg, tail_kernel="cuda"), "cpu", torch.float32)
    x = _x()
    want = np.asarray(jrrdb.rrdbnet_forward(jp, jnp.asarray(x), jcfg))
    np.testing.assert_allclose(_port(pp, pcfg, x, trunk_kernel="cuda"), want,
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("path", ["plain", "cuda"])
def test_bf16_matches_jax_bf16(path):
    jcfg, jp, pcfg, pp = _nets()
    x = _x()
    jk = "pallas" if path == "cuda" else "xla"
    want = np.asarray(jrrdb.rrdbnet_forward(
        jp, jnp.asarray(x), dataclasses.replace(jcfg, trunk_kernel=jk), dtype=jnp.bfloat16))
    want32 = np.asarray(jrrdb.rrdbnet_forward(jp, jnp.asarray(x), jcfg))
    got = _port(pp, pcfg, x, dtype=torch.bfloat16, path=path)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() < 0.05
    assert np.abs(got - want32).max() < 0.05


def test_flagship_widths_match_jax_fp32():
    """nb=23, nf=64, gc=32, ×4 at 12×16 LR: the plain graph and the kernel
    path's chain both within 1e-4 of JAX's XLA forward."""
    jcfg, jp, pcfg, pp = _nets(nb=23, nf=64, gc=32)
    x = _x(12, 16, b=1)
    want = np.asarray(jrrdb.rrdbnet_forward(jp, jnp.asarray(x), jcfg))
    assert np.abs(want).max() > 0.1
    for path in ("plain", "cuda"):
        got = _port(pp, pcfg, x, path=path)
        assert np.abs(got - want).max() <= 1e-4, path


def test_activations_match_jax():
    jcfg, jp, pcfg, pp = _nets(nb=3)
    x = _x()
    want = jrrdb.rrdbnet_activations(jp, jnp.asarray(x), jcfg)
    got = prrdb.rrdbnet_activations(pp, torch.from_numpy(x), pcfg)
    assert list(got) == list(want)
    assert list(got)[:5] == ["fea_conv", "rrdb_00", "rrdb_01", "rrdb_02", "trunk"]
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), atol=1e-5,
                                   err_msg=name)


def test_config_kernel_aliases_and_gates():
    cfg = prrdb.RRDBNetConfig(trunk_kernel="xla", tail_kernel="pallas")
    assert (cfg.trunk_kernel, cfg.tail_kernel) == ("plain", "cuda")
    with pytest.raises(ValueError):
        prrdb.RRDBNetConfig(trunk_kernel="triton")
    # noise_kernel takes the JAX package's three values; unroll (a JAX compile
    # knob) any int >= 0, changing nothing here; anything else raises
    for nk in ("input", "xla", "fused"):
        assert prrdb.RRDBNetConfig(noise_kernel=nk).noise_kernel == nk
    for n in (0, 1, 23, 99):
        assert prrdb.RRDBNetConfig(unroll=n).unroll == n
    for bad in (dict(noise_kernel="rbg"), dict(unroll=-1), dict(unroll=1.5)):
        with pytest.raises(ValueError, match="noise_kernel|unroll"):
            prrdb.RRDBNetConfig(**bad)
    auto = prrdb.RRDBNetConfig()
    assert not prrdb.use_cuda_trunk(auto, "cpu", torch.float32)
    assert not prrdb.use_cuda_tail(auto, "cpu", torch.float32)
    assert prrdb.use_cuda_trunk(auto, "cuda", torch.bfloat16)
    assert prrdb.use_cuda_trunk(auto, "cuda", torch.float32)
    assert prrdb.use_cuda_tail(auto, "cuda", torch.bfloat16)
    assert prrdb.use_cuda_tail(dataclasses.replace(auto, upscale=2), "cuda", torch.float32)
    assert not prrdb.use_cuda_tail(dataclasses.replace(auto, upscale=3), "cuda", torch.float32)
    # on the card, "auto" never gives way to the plain graph: a config the
    # kernels cannot take raises
    with pytest.raises(ValueError, match="float16"):
        prrdb.use_cuda_trunk(auto, "cuda", torch.float16)
    with pytest.raises(ValueError, match="nf=48"):
        prrdb.use_cuda_trunk(dataclasses.replace(auto, nf=48), "cuda", torch.float32)
    with pytest.raises(ValueError, match="out_nc=9"):
        prrdb.use_cuda_tail(dataclasses.replace(auto, out_nc=9), "cuda", torch.float32)
    # "plain" is the way to the plain graph on the card; "cuda" holds anywhere
    plain = prrdb.RRDBNetConfig(trunk_kernel="plain", tail_kernel="plain", nf=48)
    assert not prrdb.needs_kernel_weights(plain, "cuda", torch.float16)
    forced = prrdb.RRDBNetConfig(trunk_kernel="plain", tail_kernel="cuda")
    assert not prrdb.use_cuda_trunk(forced, "cpu", torch.float32)
    assert prrdb.use_cuda_tail(forced, "cpu", torch.float32)


def test_tail_kernel_cuda_after_plain_trunk(monkeypatch):
    """tail_kernel="cuda" runs the kernel tail after a plain trunk (here the
    kernels' twins), and matches JAX's XLA forward."""
    from esrganplus_tpu_torch.kernels import tail_ct

    calls = []
    for name in ("upfold_ct", "conv_hr_ct"):
        fn = getattr(tail_ct, name)
        monkeypatch.setattr(tail_ct, name,
                            lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))
    jcfg, jp, pcfg, pp = _nets()
    x = _x()
    want = np.asarray(jrrdb.rrdbnet_forward(jp, jnp.asarray(x), jcfg))
    got = _port(pp, pcfg, x, trunk_kernel="plain", tail_kernel="cuda")
    assert calls == ["upfold_ct", "upfold_ct", "conv_hr_ct"]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_init_param_count_matches_jax_flagship():
    cfg = prrdb.RRDBNetConfig()
    jp = jrrdb.init_rrdbnet(jax.random.PRNGKey(0), jrrdb.RRDBNetConfig())
    assert prrdb.count_params(prrdb.init_rrdbnet(cfg)) == jrrdb.count_params(jp)


def test_prep_trunk_ct_converts_once_and_keeps_canonical():
    """The kernels' weights come from prep_trunk_ct, once: the forward does
    not convert them itself and refuses a tree without them at its dtype."""
    _, _, pcfg, pp = _nets()
    prepped = prrdb.prep_trunk_ct(pp, pcfg, torch.float32)
    assert prepped["trunk"] is pp["trunk"] and len(prepped["trunk_ct"]["blocks"]) == pcfg.nb
    assert len(prepped["tail_ct"]["upconvs"]) == 2
    x = _x()
    cfg = dataclasses.replace(pcfg, trunk_kernel="cuda", tail_kernel="cuda")
    xt = torch.from_numpy(x)
    for params, dtype in ((pp, None), (prepped, torch.bfloat16)):
        with pytest.raises(ValueError, match="prep_trunk_ct"):
            prrdb.rrdbnet_forward(params, xt, cfg, dtype=dtype)
    a = prrdb.rrdbnet_forward(prepped, xt, cfg).numpy()
    np.testing.assert_array_equal(a, _port(pp, pcfg, x, path="cuda"))
    np.testing.assert_allclose(a, _port(pp, pcfg, x, path="plain"), atol=1e-4, rtol=1e-4)
