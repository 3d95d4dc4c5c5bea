"""The port's train-mode RRDBNet (``rrdbnet_forward(train=True)``) against
the JAX package's, value and every gradient, with JAX's noise realisation
fed in.

The test replays JAX's key schedule (``split(rng, nb)`` → ``split(key, 4)``
→ ``normal(ks[i], (B, H, W, nf))``, esrganplus_tpu/models/rrdb.py) and hands
the tensors to the port, so both sides see the same noise. Two paths on each
side: the plain graph against ``trunk_kernel="xla"``, and the kernel path
(``"cuda"``, on the CPU the kernels' plain twins with their explicit
backward) against ``"pallas"`` in interpret mode. Bars are the JAX suite's
for the same comparison (tests/test_kernels.py): loss ≤1e-5, every gradient
leaf ≤1e-3 of max|ref|. nb=2, nf=16, gc=8, ×4; init scale 0.5 keeps the
output O(1).
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

B, H, W, NB, NF, GC = 2, 8, 8, 2, 16, 8


def _jax_noise(rng, cfg):
    return [[np.asarray(jax.random.normal(k, (B, H, W, cfg.nf), jnp.float32))
             for k in jax.random.split(bk, 4)] for bk in jax.random.split(rng, cfg.nb)]


def _leaves(tree):
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in _leaves(v)]
    return [tree]


def _jax_side(jcfg, jp, x, rng):
    def loss(params):
        out = jrrdb.rrdbnet_forward(params, jnp.asarray(x), jcfg, train=True, rng=rng)
        return jnp.mean(jnp.abs(out - 0.5))

    v, g = jax.value_and_grad(loss)(jp)
    return float(v), [np.asarray(l) for l in jax.tree.leaves(g)]


def _port_side(pcfg, pp, x, noise):
    leaves = _leaves(pp)
    for l in leaves:
        l.requires_grad_()
    sites = [[torch.from_numpy(n) if on else None
              for n, on in zip(s, (pcfg.rdb_noise,) * 3 + (pcfg.rrdb_noise,))] for s in noise]
    out = prrdb.rrdbnet_forward(pp, torch.from_numpy(x), pcfg, train=True, noise=sites)
    loss = (out - 0.5).abs().mean()
    return loss.item(), [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def _pair(**kw):
    jcfg = jrrdb.RRDBNetConfig(nf=NF, nb=NB, gc=GC, noise_sigma=0.1, **kw)
    jp = jrrdb.init_rrdbnet(jax.random.PRNGKey(0), jcfg, init_scale=0.5)
    pcfg = prrdb.RRDBNetConfig(nf=NF, nb=NB, gc=GC, noise_sigma=0.1, **kw)
    return jcfg, jp, pcfg, from_jax_params(jax.tree.map(np.asarray, jp), pcfg)


@pytest.mark.parametrize("path", ["plain", "kernel"])
@pytest.mark.parametrize("variant", ["rdb_noise", "detach", "rrdb_noise"])
def test_train_forward_and_grads_match_jax(variant, path):
    kw = {"detach": dict(noise_relative_detach=True),
          "rrdb_noise": dict(rrdb_noise=True)}.get(variant, {})
    jcfg, jp, pcfg, pp = _pair(**kw)
    jk, pk = ("xla", "plain") if path == "plain" else ("pallas", "cuda")
    jcfg = dataclasses.replace(jcfg, trunk_kernel=jk, fused=path == "kernel")
    pcfg = dataclasses.replace(pcfg, trunk_kernel=pk, tail_kernel=pk)
    x = np.random.RandomState(1).rand(B, H, W, 3).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    vj, gj = _jax_side(jcfg, jp, x, rng)
    vp, gp = _port_side(pcfg, pp, x, _jax_noise(rng, jcfg))
    assert abs(vp - vj) <= 1e-5
    assert len(gp) == len(gj)
    for i, (a, b) in enumerate(zip(gp, gj)):
        assert a.shape == b.shape
        assert np.abs(a - b).max() / (np.abs(b).max() + 1e-6) <= 1e-3, i


def test_train_noise_changes_the_output_and_needs_a_source():
    _, _, pcfg, pp = _pair()
    x = torch.rand(1, 6, 6, 3)
    with pytest.raises(ValueError, match="rng"):
        prrdb.rrdbnet_forward(pp, x, pcfg, train=True)
    gen = torch.Generator().manual_seed(0)
    a = prrdb.rrdbnet_forward(pp, x, pcfg, train=True, rng=gen)
    b = prrdb.rrdbnet_forward(pp, x, pcfg, train=True, rng=gen.manual_seed(0))
    quiet = prrdb.rrdbnet_forward(pp, x, pcfg)
    assert torch.equal(a, b) and (a - quiet).abs().max() > 1e-4
    # sigma 0 or no site: train mode is the eval graph
    off = dataclasses.replace(pcfg, rdb_noise=False)
    assert torch.equal(prrdb.rrdbnet_forward(pp, x, off, train=True), quiet)


def test_train_kernel_path_bf16_close_to_fp32_plain():
    """bf16 compute on the kernel path (fp32 masters cast inside the
    Functions): loss within 2e-2 relative of the fp32 plain graph's, every
    gradient finite and the whole gradient's cosine ≥ 0.99."""
    _, _, pcfg, pp = _pair()
    x = np.random.RandomState(2).rand(B, H, W, 3).astype(np.float32)
    noise = _jax_noise(jax.random.PRNGKey(4), pcfg)
    plain = dataclasses.replace(pcfg, trunk_kernel="plain", tail_kernel="plain")
    kern = dataclasses.replace(pcfg, trunk_kernel="cuda", tail_kernel="cuda")
    v32, g32 = _port_side(plain, pp, x, noise)
    leaves = _leaves(pp)
    sites = [[torch.from_numpy(n) if i < 3 else None for i, n in enumerate(s)] for s in noise]
    out = prrdb.rrdbnet_forward(pp, torch.from_numpy(x), kern, train=True, noise=sites,
                                dtype=torch.bfloat16)
    loss = (out - 0.5).abs().mean()
    g16 = [g.numpy() for g in torch.autograd.grad(loss, leaves)]
    assert abs(loss.item() - v32) / v32 <= 2e-2
    a = np.concatenate([g.ravel() for g in g16])
    b = np.concatenate([g.ravel() for g in g32])
    assert np.isfinite(a).all()
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.99
