"""The fused noise mode's counter-based normals (``kernels/philox.py``) and
their per-site keys (``train/rng.py::site_seeds``).

The TPU kernel draws from the core's hardware PRNG, which cannot be replayed
off a TPU, so parity with the JAX package is statistical for the bits and
exact for the arithmetic around them:

  * the twin's Philox4x32-10 gives the Random123 known-answer vectors;
  * its Box-Muller is the JAX kernel's own ``_kernel_normal`` applied to the
    same bits (``pltpu.prng_random_bits`` replaced by the Philox words);
  * element (b, y, x, c) is Philox of counter (c, x, y, b) under the site's
    key, whatever the rest of the shape (a scalar reimplementation with
    Python ints holds the packing);
  * 2²⁰ draws have mean and standard deviation within 5e-3 of 0 and 1, and
    two sites are uncorrelated within 5e-3.

The device function (``csrc/philox.cuh``) is held against this twin on the
card by tests/test_torch_cuda.py and ``chip_smoke.py``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrganplus_tpu.kernels import rdb_ct as jrdb
from esrganplus_tpu_torch.kernels.philox import philox4x32_10, philox_normal
from esrganplus_tpu_torch.train.rng import site_seeds, step_seed

M32 = 0xFFFFFFFF


def _philox_int(ctr, key):
    """Philox4x32-10 on Python ints: the reference the tensor twin is held to."""
    c, (k0, k1) = list(ctr), key
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & M32, (p0 >> 32) ^ c[3] ^ k1, p0 & M32]
        k0, k1 = (k0 + 0x9E3779B9) & M32, (k1 + 0xBB67AE85) & M32
    return c


@pytest.mark.parametrize("ctr, key, want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32,) * 4, (M32, M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
], ids=["zeros", "ones", "pi"])
def test_philox_known_answer_vectors(ctr, key, want):
    got = philox4x32_10([torch.tensor([c]) for c in ctr], key)
    assert tuple(int(w) for w in got) == want
    assert tuple(_philox_int(ctr, key)) == want


def test_counter_packing_is_the_element_coordinates():
    seed = (0x12345678, 0x9ABCDEF0)
    n = philox_normal(seed, (2, 3, 4, 5))
    for b, y, x, c in ((0, 0, 0, 0), (1, 2, 3, 4), (1, 0, 2, 3), (0, 2, 1, 1)):
        r = _philox_int((c, x, y, b), seed)
        u1 = np.float32(r[0] >> 8) * np.float32(2 ** -24) + np.float32(2 ** -25)
        u2 = np.float32(r[1] >> 8) * np.float32(2 ** -24)
        want = math.sqrt(-2.0 * math.log(u1)) * math.cos(2 * math.pi * u2)
        assert abs(n[b, y, x, c].item() - want) <= 1e-5, (b, y, x, c)


def test_box_muller_is_the_jax_kernels_arithmetic(monkeypatch):
    """``_kernel_normal`` (esrganplus_tpu/kernels/rdb_ct.py) on the Philox
    words r0 and r1 of every element gives the twin's normals."""
    seed, shape = (7, 11), (2, 5, 6, 8)
    B, H, W, C = shape
    ar = lambda n, view: torch.arange(n).view(view).expand(shape)
    r0, r1, _, _ = philox4x32_10([ar(C, (1, 1, 1, C)), ar(W, (1, 1, W, 1)),
                                  ar(H, (1, H, 1, 1)), ar(B, (B, 1, 1, 1))], seed)
    words = [jnp.asarray(r.numpy().astype(np.uint32).view(np.int32)) for r in (r0, r1)]
    monkeypatch.setattr(jrdb.pltpu, "prng_random_bits", lambda s: words.pop(0))
    want = np.asarray(jrdb._kernel_normal(shape))
    got = philox_normal(seed, shape).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_draw_does_not_depend_on_the_rest_of_the_shape():
    seed = (3, 4)
    big = philox_normal(seed, (3, 7, 9, 16))
    assert torch.equal(philox_normal(seed, (1, 7, 9, 16))[0], big[0])
    assert torch.equal(philox_normal(seed, (3, 4, 9, 16)), big[:, :4])
    assert torch.equal(philox_normal(seed, (2, 7, 5, 8)), big[:2, :, :5, :8])
    assert not torch.equal(philox_normal((3, 5), (3, 7, 9, 16)), big)


def test_normals_have_unit_statistics_and_sites_are_uncorrelated():
    shape = (4, 64, 64, 64)  # 2^20 draws
    a = philox_normal((0xDEADBEEF, 1), shape).double()
    b = philox_normal((0xDEADBEEF, 2), shape).double()
    assert a.numel() == 2 ** 20 and a.dtype == torch.float64 and torch.isfinite(a).all()
    for n in (a, b):
        assert abs(n.mean().item()) < 5e-3
        assert abs(n.std().item() - 1.0) < 5e-3
    corr = ((a - a.mean()) * (b - b.mean())).mean() / (a.std() * b.std())
    assert abs(corr.item()) < 5e-3
    # neighbouring channels of one site are uncorrelated too
    c0, c1 = a[..., 0::2].flatten(), a[..., 1::2].flatten()
    assert abs(torch.corrcoef(torch.stack([c0, c1]))[0, 1].item()) < 5e-3


def test_site_seeds_are_a_pure_function_of_seed_and_step():
    s = site_seeds(5, 12, 3)
    assert s == site_seeds(5, 12, 3)
    assert len(s) == 3 and all(len(row) == 3 for row in s)
    words = [w for row in s for pair in row for w in pair]
    assert all(isinstance(w, int) and 0 <= w <= M32 for w in words)
    assert len({pair for row in s for pair in row}) == 9  # every site its own key
    assert s != site_seeds(5, 13, 3) and s != site_seeds(6, 12, 3)
    assert site_seeds(5, 12, 5)[:3] == s  # a deeper trunk keeps the first blocks' keys
    # the same (seed, step) fold as the generator the other modes draw from
    assert step_seed(5, 12) == step_seed(5, 12) != step_seed(5, 11)
