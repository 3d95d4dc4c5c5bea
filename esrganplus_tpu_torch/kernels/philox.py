"""Counter-based standard normals for the fused nESRGAN+ noise mode.

The JAX package's ``noise_kernel="fused"`` draws the relative noise inside
``rdb_ct`` from the TPU core's hardware PRNG and replays the bits in the
backward (``esrganplus_tpu/kernels/rdb_ct.py:98-120``). Those bits cannot be
reproduced off a TPU. The port draws from Philox4x32-10 instead
(``csrc/philox.cuh``): the normal of element (b, y, x, c) of a noise site is
a pure function of the site's two seed words (the key) and of (b, y, x, c)
(the counter), then Box-Muller on two 24-bit uniforms in fp32, the
arithmetic of ``_kernel_normal``. This module is the plain twin of that
device function. ``noise_factor_cuda`` fills the fused mode's fp32 factor
``1 + σ·n`` with the device function (``csrc/philox.cu``): ``rdb_ct_bwd``
takes one per call; ``philox_normal_cuda`` fills the normals themselves, for
the tests and ``chip_smoke.py`` only.
"""

from __future__ import annotations

import torch

from esrganplus_tpu_torch.kernels import build

_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # Random123's Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # and Weyl key increments
_MASK = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``a`` and
    the uint32 values in int64 ``b``, without overflowing int64: ``b`` is
    split into 16-bit halves, so each partial product stays below 2⁴⁸."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def philox4x32_10(ctr, key):
    """Philox4x32-10 on uint32 words held in int64 tensors (or ints): ``ctr``
    four words, ``key`` two; returns the four output words."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in ctr)
    k0, k1 = int(key[0]) & _MASK, int(key[1]) & _MASK
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def philox_normal(seed, shape, device=None) -> torch.Tensor:
    """The fp32 standard normals of the noise site keyed ``seed`` = (s0, s1)
    over the NHWC ``shape`` (B, H, W, C): element (b, y, x, c) is Philox of
    counter (c, x, y, b), so it does not depend on the rest of the shape."""
    B, H, W, C = shape
    ar = lambda n, view: torch.arange(n, dtype=torch.int64, device=device).view(view)
    ctr = (ar(C, (1, 1, 1, C)), ar(W, (1, 1, W, 1)), ar(H, (1, H, 1, 1)),
           ar(B, (B, 1, 1, 1)))
    r0, r1, _, _ = philox4x32_10([c.expand(B, H, W, C) for c in ctr], seed)
    u1 = (r0 >> 8).float() * 2.0 ** -24 + 2.0 ** -25
    u2 = (r1 >> 8).float() * 2.0 ** -24
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(6.283185307179586 * u2)


def noise_factor_cuda(seed, sigma: float, shape, device) -> torch.Tensor:
    """The fused mode's ``1 + σ·n`` of the site ``seed`` over the NHWC
    ``shape``, fp32 on ``device``, filled by the device function that
    ``rdb_ct``'s epilogue multiplies by (the same values, bit for bit)."""
    B, H, W, C = shape
    out = torch.empty((B, H, W, C), dtype=torch.float32, device=device)
    code = build.load("philox").esr_philox_factor(
        out.data_ptr(), int(seed[0]), int(seed[1]), float(sigma), B, H, W, C,
        torch.cuda.current_stream(out.device).cuda_stream)
    build.check(code, "esr_philox_factor")
    return out


def philox_normal_cuda(seed, shape, device="cuda") -> torch.Tensor:
    """The same draws from the device function the kernels call
    (``csrc/philox.cu``), as an fp32 CUDA tensor. Not on any model path."""
    B, H, W, C = shape
    out = torch.empty((B, H, W, C), dtype=torch.float32, device=device)
    lib = build.load("philox")
    code = lib.esr_philox_normal(out.data_ptr(), int(seed[0]), int(seed[1]), B, H, W, C,
                                 torch.cuda.current_stream(out.device).cuda_stream)
    build.check(code, "esr_philox_normal")
    return out
