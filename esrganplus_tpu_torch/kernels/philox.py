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
takes one per call; ``philox_normal_cuda`` fills the normals themselves (the
input noise mode's sites of a training step), ``philox_bits_cuda`` the raw
words the resident sampler and WGAN-GP derive their draws from.

A key is a site's two seed words. The kernels read them through a device
pointer, from an int32 tensor of two elements holding the uint32 bit
patterns (:func:`key_words`), so a captured CUDA graph draws with whatever
words that tensor holds at replay; the plain twins take the same tensor (or
a pair of ints). ``philox_normal_cuda.launches`` and
``philox_bits_cuda.launches`` count the launches of those two wrappers;
``noise_factor_cuda`` is counted by ``rdb_ct_bwd``'s ``seeded_launches``.
"""

from __future__ import annotations

import numpy as np
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


def key_words(seed, device=None) -> torch.Tensor:
    """A key as the kernels read it: an int32 tensor ``[2]`` (seed0, seed1)
    on ``device``; ``seed`` such a tensor (returned as it is) or a pair of
    uint32 ints (copied to the device: not inside a captured step)."""
    if torch.is_tensor(seed):
        if seed.shape != (2,) or seed.dtype != torch.int32:
            raise ValueError(f"a Philox key is an int32 tensor [2], got {seed.dtype} "
                             f"{tuple(seed.shape)}")
        return seed
    words = np.array([int(seed[0]) & _MASK, int(seed[1]) & _MASK], np.uint32).view(np.int32)
    return torch.from_numpy(words).to(device)


def _words64(key):
    """The two key words as int64 values in [0, 2³²): 0-dim tensors on the
    key tensor's device, or ints."""
    if torch.is_tensor(key):
        k = key.to(torch.int64) & _MASK
        return k[0], k[1]
    return int(key[0]) & _MASK, int(key[1]) & _MASK


def philox4x32_10(ctr, key):
    """Philox4x32-10 on uint32 words held in int64 tensors (or ints): ``ctr``
    four words, ``key`` two (ints, or a :func:`key_words` tensor); returns
    the four output words."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in ctr)
    k0, k1 = _words64(key)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def philox_normal(seed, shape, device=None) -> torch.Tensor:
    """The fp32 standard normals of the noise site keyed ``seed`` = (s0, s1)
    (ints or a :func:`key_words` tensor) over the NHWC ``shape`` (B, H, W,
    C): element (b, y, x, c) is Philox of counter (c, x, y, b), so it does
    not depend on the rest of the shape."""
    B, H, W, C = shape
    ar = lambda n, view: torch.arange(n, dtype=torch.int64, device=device).view(view)
    ctr = (ar(C, (1, 1, 1, C)), ar(W, (1, 1, W, 1)), ar(H, (1, H, 1, 1)),
           ar(B, (B, 1, 1, 1)))
    r0, r1, _, _ = philox4x32_10([c.expand(B, H, W, C) for c in ctr], seed)
    u1 = (r0 >> 8).float() * 2.0 ** -24 + 2.0 ** -25
    u2 = (r1 >> 8).float() * 2.0 ** -24
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(6.283185307179586 * u2)


def standard_normal(key: torch.Tensor, shape) -> torch.Tensor:
    """:func:`philox_normal` of the key tensor's site on its device: the
    kernel on a CUDA tensor, the twin on the CPU."""
    if key.device.type == "cpu":
        return philox_normal(key, shape)
    return philox_normal_cuda(key, shape, key.device)


def philox_bits(key, n: int, stream: int = 0, device=None) -> torch.Tensor:
    """Plain twin of :func:`philox_bits_cuda`: ``[n, 4]`` int64 words in
    [0, 2³²), row i Philox of counter (i, ``stream``, 0, 0) under ``key``."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    z = torch.zeros_like(i)
    return torch.stack(philox4x32_10((i, z + stream, z, z), key), 1)


def random_bits(key: torch.Tensor, n: int, stream: int = 0) -> torch.Tensor:
    """:func:`philox_bits` on the key tensor's device: the kernel on a CUDA
    tensor, the twin on the CPU."""
    if key.device.type == "cpu":
        return philox_bits(key, n, stream)
    return philox_bits_cuda(key, n, stream)


def philox_bits_cuda(key: torch.Tensor, n: int, stream: int = 0) -> torch.Tensor:
    """``[n, 4]`` int64 words of Philox counter (i, ``stream``, 0, 0) under
    the device key ``key`` (:func:`key_words`), drawn by ``esr_philox_bits``
    into int32 and widened here to [0, 2³²)."""
    key = key_words(key)
    out = torch.empty((n, 4), dtype=torch.int32, device=key.device)
    code = build.load("philox").esr_philox_bits(
        out.data_ptr(), key.data_ptr(), n, stream,
        torch.cuda.current_stream(key.device).cuda_stream)
    build.check(code, "esr_philox_bits")
    philox_bits_cuda.launches += 1
    return out.to(torch.int64) & _MASK


philox_bits_cuda.launches = 0


def noise_factor_cuda(seed, sigma: float, shape, device) -> torch.Tensor:
    """The fused mode's ``1 + σ·n`` of the site ``seed`` over the NHWC
    ``shape``, fp32 on ``device``, filled by the device function that
    ``rdb_ct``'s epilogue multiplies by (the same values, bit for bit)."""
    B, H, W, C = shape
    key = key_words(seed, device)
    out = torch.empty((B, H, W, C), dtype=torch.float32, device=device)
    code = build.load("philox").esr_philox_factor(
        out.data_ptr(), key.data_ptr(), float(sigma), B, H, W, C,
        torch.cuda.current_stream(out.device).cuda_stream)
    build.check(code, "esr_philox_factor")
    return out


def philox_normal_cuda(seed, shape, device="cuda") -> torch.Tensor:
    """The same draws from the device function the kernels call
    (``csrc/philox.cu``), as an fp32 CUDA tensor: the input noise mode's
    sites of a training step (:func:`models.rrdb.draw_noise` with keys)."""
    B, H, W, C = shape
    key = key_words(seed, device)
    out = torch.empty((B, H, W, C), dtype=torch.float32, device=device)
    lib = build.load("philox")
    code = lib.esr_philox_normal(out.data_ptr(), key.data_ptr(), B, H, W, C,
                                 torch.cuda.current_stream(out.device).cuda_stream)
    build.check(code, "esr_philox_normal")
    philox_normal_cuda.launches += 1
    return out


philox_normal_cuda.launches = 0
