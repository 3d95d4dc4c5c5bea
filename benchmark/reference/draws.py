"""The random draws of a training step, worked out again for the reference.

A frozen copy of the arithmetic that the program's trainers publish as their
contract (its ``train/rng.py``, ``kernels/philox.py``, ``data/resident.py``):
Philox4x32-10 under keys derived from (run seed, step) by SplitMix64, the
resident sampler's crop indices and flip / transpose coins, the pool's
source order and crop-position stream, and the nESRGAN+ noise sites'
Box-Muller normals. Plain integer arithmetic in int64 tensors; nothing is
imported from the program.
"""

from __future__ import annotations

import random

import numpy as np
import torch

_MIX = 0x9E3779B97F4A7C15
_M64 = 2 ** 64 - 1
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


def _splitmix64(z: int) -> int:
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def step_seed(seed: int, step: int) -> int:
    return ((int(seed) + 1) * _MIX + int(step) * 0xBF58476D1CE4E5B9) & (2 ** 63 - 1)


def words(v: int) -> tuple:
    return int(v) & _MASK, (int(v) >> 32) & _MASK


def sample_key(seed: int, step: int) -> tuple:
    """The resident sampler's key of 0-based step ``step``."""
    return words(_splitmix64(step_seed(seed, step) ^ 0xD1B54A32D192ED03) & (2 ** 63 - 1))


def noise_keys(seed: int, step: int, nb: int) -> list:
    """``[nb][3]`` keys of the per-RDB noise sites of step ``step``."""
    base = step_seed(seed, step)
    out = []
    for b in range(nb):
        row = []
        for r in range(3):
            z = _splitmix64((base + (3 * b + r + 1) * _MIX) & _M64)
            row.append((z & _MASK, z >> 32))
        out.append(row)
    return out


def _mulhilo(a: int, b):
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def philox(ctr, key):
    """Philox4x32-10 of four int64 counter words under the key (two ints)."""
    c0, c1, c2, c3 = ctr
    k0, k1 = int(key[0]) & _MASK, int(key[1]) & _MASK
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def sampler_draw(key, batch: int, n: int, flip: bool, rot: bool, device=None):
    """(crop indices, (hflip, vflip, transpose)) of a batch: sample i's
    words are Philox of counter (i, 0, 0, 0)."""
    i = torch.arange(batch, dtype=torch.int64, device=device)
    z = torch.zeros_like(i)
    w = philox((i, z, z, z), key)
    idx = (w[0] * n) >> 32
    coin = lambda k, on: (w[k] >> 31).bool() if on else torch.zeros_like(idx, dtype=torch.bool)
    return idx, (coin(1, flip), coin(2, rot), coin(3, rot))


def augment(img, h, v, t):
    """Per-sample hflip (W), vflip (H), transpose, in that order, on NHWC."""
    b = lambda m: m.view(-1, 1, 1, 1)
    img = torch.where(b(h), img.flip(2), img)
    img = torch.where(b(v), img.flip(1), img)
    return torch.where(b(t), img.transpose(1, 2), img)


def normal(key, shape, device=None):
    """The standard normals of one noise site over NHWC ``shape``: element
    (b, y, x, c) from Philox of counter (c, x, y, b), Box-Muller on two
    24-bit uniforms in fp32."""
    B, H, W, C = shape
    ar = lambda n, view: torch.arange(n, dtype=torch.int64, device=device).view(view)
    ctr = [c.expand(B, H, W, C) for c in (ar(C, (1, 1, 1, C)), ar(W, (1, 1, W, 1)),
                                           ar(H, (1, H, 1, 1)), ar(B, (B, 1, 1, 1)))]
    r0, r1, _, _ = philox(ctr, key)
    u1 = (r0 >> 8).float() * 2.0 ** -24 + 2.0 ** -25
    u2 = (r1 >> 8).float() * 2.0 ** -24
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(6.283185307179586 * u2)


def pool_generators(seed: int, index: int):
    """(source order RandomState, crop-position Random) of pool ``index``."""
    crop_rng = random.Random(f"{seed}/pool/{index}")
    return np.random.RandomState(crop_rng.getrandbits(32)), crop_rng


def rrdb_noise(seed: int, step: int, nb: int, shape, device=None) -> list:
    """``[nb][3]`` NCHW standard normals of the per-RDB sites of step
    ``step`` over the NHWC ``shape`` (B, H, W, nf)."""
    return [[normal(k, shape, device).permute(0, 3, 1, 2) for k in row]
            for row in noise_keys(seed, step, nb)]


def recipe_noise(seed: int, step: int, recipe: dict, batch: int, hr: int, device=None):
    """The normals of 0-based step ``step``'s nESRGAN+ noise sites for the
    recipe's RRDBNet, or None where it has them off."""
    g = recipe["network_G"]
    if not g.get("gaussian_noise", True):
        return None
    lr = hr // recipe.get("scale", 4)
    return rrdb_noise(seed, step, g["nb"], (batch, lr, lr, g["nf"]), device)
