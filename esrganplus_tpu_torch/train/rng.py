"""Per-step noise generator for the nESRGAN+ noise sites.

Counterpart of ``esrganplus_tpu/train/rng.py``. The JAX trainer folds the
step into its key (``train/sr_model.py``: ``fold_in(rng, step)``), so a
resumed run draws what an uninterrupted one would. Here a device
``torch.Generator`` is re-seeded from (seed, step) before every step, which
gives the same property. ``noise_prng`` ("rbg" | "threefry") is carried in
the training config so option files carry across; both values map to this
generator (torch's Philox), and the draws differ from either JAX
implementation's.

The fused noise mode (``noise_kernel="fused"``) draws its per-RDB sites inside
the kernels from two seed words per site instead (``kernels/philox.py``);
:func:`site_seeds` derives them from (seed, step) on the host, with Python
ints, so no device work is needed and a resumed run gets the same words.
"""

from __future__ import annotations

import torch

NOISE_PRNGS = ("rbg", "threefry")
_MIX = 0x9E3779B97F4A7C15  # odd 64-bit constant: spreads consecutive steps
_M64 = 2 ** 64 - 1


def step_seed(seed: int, step: int) -> int:
    """A 63-bit generator seed from (run seed, 0-based step)."""
    return ((int(seed) + 1) * _MIX + int(step) * 0xBF58476D1CE4E5B9) & (2 ** 63 - 1)


def noise_generator(gen: torch.Generator, seed: int, step: int,
                    impl: str = "rbg") -> torch.Generator:
    """Re-seed ``gen`` for optimizer step ``step`` of the run seeded ``seed``."""
    if impl not in NOISE_PRNGS:
        raise ValueError(f"noise_prng must be one of {NOISE_PRNGS}, got {impl!r}")
    gen.manual_seed(step_seed(seed, step))
    return gen


def _splitmix64(z: int) -> int:
    """SplitMix64's output function (Steele et al., OOPSLA'14) on a 64-bit state."""
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def site_seeds(seed: int, step: int, nb: int) -> list:
    """The fused noise mode's Philox keys for optimizer step ``step``:
    ``[nb][3]`` pairs (s0, s1) of uint32 words, one per (block, rdb) site in
    forward order. The i-th site's 64 bits are SplitMix64 of the state
    ``step_seed(seed, step) + (i + 1)·golden``, a pure function of
    (seed, step, i)."""
    base = step_seed(seed, step)
    out = []
    for b in range(nb):
        row = []
        for r in range(3):
            z = _splitmix64((base + (3 * b + r + 1) * _MIX) & _M64)
            row.append((z & 0xFFFFFFFF, z >> 32))
        out.append(row)
    return out


def sample_seed(seed: int, step: int) -> int:
    """A 63-bit seed for the device-resident sampler's draws of optimizer
    step ``step`` (``data/resident.py``), independent of the noise stream
    :func:`step_seed` gives the same (seed, step)."""
    return _splitmix64(step_seed(seed, step) ^ 0xD1B54A32D192ED03) & (2 ** 63 - 1)
