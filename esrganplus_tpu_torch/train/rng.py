"""Per-step noise generator for the nESRGAN+ noise sites.

Counterpart of ``esrganplus_tpu/train/rng.py``. The JAX trainer folds the
step into its key (``train/sr_model.py``: ``fold_in(rng, step)``), so a
resumed run draws what an uninterrupted one would. Here a device
``torch.Generator`` is re-seeded from (seed, step) before every step, which
gives the same property. ``noise_prng`` ("rbg" | "threefry") is carried in
the training config so option files carry across; both values map to this
generator (torch's Philox), and the draws differ from either JAX
implementation's.
"""

from __future__ import annotations

import torch

NOISE_PRNGS = ("rbg", "threefry")
_MIX = 0x9E3779B97F4A7C15  # odd 64-bit constant: spreads consecutive steps


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
