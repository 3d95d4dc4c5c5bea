"""The keys of a training step's random draws.

Counterpart of ``esrganplus_tpu/train/rng.py``. The JAX trainer folds the
step into its key (``train/sr_model.py``: ``fold_in(rng, step)``), so a
resumed run draws what an uninterrupted one would. Here every draw of a
step is Philox4x32-10 (``kernels/philox.py``, ``csrc/philox.cuh``) under a
key of two uint32 words that these functions derive from (run seed, step)
on the host, with Python ints: the trainers write them into the step's row
of device scalars (``train/step_scalars.py``) and the kernels read them
there, so a captured CUDA graph draws each replay's own. ``noise_prng``
("rbg" | "threefry") is carried in the training config so option files
carry across; both values key the same draws, which differ from either JAX
implementation's.

  * :func:`site_seeds` / :func:`noise_site_words`: one key per noise site
    (the fused mode's per-RDB sites, drawn inside the kernels; the input
    mode's pre-drawn sites and the per-RRDB sites);
  * :func:`sample_seed`: the resident sampler's crop indices and augment
    coins (counter stream 0) and WGAN-GP's interpolation weights (stream 1).
"""

from __future__ import annotations

NOISE_PRNGS = ("rbg", "threefry")
_MIX = 0x9E3779B97F4A7C15  # odd 64-bit constant: spreads consecutive steps
_M64 = 2 ** 64 - 1
_RRDB_SALT = 0x94D049BB133111EB  # separates the per-RRDB sites from the per-RDB ones


def step_seed(seed: int, step: int) -> int:
    """A 63-bit seed from (run seed, 0-based step)."""
    return ((int(seed) + 1) * _MIX + int(step) * 0xBF58476D1CE4E5B9) & (2 ** 63 - 1)


def split_words(v: int) -> tuple:
    """A 64-bit value as its (low, high) uint32 words: a Philox key."""
    return int(v) & 0xFFFFFFFF, (int(v) >> 32) & 0xFFFFFFFF


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


def noise_site_words(seed: int, step: int, nb: int) -> list:
    """Every noise site's key for optimizer step ``step``: ``[nb][4]`` pairs
    of uint32 words, sites rdb1, rdb2, rdb3 (:func:`site_seeds`, the fused
    mode's keys too) and the RRDB's own, a pure function of (seed, step,
    site)."""
    base = step_seed(seed, step)
    return [row + [split_words(_splitmix64(((base ^ _RRDB_SALT) + (b + 1) * _MIX) & _M64))]
            for b, row in enumerate(site_seeds(seed, step, nb))]


def sample_seed(seed: int, step: int) -> int:
    """A 63-bit seed for the device-resident sampler's draws of optimizer
    step ``step`` (``data/resident.py``), independent of the noise stream
    :func:`step_seed` gives the same (seed, step)."""
    return _splitmix64(step_seed(seed, step) ^ 0xD1B54A32D192ED03) & (2 ** 63 - 1)
