"""The step-dependent scalars of a training step, as one row of device data.

A captured CUDA graph freezes every Python scalar and launch argument it saw
at capture, so nothing a step reads may vary by step on the host. Each
trainer's step body reads its step-dependent values from one int32 row on
the device instead, which the host fills as a pure function of (run seed,
step, the Adam counts, the gates) and uploads:

  * per optimizer group (``groups``): the learning rate of the step's
    schedule, and Adam's bias corrections ``1 − b1^count``, ``1 − b2^count``
    for the count the step's update gives that group; fp32, stored as their
    bit patterns;
  * the 0-based step;
  * the resident sampler's Philox key (two words of ``train.rng.sample_seed``;
    WGAN-GP's interpolation weights draw from it too, on another counter
    stream);
  * every noise site's key (``train.rng.noise_site_words``), ``[nb, 4, 2]``
    words, for a generator with noise sites.

The eager step (host-fed, and every step on the CPU) uploads its one row
and runs the same body as the captured step, which reads its row out of a
table of a whole burst's rows (``train/resident_exec.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from esrganplus_tpu_torch.train.rng import noise_site_words, sample_seed, split_words


def adam_bias(b1: float, b2: float, count: int) -> tuple:
    """Adam's bias corrections ``(1 − b1^count, 1 − b2^count)`` in fp32, as
    optax's ``scale_by_adam`` forms them from its int32 count."""
    one, n = np.float32(1.0), np.float32(count)
    return one - np.float32(b1) ** n, one - np.float32(b2) ** n


class ScalarLayout:
    """Where each scalar sits in a row: 3 fp32 slots per group (lr, c1, c2),
    then the step, the sampler key and ``n_sites`` site keys."""

    def __init__(self, groups: tuple, n_blocks: int = 0):
        self.groups = tuple(groups)
        self.n_blocks = n_blocks
        self._step = 3 * len(self.groups)
        self._sample = self._step + 1
        self._sites = self._sample + 2
        self.width = self._sites + 8 * n_blocks

    def row(self, seed: int, step: int, lrs: dict, bias: dict) -> np.ndarray:
        """The row of ``step``: ``lrs[g]`` and ``bias[g]`` = (c1, c2) per
        group (a closed group's slots are read by nothing)."""
        f = np.zeros(3 * len(self.groups), np.float32)
        for i, g in enumerate(self.groups):
            f[3 * i] = lrs[g]
            f[3 * i + 1:3 * i + 3] = bias.get(g, (1.0, 1.0))
        words = [int(step), *split_words(sample_seed(seed, step))]
        if self.n_blocks:
            words += [w for block in noise_site_words(seed, step, self.n_blocks)
                      for site in block for w in site]
        out = np.empty(self.width, np.int32)
        out[:self._step] = f.view(np.int32)
        out[self._step:] = np.array(words, np.uint64).astype(np.uint32).view(np.int32)
        return out

    def view(self, row: torch.Tensor) -> "StepScalars":
        return StepScalars(self, row)


class StepScalars:
    """Views of one device row (``[width]`` int32): nothing is copied, so a
    captured step reads whatever the row holds at replay."""

    def __init__(self, layout: ScalarLayout, row: torch.Tensor):
        self.layout, self.row = layout, row
        self._f = row[:3 * len(layout.groups)].view(torch.float32)

    def _slot(self, group: str, k: int) -> torch.Tensor:
        return self._f[3 * self.layout.groups.index(group) + k]

    def lr(self, group: str) -> torch.Tensor:
        return self._slot(group, 0)

    def bias(self, group: str) -> tuple:
        """(c1, c2) of ``group``'s Adam update this step."""
        return self._slot(group, 1), self._slot(group, 2)

    @property
    def step(self) -> torch.Tensor:
        return self.row[self.layout._step]

    @property
    def sample_key(self) -> torch.Tensor:
        """The sampler's Philox key, int32 ``[2]``."""
        return self.row[self.layout._sample:self.layout._sample + 2]

    @property
    def site_keys(self) -> torch.Tensor:
        """Every noise site's key, int32 ``[nb, 4, 2]`` (sites rdb1..3, rrdb)."""
        return self.row[self.layout._sites:].view(self.layout.n_blocks, 4, 2)


class RowUploader:
    """Host rows → device, without waiting for the card: each upload copies
    from one of a ring of pinned buffers, and a buffer is refilled only after
    the copy that last read it has run (its event). On the CPU a plain copy."""

    RING = 4

    def __init__(self, device: torch.device):
        self.device = device
        self._ring = []  # [pinned int32 buffer, event or None]
        self._next = 0

    def upload(self, rows: np.ndarray, out: torch.Tensor = None) -> torch.Tensor:
        """Copy the int32 ``rows`` (any shape) into ``out``'s first elements
        (a fresh device tensor of their shape where ``out`` is None)."""
        src = torch.from_numpy(np.ascontiguousarray(rows, np.int32))
        if out is None:
            out = torch.empty(src.shape, dtype=torch.int32, device=self.device)
        dst = out.view(-1)[:src.numel()].view(src.shape)
        if self.device.type != "cuda":
            dst.copy_(src)
            return out
        if len(self._ring) < self.RING:
            self._ring.append([None, None])
        slot = self._ring[self._next]
        self._next = (self._next + 1) % self.RING
        if slot[1] is not None:
            slot[1].synchronize()  # the copy that last read this buffer has run
        if slot[0] is None or slot[0].numel() < src.numel():
            slot[0] = torch.empty(max(src.numel(), 4096), dtype=torch.int32).pin_memory()
        buf = slot[0][:src.numel()].view(src.shape)
        buf.copy_(src)
        dst.copy_(buf, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record(torch.cuda.current_stream(self.device))
        return out
