"""Device-resident training crops: no host→device copy of a batch.

Counterpart of ``esrganplus_tpu/data/resident.py`` (``ResidentCropStore``
and SFT-GAN's ``ResidentSegStore``). Instead of
cropping and augmenting on the host and copying every batch to the card, a
pool of aligned uint8 LR/HR crop pairs lives in device memory, and each train
step samples, augments and casts its batch on the device (the trainers'
``train_step_resident``).

The pool is re-cropped from the source images every ``refresh_steps``
optimizer steps and copied into the same device buffers with one bulk upload
each (never rebound: a captured training step keeps reading them). Augmentation is the host
pipeline's ``_paired_augment`` (``data/datasets.py``): per sample hflip,
vflip and transpose at p = 0.5 each, the same decision for LR and HR, on the
uint8 crops, with the cast to float32 / 255 after it (flips and transposes
are permutations, so they commute with the cast exactly).

Storage is uint8: images are 8-bit on disk and the host crops are lossless
re-slices of them. When the LR is synthesised on the fly (no
``dataroot_LR``), its float values are quantised to uint8 in the pool, so
resident training then sees a slightly different LR than host-fed training.
SFT-GAN's pool (:class:`ResidentSegStore`) keeps its LR in float32 instead
(the bicubic LR of a randomly rescaled HR has no 8-bit form), the seg map as
uint8 ·255 and the HR as uint8; the category rides along untouched.

Reproducibility. Pool ``r`` (the one in use from step ``r·refresh_steps``
on) is a function of (seed, r) alone: its source order and its crop
positions come from generators seeded from them, so a run resumed at step N
rebuilds the pool the uninterrupted run held at step N. The batch of step
``s`` is drawn on the device by Philox under a key of two words derived from
(run seed, s) (``train.rng.sample_seed``), as the JAX package folds its key
by the step: sample i's words are Philox4x32-10 of counter (i, 0, 0, 0)
(``kernels/philox.py``, ``csrc/philox.cu`` ``esr_philox_bits``); the first
gives its crop index ⌊w₀·n / 2³²⌋, the top bits of the other three its
hflip, vflip and transpose coins at p = 1/2. The key is read on the device,
so a captured step draws each replay's batch. The JAX package builds its
pools from one running generator (the dataset's own crop stream);
``build_crop_pool`` takes the crop generator as an argument, so given the
dataset's stream it is bit for bit JAX's. An asynchronous refresh swaps in at the first poll after its build finishes, a
few steps late, which no resume reproduces; a resume that must be
bit-equal runs with ``resident_async_refresh: false`` (or a refresh period
longer than the run).
"""

from __future__ import annotations

import random
import threading

import numpy as np
import torch

from esrganplus_tpu_torch.kernels.philox import key_words, random_bits
from esrganplus_tpu_torch.parallel import mesh
from esrganplus_tpu_torch.train.rng import split_words
from esrganplus_tpu_torch.utils.trace import span


def draw(key: torch.Tensor, batch_size: int, n: int, flip: bool, rot: bool) -> tuple:
    """The crop indices (int64 in [0, n)) and the (hflip, vflip, transpose)
    coins (bool; a disabled axis is all False) of the sampler's draw of a
    batch of ``batch_size`` under ``key`` (an int32 ``[2]`` tensor), on its
    device. ``batch_size`` is the GLOBAL batch: under a process group every
    rank draws the whole batch under the one key and keeps its own rows
    (``parallel/mesh.py`` ``local_rows``), as the JAX package draws the
    global batch and shards it over its data axis."""
    bits = mesh.local_rows(random_bits(key, batch_size))
    idx = (bits[:, 0] * n) >> 32
    off = torch.zeros_like(idx, dtype=torch.bool)
    coin = lambda k, on: (bits[:, k] >> 31).bool() if on else off
    return idx, (coin(1, flip), coin(2, rot), coin(3, rot))


def _apply_augment(img: torch.Tensor, do_h, do_v, do_r) -> torch.Tensor:
    """The shared per-sample flips and transpose on one NHWC batch (square
    crops): hflip reverses W, vflip H, transpose swaps them, in that order,
    as the JAX package's ``_apply_augment``."""
    b = lambda m: m.view(-1, 1, 1, 1)
    img = torch.where(b(do_h), img.flip(2), img)
    img = torch.where(b(do_v), img.flip(1), img)
    return torch.where(b(do_r), img.transpose(1, 2), img)


def _bypass_host_augment(dataset):
    """Turn a dataset's host flip/rot off (the device sampler applies them)
    and return the function that restores them. A key absent before is
    DELETED on restore, not written back as None: a stored None would turn
    the documented ``opt.get("use_flip", True)`` default falsy for every
    later reader of the shared options dict."""
    saved = {k: dataset.opt[k] for k in ("use_flip", "use_rot") if k in dataset.opt}
    dataset.opt["use_flip"] = False
    dataset.opt["use_rot"] = False

    def restore():
        for k in ("use_flip", "use_rot"):
            if k in saved:
                dataset.opt[k] = saved[k]
            else:
                dataset.opt.pop(k, None)

    return restore


def build_crop_pool(dataset, n_crops: int, rng: np.random.RandomState,
                    crop_rng: random.Random):
    """``n_crops`` aligned (LR, HR) crop pairs of an LRHR dataset, through
    its own sampling (``dataset.sample``, what ``__getitem__`` runs) with host
    augmentation bypassed → uint8 arrays ``(lr [N, h, w, 3], hr [N, H, W,
    3])``. ``rng`` orders the sources, ``crop_rng`` draws the crop
    positions."""
    restore = _bypass_host_augment(dataset)
    try:
        lrs, hrs = [], []
        n_src = len(dataset)
        order = rng.permutation(n_src)
        for i in range(n_crops):
            idx = int(order[i % n_src])
            s = dataset.sample(idx, crop_rng)
            lrs.append(np.clip(s["LR"] * 255.0, 0, 255).round().astype(np.uint8))
            hrs.append(np.clip(s["HR"] * 255.0, 0, 255).round().astype(np.uint8))
        return np.stack(lrs), np.stack(hrs)
    finally:
        restore()


def pool_generators(seed: int, index: int):
    """(source-order RandomState, crop-position Random) of pool ``index``."""
    crop_rng = random.Random(f"{seed}/pool/{index}")
    return np.random.RandomState(crop_rng.getrandbits(32)), crop_rng


class ResidentCropStore:
    """The crop pool in device memory, refreshed every ``refresh_steps``
    steps. ``start_step`` (a resume) selects the pool in use at that step.

    ``make_sampler(batch_size)`` returns the device sampler the trainers'
    ``train_step_resident`` call once per step."""

    def __init__(self, dataset, device, n_crops: int = 2048, refresh_steps: int = 1000,
                 seed: int = 0, use_flip: bool = True, use_rot: bool = True,
                 async_refresh: bool = True, start_step: int = 0):
        self._dataset = dataset
        self.device = torch.device(device)
        self.n_crops = int(n_crops)
        self.refresh_steps = int(refresh_steps)
        self.seed = int(seed)
        self.use_flip = bool(use_flip)
        self.use_rot = bool(use_rot)
        # the replacement pool is built in a background thread and swapped in
        # at the first maybe_refresh() poll after it finished: re-cropping
        # thousands of pairs is seconds of PNG decode, a stall of hundreds of
        # steps if done in line
        # (off under a process group, as in the JAX package: every rank must
        # swap the new pool in at the same step)
        self.async_refresh = bool(async_refresh) and mesh.world_size() == 1
        self._pending = None  # (thread, one-element result list, pool index)
        self.pool_index = self._index_at(int(start_step))
        self._upload(self._crop(self.pool_index), self.pool_index)

    def _index_at(self, step: int) -> int:
        return step // self.refresh_steps if self.refresh_steps > 0 else 0

    def _build(self, index: int):
        return build_crop_pool(self._dataset, self.n_crops, *pool_generators(self.seed, index))

    def _crop(self, index: int):
        """The host pools of pool ``index`` (the span ``store.build``, on
        whichever thread builds them)."""
        with span("store.build"):
            return self._build(index)

    POOLS = ("lr", "hr")

    def _upload(self, pools, index: int):
        """Copy the host pools into the device buffers, made at the first
        upload and kept after (a refresh lands in the same memory; the span
        ``store.upload``)."""
        with span("store.upload"):
            for name, a in zip(self.POOLS, pools):
                t = torch.from_numpy(a)
                buf = getattr(self, name, None)
                if buf is None:
                    setattr(self, name, t.to(self.device))
                else:
                    buf.copy_(t)
        self.pool_index = index

    def pools(self) -> tuple:
        """The device pool tensors, in ``POOLS`` order."""
        return tuple(getattr(self, name) for name in self.POOLS)

    @property
    def nbytes(self) -> int:
        """Device bytes of the pool."""
        return sum(t.nbytes for t in self.pools())

    def _start_build(self, index: int):
        out = []

        def work():
            try:
                out.append(("ok", self._crop(index)))
            except BaseException as e:  # re-raised at the swap point
                out.append(("err", e))

        thread = threading.Thread(target=work, daemon=True)
        thread.start()
        self._pending = (thread, out, index)

    def _harvest(self, block: bool):
        if self._pending is None:
            return
        thread, out, index = self._pending
        if not block and thread.is_alive():
            return
        thread.join()
        self._pending = None
        status, payload = out[0]
        if status == "err":
            raise payload
        self._upload(payload, index)

    def maybe_refresh(self, step: int):
        """At a multiple of ``refresh_steps`` (step > 0), re-crop and
        re-upload the pool (call from the host loop before the step). With
        ``async_refresh`` the build runs in a background thread and lands at
        the first poll after it finished."""
        if self.refresh_steps <= 0:
            return
        self._harvest(block=False)
        index = self._index_at(step)
        if step > 0 and step % self.refresh_steps == 0 and index != self.pool_index:
            if not self.async_refresh:
                self._upload(self._crop(index), index)
            elif self._pending is None:
                self._start_build(index)

    def flush_refresh(self):
        """Block until an in-flight asynchronous rebuild is swapped in."""
        self._harvest(block=True)

    def make_sampler(self, batch_size: int):
        """``sample(key) -> (lr, hr)``: float32 [0, 1] NHWC batches on the
        device, drawn from the current pool under ``key`` (the step's int32
        ``[2]`` key tensor, or an int seed: :func:`draw`)."""
        n, flip, rot = self.n_crops, self.use_flip, self.use_rot

        def sample(key):
            idx, dec = draw(key_on(key, self.device), batch_size, n, flip, rot)
            lr = _apply_augment(self.lr[idx], *dec).float() / 255.0
            hr = _apply_augment(self.hr[idx], *dec).float() / 255.0
            return lr, hr

        return sample


def key_on(key, device):
    """A sampler key as a tensor on ``device``: an int seed's two words."""
    return key if torch.is_tensor(key) else key_words(split_words(key), device)


# ---------------------------------------------------------------------------
# SFT-GAN: (LR, seg, HR, category) crops
# ---------------------------------------------------------------------------


def build_seg_crop_pool(dataset, n_crops: int, rng: np.random.RandomState,
                        crop_rng: random.Random):
    """``n_crops`` (LR, seg, HR, category) crops of an ``LRHRSegBGDataset``
    (``data/seg_dataset.py``) through its own sampling with host
    augmentation bypassed → ``(lr float32 [N, h, w, 3], seg uint8 [N, H, W,
    8], hr uint8 [N, H, W, 3], category int64 [N])``. HR is 8-bit at the
    source; the seg map is stored ·255 (a one-hot map survives the nearest
    rescale exactly); the LR stays float32. ``rng`` orders the sources,
    ``crop_rng`` draws the background coins, rescales and crops."""
    restore = _bypass_host_augment(dataset)
    try:
        lrs, segs, hrs, cats = [], [], [], []
        n_src = len(dataset)
        order = rng.permutation(n_src)
        for i in range(n_crops):
            s = dataset.sample(int(order[i % n_src]), crop_rng)
            lrs.append(s["LR"].astype(np.float32))
            segs.append(np.clip(s["seg"] * 255.0, 0, 255).round().astype(np.uint8))
            hrs.append(np.clip(s["HR"] * 255.0, 0, 255).round().astype(np.uint8))
            cats.append(int(s["category"]))
        return np.stack(lrs), np.stack(segs), np.stack(hrs), np.asarray(cats, np.int64)
    finally:
        restore()


class ResidentSegStore(ResidentCropStore):
    """SFT-GAN's (LR, seg, HR, category) crop pool in device memory: the
    design and the reproducibility contract of :class:`ResidentCropStore`;
    the three images of a sample share its flip / vflip / transpose
    decision."""

    def _build(self, index: int):
        return build_seg_crop_pool(self._dataset, self.n_crops,
                                   *pool_generators(self.seed, index))

    POOLS = ("lr", "seg", "hr", "cat")

    def make_sampler(self, batch_size: int):
        """``sample(key) -> (lr, seg, hr, category)``: LR / HR float32
        [0, 1] and the seg map float32 NHWC, the category int64, drawn on
        the device from the current pool as :class:`ResidentCropStore`
        draws, one index and one augment decision for all four."""
        n, flip, rot = self.n_crops, self.use_flip, self.use_rot

        def sample(key):
            idx, dec = draw(key_on(key, self.device), batch_size, n, flip, rot)
            lr = _apply_augment(self.lr[idx], *dec)
            seg = _apply_augment(self.seg[idx], *dec).float() / 255.0
            hr = _apply_augment(self.hr[idx], *dec).float() / 255.0
            return lr, seg, hr, self.cat[idx]

        return sample
