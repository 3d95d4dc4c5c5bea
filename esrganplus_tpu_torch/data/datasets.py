"""Datasets: paired LR/HR patches (train) and whole images (val/test).

Behavioural spec from the reference ``codes/data/LRHR_dataset.py`` /
``LR_dataset.py``: optional subset file, sorted & length-checked path pairs,
modcrop in val/test, optional colour conversion, on-the-fly MATLAB-bicubic LR
when no LR root is given, undersized-image rescue, aligned random crop
(LR crop = HR_size/scale with HR offsets at ×scale), paired flip/rot90
augmentation, BGR→RGB. Output here is NHWC float32 numpy (the layout of the
port's public functions) rather than CHW tensors. Counterpart of
``esrganplus_tpu/data/datasets.py``.

LMDB roots (``data_type: "lmdb"``) are read through the pure-python LMDB
format reader (:mod:`esrganplus_tpu_torch.data.lmdb_io`), honouring the
reference's ``_keys_cache.p`` pickled key cache — no lmdb C module required.
SFT-GAN's segmentation dataset (mode ``LRHRseg_bg``) is
``data/seg_dataset.py``.
"""

from __future__ import annotations

import random
from typing import Dict

import numpy as np

from esrganplus_tpu_torch.ops.color import channel_convert, modcrop
from esrganplus_tpu_torch.ops.image_io import read_img, scan_images
from esrganplus_tpu_torch.ops.resize import imresize_np


def _paired_augment(imgs, hflip: bool, rot: bool, rng: random.Random):
    do_h = hflip and rng.random() < 0.5
    do_v = rot and rng.random() < 0.5
    do_r = rot and rng.random() < 0.5

    def aug(img):
        if do_h:
            img = img[:, ::-1, :]
        if do_v:
            img = img[::-1, :, :]
        if do_r:
            img = img.transpose(1, 0, 2)
        return img

    return [aug(im) for im in imgs]


class _LmdbReader:
    """LMDB image source with the reference's key-cache semantics
    (``codes/data/util.py:34-69``): keys come from ``_keys_cache.p`` when
    present (creating it on first open otherwise), paths are the sorted
    non-``.meta`` keys, and each image is raw uint8 bytes shaped by its
    ``<key>.meta`` record."""

    def __init__(self, root: str):
        import os
        import pickle

        from esrganplus_tpu_torch.data.lmdb_io import LmdbReader

        self.env = LmdbReader(root)
        cache = os.path.join(root, "_keys_cache.p") if os.path.isdir(root) else None
        if cache and os.path.isfile(cache):
            with open(cache, "rb") as f:
                keys = pickle.load(f)
        else:
            keys = [k.decode("ascii") for k in self.env.keys()]
            if cache:
                with open(cache, "wb") as f:
                    pickle.dump(keys, f)
        self.keys = sorted(k for k in keys if not k.endswith(".meta"))

    def read(self, key: str) -> np.ndarray:
        buf = self.env.get(key.encode("ascii"))
        meta = self.env.get((key + ".meta").encode("ascii")).decode("ascii")
        h, w, c = [int(s) for s in meta.split(",")]
        return np.frombuffer(buf, np.uint8).reshape(h, w, c).astype(np.float32) / 255.0


class LRHRDataset:
    """Paired LR/HR dataset. ``opt`` follows the reference schema
    (dataroot_HR, dataroot_LR, HR_size, scale, phase, use_flip, use_rot,
    subset_file, color, data_type)."""

    def __init__(self, opt: Dict):
        self.opt = opt
        self.phase = opt.get("phase", "train")
        self.scale = int(opt.get("scale", 4))
        self.hr_size = opt.get("HR_size")
        self._rng = random.Random(opt.get("seed", 0))

        data_type = opt.get("data_type", "img")
        self._read_hr = self._read_lr = read_img  # path or LMDB key → image
        if data_type == "lmdb":
            hr = _LmdbReader(opt["dataroot_HR"])
            self.paths_hr, self._read_hr, self.paths_lr = hr.keys, hr.read, None
            if opt.get("dataroot_LR"):
                lr = _LmdbReader(opt["dataroot_LR"])
                self.paths_lr, self._read_lr = lr.keys, lr.read
        elif opt.get("subset_file") and self.phase == "train":
            import os

            with open(opt["subset_file"]) as f:
                names = sorted(line.strip() for line in f if line.strip())
            self.paths_hr = [os.path.join(opt["dataroot_HR"], n) for n in names]
            self.paths_lr = None
            if opt.get("dataroot_LR"):
                raise NotImplementedError("subset_file with explicit LR root")
        else:
            self.paths_hr = scan_images(opt["dataroot_HR"])
            self.paths_lr = scan_images(opt["dataroot_LR"]) if opt.get("dataroot_LR") else None

        if self.paths_lr is not None:
            assert len(self.paths_lr) == len(self.paths_hr), (
                f"HR/LR length mismatch: {len(self.paths_hr)} vs {len(self.paths_lr)}")

        # Opt-in decoded-image RAM cache: PNG decode dominates __getitem__ for
        # crop training, and every epoch re-decodes the same files. Capped by
        # cache_images_gb (stop inserting once full — crop/augment never
        # mutate the cached arrays, so sharing is safe). The byte counter is
        # updated without a lock: concurrent workers may overshoot the cap by
        # a few images, which is harmless.
        self._cache = {} if opt.get("cache_images") else None
        self._cache_cap = int(float(opt.get("cache_images_gb", 4.0)) * 1e9)
        self._cache_bytes = 0

    def __len__(self) -> int:
        return len(self.paths_hr)

    def _mod_dim(self, n: int, scale: int) -> int:
        """Largest scale-multiple ≤ n, clamped up to HR_size (reference _mod)."""
        rlt = (n // scale) * scale
        if self.hr_size and rlt < self.hr_size:
            return self.hr_size
        return rlt

    def _read(self, read, paths, idx):
        key = (paths is self.paths_lr, idx) if self._cache is not None else None
        if key is not None:
            hit = self._cache.get(key)
            if hit is not None:
                return hit
        img = read(paths[idx])
        if key is not None and self._cache_bytes + img.nbytes <= self._cache_cap:
            self._cache[key] = img
            self._cache_bytes += img.nbytes
        return img

    def __getitem__(self, idx: int) -> Dict:
        return self.sample(idx, self._rng)

    def sample(self, idx: int, rng: random.Random) -> Dict:
        """Item ``idx`` with its training crop and augmentation drawn from
        ``rng`` (``ds[idx]`` draws from the dataset's own seeded stream)."""
        scale = self.scale
        img_hr = self._read(self._read_hr, self.paths_hr, idx)
        if self.phase != "train":
            img_hr = modcrop(img_hr, scale)
        if self.opt.get("color"):
            img_hr = channel_convert(img_hr.shape[2], self.opt["color"], [img_hr])[0]

        if self.paths_lr is not None:
            img_lr = self._read(self._read_lr, self.paths_lr, idx)
        else:
            if self.phase == "train":
                # reference `_mod` semantics (LRHR_dataset.py:64-77): bilinear
                # mod-RESIZE to a scale multiple, clamped up to HR_size
                h, w, _ = img_hr.shape
                h_s = self._mod_dim(h, scale)
                w_s = self._mod_dim(w, scale)
                if (h_s, w_s) != (h, w):
                    import cv2

                    img_hr = cv2.resize(img_hr, (w_s, h_s),
                                        interpolation=cv2.INTER_LINEAR)
            img_lr = imresize_np(img_hr, 1.0 / scale, antialiasing=True)
            if img_lr.ndim == 2:
                img_lr = img_lr[:, :, None]

        if self.phase == "train":
            # undersized-image rescue: the reference applies this AFTER the LR
            # branch, regardless of whether LR came from disk — a disk LR is
            # overwritten with a regenerated one (LRHR_dataset.py:88-96).
            h, w, _ = img_hr.shape
            if self.hr_size and (h < self.hr_size or w < self.hr_size):
                import cv2

                img_hr = cv2.resize(img_hr, (self.hr_size, self.hr_size),
                                    interpolation=cv2.INTER_LINEAR)
                img_lr = imresize_np(img_hr, 1.0 / scale, antialiasing=True)
                if img_lr.ndim == 2:
                    img_lr = img_lr[:, :, None]

        if self.phase == "train":
            lr_size = self.hr_size // scale
            h, w, _ = img_lr.shape
            x = rng.randint(0, max(0, w - lr_size))
            y = rng.randint(0, max(0, h - lr_size))
            img_lr = img_lr[y:y + lr_size, x:x + lr_size, :]
            img_hr = img_hr[y * scale:(y + lr_size) * scale, x * scale:(x + lr_size) * scale, :]
            if self.opt.get("use_flip", True) or self.opt.get("use_rot", True):
                img_lr, img_hr = _paired_augment(
                    [img_lr, img_hr], self.opt.get("use_flip", True),
                    self.opt.get("use_rot", True), rng)
            if self.opt.get("color"):
                img_lr = channel_convert(img_lr.shape[2], self.opt["color"], [img_lr])[0]

        # BGR (disk) → RGB (model)
        lr_rgb = np.ascontiguousarray(img_lr[:, :, ::-1], np.float32)
        hr_rgb = np.ascontiguousarray(img_hr[:, :, ::-1], np.float32)
        out = {"LR": lr_rgb, "HR": hr_rgb, "HR_path": str(self.paths_hr[idx])}
        out["LR_path"] = str(self.paths_lr[idx]) if self.paths_lr is not None else out["HR_path"]
        return out


class LRDataset:
    """LR-only test set (reference ``codes/data/LR_dataset.py``)."""

    def __init__(self, opt: Dict):
        self.opt = opt
        if opt.get("data_type", "img") == "lmdb":
            lr = _LmdbReader(opt["dataroot_LR"])
            self.paths_lr, self._read = lr.keys, lr.read
        else:
            self.paths_lr, self._read = scan_images(opt["dataroot_LR"]), read_img

    def __len__(self):
        return len(self.paths_lr)

    def __getitem__(self, idx: int) -> Dict:
        img_lr = self._read(self.paths_lr[idx])
        if self.opt.get("color"):
            img_lr = channel_convert(img_lr.shape[2], self.opt["color"], [img_lr])[0]
        lr_rgb = np.ascontiguousarray(img_lr[:, :, ::-1], np.float32)
        return {"LR": lr_rgb, "LR_path": str(self.paths_lr[idx])}


def create_dataset(opt: Dict):
    mode = opt.get("mode", "LRHR")
    if mode == "LR":
        return LRDataset(opt)
    if mode == "LRHR":
        return LRHRDataset(opt)
    if mode == "LRHRseg_bg":
        from esrganplus_tpu_torch.data.seg_dataset import LRHRSegBGDataset

        return LRHRSegBGDataset(opt)
    raise NotImplementedError(f"Dataset mode [{mode}] not recognized")
