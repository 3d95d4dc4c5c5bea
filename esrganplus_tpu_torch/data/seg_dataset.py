"""SFT-GAN training dataset: paired LR/HR crops, segmentation and category.

Counterpart of ``esrganplus_tpu/data/seg_dataset.py`` (reference
``codes/data/LRHR_seg_bg_dataset.py``): one draw in ``bg_ratio`` (10) comes
from a general background pool (DIV2K) with an all-background seg map; seg
probability maps load from sibling ``.pth`` files (the ``/img/`` →
``/bicseg/`` path convention, configurable); a random rescale from
``[1, 0.9, …, 0.5]`` (cv2 ``INTER_LINEAR`` on HR, ``INTER_NEAREST`` on seg)
comes before the bicubic LR; aligned LR/HR/seg crops; paired flip / rot; the
category from a substring of the path (background 0, building 1, plant 2,
mountain 3, water 4, sky 5, grass 6, animal 7).

``ds[i]`` draws from the dataset's own ``random.Random(seed)`` stream in the
JAX package's order (background coin, background index, rescale, crop y,
crop x, flip, vflip, transpose), so with the same ``seed`` the samples are
bit-equal to JAX's. ``sample(i, rng)`` draws the same from another
generator: the train loader's per-batch streams and the resident store's
per-pool ones (``data/loader.py``, ``data/resident.py``).
"""

from __future__ import annotations

import random
from typing import Dict

import numpy as np

from esrganplus_tpu_torch.ops.color import modcrop
from esrganplus_tpu_torch.ops.image_io import read_img, scan_images
from esrganplus_tpu_torch.ops.resize import imresize_np

CATEGORIES = ("building", "plant", "mountain", "water", "sky", "grass", "animal")
N_CLASSES = 8  # the categories and background


def category_from_path(path: str) -> int:
    for i, name in enumerate(CATEGORIES, start=1):
        if name in path:
            return i
    return 0


class LRHRSegBGDataset:
    def __init__(self, opt: Dict):
        self.opt = opt
        self.phase = opt.get("phase", "train")
        self.scale = int(opt.get("scale", 4))
        self.hr_size = opt.get("HR_size", 96)
        self.paths_hr = scan_images(opt["dataroot_HR"])
        self.paths_hr_bg = scan_images(opt["dataroot_HR_bg"]) if opt.get("dataroot_HR_bg") else []
        self.seg_dir_from = opt.get("seg_replace_from", "/img/")
        self.seg_dir_to = opt.get("seg_replace_to", "/bicseg/")
        self.random_scale_list = [1, 0.9, 0.8, 0.7, 0.6, 0.5]
        self.ratio = opt.get("bg_ratio", 10)
        self._rng = random.Random(opt.get("seed", 0))

    def __len__(self):
        return len(self.paths_hr)

    def _load_seg(self, hr_path: str) -> np.ndarray:
        """The ``[8, H, W]`` torch seg map beside ``hr_path`` → HWC float32."""
        import torch

        cand = hr_path.replace(self.seg_dir_from, self.seg_dir_to).rsplit(".", 1)[0] + ".pth"
        try:
            seg = torch.load(cand, map_location="cpu", weights_only=True)
        except FileNotFoundError:
            raise FileNotFoundError(f"no seg map for {hr_path} (looked at {cand})") from None
        return np.transpose(np.asarray(seg, np.float32), (1, 2, 0))

    def __getitem__(self, index: int) -> Dict:
        return self.sample(index, self._rng)

    def sample(self, index: int, rng: random.Random) -> Dict:
        """Item ``index``, its background coin, rescale, crop and
        augmentation drawn from ``rng``."""
        scale, hr_size = self.scale, self.hr_size
        train = self.phase == "train"
        use_bg = bool(train and self.paths_hr_bg and rng.randrange(self.ratio) == 0)
        if use_bg:
            hr_path = self.paths_hr_bg[rng.randrange(len(self.paths_hr_bg))]
            img_hr = read_img(hr_path)
            seg = np.zeros((img_hr.shape[0], img_hr.shape[1], N_CLASSES), np.float32)
            seg[:, :, 0] = 1.0
        else:
            hr_path = self.paths_hr[index]
            img_hr = read_img(hr_path)
            seg = self._load_seg(hr_path)

        if not train:
            img_hr = modcrop(img_hr, 8)
            seg = seg[: img_hr.shape[0], : img_hr.shape[1], :]
        else:
            import cv2

            rs = rng.choice(self.random_scale_list)

            def _mod(n):
                r = (int(n * rs) // scale) * scale
                return hr_size if r < hr_size else r

            hs, ws = _mod(seg.shape[0]), _mod(seg.shape[1])
            img_hr = cv2.resize(img_hr, (ws, hs), interpolation=cv2.INTER_LINEAR)
            seg = cv2.resize(seg, (ws, hs), interpolation=cv2.INTER_NEAREST)

        img_lr = imresize_np(img_hr, 1.0 / scale)
        if img_lr.ndim == 2:
            img_lr = img_lr[:, :, None]

        category = -1
        if train:
            lr_size = hr_size // scale
            h, w, _ = img_lr.shape
            y = rng.randint(0, max(0, h - lr_size))
            x = rng.randint(0, max(0, w - lr_size))
            img_lr = img_lr[y:y + lr_size, x:x + lr_size, :]
            img_hr = img_hr[y * scale:y * scale + hr_size, x * scale:x * scale + hr_size, :]
            seg = seg[y * scale:y * scale + hr_size, x * scale:x * scale + hr_size, :]
            if self.opt.get("use_flip", True) and rng.random() < 0.5:
                img_lr, img_hr, seg = (a[:, ::-1, :] for a in (img_lr, img_hr, seg))
            if self.opt.get("use_rot", True):
                if rng.random() < 0.5:
                    img_lr, img_hr, seg = (a[::-1, :, :] for a in (img_lr, img_hr, seg))
                if rng.random() < 0.5:
                    img_lr, img_hr, seg = (a.transpose(1, 0, 2) for a in (img_lr, img_hr, seg))
            category = 0 if use_bg else category_from_path(hr_path)

        return {
            "LR": np.ascontiguousarray(img_lr[:, :, ::-1], np.float32),
            "HR": np.ascontiguousarray(img_hr[:, :, ::-1], np.float32),
            "seg": np.ascontiguousarray(seg, np.float32),
            "category": np.int32(category),
            "HR_path": hr_path,
            "LR_path": hr_path,
        }
