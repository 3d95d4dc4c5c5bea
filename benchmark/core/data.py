"""Synthetic training sets and photographs, made from the seed on the device.

DIV2K, OST and their segmentation maps are not in the repository. What
stands in for them keeps their shapes: 8-bit RGB tiles with smooth content
(a bilinear blow-up of a coarse random grid, made in bulk on the device),
their bicubic ×1/4 LR (PyTorch's antialiased bicubic), and for SFT-GAN an
8-class one-hot segmentation map and a category per source.

A dataset here offers what the program's crop pools read from a dataset
(``opt``, ``len``, ``sample(index, crop_rng)``) and, for the reference,
:meth:`positions`, the crop positions that the same ``crop_rng`` gives.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def smooth_images(gen, n: int, h: int, w: int, device, cell: int = 8) -> torch.Tensor:
    """``n`` float32 NCHW images in [0, 1]: bilinear blow-ups of coarse
    random grids with one node every ``cell`` pixels."""
    coarse = torch.rand((n, 3, h // cell + 2, w // cell + 2), generator=gen, device=device)
    return F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=True)


def to_u8(x: torch.Tensor) -> torch.Tensor:
    return (x.clamp(0, 1) * 255).round().to(torch.uint8)


def bicubic_lr(hr: torch.Tensor, scale: int = 4) -> torch.Tensor:
    """float32 NCHW [0, 1] → its antialiased bicubic ×1/scale, clamped."""
    return F.interpolate(hr, scale_factor=1 / scale, mode="bicubic", antialias=True,
                         align_corners=False).clamp(0, 1)


def nhwc_host(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).contiguous().cpu().numpy()


class CropDataset:
    """LRHR crops of ``hr_size`` from ``n`` tiles of ``tile``² (DIV2K800_sub's
    480² tiles and their bicubic LR), aligned on the LR grid."""

    def __init__(self, seed: int, n: int, tile: int, hr_size: int, device, scale: int = 4):
        gen = torch.Generator(device=device).manual_seed(seed)
        hr = smooth_images(gen, n, tile, tile, device)
        self.hr = nhwc_host(to_u8(hr))
        self.lr = nhwc_host(to_u8(bicubic_lr(to_u8(hr).float() / 255.0, scale)))
        self.scale, self.hr_size = scale, hr_size
        self.opt = {"use_flip": True, "use_rot": True}

    def __len__(self):
        return len(self.hr)

    def positions(self, crop_rng) -> tuple:
        """The LR (top, left) of the next crop that ``crop_rng`` draws."""
        room = self.lr.shape[1] - self.hr_size // self.scale
        return crop_rng.randint(0, room), crop_rng.randint(0, room)

    def crop(self, index: int, pos: tuple) -> dict:
        """uint8 LR / HR crops of source ``index`` at the LR position ``pos``."""
        (t, l), n, s = pos, self.hr_size // self.scale, self.scale
        return {"LR": self.lr[index, t:t + n, l:l + n], "HR": self.hr[index, t * s:(t + n) * s,
                                                                       l * s:(l + n) * s]}

    def sample(self, index: int, crop_rng) -> dict:
        c = self.crop(index, self.positions(crop_rng))
        return {k: v.astype(np.float32) / 255.0 for k, v in c.items()}


class SegCropDataset(CropDataset):
    """OST-like crops: HR, its float32 bicubic LR, an 8-class one-hot seg
    map at HR resolution and the source's category (``index mod 8``;
    background is 0)."""

    CLASSES = 8

    def __init__(self, seed: int, n: int, tile: int, hr_size: int, device, scale: int = 4):
        gen = torch.Generator(device=device).manual_seed(seed)
        hr = to_u8(smooth_images(gen, n, tile, tile, device))
        self.hr = nhwc_host(hr)
        self.lr = nhwc_host(bicubic_lr(hr.float() / 255.0, scale))
        field = torch.rand((n, self.CLASSES, tile // 32 + 2, tile // 32 + 2), generator=gen,
                           device=device)
        label = F.interpolate(field, size=(tile, tile), mode="bilinear",
                              align_corners=True).argmax(1)
        self.seg = F.one_hot(label, self.CLASSES).to(torch.uint8).cpu().numpy()
        self.cat = np.arange(n, dtype=np.int64) % self.CLASSES
        self.scale, self.hr_size = scale, hr_size
        self.opt = {"use_flip": True, "use_rot": False}

    def crop(self, index: int, pos: tuple) -> dict:
        (t, l), n, s = pos, self.hr_size // self.scale, self.scale
        hr_box = (slice(t * s, (t + n) * s), slice(l * s, (l + n) * s))
        return {"LR": self.lr[index, t:t + n, l:l + n], "HR": self.hr[(index, *hr_box)],
                "seg": self.seg[(index, *hr_box)], "category": int(self.cat[index])}

    def sample(self, index: int, crop_rng) -> dict:
        c = self.crop(index, self.positions(crop_rng))
        return {"LR": c["LR"].astype(np.float32), "HR": c["HR"].astype(np.float32) / 255.0,
                "seg": c["seg"].astype(np.float32), "category": c["category"]}

