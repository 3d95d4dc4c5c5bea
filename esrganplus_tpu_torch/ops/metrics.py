"""PSNR / SSIM with the reference evaluation protocol.

Protocol (reference ``codes/utils/util.py:107-158``, ``metrics/calculate_PSNR_SSIM.py``):
inputs are [0, 255] images, PSNR in float64, SSIM uses an 11×11 Gaussian window
(sigma=1.5), C1=(0.01*255)^2, C2=(0.03*255)^2, and a 5-px valid-window crop; colour
SSIM is the mean over channels. Host versions (numpy/cv2, float64) are the
ground-truth evaluators; ``psnr_torch``/``ssim_torch`` are float32 variants on
the tensors' own device (the JAX package's ``psnr_jax``/``ssim_jax``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["calculate_psnr", "calculate_ssim", "gaussian_window", "psnr_torch", "ssim_torch"]

_C1 = (0.01 * 255.0) ** 2
_C2 = (0.03 * 255.0) ** 2


def gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """1-D normalised Gaussian taps (identical to cv2.getGaussianKernel)."""
    half = (size - 1) / 2.0
    x = np.arange(size, dtype=np.float64) - half
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return g / g.sum()


def calculate_psnr(img1: np.ndarray, img2: np.ndarray) -> float:
    """PSNR of two [0, 255] images (any shape), float64."""
    a = np.asarray(img1, dtype=np.float64)
    b = np.asarray(img2, dtype=np.float64)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    return 20.0 * math.log10(255.0 / math.sqrt(mse))


def _filter_valid(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable valid-mode correlation of a 2-D image with outer(k, k), float64."""
    import cv2

    win = np.outer(k, k)
    # Window never crosses the border inside the [5:-5] crop, so border mode is moot.
    full = cv2.filter2D(img.astype(np.float64), -1, win, borderType=cv2.BORDER_REPLICATE)
    r = len(k) // 2
    return full[r:-r, r:-r]


def _ssim_single(img1: np.ndarray, img2: np.ndarray) -> float:
    k = gaussian_window()
    a = img1.astype(np.float64)
    b = img2.astype(np.float64)
    mu1 = _filter_valid(a, k)
    mu2 = _filter_valid(b, k)
    var1 = _filter_valid(a * a, k) - mu1 * mu1
    var2 = _filter_valid(b * b, k) - mu2 * mu2
    cov = _filter_valid(a * b, k) - mu1 * mu2
    num = (2.0 * mu1 * mu2 + _C1) * (2.0 * cov + _C2)
    den = (mu1 * mu1 + mu2 * mu2 + _C1) * (var1 + var2 + _C2)
    return float(np.mean(num / den))


def calculate_ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    """SSIM of two [0, 255] images; HW or HWC (channel mean), MATLAB-compatible."""
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    if img1.ndim == 2:
        return _ssim_single(img1, img2)
    if img1.ndim == 3:
        if img1.shape[2] == 1:
            return _ssim_single(img1[:, :, 0], img2[:, :, 0])
        return float(
            np.mean([_ssim_single(img1[:, :, c], img2[:, :, c]) for c in range(img1.shape[2])])
        )
    raise ValueError("Wrong input image dimensions.")


# ---------------------------------------------------------------------------
# Device-side variants (float32, on the tensors' own device).
# ---------------------------------------------------------------------------


def psnr_torch(img1: torch.Tensor, img2: torch.Tensor, max_val: float = 255.0) -> torch.Tensor:
    """PSNR over the full tensor; inputs any shape on the same [0, max_val]
    scale. A 0-d float32 tensor on the inputs' device."""
    mse = ((img1.float() - img2.float()) ** 2).mean()
    return 20.0 * math.log10(max_val) - 10.0 * mse.clamp_min(1e-12).log10()


def _blur_valid(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Separable valid Gaussian blur of [B, H, W, C] via two depthwise convs
    (full fp32: TF32 off, as the host protocol needs)."""
    c = x.shape[-1]
    kh = k.reshape(1, 1, -1, 1).expand(c, 1, -1, 1)
    kw = k.reshape(1, 1, 1, -1).expand(c, 1, 1, -1)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv2d(F.conv2d(x.permute(0, 3, 1, 2), kh, groups=c), kw, groups=c)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return y.permute(0, 2, 3, 1)


def ssim_torch(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of [B, H, W, C] (or HWC) images on the [0, 255] scale,
    float32, on the inputs' device."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    a = img1.float()
    b = img2.float()
    k = torch.as_tensor(gaussian_window(), dtype=torch.float32, device=a.device)
    mu1 = _blur_valid(a, k)
    mu2 = _blur_valid(b, k)
    var1 = _blur_valid(a * a, k) - mu1 * mu1
    var2 = _blur_valid(b * b, k) - mu2 * mu2
    cov = _blur_valid(a * b, k) - mu1 * mu2
    num = (2.0 * mu1 * mu2 + _C1) * (2.0 * cov + _C2)
    den = (mu1 * mu1 + mu2 * mu2 + _C1) * (var1 + var2 + _C2)
    return (num / den).mean()
