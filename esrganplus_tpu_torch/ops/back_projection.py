"""Iterative back-projection / reverse-filter post-processing on the device.

Counterpart of ``esrganplus_tpu/ops/back_projection.py`` (reference surface
``codes/scripts/back_projection/{backprojection.m, main_bp.m,
main_reverse_filter.m}``, MATLAB, offline). Two refinement loops over an SR
estimate, both with the MATLAB-bicubic resize of :mod:`ops.resize` (fp32 on
the tensor's device); both run 20 iterations upstream and improve distortion
metrics (PSNR) at slight perceptual cost.

* :func:`back_projection` (``backprojection.m:1-20``): the residual
  ``up(lr − down(sr))`` is smoothed with a SQUARED, renormalised 5×5 σ=1
  Gaussian (``p = fspecial('gaussian',5,1); p = p.^2; p = p/sum(p)``) before
  being added. The estimate and the smoothing accumulate in float64, the
  resizes run in float32, as the JAX package's numpy loop does.
* :func:`reverse_filter` (``main_reverse_filter.m:18-23``): fixed target
  ``J = up(lr)``; each step adds ``J − up(down(sr))`` (both resizes at the
  full scale factor, no filtering), in float32.

Both take HWC [0, 1] images (numpy or tensors) and return a clipped float32
tensor on ``device``: the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from esrganplus_tpu_torch.infer import resolve_device
from esrganplus_tpu_torch.ops.resize import imresize


def _fspecial_gaussian_sq(size: int = 5, sigma: float = 1.0) -> np.ndarray:
    """1-D factor of MATLAB's fspecial('gaussian')² kernel (separable)."""
    r = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(r ** 2) / (2 * sigma ** 2))
    g = g / g.sum()          # fspecial normalises the 2-D kernel; separably equal
    g2 = g ** 2              # p = p.^2 stays separable: (gx·gy)² = gx²·gy²
    return g2 / g2.sum()     # renormalise (2-D renorm = product of 1-D renorms)


def _conv2_same(img: torch.Tensor, k1d: np.ndarray) -> torch.Tensor:
    """Separable 2-D 'same' convolution with zero padding (MATLAB conv2) of a
    float64 HWC tensor, the taps summed in the order of the JAX package's."""
    pad = len(k1d) // 2
    h, w = img.shape[0], img.shape[1]
    tmp = torch.nn.functional.pad(img, (0, 0, 0, 0, pad, pad))
    acc = torch.zeros_like(img)
    for i, kv in enumerate(k1d):
        acc += float(kv) * tmp[i:i + h]
    tmp = torch.nn.functional.pad(acc, (0, 0, pad, pad))
    out = torch.zeros_like(acc)
    for j, kv in enumerate(k1d):
        out += float(kv) * tmp[:, j:j + w]
    return out


def _on(img, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.asarray(img) if not torch.is_tensor(img) else img).to(device, dtype)


def back_projection(sr, lr, scale: int, iters: int = 20, device="cuda") -> torch.Tensor:
    """``backprojection.m``: sr += gauss²⊛ up(lr − down(sr)) → clipped
    float32 HWC on ``device``."""
    dev = resolve_device(device)
    sr = _on(sr, dev, torch.float64).clone()
    lr = _on(lr, dev, torch.float64)
    k1d = _fspecial_gaussian_sq()
    h, w = sr.shape[0], sr.shape[1]
    for _ in range(iters):
        down = imresize(sr.float(), 1.0 / scale).double()
        diff = imresize((lr - down).float(), float(scale)).double()
        sr = sr + _conv2_same(diff[:h, :w], k1d)
    return sr.clamp(0.0, 1.0).float()


def reverse_filter(sr, lr, scale: int, iters: int = 20, device="cuda") -> torch.Tensor:
    """``main_reverse_filter.m:18-23``: sr += up(lr) − up(down(sr)) →
    clipped float32 HWC on ``device``."""
    dev = resolve_device(device)
    sr = _on(sr, dev, torch.float32).clone()
    j = imresize(_on(lr, dev, torch.float32), float(scale))
    h, w = sr.shape[0], sr.shape[1]
    for _ in range(iters):
        down = imresize(sr, 1.0 / scale)
        sr = sr + (j[:h, :w] - imresize(down, float(scale))[:h, :w])
    return sr.clamp(0.0, 1.0)
