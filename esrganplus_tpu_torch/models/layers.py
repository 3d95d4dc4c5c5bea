"""Primitive layers as plain functions on NHWC tensors with HWIO weights.

Counterpart of ``esrganplus_tpu/models/layers.py``: parameters are dicts of
tensors in the JAX package's layout (``{"w": [kh, kw, cin, cout], "b":
[cout]}``), so checkpoints and parameter trees carry across unchanged.

fp32 convolutions on the card run with TF32 off (:func:`fp32_exact`): cuDNN
would otherwise compute them in TF32, about three decimal digits, which
breaks the ≤1e-5 checkpoint parity the fp32 path is held to.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def fp32_exact():
    """Run fp32 convolutions and matmuls in full fp32 (TF32 off)."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def kaiming_conv_init(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int,
                      scale: float = 1.0, bias: bool = True,
                      dtype: torch.dtype = torch.float32) -> dict:
    """He-normal (fan_in, gain √2) conv weight ``[kh, kw, cin, cout]``,
    scaled; zero bias (reference ``codes/models/networks.py:30-45``)."""
    std = math.sqrt(2.0 / (kh * kw * cin))
    w = torch.randn((kh, kw, cin, cout), generator=gen, dtype=torch.float32)
    p = {"w": (w * (std * scale)).to(dtype)}
    if bias:
        p["b"] = torch.zeros((cout,), dtype=dtype)
    return p


def conv2d(x: torch.Tensor, p: dict, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Stride-1 SAME (zero-padded) convolution, NHWC × HWIO → NHWC.

    ``dtype`` casts input and weights (the bf16 compute policy) and the
    output stays in ``dtype``, with the bias added in ``dtype`` as the JAX
    package does. ``dtype=None`` computes in fp32 with TF32 off."""
    w = p["w"]
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
    pad = w.shape[0] // 2
    with fp32_exact():
        out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=pad)
    out = out.permute(0, 2, 3, 1)
    if "b" in p:
        out = out + p["b"].to(out.dtype)
    return out.contiguous()


def act(x: torch.Tensor, kind: Optional[str], slope: float = 0.2) -> torch.Tensor:
    """relu / leakyrelu(slope) / none (reference act factory ``block.py:12-25``)."""
    if kind is None:
        return x
    if kind == "relu":
        return torch.relu(x)
    if kind in ("leakyrelu", "lrelu"):
        return torch.where(x >= 0, x, x * slope)
    raise NotImplementedError(f"activation [{kind}]")


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour spatial upsampling of NHWC by an integer factor."""
    return x.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """Depth-to-space on NHWC with the channel index factored as
    ``(c_out, r, r)``, matching ``torch.nn.PixelShuffle`` on NCHW."""
    b, h, w, c = x.shape
    cout = c // (r * r)
    x = x.reshape(b, h, w, cout, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, cout)
