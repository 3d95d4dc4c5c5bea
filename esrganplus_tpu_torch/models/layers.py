"""Primitive layers as plain functions on NHWC tensors with HWIO weights.

Counterpart of ``esrganplus_tpu/models/layers.py``: parameters are dicts of
tensors in the JAX package's layout (``{"w": [kh, kw, cin, cout], "b":
[cout]}``), so checkpoints and parameter trees carry across unchanged.

fp32 convolutions on the card run with TF32 off (:func:`fp32_exact`): cuDNN
would otherwise compute them in TF32, about three decimal digits, which
breaks the ≤1e-5 checkpoint parity the fp32 path is held to. The context
covers what runs inside it: a backward pass started outside (``autograd.grad``
after the forward returned) picks its cuDNN algorithms under the flags of
that moment, so training wraps the whole step (``SRTrainer.train_step``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F

from esrganplus_tpu_torch.parallel import mesh


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


@contextlib.contextmanager
def deterministic_convs():
    """Make cuDNN pick deterministic algorithms (its weight-gradient kernels
    may otherwise add with atomics), so a training step that also runs the
    package's own deterministic kernels repeats bit for bit."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


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


def kaiming_linear_init(gen: torch.Generator, cin: int, cout: int, scale: float = 1.0,
                        dtype: torch.dtype = torch.float32) -> dict:
    """He-normal linear weight ``[cin, cout]`` (``x @ w``), scaled; zero bias."""
    w = torch.randn((cin, cout), generator=gen, dtype=torch.float32)
    return {"w": (w * (math.sqrt(2.0 / cin) * scale)).to(dtype),
            "b": torch.zeros((cout,), dtype=dtype)}


def batchnorm_init(c: int, dtype: torch.dtype = torch.float32) -> dict:
    return {"scale": torch.ones((c,), dtype=dtype), "bias": torch.zeros((c,), dtype=dtype),
            "mean": torch.zeros((c,), dtype=dtype), "var": torch.ones((c,), dtype=dtype)}


def conv2d(x: torch.Tensor, p: dict, stride: int = 1, pad="same",
           dtype: Optional[torch.dtype] = None, dilation: int = 1) -> torch.Tensor:
    """Zero-padded convolution, NHWC × HWIO → NHWC. ``pad``: "same" (the
    dilated kernel's extent ``(k−1)·dilation + 1`` halved, the extra pixel
    of an even extent after the image as in the JAX package), "valid", or
    an explicit symmetric int (the discriminator's 4×4 stride-2 conv pads 1
    on both sides, as torch does).

    ``dtype`` casts input and weights (the bf16 compute policy) and the
    output stays in ``dtype``, with the bias added in ``dtype`` as the JAX
    package does. ``dtype=None`` computes in fp32 with TF32 off."""
    w = p["w"]
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
    xc = x.permute(0, 3, 1, 2)
    if pad == "same":
        eh, ew = ((k - 1) * dilation + 1 for k in w.shape[:2])
        lo_h, hi_h, lo_w, hi_w = eh // 2, (eh - 1) // 2, ew // 2, (ew - 1) // 2
        if (lo_h, lo_w) == (hi_h, hi_w):
            pad = (lo_h, lo_w)
        else:
            xc = F.pad(xc, (lo_w, hi_w, lo_h, hi_h))
            pad = 0
    elif pad == "valid":
        pad = 0
    with fp32_exact():
        out = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, padding=pad,
                       dilation=dilation)
    out = out.permute(0, 2, 3, 1)
    if "b" in p:
        out = out + p["b"].to(out.dtype)
    return out.contiguous()


def linear(x: torch.Tensor, p: dict, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ w + b`` with ``w`` as ``[cin, cout]``. ``dtype`` casts input and
    weights; the product accumulates in fp32, the bias is added in fp32 and
    the result is rounded to ``dtype`` once. ``dtype=None`` computes in fp32
    with TF32 off."""
    w = p["w"]
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
    with fp32_exact():
        out = (x @ w).float() + p["b"].float()
    return out if dtype is None else out.to(dtype)


def global_moments(xf: torch.Tensor, local_var=None) -> tuple:
    """(mean, biased variance, count) of fp32 NHWC ``xf`` per channel over NHW
    of the GLOBAL batch, differentiably: each rank's mean and variance
    (``local_var(xf, mean)``, by default ``xf.var``'s centred Welford
    reduction, the centred form of ``jnp.var``) combined over the ranks by
    the law of total variance, as all-reduced sums each weighted by the
    rank's share of the count: the mean of the ranks' means, and the mean of
    their variances plus each rank mean's squared distance to the global one
    (centred across the ranks, not E[x²] − E[x]²). Without a process group
    the all-reduces are the identity (``parallel/mesh.py``) and the share is
    1.0, so one process computes ``xf.mean`` and its local variance bit for
    bit, and a group of one rounds alike."""
    n = mesh.global_rows(xf.shape[0]) * xf.shape[1] * xf.shape[2]
    share = xf.shape[0] * xf.shape[1] * xf.shape[2] / n
    m = xf.mean((0, 1, 2))
    v = xf.var((0, 1, 2), unbiased=False) if local_var is None else local_var(xf, m)
    mean = mesh.all_reduce(m * share)
    var = mesh.all_reduce((v + (m - mean) ** 2) * share)
    return mean, var, n


def batchnorm(x: torch.Tensor, p: dict, train: bool, momentum: float = 0.9,
              eps: float = 1e-5):
    """BatchNorm over NHW → (y, updated running statistics). torch semantics:
    batch statistics in train mode (biased variance to normalise, unbiased
    for the running update), running statistics in eval. ``momentum`` is the
    share of the old running value that is KEPT (torch's ``1 - momentum``).
    The statistics are reduced in fp32 and held in x's dtype, as
    ``jnp.mean`` / ``jnp.var`` hold them, over the global batch
    (:func:`global_moments`), as the JAX package's SPMD reduction over its
    sharded batch axis."""
    if train:
        xf = x.float()
        mean, var, n = global_moments(xf)
        mean, var = mean.to(x.dtype), var.to(x.dtype)
        with torch.no_grad():
            new_stats = {"mean": momentum * p["mean"] + (1 - momentum) * mean,
                         "var": momentum * p["var"] + (1 - momentum) * (var * n / max(n - 1, 1))}
    else:
        mean, var = p["mean"], p["var"]
        new_stats = {"mean": p["mean"], "var": p["var"]}
    y = (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y, new_stats


def act(x: torch.Tensor, kind: Optional[str], slope: float = 0.2) -> torch.Tensor:
    """relu / leakyrelu(slope) / none (reference act factory ``block.py:12-25``)."""
    if kind is None:
        return x
    if kind == "relu":
        return torch.relu(x)
    if kind in ("leakyrelu", "lrelu"):
        return torch.where(x >= 0, x, x * slope)
    raise NotImplementedError(f"activation [{kind}]")


def gaussian_noise(x: torch.Tensor, noise: torch.Tensor, sigma: float,
                   relative_detach: bool = False) -> torch.Tensor:
    """nESRGAN+ noise injection (reference ``block.py:110-122``): additive
    noise with per-element scale ``sigma * x``, ``x + noise·(σ·x)`` with
    ``noise`` pre-drawn standard normals of x's shape. Train-time only
    (callers gate on the train flag). With ``relative_detach`` the scale is
    cut out of the gradient. σ is rounded to x's dtype first, as a weakly
    typed scalar is in the JAX package."""
    scale = torch.tensor(sigma, dtype=x.dtype) * (x.detach() if relative_detach else x)
    return x + noise.to(x.dtype) * scale


class _FusedRelativeNoise(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fac, detach):
        ctx.save_for_backward(None if detach else fac)
        ctx.dtype = x.dtype
        return (x.float() * fac).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (fac,) = ctx.saved_tensors
        return (g if fac is None else (g.float() * fac).to(ctx.dtype)), None, None


def fused_relative_noise(x: torch.Tensor, noise: torch.Tensor, sigma: float,
                         relative_detach: bool = False) -> torch.Tensor:
    """The fused noise mode's arithmetic on the plain graph: ``x·(1 + σn)``
    in fp32 with the fp32 draws ``noise``, rounded to x's dtype once (the
    order of the JAX package's in-kernel epilogue, ``kernels/rdb_ct.py``
    :258-266). The gradient is ``g·(1 + σn)``, or ``g`` with
    ``relative_detach``: the forward is the same either way."""
    return _FusedRelativeNoise.apply(x, 1.0 + sigma * noise.float(), bool(relative_detach))


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
