"""The RRDBNet upsample tail's kernels: ``upfold_ct`` (nearest-×2 + 3×3 conv
+ lrelu) and ``conv_hr_ct`` (hr_conv0 + lrelu fused with hr_conv1).

Counterpart of ``esrganplus_tpu/kernels/tail_ct.py``. The TPU kernels carry
the growing width as column-phase planes in a ``[C, pixels]`` layout; here
activations are plain NHWC and the CUDA kernels (``csrc/tail_ct.cu``) write
the HR image directly. What is kept is what they compute and where they
round: the 2×2 dense fold of the upconv (weights folded in fp32, then cast),
one rounding of each upconv output, conv0's activation rounded and zeroed
outside the image before conv1, and conv1's output in the working dtype.

A CPU tensor goes to the plain twin (``*_plain``); a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from esrganplus_tpu_torch.kernels import build
from esrganplus_tpu_torch.kernels.rdb_ct import _bias, _conv, _lrelu, _nchw


def prepare_upfold_ct(w: torch.Tensor, b: Optional[torch.Tensor],
                      dtype: torch.dtype):
    """Upconv weights ``[3, 3, C, CO]`` (HWIO) → folded
    ``[2(a), 2(b), 2(i), 2(j), C, CO]`` in ``dtype`` + fp32 bias.

    Output phase (a, b) of the nearest-×2 conv reads LR rows ``y + a - 1 + i``
    and columns ``x + b - 1 + j``; entry (a, b, i, j) sums the HR taps
    (r, s) that land there: ``⌊(a + r - 1)/2⌋ = a - 1 + i``. Folded in fp32
    and cast once, as the JAX tail does (``models/rrdb.py:448``)."""
    pm = torch.zeros(2, 2, 3, dtype=torch.float32, device=w.device)
    for a in range(2):
        for r in range(3):
            pm[a, (a + r - 1) // 2 - (a - 1), r] = 1.0
    wf = torch.einsum("air,bjs,rsco->abijco", pm, pm, w.float())
    return wf.to(dtype).contiguous(), _bias(b, w.shape[3], w.device)


def prepare_conv_hr_ct(hr0: dict, hr1: dict, dtype: torch.dtype):
    """hr_conv0 / hr_conv1 params → (w0, b0, w1, b1): HWIO weights in
    ``dtype``, fp32 biases."""
    return (hr0["w"].to(dtype).contiguous(), _bias(hr0.get("b"), hr0["w"].shape[3],
                                                   hr0["w"].device),
            hr1["w"].to(dtype).contiguous(), _bias(hr1.get("b"), hr1["w"].shape[3],
                                                   hr1["w"].device))


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------


def upfold_ct_plain(x: torch.Tensor, wf: torch.Tensor, bias: torch.Tensor, *,
                    slope: float = 0.2) -> torch.Tensor:
    """Plain twin of :func:`upfold_ct`: per output phase, a VALID 2×2 conv
    of the zero-padded LR input with that phase's folded weights."""
    B, H, W, _ = x.shape
    CO = wf.shape[-1]
    xp = F.pad(_nchw(x), (1, 1, 1, 1))
    out = torch.empty((B, CO, 2 * H, 2 * W), dtype=torch.float32, device=x.device)
    for a in range(2):
        for b in range(2):
            win = xp[:, :, a:a + H + 1, b:b + W + 1]
            y = _conv(win, wf[a, b], bias, padding=0)
            out[:, :, a::2, b::2] = _lrelu(y, slope)
    return out.to(x.dtype).permute(0, 2, 3, 1).contiguous()


def conv_hr_ct_plain(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                     w1: torch.Tensor, b1: torch.Tensor, *,
                     slope: float = 0.2) -> torch.Tensor:
    """Plain twin of :func:`conv_hr_ct`: conv0 + lrelu rounded to the
    working dtype, then conv1 (its SAME padding zero-pads conv0's output)."""
    dt = x.dtype
    mid = _lrelu(_conv(_nchw(x), w0, b0), slope).to(dt).float()
    return _conv(mid, w1, b1).to(dt).permute(0, 2, 3, 1).contiguous()


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def upfold_ct(x: torch.Tensor, wf: torch.Tensor, bias: torch.Tensor, *,
              slope: float = 0.2) -> torch.Tensor:
    """Nearest-×2 + 3×3 conv + bias + lrelu: NHWC ``[B, H, W, C]`` →
    ``[B, 2H, 2W, CO]``. ``wf``/``bias`` from :func:`prepare_upfold_ct`.
    ``upfold_ct.launches`` counts CUDA launches."""
    if x.device.type == "cpu":
        return upfold_ct_plain(x, wf, bias, slope=slope)
    if x.dim() != 4:
        raise ValueError(f"upfold_ct: x must be NHWC, got shape {tuple(x.shape)}")
    B, H, W, C = x.shape
    CO = wf.shape[-1]
    dt, dev = x.dtype, x.device
    build.dtype_code(x)
    build.require_width(CO, "CO")
    build.require(x, "x", (B, H, W, C), dt, dev)
    build.require(wf, "wf", (2, 2, 2, 2, C, CO), dt, dev)
    build.require(bias, "bias", (CO,), torch.float32, dev)
    lib = build.load("tail_ct")
    out = torch.empty((B, 2 * H, 2 * W, CO), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        code = lib.esr_upfold(build.dtype_code(x), C, CO, x.data_ptr(),
                              wf.data_ptr(), bias.data_ptr(), out.data_ptr(),
                              B, H, W, slope,
                              torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "esr_upfold")
    upfold_ct.launches += 1
    return out


upfold_ct.launches = 0


def conv_hr_ct(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
               w1: torch.Tensor, b1: torch.Tensor, *,
               slope: float = 0.2) -> torch.Tensor:
    """hr_conv0 (3×3 C→C + lrelu) fused with hr_conv1 (3×3 C→CO2): NHWC
    ``[B, H, W, C]`` → ``[B, H, W, CO2]`` in the input dtype. Weights from
    :func:`prepare_conv_hr_ct`. ``conv_hr_ct.launches`` counts CUDA
    launches."""
    if x.device.type == "cpu":
        return conv_hr_ct_plain(x, w0, b0, w1, b1, slope=slope)
    if x.dim() != 4:
        raise ValueError(f"conv_hr_ct: x must be NHWC, got shape {tuple(x.shape)}")
    B, H, W, C = x.shape
    CO2 = w1.shape[3]
    dt, dev = x.dtype, x.device
    build.dtype_code(x)
    build.require_width(C, "C")
    build.require_width(CO2, "CO2", range(1, 9))
    build.require(x, "x", (B, H, W, C), dt, dev)
    build.require(w0, "w0", (3, 3, C, C), dt, dev)
    build.require(b0, "b0", (C,), torch.float32, dev)
    build.require(w1, "w1", (3, 3, C, CO2), dt, dev)
    build.require(b1, "b1", (CO2,), torch.float32, dev)
    lib = build.load("tail_ct")
    out = torch.empty((B, H, W, CO2), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        code = lib.esr_conv_hr(build.dtype_code(x), C, CO2, x.data_ptr(),
                               w0.data_ptr(), b0.data_ptr(), w1.data_ptr(),
                               b1.data_ptr(), out.data_ptr(), B, H, W, slope,
                               torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "esr_conv_hr")
    conv_hr_ct.launches += 1
    return out


conv_hr_ct.launches = 0
