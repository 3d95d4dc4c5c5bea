"""A 3×3 stride-1 SAME convolution as an implicit GEMM (``conv3x3``).

Counterpart of ``esrganplus_tpu/kernels/workbench/conv.py``: NHWC
``[B, H, W, Cin]`` × HWIO ``[3, 3, Cin, Cout]`` + bias, an optional fused
(leaky) ReLU, in the input's dtype. What the TPU kernel computes is kept:
the weights *and the bias* are cast to x's dtype first (in bf16 the bias is
rounded to bf16), the nine taps accumulate in fp32, the bias is added in
fp32, then the activation, then one rounding. Its channel pad to 128 and its
column over-fetch were DMA constraints of the TPU and are gone; the CUDA
kernels (``csrc/workbench_conv.cu``) take any Cin and Cout.

Two designs, picked by :func:`conv_design` from the dtype: ``"mma"`` (bf16
on the tensor cores, ``wb_conv3x3_mma_kernel``: a block computes one 8×16
pixel tile for one chunk of :func:`conv_chunk_width` output channels, the
chunks over the grid, :func:`conv_chunks`) and ``"fma"`` (fp32 on the CUDA
cores, whose 1e-4 bar TF32 would miss). The C entry takes the design code
and refuses the other; ``conv3x3.launches_by_design`` counts launches by
design.

``tile`` keeps the JAX function's contract on the spatial tile: ``None``
picks the largest of (64, 32, 16, 8) dividing H and W (else ``ValueError``),
and an explicit tile must divide both (the JAX function leaves the rows past
the last whole tile unwritten there; this one raises). It does not choose the
CUDA kernel's own tiling.

A CPU tensor goes to the plain twin (:func:`conv3x3_plain`); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from esrganplus_tpu_torch.kernels import build
from esrganplus_tpu_torch.kernels.stage_ct import DESIGNS, _aligned
from esrganplus_tpu_torch.models.layers import fp32_exact

TILES = (64, 32, 16, 8)  # the JAX function's candidate tiles, largest first
MMA_MAX_NP = 128         # output channels one tensor-core block computes at most


def conv_design(dtype: torch.dtype) -> str:
    """Which CUDA design runs :func:`conv3x3` on ``dtype`` activations:
    ``"mma"`` (bf16 on the tensor cores) or ``"fma"`` (fp32 on the CUDA
    cores), at every Cin and Cout."""
    if dtype not in build.DTYPE_CODES:
        raise TypeError(f"conv3x3: x must be float32 or bfloat16, got {dtype}")
    return "mma" if dtype == torch.bfloat16 else "fma"


def conv_chunk_width(cout: int) -> int:
    """Output channels of one tensor-core block (``csrc/workbench_conv.cu``
    ``chunk_np``): the narrowest power of two from 8 holding Cout up to 128;
    above, 64 or 128, whichever pads less (128 on a tie)."""
    if cout <= MMA_MAX_NP:
        return next(n for n in (8, 16, 32, 64, 128) if n >= cout)
    return 128 if -(-cout // 128) * 128 <= -(-cout // 64) * 64 else 64


def conv_chunks(cout: int) -> list:
    """``[(first, end)]`` output channels of each block chunk of the
    tensor-core design (``blockIdx.z`` mod the chunk count): chunks of
    :func:`conv_chunk_width`, the last one cut at Cout."""
    np_ = conv_chunk_width(cout)
    return [(n0, min(cout, n0 + np_)) for n0 in range(0, cout, np_)]


def pick_tile(h: int, w: int, tile: Optional[int] = None) -> int:
    """The spatial tile of ``conv3x3``'s contract: the largest of
    :data:`TILES` dividing H and W, or the given one if it divides both."""
    if tile is None:
        for cand in TILES:
            if h % cand == 0 and w % cand == 0:
                return cand
        raise ValueError(f"H={h}, W={w} not tileable; pad spatially first")
    if not isinstance(tile, int) or tile <= 0 or h % tile or w % tile:
        raise ValueError(f"tile={tile!r} does not divide H={h} and W={w}")
    return tile


def _act(v: torch.Tensor, act_slope: Optional[float]) -> torch.Tensor:
    if act_slope is None:
        return v
    return torch.where(v >= 0, v, v * act_slope)


def _check(x, w, b):
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv3x3: x [B, H, W, Cin] and w [3, 3, Cin, Cout], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if b is not None and tuple(b.shape) != (w.shape[3],):
        raise ValueError(f"conv3x3: b must be [{w.shape[3]}], got {tuple(b.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv3x3: x must be float32 or bfloat16, got {x.dtype}")


def _cast(x, w, b):
    """(w in x's dtype, the bias rounded to x's dtype and held in fp32)."""
    bias = (torch.zeros(w.shape[3], device=x.device) if b is None
            else b.to(x.dtype).float())
    return w.to(x.dtype), bias


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                  act_slope: Optional[float] = None, tile: Optional[int] = None) -> torch.Tensor:
    """Plain twin of :func:`conv3x3`: an fp32 conv (TF32 off) of the
    dtype-rounded values, the dtype-rounded bias added in fp32, the
    activation, one rounding."""
    _check(x, w, b)
    pick_tile(x.shape[1], x.shape[2], tile)
    wc, bias = _cast(x, w, b)
    with fp32_exact():
        y = F.conv2d(x.float().permute(0, 3, 1, 2), wc.float().permute(3, 2, 0, 1), bias,
                     padding=1)
    return _act(y, act_slope).to(x.dtype).permute(0, 2, 3, 1).contiguous()


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
            act_slope: Optional[float] = None, tile: Optional[int] = None) -> torch.Tensor:
    """3×3 stride-1 SAME conv + bias + optional activation: NHWC ``x``
    ``[B, H, W, Cin]`` (bf16 or fp32), HWIO ``w`` ``[3, 3, Cin, Cout]``,
    ``b`` ``[Cout]`` or None (zeros) → ``[B, H, W, Cout]`` in x's dtype.
    ``act_slope``: None linear, 0.0 ReLU, e.g. 0.2 LeakyReLU.
    ``conv3x3.launches`` counts CUDA launches, ``launches_by_design`` them
    by design (:func:`conv_design`)."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b, act_slope, tile)
    _check(x, w, b)
    B, H, W, cin = x.shape
    pick_tile(H, W, tile)
    cout = w.shape[3]
    wc, bias = _cast(x, w, b)
    dev = x.device
    design = conv_design(x.dtype)
    build.require(x, "x", (B, H, W, cin), x.dtype, dev)
    wc, bias = wc.contiguous(), bias.contiguous()
    build.require(wc, "w", (3, 3, cin, cout), x.dtype, dev)
    build.require(bias, "b", (cout,), torch.float32, dev)
    if design == "mma":  # the tensor-core kernel moves 16-byte vectors
        x, wc = _aligned(x), _aligned(wc)
    out = torch.empty((B, H, W, cout), dtype=x.dtype, device=dev)
    lib = build.load("workbench_conv")
    with torch.cuda.device(dev):
        code = lib.esr_wb_conv3x3(DESIGNS[design], build.dtype_code(x), x.data_ptr(),
                                  wc.data_ptr(), bias.data_ptr(), out.data_ptr(), B, H, W, cin,
                                  cout, int(act_slope is not None),
                                  0.0 if act_slope is None else float(act_slope),
                                  torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "esr_wb_conv3x3")
    conv3x3.launches += 1
    conv3x3.launches_by_design[design] += 1
    return out


def reset_launch_counts() -> None:
    """Set ``conv3x3.launches`` and ``launches_by_design`` to 0."""
    conv3x3.launches = 0
    conv3x3.launches_by_design = dict.fromkeys(DESIGNS, 0)


reset_launch_counts()
