"""One ESRGAN+ ResidualDenseBlock in one launch per spatial tile
(``rdb_fused``), on by-source weights.

Counterpart of ``esrganplus_tpu/kernels/workbench/rdb.py``. The weights are
regrouped by *source* (:func:`prepare_rdb_weights`): x, x1..x4 each convolve
once into their contributions to every later target, and a target is the sum
of its contributions. The CUDA kernel (``csrc/workbench_rdb.cu``) reads the
x tile once with a 5-pixel halo, keeps x1..x4 in shared memory and writes
only the block output.

Numerics are the TPU kernel's: every per-source contribution is rounded to
the activation dtype before any sum; x_i is the fp32 sum of the rounded
contributions plus the fp32 bias, then lrelu (x2 then adds the rounded 1×1
shortcut, x4 adds x2), zero outside the image, rounded once; x5 is the fp32
sum of the five rounded contributions plus b5, and ``x5·res_scale + x`` is
rounded once. Products are activations × weights in fp32 with the weights in
the dtype the prep gave them (bf16 by default, also for fp32 activations).

Forward only, as in the JAX package: with grad enabled and an input that
requires grad, :func:`rdb_fused` raises. H and W must be divisible by
``tile`` (the JAX contract); ``tile`` does not choose the CUDA kernel's own
tile (:data:`KERNEL_TILE`). A CPU tensor goes to the plain twin
(:func:`rdb_fused_plain`); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from esrganplus_tpu_torch.kernels import build
from esrganplus_tpu_torch.models.layers import fp32_exact

# (activation dtype, weight dtype) pairs the kernel and its twin take
DTYPES = ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
          (torch.float32, torch.bfloat16))
# The CUDA kernel's own tile. 8 rather than 16: at nf=64, gc=32 in bf16 a
# 16×16 tile needs ~200 KB of shared memory, so one block per SM and only 64
# blocks for a 128² image on the H100's 132 SMs; tile 8 (1.78× the products
# instead of 1.34×) measured faster there (chip_smoke.py kernels-workbench).
KERNEL_TILE = 8
MAX_SMEM = 232448            # opt-in shared memory per block on sm_90 (227 KB)


def prepare_rdb_weights(p: dict, nf: int, gc: int, conv1x1: bool,
                        dtype: torch.dtype = torch.bfloat16) -> tuple:
    """One RDB's params (HWIO) → ``(w0, .., w4, bias)``: ``w_i``
    ``[3 (kw), 3·C_i (kh-major), width_i]`` in ``dtype`` with lanes
    ``[t5 (nf) | t4 | t3 | t2 | t1 | (1×1 as a zero-padded 3×3, w0 only)]``;
    ``bias`` ``[1, nf + 4·gc]`` fp32 ordered b5 | b4 | b3 | b2 | b1. The JAX
    package's layout, bit for bit."""
    def src_w(lo, width, tail_targets, extra=None):
        parts = [p["conv5"]["w"][:, :, lo:lo + width, :]] + [
            p[f"conv{t}"]["w"][:, :, lo:lo + width, :] for t in tail_targets]
        if extra is not None:
            parts.append(extra)
        w = torch.cat(parts, -1)                        # [3 (kh), 3 (kw), width, n]
        return w.permute(1, 0, 2, 3).reshape(3, 3 * w.shape[2], w.shape[3])

    extra = None
    if conv1x1:
        extra = F.pad(p["conv1x1"]["w"], (0, 0, 0, 0, 1, 1, 1, 1))
    ws = [src_w(0, nf, (4, 3, 2, 1), extra)]
    for i in range(1, 5):
        ws.append(src_w(nf + (i - 1) * gc, gc, tuple(range(4, i, -1))))
    bias = torch.cat([p["conv5"]["b"]] + [p[f"conv{t}"]["b"] for t in (4, 3, 2, 1)])
    return (tuple(w.to(dtype).contiguous() for w in ws)
            + (bias.float().reshape(1, -1).contiguous(),))


def weight_shapes(nf: int, gc: int, conv1x1: bool) -> list:
    """The shapes of ``w0..w4`` for these widths."""
    shapes = [(3, 3 * nf, nf + 4 * gc + (gc if conv1x1 else 0))]
    return shapes + [(3, 3 * gc, nf + (4 - i) * gc) for i in range(1, 5)]


def _check(x, ws, bias, nf, gc, conv1x1, tile):
    if x.dim() != 4 or x.shape[3] != nf:
        raise ValueError(f"rdb_fused: x must be NHWC [B, H, W, {nf}], got {tuple(x.shape)}")
    H, W = x.shape[1:3]
    if not isinstance(tile, int) or tile <= 0 or H % tile or W % tile:
        raise ValueError(f"rdb_fused: H={H} and W={W} must be divisible by tile={tile!r}")
    if (x.dtype, ws[0].dtype) not in DTYPES or any(w.dtype != ws[0].dtype for w in ws):
        raise TypeError(f"rdb_fused: (x, weights) dtypes must be one of "
                        f"{[tuple(str(d) for d in p) for p in DTYPES]}, got {x.dtype} and "
                        f"{[str(w.dtype) for w in ws]}")
    for i, (w, shape) in enumerate(zip(ws, weight_shapes(nf, gc, conv1x1))):
        if tuple(w.shape) != shape:
            raise ValueError(f"rdb_fused: w{i} shape {tuple(w.shape)}, expected {shape}")
    if tuple(bias.shape) != (1, nf + 4 * gc) or bias.dtype != torch.float32:
        raise ValueError(f"rdb_fused: bias must be fp32 [1, {nf + 4 * gc}], got "
                         f"{bias.dtype} {tuple(bias.shape)}")


def _forward_only(*ts):
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError("rdb_fused is forward only (no gradient, as in the JAX package): "
                           "call it under torch.no_grad() or on tensors that need none")


def rdb_fused_plain(x: torch.Tensor, w0, w1, w2, w3, w4, bias, *, nf: int, gc: int,
                    conv1x1: bool = True, slope: float = 0.2, res_scale: float = 0.2,
                    tile: int = 64) -> torch.Tensor:
    """Plain twin of :func:`rdb_fused`: the by-source graph on the whole
    image (SAME convs, which is the kernel's zero ring) with the TPU
    kernel's rounding points, fp32 convs with TF32 off."""
    ws = (w0, w1, w2, w3, w4)
    _check(x, ws, bias, nf, gc, conv1x1, tile)
    dt = x.dtype
    rnd = lambda t: t.to(dt).float()
    b = bias.float().flatten()
    off = lambda j: nf + (4 - j) * gc                  # lane (and bias) offset of target j
    tgt = lambda c, j: c[:, off(j):off(j) + gc]
    lrelu = lambda t: torch.where(t >= 0, t, t * slope)

    def contrib(src, w):
        """The source's rounded contributions to every later target, NCHW."""
        hwio = w.float().reshape(3, 3, w.shape[1] // 3, w.shape[2]).permute(1, 0, 2, 3)
        with fp32_exact():
            return rnd(F.conv2d(src, hwio.permute(3, 2, 0, 1), padding=1))

    xs = [x.float().permute(0, 3, 1, 2)]
    cs = []
    for j in range(1, 5):
        cs.append(contrib(xs[-1], ws[j - 1]))
        t = tgt(cs[0], j)
        for i in range(1, j):
            t = t + tgt(cs[i], j)
        t = lrelu(t + b[off(j):off(j) + gc, None, None])
        if j == 2 and conv1x1:
            t = t + cs[0][:, nf + 4 * gc:]
        elif j == 4:
            t = t + xs[2]
        xs.append(rnd(t))
    cs.append(contrib(xs[4], ws[4]))
    x5 = cs[0][:, :nf]
    for c in cs[1:]:
        x5 = x5 + c[:, :nf]
    x5 = x5 + b[:nf, None, None]
    out = x5 * res_scale + xs[0]
    return out.to(dt).permute(0, 2, 3, 1).contiguous()


def smem_bytes(dtype: torch.dtype, nf: int, gc: int, t: int) -> int:
    """One block's shared memory at kernel tile ``t`` (the count
    ``csrc/workbench_rdb.cu`` launches with)."""
    n = nf * (t + 10) ** 2 + gc * sum((t + 2 * (5 - j)) ** 2 for j in range(1, 5))
    return n * torch.tensor([], dtype=dtype).element_size()


def _rdb_fused_cuda(x, ws, bias, *, nf, gc, conv1x1, slope, res_scale,
                    ktile: Optional[int] = None):
    """One launch at kernel tile ``ktile`` (default :data:`KERNEL_TILE`)."""
    if nf % 8 or gc % 8:
        raise ValueError(f"rdb_fused: the CUDA kernel takes nf and gc divisible by 8, "
                         f"got nf={nf}, gc={gc}")
    dev = x.device
    for name, t in (("x", x), *((f"w{i}", w) for i, w in enumerate(ws)), ("bias", bias)):
        build.require(t, name, tuple(t.shape), t.dtype, dev)
        if t.data_ptr() % 16:
            raise ValueError(f"rdb_fused: {name} must be 16-byte aligned")
    t = KERNEL_TILE if ktile is None else ktile
    if smem_bytes(x.dtype, nf, gc, t) > MAX_SMEM:
        raise ValueError(f"rdb_fused: nf={nf}, gc={gc} in {x.dtype} need more shared memory "
                         f"than a block has at kernel tile {t}")
    B, H, W, _ = x.shape
    out = torch.empty_like(x)
    lib = build.load("workbench_rdb")
    with torch.cuda.device(dev):
        code = lib.esr_wb_rdb_fused(build.dtype_code(x), build.dtype_code(ws[0]), x.data_ptr(),
                                    *(w.data_ptr() for w in ws), bias.data_ptr(),
                                    out.data_ptr(), B, H, W, nf, gc, int(conv1x1),
                                    float(slope), float(res_scale), t,
                                    torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "esr_wb_rdb_fused")
    rdb_fused.launches += 1
    return out


def rdb_fused(x: torch.Tensor, w0, w1, w2, w3, w4, bias, *, nf: int, gc: int,
              conv1x1: bool = True, slope: float = 0.2, res_scale: float = 0.2,
              tile: int = 64) -> torch.Tensor:
    """Fused RDB forward: NHWC ``x`` ``[B, H, W, nf]`` (bf16 or fp32) → the
    same shape and dtype. Weights from :func:`prepare_rdb_weights`; H and W
    divisible by ``tile``. ``rdb_fused.launches`` counts CUDA launches."""
    ws = (w0, w1, w2, w3, w4)
    _forward_only(x, *ws, bias)
    if x.device.type == "cpu":
        return rdb_fused_plain(x, *ws, bias, nf=nf, gc=gc, conv1x1=conv1x1, slope=slope,
                               res_scale=res_scale, tile=tile)
    _check(x, ws, bias, nf, gc, conv1x1, tile)
    return _rdb_fused_cuda(x, ws, bias, nf=nf, gc=gc, conv1x1=conv1x1, slope=slope,
                           res_scale=res_scale)


rdb_fused.launches = 0
