"""The RRDB trunk's kernels: a whole ResidualDenseBlock (``rdb_ct``) and the
trunk conv with the global residual (``conv3x3_ct``).

Counterpart of ``esrganplus_tpu/kernels/rdb_ct.py``. The TPU kernel keeps one
block in ``[C, pixels-in-lanes]`` VMEM planes with the column taps merged into
the dot's output rows; here activations are NHWC and the CUDA kernel
(``csrc/rdb_ct.cu``) is a dense-stage 3x3 conv launched five times per RDB
over a per-call NHWC buffer ``[B, H, W, 4·gc]`` holding x1|x2|x3|x4 (x is read
in place), so concatenation costs nothing.

Numerics match the TPU kernel's: fp32 accumulation, one rounding to the
activation dtype per stage output (x1..x4), and stage 5 computes
``β·x5 + x`` — and for an RRDB's third block ``(β·x5 + x)·β + h0`` — in fp32
with a single rounding.

Each CUDA wrapper has a plain PyTorch twin (``*_plain``) with the same
rounding points. A CPU tensor goes to the twin; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from esrganplus_tpu_torch.kernels import build
from esrganplus_tpu_torch.models.layers import fp32_exact

# dense-stage epilogue modes (csrc/rdb_ct.cu)
_ACT, _ACT_1X1, _ACT_ADD, _RESID = 0, 1, 2, 3


def _bias(b: Optional[torch.Tensor], n: int, device) -> torch.Tensor:
    """fp32 bias, zeros for a bias-free conv (the kernels always take one)."""
    if b is None:
        return torch.zeros(n, dtype=torch.float32, device=device)
    return b.float().contiguous()


def prepare_rdb_ct_weights(p: dict, dtype: torch.dtype) -> dict:
    """One RDB's params (HWIO, the JAX package's layout) → kernel weights:
    ``w1..w5`` ``[3, 3, Cin_k, S_k]`` and ``w11`` ``[nf, gc]`` (or None) in
    ``dtype``, biases ``b1..b5`` in fp32, all contiguous."""
    out = {}
    for k in range(1, 6):
        conv = p[f"conv{k}"]
        w = conv["w"]
        out[f"w{k}"] = w.to(dtype).contiguous()
        out[f"b{k}"] = _bias(conv.get("b"), w.shape[3], w.device)
    w11 = p.get("conv1x1")
    out["w11"] = None if w11 is None else w11["w"][0, 0].to(dtype).contiguous()
    return out


def prepare_conv_ct_weights(w: torch.Tensor, b: Optional[torch.Tensor],
                            dtype: torch.dtype):
    """``[3, 3, Cin, Cout]`` conv weights → (weights in ``dtype``, fp32 bias)."""
    return w.to(dtype).contiguous(), _bias(b, w.shape[3], w.device)


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.float().permute(0, 3, 1, 2)


def _conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
          padding: Optional[int] = None) -> torch.Tensor:
    """fp32 conv (SAME unless ``padding`` is given) of NCHW ``x`` with HWIO
    ``w`` whose values are already rounded to the working dtype: the
    kernel's fp32 accumulation, TF32 off."""
    pad = w.shape[0] // 2 if padding is None else padding
    with fp32_exact():
        return F.conv2d(x, w.float().permute(3, 2, 0, 1), b, padding=pad)


def _lrelu(t: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(t >= 0, t, t * slope)


def rdb_ct_plain(x: torch.Tensor, w: dict, res: Optional[torch.Tensor] = None, *,
                 rrdb_scale: Optional[float] = None, slope: float = 0.2,
                 res_scale: float = 0.2) -> torch.Tensor:
    """Plain twin of :func:`rdb_ct` (same rounding points), NHWC in and out."""
    dt = x.dtype
    rnd = lambda t: t.to(dt).float()
    xf = _nchw(x)
    x1 = rnd(_lrelu(_conv(xf, w["w1"], w["b1"]), slope))
    x2 = _lrelu(_conv(torch.cat([xf, x1], 1), w["w2"], w["b2"]), slope)
    if w["w11"] is not None:
        x2 = x2 + _conv(xf, w["w11"][None, None], None)
    x2 = rnd(x2)
    x3 = rnd(_lrelu(_conv(torch.cat([xf, x1, x2], 1), w["w3"], w["b3"]), slope))
    x4 = rnd(_lrelu(_conv(torch.cat([xf, x1, x2, x3], 1), w["w4"], w["b4"]), slope)
             + x2)
    x5 = _conv(torch.cat([xf, x1, x2, x3, x4], 1), w["w5"], w["b5"])
    out = x5 * res_scale + xf
    if res is not None:
        out = out * rrdb_scale + _nchw(res)
    return out.to(dt).permute(0, 2, 3, 1).contiguous()


def conv3x3_ct_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                     res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin of :func:`conv3x3_ct`: conv + bias (+ res), one rounding."""
    y = _conv(_nchw(x), w, bias)
    if res is not None:
        y = y + _nchw(res)
    return y.to(x.dtype).permute(0, 2, 3, 1).contiguous()


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _dense(lib, x, cat, cin, w, b, out_ptr, out_stride, *, mode, cout, w11=None,
           r1=0, r1_stride=0, r2=0, r2_stride=0, alpha=1.0, beta2=1.0, slope=0.2):
    B, H, W, c0 = x.shape
    code = lib.esr_dense_conv3x3(
        build.dtype_code(x), cout, mode, x.data_ptr(), c0,
        None if cat is None else cat.data_ptr(),
        0 if cat is None else cat.shape[3], cin, w.data_ptr(), b.data_ptr(),
        None if w11 is None else w11.data_ptr(), out_ptr, out_stride,
        r1 or None, r1_stride, r2 or None, r2_stride, alpha, beta2, slope,
        B, H, W, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(code, "esr_dense_conv3x3")


def rdb_ct(x: torch.Tensor, w: dict, res: Optional[torch.Tensor] = None, *,
           rrdb_scale: Optional[float] = None, slope: float = 0.2,
           res_scale: float = 0.2) -> torch.Tensor:
    """One ResidualDenseBlock_5C: NHWC ``x`` ``[B, H, W, nf]`` → same shape.

    ``w`` from :func:`prepare_rdb_ct_weights`. With ``res`` (the RRDB's
    input h0) and ``rrdb_scale`` the RRDB epilogue ``out·rrdb_scale + res``
    is folded in. ``rdb_ct.launches`` counts calls that launched the CUDA
    kernel, ``rdb_ct.device_launches`` the kernel launches (5 per call)."""
    if (res is None) != (rrdb_scale is None):
        raise ValueError("rdb_ct: res and rrdb_scale go together")
    if x.device.type == "cpu":
        return rdb_ct_plain(x, w, res, rrdb_scale=rrdb_scale, slope=slope,
                            res_scale=res_scale)
    if x.dim() != 4:
        raise ValueError(f"rdb_ct: x must be NHWC, got shape {tuple(x.shape)}")
    B, H, W, nf = x.shape
    gc = w["w1"].shape[3]
    dt, dev = x.dtype, x.device
    build.dtype_code(x)
    build.require_width(nf, "nf")
    build.require_width(gc, "gc")
    build.require(x, "x", (B, H, W, nf), dt, dev)
    for k in range(1, 6):
        s = nf if k == 5 else gc
        build.require(w[f"w{k}"], f"w{k}", (3, 3, nf + (k - 1) * gc, s), dt, dev)
        build.require(w[f"b{k}"], f"b{k}", (s,), torch.float32, dev)
    if w["w11"] is not None:
        build.require(w["w11"], "w11", (nf, gc), dt, dev)
    if res is not None:
        build.require(res, "res", (B, H, W, nf), dt, dev)
    lib = build.load("rdb_ct")
    cat = torch.empty((B, H, W, 4 * gc), dtype=dt, device=dev)
    out = torch.empty_like(x)
    esz = x.element_size()
    with torch.cuda.device(dev):
        for k in range(1, 5):
            if k == 2 and w["w11"] is not None:
                extra = dict(mode=_ACT_1X1, w11=w["w11"])
            elif k == 4:  # x4 += x2, read back from the buffer
                extra = dict(mode=_ACT_ADD, r1=cat.data_ptr() + gc * esz,
                             r1_stride=4 * gc)
            else:
                extra = dict(mode=_ACT)
            _dense(lib, x, cat, nf + (k - 1) * gc, w[f"w{k}"], w[f"b{k}"],
                   cat.data_ptr() + (k - 1) * gc * esz, 4 * gc, cout=gc,
                   slope=slope, **extra)
        _dense(lib, x, cat, nf + 4 * gc, w["w5"], w["b5"], out.data_ptr(), nf,
               mode=_RESID, cout=nf, r1=x.data_ptr(), r1_stride=nf,
               r2=0 if res is None else res.data_ptr(), r2_stride=nf,
               alpha=res_scale, beta2=1.0 if rrdb_scale is None else rrdb_scale)
    rdb_ct.launches += 1
    rdb_ct.device_launches += 5
    return out


rdb_ct.launches = 0
rdb_ct.device_launches = 0


def conv3x3_ct(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
               res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SAME 3×3 conv + bias (+ residual ``res``), NHWC ``[B, H, W, Cin]`` →
    ``[B, H, W, Cout]``, one rounding. ``w``/``bias`` from
    :func:`prepare_conv_ct_weights`. ``conv3x3_ct.launches`` counts CUDA
    launches."""
    if x.device.type == "cpu":
        return conv3x3_ct_plain(x, w, bias, res)
    if x.dim() != 4:
        raise ValueError(f"conv3x3_ct: x must be NHWC, got shape {tuple(x.shape)}")
    B, H, W, cin = x.shape
    cout = w.shape[3]
    dt, dev = x.dtype, x.device
    build.dtype_code(x)
    build.require_width(cout, "cout")
    build.require(x, "x", (B, H, W, cin), dt, dev)
    build.require(w, "w", (3, 3, cin, cout), dt, dev)
    build.require(bias, "bias", (cout,), torch.float32, dev)
    if res is not None:
        build.require(res, "res", (B, H, W, cout), dt, dev)
    lib = build.load("rdb_ct")
    out = torch.empty((B, H, W, cout), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        _dense(lib, x, None, cin, w, bias, out.data_ptr(), cout, mode=_RESID,
               cout=cout, r1=0 if res is None else res.data_ptr(),
               r1_stride=cout)
    conv3x3_ct.launches += 1
    return out


conv3x3_ct.launches = 0
