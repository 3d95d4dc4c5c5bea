"""The RRDBNet upsample tail's kernels: ``upfold_ct`` (nearest-×2 + 3×3 conv
+ lrelu) and ``conv_hr_ct`` (hr_conv0 + lrelu fused with hr_conv1).

Counterpart of ``esrganplus_tpu/kernels/tail_ct.py``. The TPU kernels carry
the growing width as column-phase planes in a ``[C, pixels]`` layout; here
activations are plain NHWC and the CUDA kernels (``csrc/tail_ct.cu``) write
the HR image directly. What is kept is what they compute and where they
round: the 2×2 dense fold of the upconv (weights folded in fp32, then cast),
one rounding of each upconv output, conv0's activation rounded and zeroed
outside the image before conv1, and conv1's output in the working dtype.

Training goes through ``upfold_ct_diff`` and ``conv_hr_ct_diff``
(``torch.autograd.Function``s; fp32 master weights in, fp32 gradients out).
Their backwards, ``upfold_ct_bwd`` and ``conv_hr_ct_bwd``, are built from the
data- and weight-gradient kernels of ``csrc/dgrad_ct.cu`` and
``csrc/wgrad_ct.cu``: the upconv's per-phase 2×2 convs are embedded in 3×3 taps
and read the HR cotangent through a phase view, gated by the saved output's
sign; conv_hr's adjoint recomputes conv0's activation with the forward's dense
kernel, as the TPU kernel recomputes it per stripe.

A CPU tensor goes to the plain twin (``*_plain``); a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from esrganplus_tpu_torch.kernels import build
from esrganplus_tpu_torch.kernels import launch
from esrganplus_tpu_torch.kernels.rdb_ct import (_bias, _conv, _dense, _dgrad_plain, _dlrelu,
                                                 _lrelu, _nchw, _wgrad_plain)
from esrganplus_tpu_torch.models.layers import fp32_exact


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


# ---------------------------------------------------------------------------
# training: backward twins, backward kernels, autograd Functions
# ---------------------------------------------------------------------------


def upfold_ct_bwd_plain(x, wf, out, g, *, slope: float = 0.2) -> dict:
    """Plain twin of :func:`upfold_ct_bwd` → ``{"dx", "wf", "b"}``: per
    output phase the adjoint of the forward twin's VALID 2×2 conv, the lrelu
    mask from the saved output's sign, dz rounded before each product."""
    B, H, W, C = x.shape
    dt = x.dtype
    xp = F.pad(_nchw(x), (1, 1, 1, 1))
    of, gf = _nchw(out), _nchw(g)
    dxp = torch.zeros_like(xp)
    dwf = torch.zeros(wf.shape, dtype=torch.float32, device=x.device)
    db = torch.zeros(wf.shape[-1], dtype=torch.float32, device=x.device)
    for a in range(2):
        for b in range(2):
            dz = _dlrelu(of[:, :, a::2, b::2], gf[:, :, a::2, b::2], slope)
            dzr = dz.to(dt).float()
            win = xp[:, :, a:a + H + 1, b:b + W + 1]
            with fp32_exact():
                dw = torch.nn.grad.conv2d_weight(win, (dz.shape[1], C, 2, 2), dzr)
                dwin = F.conv_transpose2d(dzr, wf[a, b].float().permute(3, 2, 0, 1))
            dwf[a, b] = dw.permute(2, 3, 1, 0)
            dxp[:, :, a:a + H + 1, b:b + W + 1] += dwin
            db += dz.sum((0, 2, 3))
    dx = dxp[:, :, 1:-1, 1:-1].to(dt).permute(0, 2, 3, 1).contiguous()
    return {"dx": dx, "wf": dwf, "b": db}


def conv_hr_ct_bwd_plain(x, w0, b0, w1, g, *, slope: float = 0.2) -> dict:
    """Plain twin of :func:`conv_hr_ct_bwd` →
    ``{"dx", "w0", "b0", "w1", "b1"}``: conv0's activation recomputed and
    rounded as in the forward, conv1's adjoint, the lrelu gate, conv0's
    adjoint; ``dz0`` rounded before its products, ``db0`` summed unrounded."""
    dt = x.dtype
    xf, gf = _nchw(x), _nchw(g)
    hid = _lrelu(_conv(xf, w0, b0), slope).to(dt).float()
    dz0 = _dlrelu(hid, _dgrad_plain(gf, w1), slope)
    dz0r = dz0.to(dt).float()
    return {"dx": _dgrad_plain(dz0r, w0).to(dt).permute(0, 2, 3, 1).contiguous(),
            "w0": _wgrad_plain(xf, dz0r), "b0": dz0.sum((0, 2, 3)),
            "w1": _wgrad_plain(hid, gf), "b1": gf.sum((0, 2, 3))}


def _embed_phases(wf: torch.Tensor) -> torch.Tensor:
    """Folded ``[2, 2, 2, 2, C, CO]`` → ``[3, 3, C, 4·CO]``: phase (a, b)'s
    2×2 taps (i, j) sit at 3×3 taps (a + i, b + j) of its CO channels."""
    C, CO = wf.shape[-2:]
    w3 = torch.zeros((3, 3, C, 4, CO), dtype=wf.dtype, device=wf.device)
    for a in range(2):
        for b in range(2):
            w3[a:a + 2, b:b + 2, :, 2 * a + b] = wf[a, b]
    return w3.view(3, 3, C, 4 * CO)


def upfold_ct_bwd(x, wf, out, g, *, slope: float = 0.2) -> dict:
    """Adjoint of :func:`upfold_ct` from its input, cast folded weights and
    saved output → ``{"dx", "wf", "b"}`` (``wf`` the folded weights' fp32
    gradient). ``upfold_ct_bwd.launches`` counts CUDA calls."""
    if x.device.type == "cpu":
        return upfold_ct_bwd_plain(x, wf, out, g, slope=slope)
    B, H, W, C = x.shape
    CO = wf.shape[-1]
    dt, dev = x.dtype, x.device
    build.require_width(CO, "CO")
    build.require(x, "x", (B, H, W, C), dt, dev)
    build.require(wf, "wf", (2, 2, 2, 2, C, CO), dt, dev)
    build.require(out, "out", (B, 2 * H, 2 * W, CO), dt, dev)
    build.require(g, "g", (B, 2 * H, 2 * W, CO), dt, dev)
    phase = lambda coff: launch.dz_src(H, W, build.DZ_PHASE, g=g, mask=out.data_ptr(), co=CO,
                                       coff=coff, slope=slope)
    dx = torch.empty_like(x)
    dwf = torch.empty((2, 2, 2, 2, C, CO), dtype=torch.float32, device=dev)
    db = None
    with torch.cuda.device(dev):
        launch.dgrad(x, B, phase(0), 4 * CO, _embed_phases(wf), C,
                     chunk=launch.dgrad_chunk(C), out=dx)
        for a in range(2):
            for b in range(2):
                dw3, dbp = launch.wgrad(x, None, C, phase((2 * a + b) * CO), CO)
                dwf[a, b] = dw3.view(3, 3, C, CO)[a:a + 2, b:b + 2]
                db = dbp if db is None else db + dbp
    upfold_ct_bwd.launches += 1
    return {"dx": dx, "wf": dwf, "b": db}


upfold_ct_bwd.launches = 0


def conv_hr_ct_bwd(x, w0, b0, w1, g, *, slope: float = 0.2) -> dict:
    """Adjoint of :func:`conv_hr_ct` → ``{"dx", "w0", "b0", "w1", "b1"}``.
    conv0's activation never left shared memory in the forward, so it is
    recomputed here (the forward's dense kernel, rounded as there) into a
    device buffer; SAME padding of that buffer is the forward's zeroing
    outside the image. ``conv_hr_ct_bwd.launches`` counts CUDA calls."""
    if x.device.type == "cpu":
        return conv_hr_ct_bwd_plain(x, w0, b0, w1, g, slope=slope)
    B, H, W, C = x.shape
    CO2 = w1.shape[3]
    dt, dev = x.dtype, x.device
    build.require_width(C, "C")
    build.require_width(CO2, "CO2", range(1, 9))
    build.require(x, "x", (B, H, W, C), dt, dev)
    build.require(w0, "w0", (3, 3, C, C), dt, dev)
    build.require(b0, "b0", (C,), torch.float32, dev)
    build.require(w1, "w1", (3, 3, C, CO2), dt, dev)
    build.require(g, "g", (B, H, W, CO2), dt, dev)
    hid = torch.empty_like(x)
    dhid = torch.empty((B, H, W, C), dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    chunk = launch.dgrad_chunk(C)
    with torch.cuda.device(dev):
        _dense(build.load("rdb_ct"), x, None, C, w0, b0, hid.data_ptr(), C, mode=launch.ACT,
               cout=C, slope=slope)
        dz1 = launch.dz_src(H, W, build.DZ_G, g=g, g_stride=CO2)
        dw1, db1 = launch.wgrad(hid, None, C, dz1, CO2)
        launch.dgrad(x, B, dz1, CO2, w1, C, chunk=chunk, out32=dhid)
        dz0 = launch.dz_src(H, W, build.DZ_GATE, d32=dhid, d_stride=C, mask=hid.data_ptr(),
                            m_stride=C, slope=slope)
        dw0, db0 = launch.wgrad(x, None, C, dz0, C)
        launch.dgrad(x, B, dz0, C, w0, C, chunk=chunk, out=dx)
    conv_hr_ct_bwd.launches += 1
    return {"dx": dx, "w0": dw0.view(3, 3, C, C), "b0": db0,
            "w1": dw1.view(3, 3, C, CO2), "b1": db1}


conv_hr_ct_bwd.launches = 0


class _UpfoldCtDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wf, bias, slope):
        out = upfold_ct(x, wf.to(x.dtype).contiguous(), bias.float().contiguous(),
                        slope=slope)
        ctx.save_for_backward(x, wf, out)
        ctx.slope = slope
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, wf, out = ctx.saved_tensors
        r = upfold_ct_bwd(x, wf.to(x.dtype).contiguous(), out, g.to(x.dtype).contiguous(),
                          slope=ctx.slope)
        return r["dx"], r["wf"].to(wf.dtype), r["b"], None


def upfold_ct_diff(x: torch.Tensor, wf: torch.Tensor, bias: torch.Tensor, *,
                   slope: float = 0.2) -> torch.Tensor:
    """Differentiable :func:`upfold_ct`. ``wf`` is the folded weight as an
    fp32 master (``prepare_upfold_ct(w, b, torch.float32)``, itself
    differentiable, so autograd carries the gradient back through the fold to
    the canonical ``[3, 3, C, CO]`` weight); it is cast to ``x.dtype`` inside."""
    return _UpfoldCtDiff.apply(x.contiguous(), wf, bias, slope)


class _ConvHrCtDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w0, b0, w1, b1, slope):
        dt = x.dtype
        ctx.save_for_backward(x, w0, b0, w1)
        ctx.slope = slope
        return conv_hr_ct(x, w0.to(dt).contiguous(), b0.float().contiguous(),
                          w1.to(dt).contiguous(), b1.float().contiguous(), slope=slope)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w0, b0, w1 = ctx.saved_tensors
        dt = x.dtype
        r = conv_hr_ct_bwd(x, w0.to(dt).contiguous(), b0.float().contiguous(),
                           w1.to(dt).contiguous(), g.to(dt).contiguous(), slope=ctx.slope)
        return r["dx"], r["w0"].to(w0.dtype), r["b0"], r["w1"].to(w1.dtype), r["b1"], None


def conv_hr_ct_diff(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, w1: torch.Tensor,
                    b1: torch.Tensor, *, slope: float = 0.2) -> torch.Tensor:
    """Differentiable :func:`conv_hr_ct`; HWIO fp32 master weights, cast to
    ``x.dtype`` inside, fp32 gradients."""
    return _ConvHrCtDiff.apply(x.contiguous(), w0, b0, w1, b1, slope)
