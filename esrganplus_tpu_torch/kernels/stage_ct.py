"""The early-stage convolutions of the discriminator and the VGG19
perceptual net: ``conv_s1_ct`` (SAME 3×3 stride-1 conv + bias + fused
activation) and ``conv_s2_ct`` (the discriminator's 4×4 stride-2 pad-1 conv),
forward and backward.

Counterpart of ``esrganplus_tpu/kernels/stage_ct.py``. The TPU kernels carry
the image as column-phase planes ``[C, pixels]`` (the stride-2 conv as a phase
decimation over parity buffers, 3 input channels padded to 8); here
activations are plain NHWC, weights HWIO, and the CUDA kernels
(``csrc/stage_ct.cu``) index them directly. What is kept is what they compute
and where they round:

  * forward: fp32 accumulation over taps and channels, ``+ bias`` in fp32, the
    activation (``None`` | ``"relu"`` | ``"lrelu"``) on the fp32 value, then
    one rounding to the working dtype. The stride-2 conv pads 1 on both
    sides: output (i, j) reads input rows 2i−1..2i+2, columns 2j−1..2j+2.
  * backward: the gate comes from the saved forward *output* (relu gates on
    ``out > 0``, lrelu on ``out >= 0``), ``dz`` is computed in fp32, ``db``
    sums it unrounded, both products take it rounded to the working dtype,
    ``dW`` and ``db`` leave in fp32, ``dx`` in the working dtype. The weight
    gradient is reduced in an order fixed by the shapes (no atomics).

Training goes through ``conv_s1_ct_diff`` and ``conv_s2_ct_diff``
(``torch.autograd.Function``s; fp32 master weights in, fp32 gradients out),
which launch only the halves of the adjoint that something needs: no weight
gradient for frozen weights (the perceptual net; the discriminator while the
generator is updated), no data gradient for an input that needs none (the
discriminator's first conv on an image).

A CPU tensor goes to the plain twin (``*_plain``); a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from esrganplus_tpu_torch.kernels import build
from esrganplus_tpu_torch.kernels.rdb_ct import _nchw, prepare_conv_ct_weights
from esrganplus_tpu_torch.models.layers import fp32_exact

ACTS = {None: 0, "relu": 1, "lrelu": 2}  # csrc/stage_ct.cu Act
STAGE_WIDTHS = (8, 16, 32, 64, 128)      # output-channel counts the kernels take
MAX_CIN = 128

# (weights in the working dtype, fp32 bias) from HWIO masters
prepare_stage_ct = prepare_conv_ct_weights


def _geometry(ks: int):
    """(stride, padding) of the ``ks``×``ks`` stage conv."""
    return (1, 1) if ks == 3 else (2, 1)


def _check_act(act):
    if act not in ACTS:
        raise ValueError(f"act must be None, 'relu' or 'lrelu', got {act!r}")


def _check_even(ks: int, H: int, W: int):
    if ks == 4 and (H % 2 or W % 2):
        raise ValueError(f"conv_s2_ct: H and W must be even, got {H}×{W}")


def _apply_act(v: torch.Tensor, act, slope: float) -> torch.Tensor:
    if act == "relu":
        return torch.clamp_min(v, 0)
    if act == "lrelu":
        return torch.where(v >= 0, v, v * slope)
    return v


def _act_adj(g: torch.Tensor, ref: Optional[torch.Tensor], act, slope: float) -> torch.Tensor:
    """Cotangent through the activation; ``ref`` is the saved forward output."""
    if act == "relu":
        return g * (ref > 0)
    if act == "lrelu":
        return torch.where(ref >= 0, g, g * slope)
    return g


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------


def _fwd_plain(ks, x, w, bias, act, slope):
    _check_act(act)
    _check_even(ks, x.shape[1], x.shape[2])
    stride, pad = _geometry(ks)
    with fp32_exact():
        y = F.conv2d(_nchw(x), w.float().permute(3, 2, 0, 1), bias.float(), stride=stride,
                     padding=pad)
    return _apply_act(y, act, slope).to(x.dtype).permute(0, 2, 3, 1).contiguous()


def conv_s1_ct_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *,
                     act: Optional[str] = None, slope: float = 0.2) -> torch.Tensor:
    """Plain twin of :func:`conv_s1_ct`: fp32 conv of the working-dtype
    values + bias, the activation in fp32, one rounding."""
    return _fwd_plain(3, x, w, bias, act, slope)


def conv_s2_ct_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *,
                     act: Optional[str] = None, slope: float = 0.2) -> torch.Tensor:
    """Plain twin of :func:`conv_s2_ct` (4×4, stride 2, padding 1)."""
    return _fwd_plain(4, x, w, bias, act, slope)


def _bwd_plain(ks, x, w, out, g, act, slope, need_dx, need_dw) -> dict:
    _check_act(act)
    stride, pad = _geometry(ks)
    dt = x.dtype
    cin, cout = w.shape[2], w.shape[3]
    xf = _nchw(x)
    dz = _act_adj(_nchw(g), None if out is None else _nchw(out), act, slope)
    dzr = dz.to(dt).float()
    res = {"dx": None, "w": None, "b": None}
    with fp32_exact():
        if need_dx:
            dx = torch.nn.grad.conv2d_input(xf.shape, w.float().permute(3, 2, 0, 1), dzr,
                                            stride=stride, padding=pad)
            res["dx"] = dx.to(dt).permute(0, 2, 3, 1).contiguous()
        if need_dw:
            dw = torch.nn.grad.conv2d_weight(xf, (cout, cin, ks, ks), dzr, stride=stride,
                                             padding=pad)
            res["w"] = dw.permute(2, 3, 1, 0).contiguous()
            res["b"] = dz.sum((0, 2, 3))
    return res


def conv_s1_ct_bwd_plain(x, w, out, g, *, act: Optional[str] = None, slope: float = 0.2,
                         need_dx: bool = True, need_dw: bool = True) -> dict:
    """Plain twin of :func:`conv_s1_ct_bwd` → ``{"dx", "w", "b"}``: the gate
    from the saved output, ``dz`` rounded before each product, ``db`` summed
    unrounded."""
    return _bwd_plain(3, x, w, out, g, act, slope, need_dx, need_dw)


def conv_s2_ct_bwd_plain(x, w, out, g, *, act: Optional[str] = None, slope: float = 0.2,
                         need_dx: bool = True, need_dw: bool = True) -> dict:
    """Plain twin of :func:`conv_s2_ct_bwd`."""
    return _bwd_plain(4, x, w, out, g, act, slope, need_dx, need_dw)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def require_stage_widths(cin: int, cout: int) -> None:
    """Raise for channel counts ``csrc/stage_ct.cu`` does not take."""
    if not 1 <= cin <= MAX_CIN:
        raise ValueError(f"cin={cin}: the stage kernels take 1..{MAX_CIN} input channels")
    build.require_width(cout, "cout", STAGE_WIDTHS)


def _dgrad_chunk(cin: int) -> int:
    """dx channels per data-gradient block."""
    return next(c for c in (8, 16, 32, 64) if c >= min(cin, 64))


def stage_wgrad_parts(B: int, Ho: int, Wo: int, cin: int, cout: int, ks: int) -> int:
    """Rows of the weight-gradient workspace: about 512 blocks over the
    channel chunks, at most one row per pixel tile and 128 rows. A function
    of the shapes only, so the reduction order is fixed."""
    tiles = B * -(-Ho // (8 if ks == 3 else 4)) * -(-Wo // 16)
    sc = min(cout, 64)
    kc = 16 if sc >= 16 else 32
    blocks = -(-cin // kc) * (cout // sc)
    want = max(1, min(tiles, 128, -(-512 // blocks)))
    per = -(-tiles // want)
    return -(-tiles // per)


def _validate(name, ks, x, w, dt, dev):
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be NHWC, got shape {tuple(x.shape)}")
    B, H, W, cin = x.shape
    cout = w.shape[3]
    build.dtype_code(x)
    require_stage_widths(cin, cout)
    _check_even(ks, H, W)
    build.require(x, "x", (B, H, W, cin), dt, dev)
    build.require(w, "w", (ks, ks, cin, cout), dt, dev)
    stride, _ = _geometry(ks)
    return B, H, W, cin, cout, H // stride, W // stride


def _fwd(fn, ks, x, w, bias, act, slope):
    _check_act(act)
    if x.device.type == "cpu":
        return _fwd_plain(ks, x, w, bias, act, slope)
    dt, dev = x.dtype, x.device
    B, H, W, cin, cout, Ho, Wo = _validate(fn.__name__, ks, x, w, dt, dev)
    build.require(bias, "bias", (cout,), torch.float32, dev)
    lib = build.load("stage_ct")
    out = torch.empty((B, Ho, Wo, cout), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        code = lib.esr_stage_fwd(build.dtype_code(x), ks, min(cout, 64), x.data_ptr(),
                                 w.data_ptr(), bias.data_ptr(), out.data_ptr(), B, H, W, cin,
                                 cout, ACTS[act], slope,
                                 torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "esr_stage_fwd")
    fn.launches += 1
    return out


def conv_s1_ct(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *,
               act: Optional[str] = None, slope: float = 0.2) -> torch.Tensor:
    """SAME 3×3 stride-1 conv + bias + fused activation: NHWC
    ``[B, H, W, C]`` → ``[B, H, W, CO]`` in the input dtype. ``w``/``bias``
    from :func:`prepare_stage_ct`. ``conv_s1_ct.launches`` counts CUDA
    launches."""
    return _fwd(conv_s1_ct, 3, x, w, bias, act, slope)


conv_s1_ct.launches = 0


def conv_s2_ct(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *,
               act: Optional[str] = None, slope: float = 0.2) -> torch.Tensor:
    """4×4 stride-2 pad-1 conv + bias + fused activation: NHWC
    ``[B, H, W, C]`` (H, W even) → ``[B, H/2, W/2, CO]``.
    ``conv_s2_ct.launches`` counts CUDA launches."""
    return _fwd(conv_s2_ct, 4, x, w, bias, act, slope)


conv_s2_ct.launches = 0


def _bwd(fn, ks, x, w, out, g, act, slope, need_dx, need_dw) -> dict:
    _check_act(act)
    if not (need_dx or need_dw):
        raise ValueError(f"{fn.__name__}: nothing asked for (need_dx and need_dw both False)")
    if act is not None and out is None:
        raise ValueError(f"{fn.__name__}: act={act!r} needs the saved forward output")
    if x.device.type == "cpu":
        return _bwd_plain(ks, x, w, out, g, act, slope, need_dx, need_dw)
    dt, dev = x.dtype, x.device
    B, H, W, cin, cout, Ho, Wo = _validate(fn.__name__, ks, x, w, dt, dev)
    build.require(g, "g", (B, Ho, Wo, cout), dt, dev)
    if act is not None:
        build.require(out, "out", (B, Ho, Wo, cout), dt, dev)
    outp = None if act is None else out.data_ptr()
    lib = build.load("stage_ct")
    stream = torch.cuda.current_stream(dev).cuda_stream
    res = {"dx": None, "w": None, "b": None}
    with torch.cuda.device(dev):
        if need_dx:
            dx = torch.empty_like(x)
            code = lib.esr_stage_dgrad(build.dtype_code(x), ks, _dgrad_chunk(cin), g.data_ptr(),
                                       outp, w.data_ptr(), dx.data_ptr(), B, H, W, cin, cout,
                                       ACTS[act], slope, stream)
            build.check(code, "esr_stage_dgrad")
            res["dx"] = dx
        if need_dw:
            npart = stage_wgrad_parts(B, Ho, Wo, cin, cout, ks)
            nw = ks * ks * cin * cout
            part = torch.empty((npart, nw + cout), dtype=torch.float32, device=dev)
            dwdb = torch.empty((nw + cout,), dtype=torch.float32, device=dev)
            code = lib.esr_stage_wgrad(build.dtype_code(x), ks, min(cout, 64), x.data_ptr(),
                                       g.data_ptr(), outp, part.data_ptr(), npart,
                                       dwdb.data_ptr(), B, H, W, cin, cout, ACTS[act], slope,
                                       stream)
            build.check(code, "esr_stage_wgrad")
            res["w"], res["b"] = dwdb[:nw].view(ks, ks, cin, cout), dwdb[nw:]
    fn.launches += 1
    return res


def conv_s1_ct_bwd(x, w, out, g, *, act: Optional[str] = None, slope: float = 0.2,
                   need_dx: bool = True, need_dw: bool = True) -> dict:
    """Adjoint of :func:`conv_s1_ct` from its input, cast weights and saved
    output (``None`` allowed when ``act`` is None) → ``{"dx", "w", "b"}``;
    an entry that was not asked for is None. On a CUDA tensor: one
    data-gradient launch and/or one weight-gradient launch with its
    fixed-order finishing pass. ``conv_s1_ct_bwd.launches`` counts CUDA
    calls."""
    return _bwd(conv_s1_ct_bwd, 3, x, w, out, g, act, slope, need_dx, need_dw)


conv_s1_ct_bwd.launches = 0


def conv_s2_ct_bwd(x, w, out, g, *, act: Optional[str] = None, slope: float = 0.2,
                   need_dx: bool = True, need_dw: bool = True) -> dict:
    """Adjoint of :func:`conv_s2_ct`; see :func:`conv_s1_ct_bwd`.
    ``conv_s2_ct_bwd.launches`` counts CUDA calls."""
    return _bwd(conv_s2_ct_bwd, 4, x, w, out, g, act, slope, need_dx, need_dw)


conv_s2_ct_bwd.launches = 0


# ---------------------------------------------------------------------------
# autograd Functions
# ---------------------------------------------------------------------------


class _StageCtDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, ks, act, slope):
        fwd = conv_s1_ct if ks == 3 else conv_s2_ct
        out = fwd(x, w.to(x.dtype).contiguous(), bias.float().contiguous(), act=act, slope=slope)
        ctx.save_for_backward(x, w, *(() if act is None else (out,)))
        ctx.opts = (ks, act, slope)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w, *saved = ctx.saved_tensors
        ks, act, slope = ctx.opts
        need_dx = ctx.needs_input_grad[0]
        need_dw = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        bwd = conv_s1_ct_bwd if ks == 3 else conv_s2_ct_bwd
        r = bwd(x, w.to(x.dtype).contiguous(), saved[0] if saved else None,
                g.to(x.dtype).contiguous(), act=act, slope=slope, need_dx=need_dx,
                need_dw=need_dw)
        dw = r["w"].to(w.dtype) if ctx.needs_input_grad[1] else None
        db = r["b"] if ctx.needs_input_grad[2] else None
        return r["dx"], dw, db, None, None, None


def conv_s1_ct_diff(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *,
                    act: Optional[str] = None, slope: float = 0.2) -> torch.Tensor:
    """Differentiable :func:`conv_s1_ct`: HWIO fp32 master ``w`` and ``bias``,
    cast to ``x.dtype`` inside; fp32 ``dW``/``db``, ``dx`` in ``x.dtype``.
    The backward computes only what needs a gradient."""
    return _StageCtDiff.apply(x.contiguous(), w, bias, 3, act, slope)


def conv_s2_ct_diff(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *,
                    act: Optional[str] = None, slope: float = 0.2) -> torch.Tensor:
    """Differentiable :func:`conv_s2_ct`; see :func:`conv_s1_ct_diff`."""
    return _StageCtDiff.apply(x.contiguous(), w, bias, 4, act, slope)
