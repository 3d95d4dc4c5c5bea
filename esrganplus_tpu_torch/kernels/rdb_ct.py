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

Training goes through ``rdb_ct_diff`` and ``conv3x3_ct_diff``:
``torch.autograd.Function``s whose forward is the same kernel in its training
mode (the concat buffer and the pre-residual activations l2, l4 are kept, the
relative noise rides in stage 5's epilogue, pre-drawn or drawn in the kernel)
and whose backward is
``rdb_ct_bwd`` / ``conv3x3_ct_bwd``: one data-gradient launch
(``csrc/dgrad_ct.cu``) and one weight-gradient launch (``csrc/wgrad_ct.cu``)
per dense stage over an fp32 cotangent buffer ``[B, H, W, nf + 4·gc]``, the
TPU kernel's ``dim_ref``. Weights cross the Function boundary as fp32 masters
and are cast inside; gradients come back fp32.

The nESRGAN+ noise comes in two modes. ``noise`` (``noise_kernel="input"``)
is a pre-drawn tensor: ``out + n·(σ·out)`` after the rounding, every op in the
working dtype, and the backward reads the tensor again. ``noise_seed``
(``"fused"``) is a site's two Philox seed words, which the kernels read on
the device (so a captured step draws each replay's own): the kernel draws n in fp32
(``csrc/philox.cuh``) and applies ``out·(1 + σn)`` before the single
rounding; the backward regenerates the same factor from the seed into one
fp32 buffer per call (``csrc/philox.cu``), which its kernels read where they
read the cotangent, so nothing is saved from the forward. The two orders
differ by one rounding per element.

The forward kernel has two designs, picked by the dtype
(:func:`~esrganplus_tpu_torch.kernels.launch.design`): bf16 runs every
dense stage as an implicit GEMM on the tensor cores (``"mma"``:
``mma.sync`` bf16 with fp32 accumulators over the haloed tile of both
sources), fp32 on the CUDA cores (``"fma"``). Both end in one epilogue, so
they round at the same points; ``launches_by_design`` counts the calls by
design. The backward's data- and weight-gradient kernels have the same two
designs (bf16 ``mma.sync`` implicit GEMMs, fp32 FMA), counted in the
backward wrappers' ``launches_by_design``.

Each CUDA wrapper has a plain PyTorch twin (``*_plain``) with the same
rounding points. A CPU tensor goes to the twin; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from esrganplus_tpu_torch.kernels import build, launch
from esrganplus_tpu_torch.kernels.launch import (ACT, ACT_1X1, ACT_ADD, DESIGNS, RESID,
                                                 aligned, count, design, dgrad, dgrad_chunk,
                                                 dz_src, wgrad_plan)
from esrganplus_tpu_torch.kernels.philox import key_words, noise_factor_cuda, philox_normal
from esrganplus_tpu_torch.models.layers import fp32_exact

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


def _nchw(t: torch.Tensor, acc: torch.dtype = torch.float32) -> torch.Tensor:
    return t.to(acc).permute(0, 3, 1, 2)


def _conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
          padding: Optional[int] = None) -> torch.Tensor:
    """Conv in x's dtype, fp32 for the twins (SAME unless ``padding`` is
    given), of NCHW ``x`` with HWIO ``w`` whose values are already rounded
    to the working dtype: the kernel's fp32 accumulation, TF32 off."""
    pad = w.shape[0] // 2 if padding is None else padding
    with fp32_exact():
        return F.conv2d(x, w.to(x.dtype).permute(3, 2, 0, 1),
                        None if b is None else b.to(x.dtype), padding=pad)


def _lrelu(t: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(t >= 0, t, t * slope)


def _noise_factor(seed, sigma: float, shape, device, b0: int = 0) -> torch.Tensor:
    """The fused mode's fp32 ``1 + σ·n`` for the site ``seed`` (rows from
    ``b0`` on), NCHW."""
    return (1.0 + sigma * philox_normal(seed, shape, device, b0)).permute(0, 3, 1, 2)


def _rdb_ct_train_plain(x, w, res=None, noise=None, *, seed=None, b0=0, rrdb_scale=None,
                         sigma=0.0, slope=0.2, res_scale=0.2, acc=torch.float32):
    """The RDB with the kernel's rounding points → (out, cat, lsv): ``cat``
    ``[B, H, W, 4·gc]`` holds x1|x2|x3|x4 and ``lsv`` ``[B, H, W, 2·gc]`` the
    pre-residual activations l2|l4, all in x's dtype. ``noise`` applies the
    input mode's noise, ``seed`` the fused mode's (its rows from ``b0``
    on). Sums in ``acc``."""
    dt = x.dtype
    rnd = lambda t: t.to(dt).to(acc)
    xf = _nchw(x, acc)
    x1 = rnd(_lrelu(_conv(xf, w["w1"], w["b1"]), slope))
    l2 = _lrelu(_conv(torch.cat([xf, x1], 1), w["w2"], w["b2"]), slope)
    x2 = l2
    if w["w11"] is not None:
        x2 = x2 + _conv(xf, w["w11"][None, None], None)
    x2 = rnd(x2)
    x3 = rnd(_lrelu(_conv(torch.cat([xf, x1, x2], 1), w["w3"], w["b3"]), slope))
    l4 = _lrelu(_conv(torch.cat([xf, x1, x2, x3], 1), w["w4"], w["b4"]), slope)
    x4 = rnd(l4 + x2)
    x5 = _conv(torch.cat([xf, x1, x2, x3, x4], 1), w["w5"], w["b5"])
    out = x5 * res_scale + xf
    if res is not None:
        out = out * rrdb_scale + _nchw(res, acc)
    if seed is not None:  # fp32 product with the fp32 draw, then the one rounding
        out = out * _noise_factor(seed, sigma, x.shape, x.device, b0)
    out = out.to(dt)
    if noise is not None:
        # out + n·(σ·out), every op in the working dtype (σ rounded to it too)
        out = out + noise.permute(0, 3, 1, 2) * (torch.tensor(sigma, dtype=dt) * out)
    nhwc = lambda t: t.to(dt).permute(0, 2, 3, 1).contiguous()
    return nhwc(out), nhwc(torch.cat([x1, x2, x3, x4], 1)), nhwc(torch.cat([l2, l4], 1))


def rdb_ct_fp64(x, w, res=None, noise=None, **kw):
    """The training-mode twin's graph and rounding points with every sum in
    float64 → (out, cat, lsv), keywords as :func:`rdb_ct`'s training forward.
    The reference that both the twin's fp32 sums and the bf16 tensor-core
    kernel's are off by their summation order: the twin shares cuDNN's
    order with the FMA design, not the exact sum (PERF.md, Findings)."""
    return _rdb_ct_train_plain(x, w, res, noise, acc=torch.float64, **kw)


def rdb_ct_plain(x: torch.Tensor, w: dict, res: Optional[torch.Tensor] = None, *,
                 rrdb_scale: Optional[float] = None, slope: float = 0.2,
                 res_scale: float = 0.2) -> torch.Tensor:
    """Plain twin of :func:`rdb_ct` (same rounding points), NHWC in and out."""
    return _rdb_ct_train_plain(x, w, res, rrdb_scale=rrdb_scale, slope=slope,
                               res_scale=res_scale)[0]


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
           r1=0, r1_stride=0, r2=0, r2_stride=0, lsave=0, lsave_stride=0, noise=None,
           seed=None, b0=0, sigma=0.0, alpha=1.0, beta2=1.0, slope=0.2, kind=None):
    """One dense-stage launch on the design ``kind`` (default: x's dtype's)."""
    B, H, W, c0 = x.shape
    kind = kind or design(x.dtype)
    code = lib.esr_dense_conv3x3(
        build.dtype_code(x), DESIGNS[kind], cout, mode, x.data_ptr(), c0,
        None if cat is None else cat.data_ptr(),
        0 if cat is None else cat.shape[3], cin, w.data_ptr(), b.data_ptr(),
        None if w11 is None else w11.data_ptr(), out_ptr, out_stride,
        r1 or None, r1_stride, r2 or None, r2_stride, lsave or None, lsave_stride,
        None if noise is None else noise.data_ptr(), sigma,
        None if seed is None else seed.data_ptr(), int(b0), alpha, beta2, slope, B, H, W,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(code, "esr_dense_conv3x3")
    launch.launched("dense", kind)


def rdb_ct_steps(x, w, res=None, noise=None, *, seed=None, b0=0, rrdb_scale=None, sigma=0.0,
                 slope=0.2, res_scale=0.2, save=False, kind=None):
    """Validate and plan the five dense-stage launches over outputs
    allocated here → ``(steps, (out, cat, lsv))``: ``steps`` maps
    ``"stage1"`` .. ``"stage5"`` to callables that launch them, in order
    (each may be run again on its own, for timing, and gives the same bits).
    ``lsv`` (l2|l4) is kept only with ``save``. ``kind`` names the design;
    the default, x's dtype's, is the only one the model paths use (``"fma"``
    on bf16 is the baseline ``chip_smoke.py`` holds the tensor cores'
    accuracy against). Counts nothing: :func:`rdb_ct` and the training
    forward run the steps and count the call."""
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
    if noise is not None:
        build.require(noise, "noise", (B, H, W, nf), dt, dev)
    if noise is not None and seed is not None:
        raise ValueError("rdb_ct: pre-drawn noise or a noise seed, not both")
    kind = kind or design(dt)
    seed = None if seed is None else key_words(seed, dev)  # the kernel reads it on the device
    x = aligned(x)
    w = {k: None if v is None else aligned(v) for k, v in w.items()}
    lib = build.load("rdb_ct")
    cat = torch.empty((B, H, W, 4 * gc), dtype=dt, device=dev)
    lsv = torch.empty((B, H, W, 2 * gc), dtype=dt, device=dev) if save else None
    out = torch.empty_like(x)
    esz = x.element_size()
    steps = {}
    for k in range(1, 5):
        if k == 2 and w["w11"] is not None:
            extra = dict(mode=ACT_1X1, w11=w["w11"])
        elif k == 4:  # x4 += x2, read back from the buffer
            extra = dict(mode=ACT_ADD, r1=cat.data_ptr() + gc * esz, r1_stride=4 * gc)
        else:
            extra = dict(mode=ACT)
        if save and k in (2, 4):
            extra.update(lsave=lsv.data_ptr() + (k // 2 - 1) * gc * esz, lsave_stride=2 * gc)
        # the step holds lsv, which extra's raw address points into
        steps[f"stage{k}"] = lambda k=k, extra=extra, held=lsv: _dense(
            lib, x, cat, nf + (k - 1) * gc, w[f"w{k}"], w[f"b{k}"],
            cat.data_ptr() + (k - 1) * gc * esz, 4 * gc, cout=gc, slope=slope, kind=kind,
            **extra)
    steps["stage5"] = lambda: _dense(
        lib, x, cat, nf + 4 * gc, w["w5"], w["b5"], out.data_ptr(), nf, mode=RESID, cout=nf,
        kind=kind, r1=x.data_ptr(), r1_stride=nf, r2=0 if res is None else res.data_ptr(),
        r2_stride=nf, noise=noise, seed=seed, b0=b0, sigma=sigma, alpha=res_scale,
        beta2=1.0 if rrdb_scale is None else rrdb_scale)
    return steps, (out, cat, lsv)


def _rdb_ct_cuda(x, w, res=None, noise=None, *, seed=None, kind=None, **kw):
    """Launch the five dense stages (:func:`rdb_ct_steps`) and count the
    call → (out, cat, lsv)."""
    steps, result = rdb_ct_steps(x, w, res, noise, seed=seed, kind=kind, **kw)
    with torch.cuda.device(x.device):
        for step in steps.values():
            step()
    count(rdb_ct, kind or design(x.dtype))
    rdb_ct.device_launches += 5
    rdb_ct.seeded_launches += seed is not None
    return result


def rdb_ct(x: torch.Tensor, w: dict, res: Optional[torch.Tensor] = None, *,
           rrdb_scale: Optional[float] = None, slope: float = 0.2,
           res_scale: float = 0.2) -> torch.Tensor:
    """One ResidualDenseBlock_5C: NHWC ``x`` ``[B, H, W, nf]`` → same shape.

    ``w`` from :func:`prepare_rdb_ct_weights`. With ``res`` (the RRDB's
    input h0) and ``rrdb_scale`` the RRDB epilogue ``out·rrdb_scale + res``
    is folded in. ``rdb_ct.launches`` counts calls that launched the CUDA
    kernel (training forwards included), ``rdb_ct.launches_by_design`` them
    by design, ``rdb_ct.device_launches`` the kernel launches (5 per call),
    ``rdb_ct.seeded_launches`` the calls that drew the fused mode's noise in
    the kernel."""
    if (res is None) != (rrdb_scale is None):
        raise ValueError("rdb_ct: res and rrdb_scale go together")
    if x.device.type == "cpu":
        return rdb_ct_plain(x, w, res, rrdb_scale=rrdb_scale, slope=slope,
                            res_scale=res_scale)
    return _rdb_ct_cuda(x, w, res, rrdb_scale=rrdb_scale, slope=slope,
                        res_scale=res_scale)[0]


rdb_ct.launches = 0
rdb_ct.launches_by_design = dict.fromkeys(DESIGNS, 0)
rdb_ct.device_launches = 0
rdb_ct.seeded_launches = 0


def conv3x3_ct(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
               res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SAME 3×3 conv + bias (+ residual ``res``), NHWC ``[B, H, W, Cin]`` →
    ``[B, H, W, Cout]``, one rounding. ``w``/``bias`` from
    :func:`prepare_conv_ct_weights`. ``conv3x3_ct.launches`` counts CUDA
    launches, ``conv3x3_ct.launches_by_design`` them by design."""
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
    kind = design(dt)
    x, w = aligned(x), aligned(w)
    lib = build.load("rdb_ct")
    out = torch.empty((B, H, W, cout), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        _dense(lib, x, None, cin, w, bias, out.data_ptr(), cout, mode=RESID,
               cout=cout, r1=0 if res is None else res.data_ptr(),
               r1_stride=cout)
    count(conv3x3_ct, kind)
    return out


conv3x3_ct.launches = 0
conv3x3_ct.launches_by_design = dict.fromkeys(DESIGNS, 0)


def reset_design_counts() -> None:
    """Set ``launches`` and ``launches_by_design`` of :func:`rdb_ct`,
    :func:`conv3x3_ct`, :func:`rdb_ct_bwd` and :func:`conv3x3_ct_bwd` to 0."""
    for fn in (rdb_ct, conv3x3_ct, rdb_ct_bwd, conv3x3_ct_bwd):
        fn.launches = 0
        fn.launches_by_design = dict.fromkeys(DESIGNS, 0)


# ---------------------------------------------------------------------------
# training: backward twins, backward kernels, autograd Functions
# ---------------------------------------------------------------------------


def _dgrad_plain(dz: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Adjoint of the SAME conv wrt its input: NCHW ``dz`` (already rounded;
    fp32 for the twins) with HWIO ``w`` → ``[B, Cin, H, W]`` in dz's dtype."""
    with fp32_exact():
        return F.conv_transpose2d(dz, w.to(dz.dtype).permute(3, 2, 0, 1),
                                  padding=w.shape[0] // 2)


def _wgrad_plain(xin: torch.Tensor, dz: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Adjoint of the SAME k×k conv wrt its HWIO weight, fp32, summed over
    the batch: NCHW ``xin`` and ``dz`` (already rounded)."""
    with fp32_exact():
        dw = torch.nn.grad.conv2d_weight(xin, (dz.shape[1], xin.shape[1], k, k), dz,
                                         padding=k // 2)
    return dw.permute(2, 3, 1, 0).contiguous()


def _dlrelu(src: torch.Tensor, t: torch.Tensor, slope: float) -> torch.Tensor:
    """lrelu' from the sign of a saved activation (``>= 0`` of the value
    rounded to the working dtype, the TPU kernel's rule)."""
    return torch.where(src >= 0, t, t * slope)


def rdb_ct_bwd_plain(x, w, cat, lsv, g, noise=None, *, seed=None, b0: int = 0,
                     sigma: float = 0.0, slope: float = 0.2, res_scale: float = 0.2,
                     acc: torch.dtype = torch.float32) -> dict:
    """Plain twin of :func:`rdb_ct_bwd`: the dense chain's adjoint walked
    5 → 1 with the kernels' rounding points. Each ``dz_k`` is rounded to the
    working dtype before a product, ``db_k`` sums it unrounded, dx is rounded
    once. The cotangent is scaled by ``1 + σ·n`` for the pre-drawn ``noise``
    or the fused mode's draw of ``seed``. Returns ``{"dx", "w1".."w5",
    "b1".."b5", "w11"}`` (weights HWIO in ``acc``, ``w11`` ``[nf, gc]`` or
    None). Sums in ``acc``: float64 gives the graph that both the twin's
    fp32 sums and the kernels' are off by their order (dx is still rounded
    once to x's dtype), the reference of ``chip_smoke.py``'s accuracy
    phase."""
    dt = x.dtype
    rnd = lambda t: t.to(dt).to(acc)
    nf, gc = x.shape[3], w["w1"].shape[3]
    src = torch.cat([_nchw(x, acc), _nchw(cat, acc)], 1)
    lf = _nchw(lsv, acc)
    gf = _nchw(g, acc)
    if noise is not None:
        gf = gf * (1.0 + sigma * _nchw(noise, acc))
    elif seed is not None:
        gf = gf * _noise_factor(seed, sigma, x.shape, x.device, b0).to(acc)
    dcat = torch.zeros_like(src)
    out = {}

    def stage(k, dz):
        cin = nf + (k - 1) * gc
        dzr = rnd(dz)
        out[f"w{k}"] = _wgrad_plain(src[:, :cin], dzr)
        out[f"b{k}"] = dz.sum((0, 2, 3))
        dcat[:, :cin] += _dgrad_plain(dzr, w[f"w{k}"])

    xk = lambda k: slice(nf + (k - 1) * gc, nf + k * gc)  # x_k's channels
    stage(5, gf * res_scale)
    stage(4, _dlrelu(lf[:, gc:], dcat[:, xk(4)], slope))
    stage(3, _dlrelu(src[:, xk(3)], dcat[:, xk(3)], slope))
    dx2 = dcat[:, xk(2)] + dcat[:, xk(4)]            # + the x4 += x2 path
    out["w11"] = None
    if w["w11"] is not None:                         # the 1×1 shortcut, not gated
        dx2r = rnd(dx2)
        out["w11"] = _wgrad_plain(src[:, :nf], dx2r, 1)[0, 0]
        dcat[:, :nf] += _dgrad_plain(dx2r, w["w11"][None, None])
    stage(2, _dlrelu(lf[:, :gc], dx2, slope))
    stage(1, _dlrelu(src[:, xk(1)], dcat[:, xk(1)], slope))
    out["dx"] = (dcat[:, :nf] + gf).to(dt).permute(0, 2, 3, 1).contiguous()
    return out


def conv3x3_ct_bwd_plain(x, w, g) -> dict:
    """Plain twin of :func:`conv3x3_ct_bwd` → ``{"dx", "w", "b"}``."""
    gf = _nchw(g)
    return {"dx": _dgrad_plain(gf, w).to(x.dtype).permute(0, 2, 3, 1).contiguous(),
            "w": _wgrad_plain(_nchw(x), gf), "b": gf.sum((0, 2, 3))}


def _rdb_ct_bwd_steps(x, w, cat, lsv, g, noise=None, *, seed=None, b0=0, sigma=0.0,
                      slope=0.2, res_scale=0.2, kind=None):
    """Validate and plan :func:`rdb_ct_bwd`'s launches on the design ``kind``
    over outputs allocated here → ``(steps, out)``: ``steps`` maps ``"dw5"``,
    ``"dx5"``, …, ``"dw11"``, ``"dx11"``, ``"dw2"``, ``"dx2"``, ``"dw1"``,
    ``"dx1"`` to callables that launch the weight and data gradient of each
    stage (and of the 1×1 shortcut), in that order; ``out`` is the result
    dict they fill. A step may run again on its own for timing, but the data
    gradients of stages 4 → 1 add into the cotangent buffer, so only the
    whole walk in order gives the gradients."""
    B, H, W, nf = x.shape
    gc = w["w1"].shape[3]
    dt, dev = x.dtype, x.device
    ctot = nf + 4 * gc
    build.require(x, "x", (B, H, W, nf), dt, dev)
    build.require(g, "g", (B, H, W, nf), dt, dev)
    build.require(cat, "cat", (B, H, W, 4 * gc), dt, dev)
    build.require(lsv, "lsv", (B, H, W, 2 * gc), dt, dev)
    if noise is not None:
        build.require(noise, "noise", (B, H, W, nf), dt, dev)
    if noise is not None and seed is not None:
        raise ValueError("rdb_ct_bwd: pre-drawn noise or a noise seed, not both")
    kind = kind or design(dt)
    # the mma kernels move 16-byte vectors of every tensor they read
    x, g, cat, lsv = (aligned(t) for t in (x, g, cat, lsv))
    noise = None if noise is None else aligned(noise)
    w = {k: None if v is None else aligned(v) for k, v in w.items()}
    # the fused mode's 1 + σn, regenerated for this call and freed with it
    fac = None if seed is None else noise_factor_cuda(seed, sigma, x.shape, dev, b0)
    chunk = dgrad_chunk(nf, gc)
    esz = x.element_size()
    dcat = torch.empty((B, H, W, ctot), dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    out = {"dx": dx, "w11": None}
    gate = lambda k, mask, m_stride, coff2=-1: dz_src(
        H, W, build.DZ_GATE, d32=dcat, d_stride=ctot, coff=nf + (k - 1) * gc, coff2=coff2,
        mask=mask, m_stride=m_stride, slope=slope)
    stages = {
        5: dz_src(H, W, build.DZ_G, g=g, g_stride=nf, noise=noise, fac=fac, sigma=sigma,
                  scale=res_scale),
        4: gate(4, lsv.data_ptr() + gc * esz, 2 * gc),
        3: gate(3, cat.data_ptr() + 2 * gc * esz, 4 * gc),
        2: gate(2, lsv.data_ptr(), 2 * gc, coff2=nf + 3 * gc),   # dx2 = dx2 + dx4
        1: gate(1, cat.data_ptr(), 4 * gc),
    }
    skip = dz_src(H, W, build.DZ_G, g=g, g_stride=nf, noise=noise, fac=fac, sigma=sigma)
    held = (x, g, cat, lsv, noise, fac, dcat)  # the raw addresses above point into these
    steps = {}
    for k in (5, 4, 3, 2, 1):
        cin, s = nf + (k - 1) * gc, nf if k == 5 else gc
        if k == 2 and w["w11"] is not None:  # the 1×1 shortcut: dx2, not gated
            dz11 = dz_src(H, W, build.DZ_PLAIN, d32=dcat, d_stride=ctot, coff=nf + gc,
                          coff2=nf + 3 * gc)
            steps["dw11"], dw11, _ = wgrad_plan(x, None, nf, dz11, gc, taps=1, kind=kind)
            out["w11"] = dw11[0]
            steps["dx11"] = lambda dz11=dz11, held=held: dgrad(
                x, B, dz11, gc, w["w11"], nf, taps=1, chunk=chunk, out32=dcat, accumulate=True,
                kind=kind)
        steps[f"dw{k}"], dw, out[f"b{k}"] = wgrad_plan(x, cat, cin, stages[k], s, kind=kind)
        out[f"w{k}"] = dw.view(3, 3, cin, s)
        # the last launch: + the earlier stages' share, + the skip's cotangent, one rounding
        last = dict(out=dx, addg=skip) if k == 1 else {}
        steps[f"dx{k}"] = lambda k=k, cin=cin, s=s, last=last, held=held: dgrad(
            x, B, stages[k], s, w[f"w{k}"], cin, chunk=chunk, out32=dcat, accumulate=k < 5,
            kind=kind, **last)
    return steps, out


def rdb_ct_bwd_mma_steps(x, w, cat, lsv, g, noise=None, **kw):
    """The named launches of bf16 :func:`rdb_ct_bwd` on the tensor cores
    (:func:`_rdb_ct_bwd_steps`; keywords as :func:`rdb_ct_bwd`'s) →
    ``(steps, out)``; counts nothing."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"rdb_ct_bwd_mma_steps: the tensor cores take bfloat16, got {x.dtype}")
    return _rdb_ct_bwd_steps(x, w, cat, lsv, g, noise, kind="mma", **kw)


def rdb_ct_bwd(x, w, cat, lsv, g, noise=None, *, seed=None, b0: int = 0,
               sigma: float = 0.0, slope: float = 0.2, res_scale: float = 0.2) -> dict:
    """Adjoint of the training-mode :func:`rdb_ct` from its saved buffers.

    ``w`` are the forward's cast weights, ``g`` the output cotangent in x's
    dtype, ``noise`` the forward's noise tensor, or ``seed`` the fused
    mode's site key (its rows from ``b0`` on), when the cotangent is to be
    scaled by ``1 + sigma·n`` (neither for no noise or a detached scale).
    Returns ``{"dx", "w1".."w5", "b1".."b5", "w11"}``. On a CUDA tensor: 12
    launches (a data- and a weight-gradient per stage and for the 1×1), all
    deterministic, and with ``seed`` one more that fills the noise factor.
    bf16 runs them on the tensor cores, fp32 on the CUDA cores.
    ``rdb_ct_bwd.launches`` counts CUDA calls, ``launches_by_design`` them
    by design, ``rdb_ct_bwd.seeded_launches`` those that replayed the fused
    noise."""
    if x.device.type == "cpu":
        return rdb_ct_bwd_plain(x, w, cat, lsv, g, noise, seed=seed, b0=b0, sigma=sigma,
                                slope=slope, res_scale=res_scale)
    kind = design(x.dtype)
    steps, out = _rdb_ct_bwd_steps(x, w, cat, lsv, g, noise, seed=seed, b0=b0, sigma=sigma,
                                   slope=slope, res_scale=res_scale)
    with torch.cuda.device(x.device):
        for step in steps.values():
            step()
    count(rdb_ct_bwd, kind)
    rdb_ct_bwd.seeded_launches += seed is not None
    return out


rdb_ct_bwd.launches = 0
rdb_ct_bwd.launches_by_design = dict.fromkeys(DESIGNS, 0)
rdb_ct_bwd.seeded_launches = 0


def _conv3x3_ct_bwd_steps(x, w, g, kind=None):
    """Validate and plan :func:`conv3x3_ct_bwd`'s two launches on the design
    ``kind`` → ``(steps, out)``: ``steps`` maps ``"dw"`` and ``"dx"`` to
    callables that launch them (each may run again for the same bits)."""
    B, H, W, cin = x.shape
    cout = w.shape[3]
    dt, dev = x.dtype, x.device
    build.require_width(cout, "cout")
    build.require(x, "x", (B, H, W, cin), dt, dev)
    build.require(w, "w", (3, 3, cin, cout), dt, dev)
    build.require(g, "g", (B, H, W, cout), dt, dev)
    kind = kind or design(dt)
    chunk = dgrad_chunk(cin)
    x, w, g = aligned(x), aligned(w), aligned(g)
    dz = dz_src(H, W, build.DZ_G, g=g, g_stride=cout)
    dx = torch.empty_like(x)
    run, dw, db = wgrad_plan(x, None, cin, dz, cout, kind=kind)
    steps = {"dw": run,
             "dx": lambda held=g: dgrad(x, B, dz, cout, w, cin, chunk=chunk, out=dx, kind=kind)}
    return steps, {"dx": dx, "w": dw.view(3, 3, cin, cout), "b": db}


def conv3x3_ct_bwd_mma_steps(x, w, g):
    """The named launches of bf16 :func:`conv3x3_ct_bwd` on the tensor cores
    (:func:`_conv3x3_ct_bwd_steps`) → ``(steps, out)``; counts nothing."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"conv3x3_ct_bwd_mma_steps: the tensor cores take bfloat16, got {x.dtype}")
    return _conv3x3_ct_bwd_steps(x, w, g, "mma")


def conv3x3_ct_bwd(x, w, g) -> dict:
    """Adjoint of :func:`conv3x3_ct` wrt x, w and bias → ``{"dx", "w", "b"}``
    (the residual's cotangent is ``g`` itself): a weight- and a data-gradient
    launch, bf16 on the tensor cores, fp32 on the CUDA cores.
    ``conv3x3_ct_bwd.launches`` counts CUDA calls, ``launches_by_design``
    them by design."""
    if x.device.type == "cpu":
        return conv3x3_ct_bwd_plain(x, w, g)
    kind = design(x.dtype)
    steps, out = _conv3x3_ct_bwd_steps(x, w, g)
    with torch.cuda.device(x.device):
        for step in steps.values():
            step()
    count(conv3x3_ct_bwd, kind)
    return out


conv3x3_ct_bwd.launches = 0
conv3x3_ct_bwd.launches_by_design = dict.fromkeys(DESIGNS, 0)


def _cast_masters(wb, dt) -> dict:
    """(w1, b1, …, w5, b5[, w11]) fp32 masters → the kernels' weight dict at
    ``dt`` (what :func:`prepare_rdb_ct_weights` gives for inference)."""
    w = {f"w{k}": wb[2 * k - 2].to(dt).contiguous() for k in range(1, 6)}
    w.update({f"b{k}": wb[2 * k - 1].float().contiguous() for k in range(1, 6)})
    w["w11"] = wb[10].to(dt).contiguous() if len(wb) > 10 else None
    return w


class _RdbCtDiff(torch.autograd.Function):
    """``wb`` = (w1, b1, …, w5, b5[, w11]) fp32 masters; ``opts`` = (σ,
    detach, slope, β, the fused mode's seed words or None, its batch
    offset)."""

    @staticmethod
    def forward(ctx, x, noise, opts, *wb):
        sigma, detach, slope, res_scale, seed, b0 = opts
        w = _cast_masters(wb, x.dtype)
        fwd = _rdb_ct_train_plain if x.device.type == "cpu" else _rdb_ct_cuda
        extra = {} if x.device.type == "cpu" else {"save": True}
        out, cat, lsv = fwd(x, w, None, noise, seed=seed, b0=b0, sigma=sigma, slope=slope,
                            res_scale=res_scale, **extra)
        # the fused mode keeps its key tensor (in opts): the backward reads
        # the same two words on the device
        ctx.save_for_backward(x, cat, lsv, noise, *wb)
        ctx.opts = opts
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, cat, lsv, noise, *wb = ctx.saved_tensors
        sigma, detach, slope, res_scale, seed, b0 = ctx.opts
        # recast from the masters, as the forward did (no cast copy is kept)
        r = rdb_ct_bwd(x, _cast_masters(wb, x.dtype), cat, lsv, g.to(x.dtype).contiguous(),
                       None if detach else noise, seed=None if detach else seed, b0=b0,
                       sigma=sigma, slope=slope, res_scale=res_scale)
        grads = []
        for k in range(1, 6):
            grads += [r[f"w{k}"].to(wb[2 * k - 2].dtype), r[f"b{k}"].to(wb[2 * k - 1].dtype)]
        if len(wb) > 10:
            grads.append(r["w11"].to(wb[10].dtype))
        return (r["dx"], None, None, *grads)


def rdb_ct_diff(x: torch.Tensor, p: dict, noise: Optional[torch.Tensor] = None, *,
                noise_seed: Optional[tuple] = None, noise_b0: int = 0,
                noise_sigma: float = 0.0, noise_detach: bool = False, slope: float = 0.2,
                res_scale: float = 0.2) -> torch.Tensor:
    """Differentiable :func:`rdb_ct`: forward the training-mode kernel,
    backward :func:`rdb_ct_bwd`.

    ``p`` is one RDB's canonical params (HWIO fp32 masters, ``conv1..conv5``
    with biases, optional bias-free ``conv1x1``): they are cast to ``x.dtype``
    inside and their gradients come back in the masters' dtype. ``noise``
    (x's shape and dtype, pre-drawn standard normals) applies the nESRGAN+
    relative noise ``out + n·(σ·out)`` in the kernel's epilogue (the JAX
    package's ``noise_input=True``). ``noise_seed`` = (s0, s1) (ints, or the
    int32 ``[2]`` device tensor of ``kernels.philox.key_words``, which the
    kernels read through a pointer) instead draws n in the kernel from that
    site key (its ``noise_input=False``, the fused
    mode): ``out·(1 + σn)`` in fp32 before the one rounding, and the backward
    regenerates n; local row b draws the site's row ``noise_b0`` + b (a
    rank's rows of the global batch). Either way the backward scales the
    cotangent by ``1 + σ·n``, or not at all with ``noise_detach``."""
    if noise is not None and noise_seed is not None:
        raise ValueError("rdb_ct_diff: pre-drawn noise or a noise seed, not both")
    wb = []
    for k in range(1, 6):
        wb += [p[f"conv{k}"]["w"], p[f"conv{k}"]["b"]]
    if "conv1x1" in p:
        wb.append(p["conv1x1"]["w"][0, 0])
    if noise is not None:
        noise = noise.to(x.dtype).contiguous()
    seed = None if noise_seed is None else key_words(noise_seed, x.device)
    return _RdbCtDiff.apply(x.contiguous(), noise,
                            (float(noise_sigma), bool(noise_detach), slope, res_scale, seed,
                             int(noise_b0)),
                            *wb)


class _Conv3x3CtDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, res):
        ctx.save_for_backward(x, w)
        return conv3x3_ct(x, w.to(x.dtype).contiguous(), bias.float().contiguous(), res)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        r = conv3x3_ct_bwd(x, w.to(x.dtype).contiguous(), g)
        return r["dx"], r["w"].to(w.dtype), r["b"], g


def conv3x3_ct_diff(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    res: torch.Tensor) -> torch.Tensor:
    """Differentiable :func:`conv3x3_ct` (bias + residual): the trunk conv
    with the global residual in training. ``w`` is the fp32 master (HWIO),
    cast to ``x.dtype`` inside; dW comes back fp32 and the residual's
    cotangent is the output's, unchanged."""
    return _Conv3x3CtDiff.apply(x.contiguous(), w, bias, res.contiguous())
