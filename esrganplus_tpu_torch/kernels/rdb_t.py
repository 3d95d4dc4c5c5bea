"""The 9-tap ResidualDenseBlock on by-target weights (``rdb_t``) and its
adjoint (``rdb_t_bwd``).

Counterpart of ``esrganplus_tpu/kernels/rdb_t.py``, the reference layout the
JAX package keeps beside its model path's column-merged ``rdb_ct``: stage k is
one product ``[S_k, 9·C_prefix_k] @ IM`` against an im2col buffer grown one
source at a time (x, then x1..x4), its K rows ordered source, then tap
r·3+s, then channel. No model path calls it, in the JAX package or here; it
is public API of both. Activations here are NHWC, and the CUDA kernels
(``csrc/rdb_t.cu``) read the by-target matrices in place: five dense-stage
launches over an NHWC concat buffer forward; backward a recompute of stages
1..4 from x into a workspace freed at return, then a data-gradient and a
weight-gradient launch per stage and for the 1×1 shortcut, dW written
straight into rdb_t's layout.

Numerics are the TPU kernel's: fp32 accumulation, x1..x4 rounded to the
activation dtype, ``β·x5 + x`` (and the RRDB fold ``·rrdb_scale + res``) in
fp32 with one rounding; the adjoint rounds each ``dz_k`` before a product,
sums ``db`` from the unrounded ``dz``, and rounds dx once. The 1×1 shortcut
is always applied (``w11`` is zeros without conv1x1) and its gradient
always returned, as in the JAX package.

The TPU scheduling knobs of the JAX functions (``pack``, ``bwd_pack``,
``split_dots``, ``interpret``) are left out: they change no value.

Each CUDA wrapper has a plain PyTorch twin (``*_plain``) with the same
rounding points, written on the im2col buffer as the TPU kernel is. A CPU
tensor goes to the twin; a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from esrganplus_tpu_torch.kernels import build
from esrganplus_tpu_torch.kernels.launch import (ACT, ACT_1X1, ACT_ADD, RESID, dgrad,
                                                 dgrad_chunk, dz_src, wgrad)
from esrganplus_tpu_torch.models.layers import fp32_exact


def prepare_rdb_t_weights(p: dict, nf: int, gc: int, conv1x1: bool,
                          dtype: torch.dtype = torch.bfloat16) -> tuple:
    """One RDB's params (HWIO) → ``(w1, .., w5, w11, bias)``: ``w_k``
    ``[S_k, 9·C_prefix_k]`` with K rows ordered source, tap, channel, in
    ``dtype``; ``w11`` ``[gc, nf]`` (zeros without conv1x1); ``bias``
    ``[nf + 4·gc, 1]`` fp32 packing b5 | b4 | b3 | b2 | b1."""
    def wk(k):
        w = p[f"conv{k}"]["w"]
        cp, s = w.shape[2], w.shape[3]
        srcs = [nf] + [gc] * ((cp - nf) // gc)
        blocks, off = [], 0
        for c in srcs:
            blocks.append(w[:, :, off:off + c, :].reshape(9 * c, s))  # (r·3+s)·C + c rows
            off += c
        return torch.cat(blocks, 0).t().to(dtype).contiguous()

    ref = p["conv1"]["w"]
    w11 = (p["conv1x1"]["w"][0, 0].t().to(dtype).contiguous() if conv1x1
           else torch.zeros((gc, nf), dtype=dtype, device=ref.device))
    bias = torch.cat([p["conv5"]["b"]] + [p[f"conv{t}"]["b"] for t in (4, 3, 2, 1)])
    return (wk(1), wk(2), wk(3), wk(4), wk(5), w11,
            bias.float().reshape(-1, 1).contiguous())


def _boff(k: int, nf: int, gc: int) -> int:
    """Row of stage k's bias in the packed column (b5 first)."""
    return 0 if k == 5 else nf + (4 - k) * gc


# ---------------------------------------------------------------------------
# plain PyTorch twins (on the im2col buffer, as the TPU kernel)
# ---------------------------------------------------------------------------


def _taps(src: torch.Tensor) -> torch.Tensor:
    """NHWC fp32 ``[B, H, W, C]`` → its nine SAME-padded tap copies
    ``[B, H, W, 9·C]``, tap r·3+s major: tap (r, s) at (y, x) holds
    src(y + r - 1, x + s - 1), zero outside the image."""
    H, W = src.shape[1:3]
    p = F.pad(src, (0, 0, 1, 1, 1, 1))
    return torch.cat([p[:, r:r + H, s:s + W] for r in range(3) for s in range(3)], -1)


def _untap(d: torch.Tensor, c: int) -> torch.Tensor:
    """Adjoint of :func:`_taps`: ``[B, H, W, 9·c]`` → ``[B, H, W, c]``."""
    B, H, W = d.shape[:3]
    p = d.new_zeros((B, H + 2, W + 2, c))
    for t in range(9):
        r, s = divmod(t, 3)
        p[:, r:r + H, s:s + W] += d[..., t * c:(t + 1) * c]
    return p[:, 1:H + 1, 1:W + 1]


def _lrelu(t, slope):
    return torch.where(t >= 0, t, t * slope)


def _forward_plain(x, ws, slope):
    """Stages 1..4 and x5 on the im2col buffer → (im, [z1..z4], x5) in
    fp32; x1..x4 in ``im`` are rounded to x's dtype."""
    dt = x.dtype
    rnd = lambda t: t.to(dt).float()
    w = [t.float() for t in ws[:5]]
    w11, b = ws[5].float(), ws[6].float().flatten()
    nf, gc = x.shape[3], w[0].shape[0]
    xf = x.float()
    im = _taps(xf)
    zs, xs = [], []

    def stage(k):
        s = nf if k == 5 else gc
        o = _boff(k, nf, gc)
        return im @ w[k - 1].t() + b[o:o + s]

    with fp32_exact():
        for k in range(1, 5):
            z = stage(k)
            zs.append(z)
            xk = _lrelu(z, slope)
            if k == 2:
                xk = xk + xf @ w11.t()          # the 1×1 shortcut on x's centre tap
            elif k == 4:
                xk = xk + xs[1]                  # x4 += x2 (rounded)
            xs.append(rnd(xk))
            im = torch.cat([im, _taps(xs[-1])], -1)
        x5 = stage(5)
    return im, zs, x5


def rdb_t_plain(x: torch.Tensor, w1, w2, w3, w4, w5, w11, bias,
                res: Optional[torch.Tensor] = None, *, slope: float = 0.2,
                res_scale: float = 0.2, rrdb_scale: Optional[float] = None) -> torch.Tensor:
    """Plain twin of :func:`rdb_t` (same rounding points), NHWC in and out."""
    _, _, x5 = _forward_plain(x, (w1, w2, w3, w4, w5, w11, bias), slope)
    out = x5 * res_scale + x.float()
    if res is not None:
        out = out * rrdb_scale + res.float()
    return out.to(x.dtype)


def rdb_t_bwd_plain(x, w1, w2, w3, w4, w5, w11, bias, g, *, slope: float = 0.2,
                    res_scale: float = 0.2) -> tuple:
    """Plain twin of :func:`rdb_t_bwd`: the forward recomputed from x, then
    ``_rdb_t_bwd_kernel``'s adjoint on the im2col buffer (``dW_k = dz_kᵀ·IM``,
    ``dIM += dz_k·W_k``, the tap-append adjoint as reverse shifts). Returns
    ``(dx, dw1, .., dw5, dw11, db)``."""
    dt = x.dtype
    rnd = lambda t: t.to(dt).float()
    ws = (w1, w2, w3, w4, w5, w11, bias)
    w = [t.float() for t in ws[:5]]
    nf, gc = x.shape[3], w[0].shape[0]
    im, (z1, z2, z3, z4), _ = _forward_plain(x, ws, slope)
    off9 = lambda k: 9 * (nf + (k - 1) * gc)      # IM column where source k's taps start
    flat = lambda t: t.reshape(-1, t.shape[-1])
    dlrelu = lambda z, t: torch.where(z >= 0, t, t * slope)
    gf = g.float()
    dim = torch.zeros_like(im)
    dws = [None] * 5
    with fp32_exact():
        def stage(k, dzk):                        # dzk already rounded
            dws[k - 1] = flat(dzk).t() @ flat(im[..., :off9(k)])
            dim[..., :off9(k)] += dzk @ w[k - 1]

        dz5 = gf * res_scale
        stage(5, rnd(dz5))
        dx4 = _untap(dim[..., off9(4):off9(5)], gc)
        dz4 = dlrelu(z4, dx4)
        stage(4, rnd(dz4))
        dx3 = _untap(dim[..., off9(3):off9(4)], gc)
        dz3 = dlrelu(z3, dx3)
        stage(3, rnd(dz3))
        dx2 = _untap(dim[..., off9(2):off9(3)], gc) + dx4   # + the x4 += x2 residual
        dz2 = dlrelu(z2, dx2)
        stage(2, rnd(dz2))
        dx2k = rnd(dx2)
        dx1 = _untap(dim[..., off9(1):off9(2)], gc)
        dw11 = flat(dx2k).t() @ flat(x.float())            # c11 = W11 · x (centre tap)
        dx_c11 = dx2k @ ws[5].float()
        dz1 = dlrelu(z1, dx1)
        stage(1, rnd(dz1))
        dx0 = _untap(dim[..., :off9(1)], nf) + dx_c11 + gf
    db = torch.cat([t.sum((0, 1, 2)) for t in (dz5, dz4, dz3, dz2, dz1)]).reshape(-1, 1)
    return (dx0.to(dt), *dws, dw11, db)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _check(x, ws, g=None, res=None):
    """Validate the tensors handed to the kernels → (nf, gc)."""
    if x.dim() != 4:
        raise ValueError(f"rdb_t: x must be NHWC, got shape {tuple(x.shape)}")
    B, H, W, nf = x.shape
    gc = ws[0].shape[0]
    dt, dev = x.dtype, x.device
    build.dtype_code(x)
    build.require_width(nf, "nf")
    build.require_width(gc, "gc")
    build.require(x, "x", (B, H, W, nf), dt, dev)
    for k in range(1, 6):
        build.require(ws[k - 1], f"w{k}", (nf if k == 5 else gc, 9 * (nf + (k - 1) * gc)),
                      dt, dev)
    build.require(ws[5], "w11", (gc, nf), dt, dev)
    build.require(ws[6], "bias", (nf + 4 * gc, 1), torch.float32, dev)
    for t, name in ((g, "g"), (res, "res")):
        if t is not None:
            build.require(t, name, (B, H, W, nf), dt, dev)
    return nf, gc


def _stages(x, ws, *, slope, last=True, res=None, rrdb_scale=None, res_scale=0.2):
    """Launch stages 1..4 (and 5 with ``last``) of the forward → (out or
    None, cat, lsv): ``cat`` holds x1|x2|x3|x4, ``lsv`` (kept when stage 5
    is skipped, for the backward's masks) l2|l4."""
    B, H, W, nf = x.shape
    gc = ws[0].shape[0]
    dt, dev, esz = x.dtype, x.device, x.element_size()
    lib = build.load("rdb_t")
    cat = torch.empty((B, H, W, 4 * gc), dtype=dt, device=dev)
    lsv = None if last else torch.empty((B, H, W, 2 * gc), dtype=dt, device=dev)
    out = torch.empty_like(x) if last else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    bias = lambda k: ws[6].data_ptr() + 4 * _boff(k, nf, gc)

    def launch(k, mode, out_ptr, out_stride, cout, r1=0, r1_stride=0, r2=0, r2_stride=0,
               lsave=0, lsave_stride=0, alpha=1.0, beta2=1.0):
        code = lib.esr_rdb_t_stage(build.dtype_code(x), cout, mode, nf, gc, x.data_ptr(),
                                   cat.data_ptr(), 4 * gc, nf + (k - 1) * gc,
                                   ws[k - 1].data_ptr(), bias(k), ws[5].data_ptr(), out_ptr,
                                   out_stride, r1 or None, r1_stride, r2 or None, r2_stride,
                                   lsave or None, lsave_stride, alpha, beta2, slope, B, H, W,
                                   stream)
        build.check(code, "esr_rdb_t_stage")

    with torch.cuda.device(dev):
        for k in range(1, 5):
            extra = {}
            if k == 4:  # x4 += x2, read back from the buffer
                extra = dict(r1=cat.data_ptr() + gc * esz, r1_stride=4 * gc)
            if lsv is not None and k in (2, 4):
                extra.update(lsave=lsv.data_ptr() + (k // 2 - 1) * gc * esz,
                             lsave_stride=2 * gc)
            mode = {2: ACT_1X1, 4: ACT_ADD}.get(k, ACT)
            launch(k, mode, cat.data_ptr() + (k - 1) * gc * esz, 4 * gc, gc, **extra)
        if last:
            launch(5, RESID, out.data_ptr(), nf, nf, r1=x.data_ptr(), r1_stride=nf,
                   r2=0 if res is None else res.data_ptr(), r2_stride=nf, alpha=res_scale,
                   beta2=1.0 if rrdb_scale is None else rrdb_scale)
    return out, cat, lsv


def rdb_t(x: torch.Tensor, w1, w2, w3, w4, w5, w11, bias,
          res: Optional[torch.Tensor] = None, *, slope: float = 0.2, res_scale: float = 0.2,
          rrdb_scale: Optional[float] = None) -> torch.Tensor:
    """One ResidualDenseBlock_5C on rdb_t's weights
    (:func:`prepare_rdb_t_weights`): NHWC ``x`` ``[B, H, W, nf]`` → same
    shape. With ``res`` (the RRDB's input) and ``rrdb_scale`` the RRDB
    epilogue ``out·rrdb_scale + res`` is folded in. ``rdb_t.launches``
    counts calls that launched the CUDA kernels (5 launches each)."""
    if (res is None) != (rrdb_scale is None):
        raise ValueError("rdb_t: res and rrdb_scale go together")
    ws = (w1, w2, w3, w4, w5, w11, bias)
    if x.device.type == "cpu":
        return rdb_t_plain(x, *ws, res, slope=slope, res_scale=res_scale,
                           rrdb_scale=rrdb_scale)
    _check(x, ws, res=res)
    out = _stages(x, ws, slope=slope, res=res, rrdb_scale=rrdb_scale, res_scale=res_scale)[0]
    rdb_t.launches += 1
    return out


rdb_t.launches = 0


def rdb_t_bwd(x, w1, w2, w3, w4, w5, w11, bias, g, *, slope: float = 0.2,
              res_scale: float = 0.2) -> tuple:
    """Adjoint of :func:`rdb_t` (no fold) from x alone: the forward's
    stages 1..4 are recomputed into a workspace that is freed at return.
    ``w*`` and ``bias`` as the forward took them, ``g`` the output cotangent
    in x's dtype. Returns ``(dx, dw1, .., dw5, dw11, db)``: dx in x's dtype,
    fp32 ``dw_k`` ``[S_k, 9·C_prefix_k]``, ``dw11`` ``[gc, nf]`` and the
    packed ``db`` ``[nf + 4·gc, 1]``. On a CUDA tensor 4 + 12 launches, all
    deterministic; ``rdb_t_bwd.launches`` counts CUDA calls."""
    ws = (w1, w2, w3, w4, w5, w11, bias)
    if x.device.type == "cpu":
        return rdb_t_bwd_plain(x, *ws, g, slope=slope, res_scale=res_scale)
    nf, gc = _check(x, ws, g=g)
    B, H, W, _ = x.shape
    dt, dev, esz = x.dtype, x.device, x.element_size()
    ctot = nf + 4 * gc
    _, cat, lsv = _stages(x, ws, slope=slope, last=False)
    chunk = dgrad_chunk(nf, gc)
    dcat = torch.empty((B, H, W, ctot), dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    lay = (nf, gc)
    gate = lambda k, mask, m_stride, coff2=-1: dz_src(
        H, W, build.DZ_GATE, d32=dcat, d_stride=ctot, coff=nf + (k - 1) * gc, coff2=coff2,
        mask=mask, m_stride=m_stride, slope=slope)
    stages = {
        5: dz_src(H, W, build.DZ_G, g=g, g_stride=nf, scale=res_scale),
        4: gate(4, lsv.data_ptr() + gc * esz, 2 * gc),
        3: gate(3, cat.data_ptr() + 2 * gc * esz, 4 * gc),
        2: gate(2, lsv.data_ptr(), 2 * gc, coff2=nf + 3 * gc),   # dx2 = dx2 + dx4
        1: gate(1, cat.data_ptr(), 4 * gc),
    }
    skip = dz_src(H, W, build.DZ_G, g=g, g_stride=nf)
    dws, dbs = {}, {}
    with torch.cuda.device(dev):
        for k in (5, 4, 3, 2, 1):
            cin, s = nf + (k - 1) * gc, nf if k == 5 else gc
            if k == 2:  # the 1×1 shortcut from the rounded dx2, not gated, always
                dz11 = dz_src(H, W, build.DZ_PLAIN, d32=dcat, d_stride=ctot, coff=nf + gc,
                              coff2=nf + 3 * gc)
                dw11 = wgrad(x, None, nf, dz11, gc, taps=1, by_target=lay)[0]
                dgrad(x, B, dz11, gc, w11, nf, taps=1, chunk=chunk, out32=dcat,
                      accumulate=True, by_target=lay)
            dws[k], dbs[k] = wgrad(x, cat, cin, stages[k], s, by_target=lay)
            if k > 1:
                dgrad(x, B, stages[k], s, ws[k - 1], cin, chunk=chunk, out32=dcat,
                      accumulate=k < 5, by_target=lay)
            else:  # + the earlier stages' share, + the skip's cotangent, one rounding
                dgrad(x, B, stages[k], s, ws[k - 1], cin, chunk=chunk, out32=dcat,
                      accumulate=True, out=dx, addg=skip, by_target=lay)
    db = torch.cat([dbs[k] for k in (5, 4, 3, 2, 1)]).reshape(-1, 1)
    rdb_t_bwd.launches += 1
    return (dx, *(dws[k] for k in range(1, 6)), dw11, db)


rdb_t_bwd.launches = 0


def _cast(wb, dt) -> tuple:
    """(w1..w5, w11, bias) masters → the kernels' weights: the matrices in
    ``dt``, the bias in fp32, all contiguous."""
    return (*(w.to(dt).contiguous() for w in wb[:6]), wb[6].float().contiguous())


class _RdbTDiff(torch.autograd.Function):
    """Saves x and the fp32 master weights only: the backward recomputes the
    stages, the TPU kernel's contract (``rdb_t.py:383-408``)."""

    @staticmethod
    def forward(ctx, x, opts, *wb):
        slope, res_scale = opts
        ctx.save_for_backward(x, *wb)
        ctx.opts = opts
        return rdb_t(x, *_cast(wb, x.dtype), slope=slope, res_scale=res_scale)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, *wb = ctx.saved_tensors
        slope, res_scale = ctx.opts
        dx, *grads = rdb_t_bwd(x, *_cast(wb, x.dtype), g.to(x.dtype).contiguous(),
                               slope=slope, res_scale=res_scale)
        return (dx, None, *(d.to(p.dtype) for d, p in zip(grads, wb)))


def rdb_t_diff(x: torch.Tensor, w1, w2, w3, w4, w5, w11, bias, *, slope: float = 0.2,
               res_scale: float = 0.2) -> torch.Tensor:
    """Differentiable :func:`rdb_t`: forward the kernels, backward
    :func:`rdb_t_bwd`. Pass the weights as fp32 masters in rdb_t's layout
    (:func:`prepare_rdb_t_weights` with ``dtype=torch.float32``): they are cast
    to ``x.dtype`` inside, and their gradients come back in the masters'
    dtype: dW in the by-target layout, dW11 (also when the RDB has no
    conv1x1) and the packed db."""
    return _RdbTDiff.apply(x.contiguous(), (slope, res_scale), w1, w2, w3, w4, w5, w11, bias)
