"""Launches shared by the wrappers of several kernel modules.

The dense-stage epilogue modes (``csrc/dense_conv.cuh``), the cotangent
source the backward kernels read (``csrc/dz_src.cuh``, ``build.DzSrc``), and
one data-gradient or weight-gradient launch (``csrc/dgrad.cuh``,
``csrc/wgrad.cuh``). The weight layout picks the library: HWIO weights go to
``dgrad_ct`` / ``wgrad_ct``; ``by_target=(nf, gc)`` reads and writes rdb_t's
by-target matrices ``[s, taps·cin]`` through the ``rdb_t`` library.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from esrganplus_tpu_torch.kernels import build

# dense-stage epilogue modes (csrc/dense_conv.cuh)
ACT, ACT_1X1, ACT_ADD, RESID = 0, 1, 2, 3


def dz_src(H: int, W: int, mode: int, *, g=None, g_stride=0, noise=None, fac=None,
           sigma=0.0, scale=1.0, d32=None, d_stride=0, coff=0, coff2=-1, mask=0,
           m_stride=0, co=0, slope=0.2) -> build.DzSrc:
    """A cotangent source for the backward kernels (``csrc/dz_src.cuh``).
    ``mask`` is a raw address (a channel offset into a saved buffer);
    ``fac`` the fused noise mode's fp32 ``1 + σ·n`` (``noise_factor_cuda``)."""
    ptr = lambda t: None if t is None else t.data_ptr()
    return build.DzSrc(ptr(g), ptr(noise), ptr(fac), ptr(d32), mask or None, mode, g_stride,
                       d_stride, coff, coff2, m_stride, co, H, W, sigma, scale, slope)


def dgrad_chunk(*widths: int) -> int:
    """Input channels per data-gradient block: the largest instantiated
    chunk that divides every width."""
    for c in (32, 16, 8):
        if all(n % c == 0 for n in widths):
            return c
    raise ValueError(f"widths {widths}: the CUDA backward takes multiples of 8")


def dgrad(x_like: torch.Tensor, B: int, dz: build.DzSrc, s: int, w: torch.Tensor, cin: int,
          *, taps: int = 9, chunk: int, out32=None, accumulate=False, out=None, addg=None,
          by_target=None):
    """One data-gradient launch on ``x_like``'s device and dtype: into the
    fp32 buffer ``out32`` (channels [0, cin)), or rounded into ``out``.
    ``w`` is HWIO, or with ``by_target=(nf, gc)`` rdb_t's ``[s, taps·cin]``."""
    stream = torch.cuda.current_stream(x_like.device).cuda_stream
    args = (ctypes.byref(dz), s, w.data_ptr(), cin,
            None if out32 is None else out32.data_ptr(),
            0 if out32 is None else out32.shape[-1], int(accumulate),
            None if out is None else out.data_ptr(), 0 if out is None else out.shape[-1],
            None if addg is None else ctypes.byref(addg), B, stream)
    dt = build.dtype_code(x_like)
    if by_target is None:
        code = build.load("dgrad_ct").esr_dgrad(dt, chunk, taps, *args)
    else:
        code = build.load("rdb_t").esr_rdb_t_dgrad(dt, chunk, taps, *by_target, *args)
    build.check(code, "esr_dgrad")


def wgrad_parts(B: int, H: int, W: int, cin: int, s: int) -> int:
    """Rows of the weight-gradient workspace: about 512 blocks over the
    input-channel chunks, at most one row per 8×16 pixel tile and 128 rows.
    A function of the shapes only, so the reduction order is fixed."""
    tiles = B * -(-H // 8) * -(-W // 16)
    kc = 16 if s >= 16 else 32
    want = max(1, min(tiles, 128, -(-512 // -(-cin // kc))))
    per = -(-tiles // want)
    return -(-tiles // per)


def wgrad(x: torch.Tensor, cat: Optional[torch.Tensor], cin: int, dz: build.DzSrc, s: int,
          *, taps: int = 9, by_target=None):
    """One weight-gradient launch plus its fixed-order finishing pass →
    (dW fp32, db ``[s]`` fp32). The conv's input is the first ``cin``
    channels of (x | cat). dW is HWIO ``[taps, cin, s]``, or with
    ``by_target=(nf, gc)`` rdb_t's ``[s, taps·cin]`` (x's width is then
    the layout's nf)."""
    B, H, W, c0 = x.shape
    npart = wgrad_parts(B, H, W, cin, s)
    row = taps * cin * s + s
    part = torch.empty((npart, row), dtype=torch.float32, device=x.device)
    out = torch.empty((row,), dtype=torch.float32, device=x.device)
    dt = build.dtype_code(x)
    rest = (None if cat is None else cat.data_ptr(), 0 if cat is None else cat.shape[3], cin,
            ctypes.byref(dz), s, part.data_ptr(), npart, out.data_ptr(), B,
            torch.cuda.current_stream(x.device).cuda_stream)
    if by_target is None:
        code = build.load("wgrad_ct").esr_wgrad(dt, taps, x.data_ptr(), c0, *rest)
        shape = (taps, cin, s)
    else:
        code = build.load("rdb_t").esr_rdb_t_wgrad(dt, taps, *by_target, x.data_ptr(), *rest)
        shape = (s, taps * cin)
    build.check(code, "esr_wgrad")
    return out[:taps * cin * s].view(shape), out[taps * cin * s:]
