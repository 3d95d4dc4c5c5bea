"""Launches shared by the wrappers of several kernel modules.

The design a dtype runs on (:func:`design`, for the dense, stage, tail and
backward wrappers alike), the dense-stage epilogue modes and the mirror of
the bf16 dense kernel's tile and weight walk (``csrc/dense_conv.cuh``), the
cotangent source the backward kernels read (``csrc/dz_src.cuh``,
``build.DzSrc``), one data-gradient or weight-gradient launch
(``csrc/dgrad.cuh``, ``csrc/wgrad.cuh``), and the mirrors of the bf16
designs' blocks, weight slots and reduction split that the CPU tests hold.
The weight layout picks the library: HWIO weights go to ``dgrad_ct`` /
``wgrad_ct``; ``by_target=(nf, gc)`` reads and writes rdb_t's by-target
matrices ``[s, taps·cin]`` through the ``rdb_t`` library.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from esrganplus_tpu_torch.kernels import build

# dense-stage epilogue modes (csrc/dense_conv.cuh)
ACT, ACT_1X1, ACT_ADD, RESID = 0, 1, 2, 3
DESIGNS = {"fma": 0, "mma": 1}  # csrc/dense_conv.cuh and csrc/stage_ct.cu Design


def design(dtype: torch.dtype) -> str:
    """Which CUDA design runs a dense, stage or tail kernel on a ``dtype``
    tensor: ``"mma"`` (bf16 on the tensor cores) or ``"fma"`` (fp32 on the
    CUDA cores, whose 1e-4 bar TF32 would miss). The widths are the
    wrappers' to check."""
    if dtype not in build.DTYPE_CODES:
        raise TypeError(f"CUDA kernels take float32 or bfloat16, got {dtype}")
    return "mma" if dtype == torch.bfloat16 else "fma"


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it whose data start on 16 bytes: the mma kernels
    move 16-byte vectors (a fresh allocation always is aligned)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def count(fn, kind: str) -> None:
    """One call of the wrapper ``fn`` on design ``kind``."""
    fn.launches += 1
    fn.launches_by_design[kind] += 1


# the dense, data-gradient and weight-gradient kernels launched, counted where
# they are launched, by the name a profiler trace gives them
# (utils/trace.op_family): "dense_mma_kernel", "dgrad_kernel", ...;
# device_launches.clear() zeroes them
device_launches = collections.Counter()
_FAMILY = {("dense", "mma"): "dense_mma_kernel", ("dense", "fma"): "dense_conv3x3_kernel",
           ("dgrad", "mma"): "dgrad_mma_kernel", ("dgrad", "fma"): "dgrad_kernel",
           ("wgrad", "mma"): "wgrad_mma_kernel", ("wgrad", "fma"): "wgrad_kernel"}


def launched(op: str, kind: str) -> None:
    """One launch of the ``op`` kernel ("dense", "dgrad", "wgrad") on design
    ``kind``; a weight gradient also launches its finishing pass."""
    device_launches[_FAMILY[op, kind]] += 1
    if op == "wgrad":
        device_launches["wgrad_finish_kernel"] += 1


# ---------------------------------------------------------------------------
# the bf16 dense kernel's tile and weight walk (csrc/dense_conv.cuh dmma),
# mirrored for the CPU tests
# ---------------------------------------------------------------------------

DENSE_NSLOT = 3        # weight-ring depth
DENSE_KCH = 192        # K rows of a ring slot at most, and a tile slice's channels
MAX_SMEM = 232448      # opt-in shared memory per block on sm_90 (227 KB)
HALO_PIX = 10 * 18     # the haloed 8×16 pixel tile


def round16(c: int) -> int:
    return -(-c // 16) * 16


def ldsm_pitch(c: int) -> int:
    """Bytes of a shared [row][c × bf16] row (``csrc/mma_bf16.cuh``): c
    rounded up to 16-byte units, then to an odd count of them."""
    return ((c + 7) // 8 | 1) * 16


def dense_slot(n: int, kch: int, kn: bool) -> int:
    """Bytes of a ring slot of ``kch`` K rows by ``n`` outputs: [k][n] rows
    (HWIO, ``kn``) or [n][k] rows (by-target)."""
    return kch * ldsm_pitch(n) if kn else n * ldsm_pitch(kch)


def dense_smem(n: int, kt: int, kn: bool, c11: int = 0) -> int:
    """A block's shared memory: the haloed tile of ``kt`` channels, the ring,
    and the 1×1 shortcut's ``c11`` K rows (stage 2; else 0)."""
    return (HALO_PIX * ldsm_pitch(kt) + DENSE_NSLOT * dense_slot(n, min(kt, DENSE_KCH), kn)
            + (dense_slot(n, c11, kn) if c11 else 0))


def dense_kt(n: int, kp: int, kn: bool, c11: int = 0) -> int:
    """Channels the staged tile holds: all ``kp`` where the block fits, else
    :data:`DENSE_KCH`, restaged in turn."""
    return kp if dense_smem(n, kp, kn, c11) <= MAX_SMEM else DENSE_KCH


def dense_stages(cin: int, n: int, kn: bool, c11: int = 0) -> list:
    """The ring's stages of one launch in order (``tap_mma``'s walk: tile
    slice, tap, K chunk) as ``(tap, first channel, K rows)``; rows past
    ``cin`` are the zero padding to 16."""
    kp = round16(cin)
    kt = dense_kt(n, kp, kn, c11)
    kch = min(kt, DENSE_KCH)
    out = []
    for sl in range(-(-kp // kt)):
        for t in range(9):
            for kc in range(-(-kt // kch)):
                c = sl * kt + kc * kch
                out.append((t, c, min(kch, min(kp, (sl + 1) * kt) - c)))
    return out


def dense_slot_reads(t: int, c: int, rows: int, cin: int, cout: int, *, taps: int = 9,
                     by_target=None):
    """The weight elements one ring slot of the bf16 dense kernel reads
    (``csrc/dense_conv.cuh`` ``load_rows``; the layouts of
    ``csrc/wlayout.cuh``) → (K row, output channel, flat index, -1 for a zero
    row past ``cin``) as flat tensors, for slot rows ``c .. c+rows`` of tap
    ``t``: HWIO ``[taps, cin, cout]``, or with ``by_target=(nf, gc)``
    rdb_t's ``[cout, taps·cin]`` with K ordered source, tap, channel."""
    r, n = torch.meshgrid(torch.arange(rows), torch.arange(cout), indexing="ij")
    ci = c + r
    if by_target is None:
        idx = (t * cin + ci) * cout + n
    else:
        nf, gc = by_target
        j = (ci - nf).clamp(min=0)
        src = j // gc
        k = torch.where(ci < nf, t * nf + ci, taps * (nf + src * gc) + t * gc + (j - src * gc))
        idx = n * taps * cin + k
    idx = torch.where(ci < cin, idx, torch.full_like(idx, -1))
    return r.flatten(), n.flatten(), idx.flatten()


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
          by_target=None, kind: Optional[str] = None):
    """One data-gradient launch on ``x_like``'s device and dtype: into the
    fp32 buffer ``out32`` (channels [0, cin)), or rounded into ``out``.
    ``w`` is HWIO, or with ``by_target=(nf, gc)`` rdb_t's ``[s, taps·cin]``.
    ``kind`` names the design (default: the dtype's); ``chunk`` is the FMA
    design's channels a block (:func:`dgrad_chunk`), the mma design's are
    :func:`dgrad_np`'s."""
    stream = torch.cuda.current_stream(x_like.device).cuda_stream
    args = (ctypes.byref(dz), s, w.data_ptr(), cin,
            None if out32 is None else out32.data_ptr(),
            0 if out32 is None else out32.shape[-1], int(accumulate),
            None if out is None else out.data_ptr(), 0 if out is None else out.shape[-1],
            None if addg is None else ctypes.byref(addg), B, stream)
    kind = kind or design(x_like.dtype)
    head = (build.dtype_code(x_like), DESIGNS[kind], chunk, taps)
    if by_target is None:
        code = build.load("dgrad_ct").esr_dgrad(*head, *args)
    else:
        code = build.load("rdb_t").esr_rdb_t_dgrad(*head, *by_target, *args)
    build.check(code, "esr_dgrad")
    launched("dgrad", kind)


def wgrad_tiles(B: int, H: int, W: int, kind: str = "fma") -> int:
    """Pixel tiles the weight gradient walks: 8×16 (FMA) or 4×16 (mma)."""
    th = 8 if kind == "fma" else WG_TH
    return B * -(-H // th) * -(-W // 16)


def wgrad_parts(B: int, H: int, W: int, cin: int, s: int, *, taps: int = 9,
                kind: str = "fma") -> int:
    """Rows of the weight-gradient workspace, at most one per pixel tile and
    128: about 512 blocks over the FMA design's input-channel chunks, or
    :data:`WG_BLOCKS` over the mma design's blocks of ``WG_MT[taps]`` m16
    tiles of (16 ci, tap) rows. A function of the shapes only, so the
    reduction order is fixed."""
    tiles = wgrad_tiles(B, H, W, kind)
    if kind == "mma":
        want = -(-WG_BLOCKS // -(-(taps * -(-cin // 16)) // WG_MT[taps]))
    else:
        want = -(-512 // -(-cin // (16 if s >= 16 else 32)))
    per = -(-tiles // max(1, min(tiles, 128, want)))
    return -(-tiles // per)


def wgrad_ranges(B: int, H: int, W: int, cin: int, s: int, *, taps: int = 9,
                 kind: str = "fma") -> list:
    """``[(first tile, end)]`` of each workspace row, as ``esr_wgrad`` cuts
    them: ``per = ceil(tiles / parts)`` tiles a row, in tile order; the
    finishing pass adds the rows in this order."""
    tiles = wgrad_tiles(B, H, W, kind)
    per = -(-tiles // wgrad_parts(B, H, W, cin, s, taps=taps, kind=kind))
    return [(p * per, min(tiles, (p + 1) * per)) for p in range(-(-tiles // per))]


def wgrad_plan(x: torch.Tensor, cat: Optional[torch.Tensor], cin: int, dz: build.DzSrc,
               s: int, *, taps: int = 9, by_target=None, kind: Optional[str] = None):
    """One weight-gradient launch plus its fixed-order finishing pass,
    planned over buffers allocated here → ``(launch, dW, db)``: ``launch()``
    writes dW (fp32) and db (``[s]``, fp32), and may run again for the same
    bits. The conv's input is the first ``cin`` channels of (x | cat). dW is
    HWIO ``[taps, cin, s]``, or with ``by_target=(nf, gc)`` rdb_t's
    ``[s, taps·cin]`` (x's width is then the layout's nf). ``kind`` names
    the design (default: x's dtype's)."""
    B, H, W, c0 = x.shape
    kind = kind or design(x.dtype)
    npart = wgrad_parts(B, H, W, cin, s, taps=taps, kind=kind)
    row = taps * cin * s + s
    part = torch.empty((npart, row), dtype=torch.float32, device=x.device)
    out = torch.empty((row,), dtype=torch.float32, device=x.device)
    head = (build.dtype_code(x), DESIGNS[kind], taps)
    rest = (None if cat is None else cat.data_ptr(), 0 if cat is None else cat.shape[3], cin,
            ctypes.byref(dz), s, part.data_ptr(), npart, out.data_ptr(), B,
            torch.cuda.current_stream(x.device).cuda_stream)
    if by_target is None:
        fn = lambda: build.load("wgrad_ct").esr_wgrad(*head, x.data_ptr(), c0, *rest)
        shape = (taps, cin, s)
    else:
        fn = lambda: build.load("rdb_t").esr_rdb_t_wgrad(*head, *by_target, x.data_ptr(), *rest)
        shape = (s, taps * cin)
    def run(held=(x, cat, dz, part)):  # holds what the raw addresses point at
        build.check(fn(), "esr_wgrad")
        launched("wgrad", kind)

    return run, out[:taps * cin * s].view(shape), out[taps * cin * s:]


def wgrad(x: torch.Tensor, cat: Optional[torch.Tensor], cin: int, dz: build.DzSrc, s: int,
          *, taps: int = 9, by_target=None, kind: Optional[str] = None):
    """:func:`wgrad_plan`, launched once → (dW fp32, db ``[s]`` fp32)."""
    run, dw, db = wgrad_plan(x, cat, cin, dz, s, taps=taps, by_target=by_target, kind=kind)
    run()
    return dw, db


# ---------------------------------------------------------------------------
# the bf16 backward kernels' blocks, weight slots and split (csrc/dgrad.cuh
# and csrc/wgrad.cuh, namespace tc), mirrored for the CPU tests
# ---------------------------------------------------------------------------

DGRAD_MAX_S = 64          # dz channels a data-gradient block takes (K of a tap)
WG_TH = 4                 # weight-gradient pixel tile: 4×16
WG_MT = {9: 12, 1: 4}     # m16 tiles of (16 ci, tap) rows a weight-gradient block owns
WG_XC = {9: 32, 1: 64}    # input channels it stages
WG_BLOCKS = 264           # weight-gradient blocks a launch aims at: two an SM


def dgrad_np(cin: int) -> int:
    """Conv input channels a data-gradient block owns (N of its GEMM): 64
    from 97 up, 32 from 17, else 16 or 8; ``ceil(cin / np)`` blocks a tile."""
    return 64 if cin > 96 else 32 if cin > 16 else 16 if cin > 8 else 8


def dgrad_slot(n: int, sp: int, nk: bool) -> int:
    """Bytes of one tap's weight slot: ``sp`` K rows (dz channels) by ``n``
    conv input channels, [n][k] rows (HWIO, ``nk``) or [k][n] (by-target)."""
    return n * ldsm_pitch(sp) if nk else sp * ldsm_pitch(n)


def dgrad_smem(n: int, sp: int, taps: int, nk: bool) -> int:
    """A data-gradient block's shared memory: the haloed dz tile of ``sp``
    channels and every tap's slot."""
    return HALO_PIX * ldsm_pitch(sp) + taps * dgrad_slot(n, sp, nk)


def wgrad_smem(taps: int, nch: int) -> int:
    """A weight-gradient block's shared memory: two buffers of the haloed
    6×18 input tile and the 64-pixel dz tile of ``nch`` channels."""
    return 2 * ((WG_TH + 2) * 18 * ldsm_pitch(WG_XC[taps]) + WG_TH * 16 * ldsm_pitch(nch))


def dgrad_slot_reads(t: int, n0: int, n: int, s: int, cin: int, *, taps: int = 9,
                     by_target=None):
    """The weight elements slot ``t`` of the bf16 data-gradient block of
    input channels ``n0 .. n0+n`` reads (``csrc/dgrad.cuh`` ``tc``) → (K row
    = dz channel, N column, flat index or -1 for a zero past s or cin) as
    ``[rows, n]`` tensors, rows = s rounded up to 16. The slot holds forward
    tap ``taps-1-t`` (the flip); HWIO ``[taps, cin, s]`` or, with
    ``by_target=(nf, gc)``, rdb_t's ``[s, taps·cin]``."""
    tf = taps - 1 - t
    k, c = torch.meshgrid(torch.arange(round16(s)), torch.arange(n), indexing="ij")
    ci = n0 + c
    if by_target is None:
        idx = (tf * cin + ci) * s + k
    else:
        nf, gc = by_target
        j = (ci - nf).clamp(min=0)
        src = j // gc
        kk = torch.where(ci < nf, tf * nf + ci, taps * (nf + src * gc) + tf * gc + (j - src * gc))
        idx = k * taps * cin + kk
    return k, c, torch.where((k < s) & (ci < cin), idx, torch.full_like(idx, -1))
