"""Launches shared by the wrappers of several kernel modules.

The design a dtype runs on (:func:`design`, for the dense, stage, tail and
backward wrappers alike), the dense-stage epilogue modes and the mirror of
the bf16 dense kernel's plan, tile walk and weight staging
(``csrc/dense_conv.cuh``), the
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
import functools
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
# the bf16 dense kernel's plan, tile walk and weight staging
# (csrc/dense_conv.cuh dmma), mirrored for the CPU tests and the counters
# ---------------------------------------------------------------------------

DENSE_TH = 8           # tile rows: a wgmma M block is 8 rows × 8 columns
DENSE_GCH = 32         # channels of a group: one 64-byte swizzled row a pixel
DENSE_SLICE_G = 6      # groups a tile slot holds at most (192 channels: one partial's K)
DENSE_NWG = 2          # consumer warpgroups a block, each its own stream of tiles
DENSE_MAX_BUF = 4      # tile slots at most
MAX_SMEM = 232448      # opt-in shared memory per block on sm_90 (227 KB)
HALO_PIX = 10 * 18     # the haloed 8×16 pixel tile (the data-gradient kernel's)


def round16(c: int) -> int:
    return -(-c // 16) * 16


def ldsm_pitch(c: int) -> int:
    """Bytes of a shared [row][c × bf16] row (``csrc/mma_bf16.cuh``): c
    rounded up to 16-byte units, then to an odd count of them."""
    return ((c + 7) // 8 | 1) * 16


def dense_group_bytes(tw: int) -> int:
    """Bytes of one haloed (8+2) × (tw+2) group of 32 channels, 64 bytes a
    pixel, padded to 1024."""
    return -(-(DENSE_TH + 2) * (tw + 2) * DENSE_GCH * 2 // 1024) * 1024


def dense_groups(cin: int, c0: int) -> tuple:
    """``(groups of x, all groups)`` of the K walk: x's c0 channels, then the
    concat prefix's cin - c0, each source padded to whole 32-channel
    groups."""
    gx = -(-c0 // DENSE_GCH)
    return gx, gx + -(-(cin - c0) // DENSE_GCH)


def dense_k_channels(cin: int, c0: int) -> list:
    """The source channel of each K row of the group walk, None for a
    padding row (``csrc/dense_conv.cuh`` ``k_channel``)."""
    gx, ng = dense_groups(cin, c0)
    out = []
    for k in range(ng * DENSE_GCH):
        g, w = divmod(k, DENSE_GCH)
        c = g * DENSE_GCH + w if g < gx else c0 + (g - gx) * DENSE_GCH + w
        out.append(c if (c < c0 if g < gx else c < cin) else None)
    return out


def dense_w_bytes(ng: int, nb: int) -> int:
    """Bytes of a block's resident weights: ``nb`` outputs × ``ng`` groups ×
    9 taps."""
    return 9 * ng * DENSE_GCH * nb * 2


def dense_smem(tw: int, nb: int, nbuf: int, ng: int, gx: int, s11: bool = False) -> int:
    """A block's shared memory: ``nbuf`` tile slots of up to 6 groups, the
    weights, the 1×1 shortcut's x groups (stage 2) and two 8-byte barriers
    a slot."""
    return (nbuf * min(ng, DENSE_SLICE_G) * dense_group_bytes(tw) + dense_w_bytes(ng, nb)
            + (gx * DENSE_GCH * nb * 2 if s11 else 0) + 16 * nbuf)


DensePlan = collections.namedtuple("DensePlan", "tw nb nbuf tiles blocks smem")


def dense_plan(cout: int, cin: int, c0: int, s11: bool, B: int, H: int, W: int, nsm: int):
    """A launch's plan (``csrc/dense_conv.cuh`` ``dmma::plan``), or None where
    none fits: the outputs a block owns ``nb`` (cout, else halved down to 8),
    the tile width ``tw`` (16 where nb ≤ 32, two slots fit and every
    warpgroup gets a tile, else 8), 4 tile slots where they fit, else 2 (one
    or two a warpgroup's stream), the tiles and the blocks (at most one an
    SM, a multiple of cout/nb)."""
    gx, ng = dense_groups(cin, c0)
    nb = cout
    while nb >= 8:
        fit16 = nb <= 32 and dense_smem(16, nb, DENSE_NWG, ng, gx, s11) <= MAX_SMEM
        if fit16 or dense_smem(8, nb, DENSE_NWG, ng, gx, s11) <= MAX_SMEM:
            np_ = cout // nb
            tiles16 = B * -(-H // DENSE_TH) * -(-W // 16)
            tw = 16 if fit16 and tiles16 * np_ >= DENSE_NWG * nsm else 8
            nbuf = (DENSE_MAX_BUF if dense_smem(tw, nb, DENSE_MAX_BUF, ng, gx, s11) <= MAX_SMEM
                    else DENSE_NWG)
            tiles = B * -(-H // DENSE_TH) * -(-W // tw)
            blocks = max(np_, min(tiles * np_, nsm) // np_ * np_)
            return DensePlan(tw, nb, nbuf, tiles, blocks,
                             dense_smem(tw, nb, nbuf, ng, gx, s11))
        nb //= 2
    return None


def dense_walk(plan: DensePlan, cout: int, B: int, H: int, W: int) -> list:
    """Each block's work in order, ``[(outputs, [(b, y0, x0), ...])]``: block
    k owns outputs ``part·nb .. +nb`` (part = k mod cout/nb) of the tiles
    g, g + G, ... (g = k div cout/nb, G = blocks·nb/cout), tiles numbered
    column-fastest, then row, then image; its warpgroups take them in turn."""
    np_ = cout // plan.nb
    G = plan.blocks // np_
    ntx, nty = -(-W // plan.tw), -(-H // DENSE_TH)
    out = []
    for k in range(plan.blocks):
        part, g = k % np_, k // np_
        tiles = []
        for i in range(g, plan.tiles, G):
            r = i // ntx
            tiles.append((r // nty, (r % nty) * DENSE_TH, (i % ntx) * plan.tw))
        out.append((range(part * plan.nb, (part + 1) * plan.nb), tiles))
    return out


def dense_joins(cin: int, c0: int) -> list:
    """The order in which an output's partial sums join its fp32 total:
    ``(tap, source channels)``, slice by slice of at most 6 groups (192
    channels), tap by tap within one; each partial runs over its slice's
    channels from zero."""
    k = dense_k_channels(cin, c0)
    step = DENSE_SLICE_G * DENSE_GCH
    out = []
    for lo in range(0, len(k), step):
        chans = [c for c in k[lo:lo + step] if c is not None]
        out += [(t, chans) for t in range(9)]
    return out


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def dense_staged_bytes(cout: int, cin: int, c0: int, s11: bool, B: int, H: int, W: int,
                       nsm: int) -> int:
    """Weight bytes one bf16 dense-stage launch stages into shared memory by
    the mirrored plan: every block its outputs' weights (and the 1×1's)
    once."""
    p = dense_plan(cout, cin, c0, s11, B, H, W, nsm)
    gx, ng = dense_groups(cin, c0)
    return p.blocks * (dense_w_bytes(ng, p.nb) + (gx * DENSE_GCH * p.nb * 2 if s11 else 0))


@functools.lru_cache(maxsize=4096)
def dense_c_plan(cout: int, cin: int, c0: int, s11: bool, B: int, H: int, W: int,
                 index: int) -> tuple:
    """The plan the bf16 dense kernel launches with on CUDA device ``index``
    (``esr_dense_plan``): :data:`DensePlan`'s fields, then the weight bytes
    the launch stages into shared memory."""
    out = (ctypes.c_int * 7)()
    code = build.load("rdb_ct").esr_dense_plan(cout, cin, c0, ACT_1X1 if s11 else ACT, B, H, W,
                                               sm_count(index), out)
    build.check(code, "esr_dense_plan")
    return tuple(out)


def dense_weight_reads(t: int, c: int, rows: int, cin: int, cout: int, *, taps: int = 9,
                       by_target=None):
    """The weight elements the bf16 dense kernel stages for K rows ``c ..
    c+rows`` of tap ``t`` (``csrc/dense_conv.cuh`` ``stage_weights``; the
    layouts of ``csrc/wlayout.cuh``) → (K row, output channel, flat index,
    -1 for a zero row past ``cin``) as flat tensors: HWIO ``[taps, cin,
    cout]``, or with ``by_target=(nf, gc)`` rdb_t's ``[cout, taps·cin]``
    with K ordered source, tap, channel."""
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
