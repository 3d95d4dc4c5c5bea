"""One ESRGAN+ ResidualDenseBlock in one launch per spatial tile
(``rdb_fused``), on by-source weights.

Counterpart of ``esrganplus_tpu/kernels/workbench/rdb.py``. The weights are
regrouped by *source* (:func:`prepare_rdb_weights`): x, x1..x4 each convolve
once into their contributions to every later target, and a target is the sum
of its contributions. The CUDA kernels (``csrc/workbench_rdb.cu``) read the
x tile once with a 5-pixel halo, keep x1..x4 in shared memory and write
only the block output.

Two designs, picked by :func:`rdb_design` from the (activation, weight)
dtypes: ``"mma"`` for bf16 with bf16 weights (the tensor cores: per target
one implicit GEMM per source over tap-shifted rows of its shared-memory
plane, :func:`mma_regions`, N in passes of 32 (64 for the output) columns,
tile :func:`mma_tile`) and ``"fma"`` for fp32 activations (the CUDA cores,
tile :data:`KERNEL_TILE`). Both take any nf and gc divisible by 8 whose
planes fit a block's shared memory.
The C entry takes the design code and refuses the other;
``rdb_fused.launches_by_design`` counts launches by design.

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
tile (:data:`KERNEL_TILE`, :func:`mma_tile`). A CPU tensor goes to the plain twin
(:func:`rdb_fused_plain`); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from esrganplus_tpu_torch.kernels import build
from esrganplus_tpu_torch.kernels.stage_ct import DESIGNS
from esrganplus_tpu_torch.models.layers import fp32_exact

# (activation dtype, weight dtype) pairs the kernel and its twin take
DTYPES = ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
          (torch.float32, torch.bfloat16))
# The FMA kernel's own (square) tile. 8 rather than 16: at nf=64, gc=32 a
# 16×16 tile needs ~200 KB of shared memory even in bf16, so one block per SM
# and only 64 blocks for a 128² image on the H100's 132 SMs; tile 8 (1.78× the
# products instead of 1.34×) measured faster there (chip_smoke.py
# kernels-workbench).
KERNEL_TILE = 8
# The tensor-core kernel's (rows, columns) tiles, largest first
# (csrc/workbench_rdb.cu launches these three); a call runs the first that
# takes its widths (mma_tile): 8×16, which runs one pass and one K chunk a
# tap only (nf ≤ 64, gc ≤ 32) and is 1.7× faster than 8×8 at the flagship
# widths (chip_smoke.py kernels-workbench), else 8×8, else 4×8, by shared
# memory.
MMA_TILES = ((8, 16), (8, 8), (4, 8))
MMA_TILE = MMA_TILES[0]
MMA_NF_PASS, MMA_GC_PASS = 64, 32  # N columns of a pass of x5 and of x1..x4
MMA_K_SLOT = 64                    # K rows (source channels) of a weight-ring slot
MMA_WARPS, MMA_SLOTS = 8, 3        # warps of a block, weight-ring depth
MAX_SMEM = 232448            # opt-in shared memory per block on sm_90 (227 KB)


def rdb_design(xdtype: torch.dtype, wdtype: torch.dtype) -> str:
    """Which CUDA design runs :func:`rdb_fused` on these (activation,
    weight) dtypes: ``"mma"`` (the tensor cores) for bf16 with bf16 weights,
    ``"fma"`` (fp32 on the CUDA cores, whose 1e-4 bar TF32 would miss) for
    fp32 activations with fp32 or bf16 weights."""
    if (xdtype, wdtype) not in DTYPES:
        raise TypeError(f"rdb_fused: (x, weights) dtypes must be one of "
                        f"{[tuple(str(d) for d in p) for p in DTYPES]}, got {xdtype}, {wdtype}")
    return "mma" if xdtype == torch.bfloat16 else "fma"


def _round16(c: int) -> int:
    return -(-c // 16) * 16


def _ldsm_pitch(c: int) -> int:
    """Bytes of a shared [row][c × bf16] row (``csrc/mma_bf16.cuh``
    ``ldsm_pitch``): c rounded up to 16-byte units, then to an odd count."""
    return ((c + 7) // 8 | 1) * 16


def mma_regions(th: int, tw: int) -> list:
    """Per target j = 0 (x) .. 5 (the output) of a th × tw tensor-core tile:
    ``(rows, columns, pixels, m16 tiles, N splits, m16 units a warp holds)``.
    Region j has halo 5 − j, flattened row-major and padded to m16 tiles;
    warps take the tiles round-robin and own all of N, except that x5 on a
    tile of fewer m16 tiles than warps splits N in two
    (``csrc/workbench_rdb.cu`` ``Geo``)."""
    out = []
    for j in range(6):
        rh, rw = th + 2 * (5 - j), tw + 2 * (5 - j)
        nmt = -(-rh * rw // 16)
        nsplit = 2 if j == 5 and nmt < MMA_WARPS else 1
        out.append((rh, rw, rh * rw, nmt, nsplit, -(-nmt * nsplit // MMA_WARPS)))
    return out


def mma_smem_bytes(nf: int, gc: int, th: int, tw: int) -> int:
    """One tensor-core block's shared memory (``csrc/workbench_rdb.cu``
    ``smem_bytes``): x's plane and x1..x4's ([pixel][channel] rows, channels
    padded to 16, :func:`_ldsm_pitch` bytes a row) and the weight ring
    (:data:`MMA_SLOTS` slots of :data:`MMA_K_SLOT` K rows ×
    :data:`MMA_NF_PASS` columns)."""
    regions = mma_regions(th, tw)
    n = regions[0][2] * _ldsm_pitch(_round16(nf))
    n += sum(regions[j][2] for j in range(1, 5)) * _ldsm_pitch(_round16(gc))
    return n + MMA_SLOTS * MMA_K_SLOT * _ldsm_pitch(MMA_NF_PASS)


def mma_tiles(nf: int, gc: int) -> list:
    """The tensor-core tiles that take these widths, in
    :data:`MMA_TILES`'s order: their shared memory (:func:`mma_smem_bytes`)
    fits a block, and 8×16 (:data:`MMA_TILE`) only at one pass (nf ≤
    :data:`MMA_NF_PASS`, gc ≤ :data:`MMA_GC_PASS`)."""
    one = nf <= MMA_NF_PASS and gc <= MMA_GC_PASS
    return [t for t in MMA_TILES
            if mma_smem_bytes(nf, gc, *t) <= MAX_SMEM and (one or t != MMA_TILE)]


def mma_tile(nf: int, gc: int) -> tuple:
    """The tensor-core tile a call at these widths runs: the first of
    :func:`mma_tiles`, else ``ValueError``."""
    tiles = mma_tiles(nf, gc)
    if not tiles:
        raise ValueError(f"rdb_fused: nf={nf}, gc={gc} in bf16 need more shared memory than a "
                         f"block has at every tensor-core tile {MMA_TILES}")
    return tiles[0]


def mma_stages(nf: int, gc: int, conv1x1: bool) -> list:
    """The tensor-core kernel's weight-ring stages in order (``csrc/
    workbench_rdb.cu`` ``advance``): ``(target j, pass p, source i, tap t, K
    chunk kc)`` per target, pass of :data:`MMA_GC_PASS` (x5:
    :data:`MMA_NF_PASS`) columns, source i < j, tap and chunk of
    :data:`MMA_K_SLOT` source channels; target 2 with the 1×1 then takes x
    at the centre tap as source i = j."""
    nk = lambda i: -(-_round16(nf if i == 0 else gc) // MMA_K_SLOT)
    out = []
    for j in range(1, 6):
        npass = -(-nf // MMA_NF_PASS) if j == 5 else -(-gc // MMA_GC_PASS)
        for p in range(npass):
            for i in range(j):
                out += [(j, p, i, t, kc) for t in range(9) for kc in range(nk(i))]
            if j == 2 and conv1x1:
                out += [(j, p, j, 4, kc) for kc in range(nk(0))]
    return out


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


def rdb_fused_fp64(x: torch.Tensor, w0, w1, w2, w3, w4, bias, *, nf: int, gc: int,
                   conv1x1: bool = True, slope: float = 0.2,
                   res_scale: float = 0.2) -> torch.Tensor:
    """:func:`rdb_fused_plain`'s graph with float64 convs and sums: the
    exact per-source partials rounded at the same points. A yardstick for the
    twin's own fp32 summation error, which grows with the widths (no CUDA
    path uses it)."""
    dt = x.dtype
    rnd = lambda t: t.to(dt).double()
    b = bias.double().flatten()
    off = lambda j: nf + (4 - j) * gc
    ws = (w0, w1, w2, w3, w4)

    def contrib(src, w):
        k = w.double().reshape(3, 3, w.shape[1] // 3, w.shape[2]).permute(3, 2, 1, 0)
        return rnd(F.conv2d(src, k.contiguous(), padding=1))

    xs, cs = [x.double().permute(0, 3, 1, 2)], []
    for j in range(1, 5):
        cs.append(contrib(xs[-1], ws[j - 1]))
        t = sum(c[:, off(j):off(j) + gc] for c in cs) + b[off(j):off(j) + gc, None, None]
        t = torch.where(t >= 0, t, t * slope)
        if j == 2 and conv1x1:
            t = t + cs[0][:, nf + 4 * gc:]
        elif j == 4:
            t = t + xs[2]
        xs.append(rnd(t))
    cs.append(contrib(xs[4], ws[4]))
    x5 = sum(c[:, :nf] for c in cs) + b[:nf, None, None]
    return (x5 * res_scale + xs[0]).to(dt).permute(0, 2, 3, 1).contiguous()


def smem_bytes(dtype: torch.dtype, nf: int, gc: int, t: int) -> int:
    """One FMA block's shared memory at kernel tile ``t`` (the count
    ``csrc/workbench_rdb.cu`` launches the FMA kernel with; the tensor-core
    kernel's is :func:`mma_smem_bytes`)."""
    n = nf * (t + 10) ** 2 + gc * sum((t + 2 * (5 - j)) ** 2 for j in range(1, 5))
    return n * torch.tensor([], dtype=dtype).element_size()


def kernel_tile(design: str, ktile=None, *, nf: int, gc: int) -> tuple:
    """The (rows, columns) tile a design's kernel runs at these widths:
    ``ktile`` (an int T for the FMA kernel's T × T, a pair from
    :data:`MMA_TILES` for the tensor cores) or the design's default
    (:data:`KERNEL_TILE`, :func:`mma_tile`)."""
    if design == "mma":
        t = mma_tile(nf, gc) if ktile is None else ktile
        if not isinstance(t, tuple) or t not in MMA_TILES:
            raise ValueError(f"rdb_fused: the tensor-core kernel runs tiles {MMA_TILES}, got {t}")
        return t
    t = KERNEL_TILE if ktile is None else ktile
    if not isinstance(t, int) or t <= 0:
        raise ValueError(f"rdb_fused: the FMA kernel runs a square tile T, got {t!r}")
    return t, t


def _rdb_fused_cuda(x, ws, bias, *, nf, gc, conv1x1, slope, res_scale, ktile=None):
    """One launch at kernel tile ``ktile`` (default: the design's,
    :func:`kernel_tile`)."""
    if nf % 8 or gc % 8:
        raise ValueError(f"rdb_fused: the CUDA kernels take nf and gc divisible by 8, "
                         f"got nf={nf}, gc={gc}")
    dev = x.device
    for name, t in (("x", x), *((f"w{i}", w) for i, w in enumerate(ws)), ("bias", bias)):
        build.require(t, name, tuple(t.shape), t.dtype, dev)
        if t.data_ptr() % 16:
            raise ValueError(f"rdb_fused: {name} must be 16-byte aligned")
    design = rdb_design(x.dtype, ws[0].dtype)
    th, tw = kernel_tile(design, ktile, nf=nf, gc=gc)
    if design == "mma":
        if (th, tw) not in mma_tiles(nf, gc):
            raise ValueError(f"rdb_fused: the tensor-core tile {th}×{tw} does not take "
                             f"nf={nf}, gc={gc} (it takes {mma_tiles(nf, gc)})")
        smem = mma_smem_bytes(nf, gc, th, tw)
    else:
        smem = smem_bytes(x.dtype, nf, gc, th)
    if smem > MAX_SMEM:
        raise ValueError(f"rdb_fused: nf={nf}, gc={gc} in {x.dtype} need more shared memory "
                         f"than a block has at kernel tile {th}×{tw}")
    B, H, W, _ = x.shape
    out = torch.empty_like(x)
    lib = build.load("workbench_rdb")
    with torch.cuda.device(dev):
        code = lib.esr_wb_rdb_fused(DESIGNS[design], build.dtype_code(x),
                                    build.dtype_code(ws[0]), x.data_ptr(),
                                    *(w.data_ptr() for w in ws), bias.data_ptr(),
                                    out.data_ptr(), B, H, W, nf, gc, int(conv1x1),
                                    float(slope), float(res_scale), th, tw,
                                    torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "esr_wb_rdb_fused")
    rdb_fused.launches += 1
    rdb_fused.launches_by_design[design] += 1
    return out


def rdb_fused(x: torch.Tensor, w0, w1, w2, w3, w4, bias, *, nf: int, gc: int,
              conv1x1: bool = True, slope: float = 0.2, res_scale: float = 0.2,
              tile: int = 64) -> torch.Tensor:
    """Fused RDB forward: NHWC ``x`` ``[B, H, W, nf]`` (bf16 or fp32) → the
    same shape and dtype. Weights from :func:`prepare_rdb_weights`; H and W
    divisible by ``tile``. ``rdb_fused.launches`` counts CUDA launches,
    ``launches_by_design`` them by design (:func:`rdb_design`)."""
    ws = (w0, w1, w2, w3, w4)
    _forward_only(x, *ws, bias)
    if x.device.type == "cpu":
        return rdb_fused_plain(x, *ws, bias, nf=nf, gc=gc, conv1x1=conv1x1, slope=slope,
                               res_scale=res_scale, tile=tile)
    _check(x, ws, bias, nf, gc, conv1x1, tile)
    return _rdb_fused_cuda(x, ws, bias, nf=nf, gc=gc, conv1x1=conv1x1, slope=slope,
                           res_scale=res_scale)


def reset_launch_counts() -> None:
    """Set ``rdb_fused.launches`` and ``launches_by_design`` to 0."""
    rdb_fused.launches = 0
    rdb_fused.launches_by_design = dict.fromkeys(DESIGNS, 0)


reset_launch_counts()
