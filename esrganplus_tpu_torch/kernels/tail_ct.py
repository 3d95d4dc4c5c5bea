"""The RRDBNet upsample tail's kernels: ``upfold_ct`` (nearest-×2 + 3×3 conv
+ lrelu) and ``conv_hr_ct`` (hr_conv0 + lrelu, then hr_conv1).

Counterpart of ``esrganplus_tpu/kernels/tail_ct.py``. The TPU kernels carry
the growing width as column-phase planes in a ``[C, pixels]`` layout; here
activations are plain NHWC and the CUDA kernels (``csrc/tail_ct.cu``) write
the HR image directly. What is kept is what they compute and where they
round: the 2×2 dense fold of the upconv (weights folded in fp32, then cast),
one rounding of each upconv output, conv0's activation rounded and zeroed
outside the image before conv1, and conv1's output in the working dtype.

Two designs, picked by dtype (:func:`stage_ct.design`): bf16 runs on the tensor
cores (``"mma"``: ``mma.sync`` implicit GEMMs, ``csrc/mma_tile.cuh``), fp32 on
the CUDA cores (``"fma"``), whose 1e-4 bar TF32 would miss. ``upfold_ct`` in
bf16 is the phase fold of ``csrc/phase_fold.cuh`` (``upfold_mma_kernel``: a
block stages its LR tile once and runs the four output phases as 2×2 convs
of it, see :func:`esrganplus_tpu_torch.kernels.stage_ct.fold_tap_slot`);
in fp32 one FMA block a phase. ``conv_hr_ct`` in bf16 is two launches
(:func:`conv_hr_mma_steps`): the stage forward of ``csrc/stage_ct.cu`` writes
conv0's activation, ``conv_hr_out_mma_kernel`` runs conv1 on it; in fp32 one
fused FMA kernel keeps the activation in shared memory.

Training goes through ``upfold_ct_diff`` and ``conv_hr_ct_diff``
(``torch.autograd.Function``s; fp32 master weights in, fp32 gradients out).
``upfold_ct_bwd`` in bf16 (:func:`upfold_bwd_mma_steps`) gates the HR
cotangent once into a phase-stacked LR tensor and runs the 16 (shift, phase)
blocks of the fold as the K of the data gradient and as the taps of the
weight gradient; in fp32 it runs the data- and weight-gradient kernels of
``csrc/dgrad_ct.cu`` and ``csrc/wgrad_ct.cu``, the per-phase 2×2 convs
embedded in 3×3 taps and reading the HR cotangent through a phase view.
``conv_hr_ct_bwd`` recomputes conv0's activation, as the TPU kernel
recomputes it per stripe: in bf16 the stage kernels of ``csrc/stage_ct.cu``
recompute it and run conv0's adjoint, and ``csrc/tail_ct.cu`` rewrites its
entries near 0 as the FMA design computes them (so the lrelu gate takes the
FMA design's sign there) and forms conv1's adjoint, the gate and conv1's
weight gradient between them; in fp32, the FMA kernels (the forward's dense
kernel, ``dgrad_ct``, ``wgrad_ct``).

A CPU tensor goes to the plain twin (``*_plain``); a CUDA tensor launches the
kernel or raises. Each wrapper counts its calls in ``launches`` and, where it
has two designs, in ``launches_by_design``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from esrganplus_tpu_torch.kernels import build
from esrganplus_tpu_torch.kernels import launch
from esrganplus_tpu_torch.kernels import stage_ct as S
from esrganplus_tpu_torch.kernels.rdb_ct import (_bias, _conv, _dense, _dgrad_plain, _dlrelu,
                                                 _lrelu, _nchw, _wgrad_plain)
from esrganplus_tpu_torch.models.layers import fp32_exact


_PHASE_MAPS = {}  # device → the 0/1 map: made once, outside any captured step


def _phase_map(device) -> torch.Tensor:
    """``pm[a, i, r]`` = 1 where HR tap r of output phase a reads LR offset i
    (a normal tensor, whatever mode the first caller runs in: training saves
    it for the backward)."""
    device = torch.device(device)
    if device not in _PHASE_MAPS:
        with torch.inference_mode(False):
            pm = torch.zeros(2, 2, 3, dtype=torch.float32)
            for a in range(2):
                for r in range(3):
                    pm[a, (a + r - 1) // 2 - (a - 1), r] = 1.0
            _PHASE_MAPS[device] = pm.to(device)
    return _PHASE_MAPS[device]


def prepare_upfold_ct(w: torch.Tensor, b: Optional[torch.Tensor],
                      dtype: torch.dtype):
    """Upconv weights ``[3, 3, C, CO]`` (HWIO) → folded
    ``[2(a), 2(b), 2(i), 2(j), C, CO]`` in ``dtype`` + fp32 bias.

    Output phase (a, b) of the nearest-×2 conv reads LR rows ``y + a - 1 + i``
    and columns ``x + b - 1 + j``; entry (a, b, i, j) sums the HR taps
    (r, s) that land there: ``⌊(a + r - 1)/2⌋ = a - 1 + i``. Folded in fp32
    and cast once, as the JAX tail does (``models/rrdb.py:448``)."""
    pm = _phase_map(w.device)
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
    bf16 runs the tensor-core design (``upfold_mma_kernel``, at any C: its
    block restages the haloed LR tile in slices of 128 channels where all C
    do not fit shared memory), fp32 the FMA kernel; no fallback between
    them. ``upfold_ct.launches`` counts CUDA launches,
    ``launches_by_design`` them by design."""
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
    launch, out = upfold_launch(x, wf, bias, slope=slope)
    launch()
    S._count(upfold_ct, S.design(dt))
    return out


def upfold_launch(x: torch.Tensor, wf: torch.Tensor, bias: torch.Tensor, *,
                  slope: float = 0.2):
    """The launch of :func:`upfold_ct` over an output allocated here →
    ``(launch, out)``: ``launch()`` calls the C entry with the design of x's
    dtype; it may run again (for timing) and gives the same bits. Inputs as
    :func:`upfold_ct` validates them; counts nothing."""
    B, H, W, C = x.shape
    CO = wf.shape[-1]
    dev = x.device
    x, wf = S._aligned(x), S._aligned(wf)  # held by the closure with out
    lib = build.load("tail_ct")
    out = torch.empty((B, 2 * H, 2 * W, CO), dtype=x.dtype, device=dev)
    design = S.DESIGNS[S.design(x.dtype)]

    def launch():
        with torch.cuda.device(dev):
            build.check(lib.esr_upfold(build.dtype_code(x), design, C, CO, x.data_ptr(),
                                       wf.data_ptr(), bias.data_ptr(), out.data_ptr(), B, H, W,
                                       slope, torch.cuda.current_stream(dev).cuda_stream),
                        "esr_upfold")

    return launch, out

CONV_HR_OUT_TILE = (8, 16)  # pixel rows × columns of a conv_hr_out_mma_kernel block


def conv_hr_mma_steps(x, w0, b0, w1, b1, *, slope: float = 0.2):
    """The bf16 design of :func:`conv_hr_ct` as its two launches, in order,
    over buffers allocated here → ``(steps, out)``. ``steps`` maps ``"hid"``
    (conv0 + lrelu rounded, ``stage_fwd_mma_kernel``) and ``"out"``
    (``conv_hr_out_mma_kernel``: conv1 + b1 over hid) to callables; each may
    run again on its own (for timing) and gives the same bits. Inputs as
    :func:`conv_hr_ct` validates them."""
    B, H, W, C = x.shape
    CO2 = w1.shape[3]
    x, w0, w1 = S._aligned(x), S._aligned(w0), S._aligned(w1)
    stage, tail = build.load("stage_ct"), build.load("tail_ct")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    mma = S.DESIGNS["mma"]
    hid = torch.empty_like(x)
    out = torch.empty((B, H, W, CO2), dtype=x.dtype, device=x.device)

    def hid_step():
        build.check(stage.esr_stage_fwd(build.dtype_code(x), 3, mma, min(C, 64), x.data_ptr(),
                                        w0.data_ptr(), b0.data_ptr(), hid.data_ptr(), B, H, W,
                                        C, C, S.ACTS["lrelu"], slope, stream), "esr_stage_fwd")

    def out_step():
        build.check(tail.esr_conv_hr_out(mma, C, CO2, hid.data_ptr(), w1.data_ptr(),
                                         b1.data_ptr(), out.data_ptr(), B, H, W, stream),
                    "esr_conv_hr_out")

    return {"hid": hid_step, "out": out_step}, out


def conv_hr_ct(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
               w1: torch.Tensor, b1: torch.Tensor, *,
               slope: float = 0.2) -> torch.Tensor:
    """hr_conv0 (3×3 C→C + lrelu) then hr_conv1 (3×3 C→CO2): NHWC
    ``[B, H, W, C]`` → ``[B, H, W, CO2]`` in the input dtype. Weights from
    :func:`prepare_conv_hr_ct`. bf16 runs the tensor-core design
    (:func:`conv_hr_mma_steps`), fp32 the fused FMA kernel; no fallback
    between them. ``conv_hr_ct.launches`` counts CUDA calls,
    ``launches_by_design`` them by design."""
    if x.device.type == "cpu":
        return conv_hr_ct_plain(x, w0, b0, w1, b1, slope=slope)
    if x.dim() != 4:
        raise ValueError(f"conv_hr_ct: x must be NHWC, got shape {tuple(x.shape)}")
    B, H, W, C = x.shape
    CO2 = w1.shape[3]
    dt, dev = x.dtype, x.device
    design = S.design(dt)
    build.require_width(C, "C")
    build.require_width(CO2, "CO2", range(1, 9))
    build.require(x, "x", (B, H, W, C), dt, dev)
    build.require(w0, "w0", (3, 3, C, C), dt, dev)
    build.require(b0, "b0", (C,), torch.float32, dev)
    build.require(w1, "w1", (3, 3, C, CO2), dt, dev)
    build.require(b1, "b1", (CO2,), torch.float32, dev)
    if design == "mma":
        steps, out = conv_hr_mma_steps(x, w0, b0, w1, b1, slope=slope)
    else:
        lib = build.load("tail_ct")
        out = torch.empty((B, H, W, CO2), dtype=dt, device=dev)
        steps = {"fused": lambda: build.check(lib.esr_conv_hr(
            build.dtype_code(x), S.DESIGNS[design], C, CO2, x.data_ptr(), w0.data_ptr(),
            b0.data_ptr(), w1.data_ptr(), b1.data_ptr(), out.data_ptr(), B, H, W, slope,
            torch.cuda.current_stream(dev).cuda_stream), "esr_conv_hr")}
    with torch.cuda.device(dev):
        for step in steps.values():
            step()
    S._count(conv_hr_ct, design)
    return out


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


CONV_HR_ADJ_TILE = (8, 16)    # pixel rows × columns of a conv_hr_adj_kernel tile
CONV_HR_ADJ_MAX_PARTS = 256   # workspace rows: about two blocks an SM


def conv_hr_adj_tiles(B: int, H: int, W: int) -> int:
    """8×16 pixel tiles that ``conv_hr_adj_kernel`` walks."""
    th, tw = CONV_HR_ADJ_TILE
    return B * -(-H // th) * -(-W // tw)


def conv_hr_adj_parts(B: int, H: int, W: int) -> int:
    """Rows of ``conv_hr_adj_kernel``'s workspace (one block each): at most
    ``CONV_HR_ADJ_MAX_PARTS``, none empty. A function of the shapes only, so
    the reduction order of dW1, db1 and db0 is."""
    tiles = conv_hr_adj_tiles(B, H, W)
    per = -(-tiles // min(tiles, CONV_HR_ADJ_MAX_PARTS))
    return -(-tiles // per)


def conv_hr_adj_ranges(B: int, H: int, W: int) -> list:
    """``[(first tile, end)]`` of each workspace row, as ``esr_conv_hr_adj``
    cuts them: ``per = ceil(tiles / parts)`` tiles a row, in tile order."""
    tiles = conv_hr_adj_tiles(B, H, W)
    parts = conv_hr_adj_parts(B, H, W)
    per = -(-tiles // parts)
    return [(p * per, min(tiles, (p + 1) * per)) for p in range(parts)]


def fix_near_zero_hid(hid, x, w0, b0, *, slope: float = 0.2) -> None:
    """In place: the entries of ``hid`` (conv0's bf16 activation as the
    tensor cores recompute it) within 2⁻¹⁶ of their pixel's 8-channel
    group's largest, recomputed as the FMA design sums them, bit for bit
    (``conv_hr_hid_fix_kernel``), so that conv_hr's lrelu gate takes that
    design's sign, which is the twin's. CUDA bf16 tensors as
    :func:`conv_hr_ct_bwd` validates them."""
    B, H, W, C = x.shape
    with torch.cuda.device(x.device):
        build.check(build.load("tail_ct").esr_conv_hr_hid_fix(
            C, hid.data_ptr(), x.data_ptr(), w0.data_ptr(), b0.data_ptr(), B, H, W, slope,
            torch.cuda.current_stream(x.device).cuda_stream), "esr_conv_hr_hid_fix")


def conv_hr_bwd_mma_steps(x, w0, b0, w1, g, *, slope: float = 0.2):
    """The bf16 design of :func:`conv_hr_ct_bwd` as its five launches, in
    order, over outputs allocated here → ``(steps, result)``. ``steps`` maps
    ``"hid"`` (conv0 + lrelu recomputed, ``stage_fwd_mma_kernel``),
    ``"hid_near_zero"`` (:func:`fix_near_zero_hid`), ``"adjoint_gate"``
    (``conv_hr_adj_kernel``: dz0 rounded once, dW1, db1 and db0 from the
    unrounded dz0), ``"dw0"`` (``stage_wgrad_mma_kernel``; its db, the sum of
    the *rounded* dz0, is not used) and ``"dx"`` (``stage_dgrad_mma_kernel``)
    to callables; each may be run again on its own (for timing) and gives
    the same bits. ``result`` holds the gradients once every step has run.
    Inputs as :func:`conv_hr_ct_bwd` validates them."""
    B, H, W, C = x.shape
    CO2 = w1.shape[3]
    dev = x.device
    x, w0 = S._aligned(x), S._aligned(w0)
    stage, tail = build.load("stage_ct"), build.load("tail_ct")
    stream = torch.cuda.current_stream(dev).cuda_stream
    bf, mma = build.dtype_code(x), S.DESIGNS["mma"]
    hid, dz0, dx = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    n1, nw0 = 9 * C * CO2, 9 * C * C
    npart_a = conv_hr_adj_parts(B, H, W)
    part_a = torch.empty((npart_a, n1 + CO2 + C), dtype=torch.float32, device=dev)
    out_a = torch.empty((n1 + CO2 + C,), dtype=torch.float32, device=dev)
    npart_w = S.stage_wgrad_parts(B, H, W, C, C, 3, "mma")
    part_w = torch.empty((npart_w, nw0 + C), dtype=torch.float32, device=dev)
    dwdb0 = torch.empty((nw0 + C,), dtype=torch.float32, device=dev)
    chunk = min(C, 64)  # read by the FMA design only

    def hid_step():
        build.check(stage.esr_stage_fwd(bf, 3, mma, chunk, x.data_ptr(), w0.data_ptr(),
                                        b0.data_ptr(), hid.data_ptr(), B, H, W, C, C,
                                        S.ACTS["lrelu"], slope, stream), "esr_stage_fwd")

    def hid_near_zero_step():
        fix_near_zero_hid(hid, x, w0, b0, slope=slope)

    def adjoint_gate_step():
        build.check(tail.esr_conv_hr_adj(C, CO2, g.data_ptr(), w1.data_ptr(), hid.data_ptr(),
                                         dz0.data_ptr(), part_a.data_ptr(), npart_a,
                                         out_a.data_ptr(), B, H, W, slope, stream),
                    "esr_conv_hr_adj")

    def dw0_step():
        build.check(stage.esr_stage_wgrad(bf, 3, mma, chunk, x.data_ptr(), dz0.data_ptr(), None,
                                          part_w.data_ptr(), npart_w, dwdb0.data_ptr(), B, H,
                                          W, C, C, S.ACTS[None], slope, stream),
                    "esr_stage_wgrad")

    def dx_step():
        build.check(stage.esr_stage_dgrad(bf, 3, mma, chunk, dz0.data_ptr(), None,
                                          w0.data_ptr(), dx.data_ptr(), B, H, W, C, C,
                                          S.ACTS[None], slope, stream), "esr_stage_dgrad")

    steps = {"hid": hid_step, "hid_near_zero": hid_near_zero_step,
             "adjoint_gate": adjoint_gate_step, "dw0": dw0_step, "dx": dx_step}
    result = {"dx": dx, "w0": dwdb0[:nw0].view(3, 3, C, C), "b0": out_a[n1 + CO2:],
              "w1": out_a[:n1].view(3, 3, C, CO2), "b1": out_a[n1:n1 + CO2]}
    return steps, result


def _embed_phases(wf: torch.Tensor) -> torch.Tensor:
    """Folded ``[2, 2, 2, 2, C, CO]`` → ``[3, 3, C, 4·CO]``: phase (a, b)'s
    2×2 taps (i, j) sit at 3×3 taps (a + i, b + j) of its CO channels."""
    C, CO = wf.shape[-2:]
    w3 = torch.zeros((3, 3, C, 4, CO), dtype=wf.dtype, device=wf.device)
    for a in range(2):
        for b in range(2):
            w3[a:a + 2, b:b + 2, :, 2 * a + b] = wf[a, b]
    return w3.view(3, 3, C, 4 * CO)


UPFOLD_DX_TILE = (8, 16)      # LR rows × columns of an upfold_dgrad_mma_kernel block
UPFOLD_WG_TILE = (4, 16)      # LR pixel tiles upfold_wgrad_mma_kernel walks (its K)
UPFOLD_WG_MAX_PARTS = 64      # dW workspace rows, four blocks (one per phase) each
UPFOLD_DZ_THREADS = 256       # threads of an upfold_dz_kernel block
UPFOLD_DZ_MAX_PARTS = 264     # db workspace rows, one block each: two an SM


def upfold_phase_width(co: int) -> int:
    """Channels of one output phase in the phase-stacked dz: CO, at least 16
    (K of one ``mma.sync``; the padding is zero)."""
    return max(co, 16)


def upfold_blocks() -> list:
    """The 16 (shift, phase) blocks of the upconv's folded adjoint in the
    order the kernels walk them: block ``s`` = ``(a, b, i, j)``, the bits of
    s, is ``wf[a, b, i, j]``; it pairs output phase ``2a + b`` of dz with the
    LR input at shift ``(a - 1 + i, b - 1 + j)``. Returns
    ``[((a, b, i, j), phase, (dy, dx))]``."""
    return [((a, b, i, j), 2 * a + b, (a - 1 + i, b - 1 + j))
            for a in range(2) for b in range(2) for i in range(2) for j in range(2)]


def upfold_stack_dz(out: torch.Tensor, g: torch.Tensor, *, slope: float = 0.2):
    """Plain mirror of ``upfold_dz_kernel`` → ``(dz, db)``: dz of output phase
    (a, b) = g[2y+a, 2x+b] gated by ``out >= 0``, rounded to g's dtype and
    phase-stacked at LR pixel (y, x) as ``[B, H, W, 4·COP]`` (channel
    ``(2a+b)·COP + co``, zero at co ≥ CO), and db summed unrounded in fp32."""
    B, H2, W2, CO = g.shape
    cop = upfold_phase_width(CO)
    dz = _dlrelu(out, g.float(), slope)
    st = torch.zeros((B, H2 // 2, W2 // 2, 2, 2, cop), dtype=g.dtype, device=g.device)
    st[..., :CO] = dz.view(B, H2 // 2, 2, W2 // 2, 2, CO).permute(0, 1, 3, 2, 4, 5).to(g.dtype)
    return st.view(B, H2 // 2, W2 // 2, 4 * cop), dz.sum((0, 1, 2))


def upfold_dz_chunks(B: int, H: int, W: int, CO: int) -> int:
    """16-byte chunks of the cotangent that ``upfold_dz_kernel`` gates (the
    LR image is H × W; COP channels a pixel, the padding included)."""
    return B * 4 * H * W * upfold_phase_width(CO) // 8


def _dz_per(n8: int) -> int:
    """Chunks a db workspace row takes: ceil(n8 / parts), rounded up to a
    multiple of the block's threads."""
    nt = UPFOLD_DZ_THREADS
    per = -(-n8 // min(UPFOLD_DZ_MAX_PARTS, -(-n8 // nt)))
    return -(-per // nt) * nt


def upfold_dz_parts(B: int, H: int, W: int, CO: int) -> int:
    """Rows of ``upfold_dz_kernel``'s db workspace (one block each), at most
    ``UPFOLD_DZ_MAX_PARTS``, none empty; see :func:`upfold_dz_ranges`."""
    n8 = upfold_dz_chunks(B, H, W, CO)
    return -(-n8 // _dz_per(n8))


def upfold_dz_ranges(B: int, H: int, W: int, CO: int) -> list:
    """``[(first chunk, end)]`` of each db workspace row, as
    ``esr_upfold_dz`` cuts them: ``per`` = ceil(chunks / parts) rounded up to
    a multiple of ``UPFOLD_DZ_THREADS`` (so a thread always forms the same 8
    channels). A function of the shapes only, so db's reduction order is."""
    n8 = upfold_dz_chunks(B, H, W, CO)
    per = _dz_per(n8)
    return [(p, min(n8, p + per)) for p in range(0, n8, per)]


def upfold_wgrad_tiles(B: int, H: int, W: int) -> int:
    """4×16 LR pixel tiles ``upfold_wgrad_mma_kernel`` walks."""
    th, tw = UPFOLD_WG_TILE
    return B * -(-H // th) * -(-W // tw)


def upfold_wgrad_parts(B: int, H: int, W: int) -> int:
    """Rows of ``upfold_wgrad_mma_kernel``'s dW workspace (four blocks each),
    at most ``UPFOLD_WG_MAX_PARTS``, none empty; see
    :func:`upfold_wgrad_ranges`."""
    tiles = upfold_wgrad_tiles(B, H, W)
    per = -(-tiles // min(tiles, UPFOLD_WG_MAX_PARTS))
    return -(-tiles // per)


def upfold_wgrad_ranges(B: int, H: int, W: int) -> list:
    """``[(first tile, end)]`` of each dW workspace row, as
    ``esr_upfold_wgrad`` cuts them: ``per = ceil(tiles / parts)`` tiles a row
    in tile order. A function of the shapes only."""
    tiles = upfold_wgrad_tiles(B, H, W)
    per = -(-tiles // upfold_wgrad_parts(B, H, W))
    return [(p, min(tiles, p + per)) for p in range(0, tiles, per)]


def upfold_bwd_mma_steps(x, wf, out, g, *, slope: float = 0.2):
    """The bf16 design of :func:`upfold_ct_bwd` as its three launches, in
    order, over buffers allocated here → ``(steps, result)``. ``steps`` maps
    ``"dz"`` (``upfold_dz_kernel``: the gated, rounded, phase-stacked dz and
    db from the unrounded one, with its ordered finish), ``"dx"``
    (``upfold_dgrad_mma_kernel``) and ``"dw"`` (``upfold_wgrad_mma_kernel``
    and its ordered finish) to callables; each may run again on its own (for
    timing) and gives the same bits. ``result`` holds ``{"dx", "wf", "b"}``
    once every step has run. Inputs as :func:`upfold_ct_bwd` validates
    them."""
    B, H, W, C = x.shape
    CO = wf.shape[-1]
    dev = x.device
    x, wf, out, g = S._aligned(x), S._aligned(wf), S._aligned(out), S._aligned(g)
    lib = build.load("tail_ct")
    stream = torch.cuda.current_stream(dev).cuda_stream
    mma = S.DESIGNS["mma"]
    dz = torch.empty((B, H, W, 4 * upfold_phase_width(CO)), dtype=x.dtype, device=dev)
    dx = torch.empty_like(x)
    nz, nw = upfold_dz_parts(B, H, W, CO), upfold_wgrad_parts(B, H, W)
    part_z = torch.empty((nz, CO), dtype=torch.float32, device=dev)
    part_w = torch.empty((nw, 16 * C * CO), dtype=torch.float32, device=dev)
    db = torch.empty((CO,), dtype=torch.float32, device=dev)
    dwf = torch.empty((2, 2, 2, 2, C, CO), dtype=torch.float32, device=dev)

    def dz_step():
        build.check(lib.esr_upfold_dz(mma, CO, g.data_ptr(), out.data_ptr(), dz.data_ptr(),
                                      part_z.data_ptr(), nz, db.data_ptr(), B, H, W, slope,
                                      stream), "esr_upfold_dz")

    def dx_step():
        build.check(lib.esr_upfold_dgrad(mma, C, CO, dz.data_ptr(), wf.data_ptr(),
                                         dx.data_ptr(), B, H, W, stream), "esr_upfold_dgrad")

    def dw_step():
        build.check(lib.esr_upfold_wgrad(mma, C, CO, x.data_ptr(), dz.data_ptr(),
                                         part_w.data_ptr(), nw, dwf.data_ptr(), B, H, W,
                                         stream), "esr_upfold_wgrad")

    return {"dz": dz_step, "dx": dx_step, "dw": dw_step}, {"dx": dx, "wf": dwf, "b": db}


def upfold_ct_bwd(x, wf, out, g, *, slope: float = 0.2) -> dict:
    """Adjoint of :func:`upfold_ct` from its input, cast folded weights and
    saved output → ``{"dx", "wf", "b"}`` (``wf`` the folded weights' fp32
    gradient). bf16 runs the tensor-core design
    (:func:`upfold_bwd_mma_steps`), fp32 the FMA kernels; no fallback between
    them. ``upfold_ct_bwd.launches`` counts CUDA calls,
    ``launches_by_design`` them by design."""
    if x.device.type == "cpu":
        return upfold_ct_bwd_plain(x, wf, out, g, slope=slope)
    B, H, W, C = x.shape
    CO = wf.shape[-1]
    dt, dev = x.dtype, x.device
    design = S.design(dt)
    build.require_width(CO, "CO")
    if design == "mma":
        build.require_width(C, "C")
    build.require(x, "x", (B, H, W, C), dt, dev)
    build.require(wf, "wf", (2, 2, 2, 2, C, CO), dt, dev)
    build.require(out, "out", (B, 2 * H, 2 * W, CO), dt, dev)
    build.require(g, "g", (B, 2 * H, 2 * W, CO), dt, dev)
    with torch.cuda.device(dev):
        if design == "mma":
            steps, res = upfold_bwd_mma_steps(x, wf, out, g, slope=slope)
            for step in steps.values():
                step()
        else:
            res = _upfold_bwd_fma(x, wf, out, g, slope)
    S._count(upfold_ct_bwd, design)
    return res


def _upfold_bwd_fma(x, wf, out, g, slope) -> dict:
    """The fp32 design: one data-gradient launch over the phases embedded in
    3×3 taps, four weight-gradient launches (one per phase) reading the HR
    cotangent through a phase view gated by the saved output."""
    B, H, W, C = x.shape
    CO = wf.shape[-1]
    phase = lambda coff: launch.dz_src(H, W, build.DZ_PHASE, g=g, mask=out.data_ptr(), co=CO,
                                       coff=coff, slope=slope)
    dx = torch.empty_like(x)
    dwf = torch.empty((2, 2, 2, 2, C, CO), dtype=torch.float32, device=x.device)
    db = None
    launch.dgrad(x, B, phase(0), 4 * CO, _embed_phases(wf), C, chunk=launch.dgrad_chunk(C),
                 out=dx)
    for a in range(2):
        for b in range(2):
            dw3, dbp = launch.wgrad(x, None, C, phase((2 * a + b) * CO), CO)
            dwf[a, b] = dw3.view(3, 3, C, CO)[a:a + 2, b:b + 2]
            db = dbp if db is None else db + dbp
    return {"dx": dx, "wf": dwf, "b": db}


def conv_hr_ct_bwd(x, w0, b0, w1, g, *, slope: float = 0.2) -> dict:
    """Adjoint of :func:`conv_hr_ct` → ``{"dx", "w0", "b0", "w1", "b1"}``.
    The forward keeps no conv0 activation (fp32: it never leaves shared
    memory; bf16: a buffer freed after conv1), so it is recomputed here
    (rounded as there) into a device buffer; SAME padding of that buffer is
    the forward's zeroing outside the image. bf16 runs the
    tensor-core design (:func:`conv_hr_bwd_mma_steps`), fp32 the FMA
    kernels; no fallback between them. ``conv_hr_ct_bwd.launches`` counts
    CUDA calls, ``launches_by_design`` them by design."""
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
    design = S.design(dt)
    with torch.cuda.device(dev):
        if design == "mma":
            steps, res = conv_hr_bwd_mma_steps(x, w0, b0, w1, g, slope=slope)
            for step in steps.values():
                step()
        else:
            res = _conv_hr_bwd_fma(x, w0, b0, w1, g, slope)
    S._count(conv_hr_ct_bwd, design)
    return res


def _conv_hr_bwd_fma(x, w0, b0, w1, g, slope) -> dict:
    """The fp32 design: the forward's dense kernel recomputes hid, conv1's
    data gradient lands in an fp32 buffer that the gate of conv0's weight-
    and data-gradient launches reads at load."""
    B, H, W, C = x.shape
    CO2 = w1.shape[3]
    hid = torch.empty_like(x)
    dhid = torch.empty((B, H, W, C), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    chunk = launch.dgrad_chunk(C)
    _dense(build.load("rdb_ct"), x, None, C, w0, b0, hid.data_ptr(), C, mode=launch.ACT,
           cout=C, slope=slope)
    dz1 = launch.dz_src(H, W, build.DZ_G, g=g, g_stride=CO2)
    dw1, db1 = launch.wgrad(hid, None, C, dz1, CO2)
    launch.dgrad(x, B, dz1, CO2, w1, C, chunk=chunk, out32=dhid)
    dz0 = launch.dz_src(H, W, build.DZ_GATE, d32=dhid, d_stride=C, mask=hid.data_ptr(),
                        m_stride=C, slope=slope)
    dw0, db0 = launch.wgrad(x, None, C, dz0, C)
    launch.dgrad(x, B, dz0, C, w0, C, chunk=chunk, out=dx)
    return {"dx": dx, "w0": dw0.view(3, 3, C, C), "b0": db0,
            "w1": dw1.view(3, 3, C, CO2), "b1": db1}


def reset_design_counts() -> None:
    """Set ``launches`` and ``launches_by_design`` of :func:`upfold_ct`,
    :func:`conv_hr_ct`, :func:`upfold_ct_bwd` and :func:`conv_hr_ct_bwd` to
    0."""
    for fn in (upfold_ct, conv_hr_ct, upfold_ct_bwd, conv_hr_ct_bwd):
        fn.launches = 0
        fn.launches_by_design = dict.fromkeys(S.DESIGNS, 0)


reset_design_counts()


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
