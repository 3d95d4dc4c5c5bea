"""RRDB generator (ESRGAN / ESRGAN+), one-shot inference.

Counterpart of ``esrganplus_tpu/models/rrdb.py``. Parameters are dicts of
tensors in the JAX package's layout (HWIO weights, the ``trunk`` subtree
stacked over the nb blocks), activations are NHWC.

Two paths, picked from the config and the tensor's device:

  * the plain graph — the literal reference dataflow (bias-free 1×1 dense
    shortcut into x2, ``x4 = conv4(cat) + x2``, β=0.2 on both residuals)
    built from :mod:`layers`; the fp32 parity path and everything on the CPU;
  * the kernel path — on a CUDA tensor the trunk runs through the
    hand-written CUDA kernels ``rdb_ct`` (69 calls at nb=23, each RRDB's
    third call folding the RRDB epilogue) and ``conv3x3_ct`` (trunk conv +
    global residual), and a ×2ⁿ tail through ``upfold_ct`` and
    ``conv_hr_ct``. The ×3 upconv has no kernel and stays plain, as in the
    JAX package. Forced onto the CPU (``trunk_kernel="cuda"``,
    ``tail_kernel="cuda"``), the same chain runs the kernels' plain twins.
    Its weights are converted once, by :func:`prep_trunk_ct`.

Noise sites (nESRGAN+ training, the Tarsier inference mode) are not ported
yet: the config carries their fields so configs carry across unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from esrganplus_tpu_torch.kernels.build import KERNEL_WIDTHS
from esrganplus_tpu_torch.models.layers import (
    act,
    conv2d,
    fp32_exact,
    kaiming_conv_init,
    pixel_shuffle,
    upsample_nearest,
)

_KERNEL_ALIASES = {"xla": "plain", "pallas": "cuda"}


@dataclasses.dataclass(frozen=True)
class RRDBNetConfig:
    in_nc: int = 3
    out_nc: int = 3
    nf: int = 64
    nb: int = 23
    gc: int = 32
    upscale: int = 4
    act_type: str = "leakyrelu"
    act_slope: float = 0.2
    # ESRGAN+ 1×1 dense shortcut (reference block.py:153-154,263); False gives
    # the vanilla-ESRGAN RDB graph.
    conv1x1: bool = True
    # Noise sites act only in training and the Tarsier noise_rng mode, neither
    # ported yet: these four fields are carried but read by nothing.
    rdb_noise: bool = True
    rrdb_noise: bool = False
    noise_sigma: float = 0.1
    noise_relative_detach: bool = False
    res_scale: float = 0.2
    # The JAX package's trunk unroll; only 0 (the loop as written) is taken.
    unroll: int = 0
    # True: the plain ×3 tail folds nearest-×3 + conv into one LR conv with
    # phase-packed outputs + pixel shuffle (exact), as the JAX package does.
    fused: bool = True
    # "auto" | "plain" | "cuda" ("xla" and "pallas" are accepted aliases).
    # auto: the CUDA kernels on a CUDA device (the ×3 tail, which has none,
    # stays plain), the plain graph on the CPU. cuda: the kernels wherever
    # the tensor lies (their plain twins on the CPU). Either raises where the
    # kernels cannot take the config; only "plain" asks for the plain graph.
    trunk_kernel: str = "auto"
    tail_kernel: str = "auto"
    # The noise application site; only "input" is taken.
    noise_kernel: str = "input"

    def __post_init__(self):
        for f in ("trunk_kernel", "tail_kernel"):
            v = _KERNEL_ALIASES.get(getattr(self, f), getattr(self, f))
            if v not in ("auto", "plain", "cuda"):
                raise ValueError(f"{f} must be auto|plain|cuda, got {v!r}")
            object.__setattr__(self, f, v)
        if self.unroll != 0 or self.noise_kernel != "input":
            raise ValueError(f"unroll={self.unroll}, noise_kernel={self.noise_kernel!r}: "
                             "not ported; only unroll=0, noise_kernel='input'")

    @property
    def n_upscale_stages(self) -> int:
        if self.upscale == 3:
            return 1
        return int(round(math.log2(self.upscale))) if self.upscale > 1 else 0


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_rdb(gen, cfg: RRDBNetConfig, scale: float, dtype) -> dict:
    nf, gc = cfg.nf, cfg.gc
    p = {f"conv{k}": kaiming_conv_init(gen, 3, 3, nf + (k - 1) * gc,
                                       nf if k == 5 else gc, scale, dtype=dtype)
         for k in range(1, 6)}
    if cfg.conv1x1:
        p["conv1x1"] = kaiming_conv_init(gen, 1, 1, nf, gc, scale, bias=False,
                                         dtype=dtype)
    return p


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_rrdbnet(cfg: RRDBNetConfig, seed: int = 0, init_scale: float = 0.1,
                 dtype: torch.dtype = torch.float32) -> dict:
    """Seeded random parameters (CPU) in the JAX package's layout. Values
    differ from ``esrganplus_tpu``'s init for the same seed (another RNG)."""
    gen = torch.Generator().manual_seed(seed)
    trunk = {name: _stack([_init_rdb(gen, cfg, init_scale, dtype)
                           for _ in range(cfg.nb)])
             for name in ("rdb1", "rdb2", "rdb3")}
    conv = lambda cin, cout: kaiming_conv_init(gen, 3, 3, cin, cout, init_scale,
                                               dtype=dtype)
    return {
        "fea_conv": conv(cfg.in_nc, cfg.nf),
        "trunk": trunk,
        "trunk_conv": conv(cfg.nf, cfg.nf),
        "hr_conv0": conv(cfg.nf, cfg.nf),
        "hr_conv1": conv(cfg.nf, cfg.out_nc),
        "upconvs": [conv(cfg.nf, cfg.nf) for _ in range(cfg.n_upscale_stages)],
    }


def block_params(trunk: dict, i: int) -> dict:
    """Block ``i`` of the nb-stacked trunk (views, no copies)."""
    if isinstance(trunk, dict):
        return {k: block_params(v, i) for k, v in trunk.items()}
    return trunk[i]


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return params.numel()


# ---------------------------------------------------------------------------
# plain graph
# ---------------------------------------------------------------------------


def _rdb_forward(x, p: dict, cfg: RRDBNetConfig, dtype):
    """Residual dense block with ESRGAN+'s two extra residual paths."""
    a = lambda t: act(t, cfg.act_type, cfg.act_slope)
    x1 = a(conv2d(x, p["conv1"], dtype=dtype))
    x2 = a(conv2d(torch.cat([x, x1], -1), p["conv2"], dtype=dtype))
    if cfg.conv1x1:
        x2 = x2 + conv2d(x, p["conv1x1"], dtype=dtype)
    x3 = a(conv2d(torch.cat([x, x1, x2], -1), p["conv3"], dtype=dtype))
    x4 = a(conv2d(torch.cat([x, x1, x2, x3], -1), p["conv4"], dtype=dtype)) + x2
    x5 = conv2d(torch.cat([x, x1, x2, x3, x4], -1), p["conv5"], dtype=dtype)
    return x5 * cfg.res_scale + x


def _rrdb_forward(x, p: dict, cfg: RRDBNetConfig, dtype):
    h = _rdb_forward(x, p["rdb1"], cfg, dtype)
    h = _rdb_forward(h, p["rdb2"], cfg, dtype)
    h = _rdb_forward(h, p["rdb3"], cfg, dtype)
    return h * cfg.res_scale + x


def _fold_upconv(p: dict, f: int) -> dict:
    """Fold a 3×3 HR conv (after nearest-×f upsampling) into a 3×3 LR conv
    with f²·Cout phase-packed outputs (pixel-shuffle channel order)."""
    w = p["w"].float()
    cin, cout = w.shape[2], w.shape[3]
    a = torch.arange(f)[:, None, None]
    i = torch.arange(3)[None, :, None]
    r = torch.arange(3)[None, None, :]
    phase_map = (torch.div(a + r - 1, f, rounding_mode="floor") == i - 1).to(w)
    with fp32_exact():
        folded = torch.einsum("air,bjs,rsco->ijcoab", phase_map, phase_map, w)
    out = {"w": folded.reshape(3, 3, cin, cout * f * f).to(p["w"].dtype)}
    if "b" in p:
        out["b"] = p["b"].repeat_interleave(f * f)
    return out


def _tail_plain(params: dict, fea, cfg: RRDBNetConfig, dtype):
    factor = 3 if cfg.upscale == 3 else 2
    for up in params["upconvs"]:
        if cfg.fused:
            y = pixel_shuffle(conv2d(fea, _fold_upconv(up, factor), dtype=dtype), factor)
        else:
            y = conv2d(upsample_nearest(fea, factor), up, dtype=dtype)
        fea = act(y, cfg.act_type, cfg.act_slope)
    fea = act(conv2d(fea, params["hr_conv0"], dtype=dtype), cfg.act_type, cfg.act_slope)
    return conv2d(fea, params["hr_conv1"], dtype=dtype).float()


# ---------------------------------------------------------------------------
# kernel path
# ---------------------------------------------------------------------------


def _slope(cfg: RRDBNetConfig) -> float:
    return 0.0 if cfg.act_type == "relu" else cfg.act_slope


def _require_kernels_fit(cfg: RRDBNetConfig, device, dtype, field: str) -> None:
    """Raise where the kernel path cannot take the config: its dataflow
    anywhere, and on a CUDA device also the dtypes and widths the kernels
    are built for (the CPU twins take any)."""
    bad = []
    if cfg.act_type not in ("leakyrelu", "lrelu", "relu"):
        bad.append(f"act_type {cfg.act_type!r}")
    if field == "tail_kernel" and cfg.upscale & (cfg.upscale - 1):
        bad.append(f"upscale={cfg.upscale} (×2ⁿ only)")
    if torch.device(device).type == "cuda":
        if dtype not in (torch.float32, torch.bfloat16):
            bad.append(f"dtype {dtype}")
        if cfg.nf not in KERNEL_WIDTHS or cfg.gc not in KERNEL_WIDTHS:
            bad.append(f"nf={cfg.nf}, gc={cfg.gc} (widths {KERNEL_WIDTHS})")
        if field == "tail_kernel" and cfg.out_nc > 8:
            bad.append(f"out_nc={cfg.out_nc} (at most 8)")
    if bad:
        raise ValueError(f"{field}={getattr(cfg, field)!r}: the CUDA kernels do not take "
                         f"{', '.join(bad)}; set {field}='plain' for the plain graph")


def use_cuda_trunk(cfg: RRDBNetConfig, device, dtype) -> bool:
    """The trunk takes the CUDA kernels: "cuda", or "auto" on a CUDA device.
    Raises where the kernels cannot take the config."""
    if cfg.trunk_kernel == "plain" or (cfg.trunk_kernel == "auto"
                                       and torch.device(device).type != "cuda"):
        return False
    _require_kernels_fit(cfg, device, dtype, "trunk_kernel")
    return True


def use_cuda_tail(cfg: RRDBNetConfig, device, dtype) -> bool:
    """The tail takes the CUDA kernels: "cuda", or "auto" on a CUDA device
    for a ×2ⁿ tail (×3 has no kernel and stays plain). Raises where the
    kernels cannot take the config."""
    if cfg.tail_kernel == "plain" or (cfg.tail_kernel == "auto"
                                      and (torch.device(device).type != "cuda"
                                           or cfg.upscale == 3)):
        return False
    _require_kernels_fit(cfg, device, dtype, "tail_kernel")
    return True


def needs_kernel_weights(cfg: RRDBNetConfig, device, dtype) -> bool:
    """Whether a forward on ``device`` at ``dtype`` runs a kernel, and so
    needs :func:`prep_trunk_ct`'s weights."""
    return use_cuda_trunk(cfg, device, dtype) or use_cuda_tail(cfg, device, dtype)


def prep_trunk_ct(params: dict, cfg: RRDBNetConfig, dtype: torch.dtype) -> dict:
    """Add the kernels' weights, converted once (cast, contiguous, upconvs
    folded): ``trunk_ct`` (per block the three RDBs' weights, and the trunk
    conv) and ``tail_ct`` (folded upconvs and the hr convs). The canonical
    entries stay, so the plain path and activation dumps still run."""
    from esrganplus_tpu_torch.kernels.rdb_ct import (prepare_conv_ct_weights,
                                                     prepare_rdb_ct_weights)
    from esrganplus_tpu_torch.kernels.tail_ct import (prepare_conv_hr_ct,
                                                      prepare_upfold_ct)

    blocks = []
    for i in range(cfg.nb):
        bp = block_params(params["trunk"], i)
        blocks.append([prepare_rdb_ct_weights(bp[k], dtype)
                       for k in ("rdb1", "rdb2", "rdb3")])
    tc = params["trunk_conv"]
    out = dict(params)
    out["trunk_ct"] = {"dtype": dtype, "blocks": blocks,
                       "lr_conv": prepare_conv_ct_weights(tc["w"], tc.get("b"), dtype)}
    out["tail_ct"] = {
        "upconvs": [prepare_upfold_ct(up["w"], up.get("b"), dtype)
                    for up in params["upconvs"]],
        "hr": prepare_conv_hr_ct(params["hr_conv0"], params["hr_conv1"], dtype),
    }
    return out


def _trunk_cuda(ct: dict, fea, cfg: RRDBNetConfig):
    """fea ``[B, H, W, nf]`` (kernel dtype) → fea + trunk_conv(trunk(fea))."""
    from esrganplus_tpu_torch.kernels.rdb_ct import conv3x3_ct, rdb_ct

    kw = dict(slope=_slope(cfg), res_scale=cfg.res_scale)
    h = fea
    for w1, w2, w3 in ct["blocks"]:
        h0 = h
        h = rdb_ct(h, w1, **kw)
        h = rdb_ct(h, w2, **kw)
        h = rdb_ct(h, w3, h0, rrdb_scale=cfg.res_scale, **kw)
    return conv3x3_ct(h, *ct["lr_conv"], fea)


def _tail_cuda(tc: dict, fea, cfg: RRDBNetConfig):
    from esrganplus_tpu_torch.kernels.tail_ct import conv_hr_ct, upfold_ct

    for wf, b in tc["upconvs"]:
        fea = upfold_ct(fea, wf, b, slope=_slope(cfg))
    return conv_hr_ct(fea, *tc["hr"], slope=_slope(cfg)).float()


def rrdbnet_forward(params: dict, x: torch.Tensor, cfg: RRDBNetConfig, *,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """×``cfg.upscale`` super-resolution of NHWC RGB [0,1] input → fp32.

    ``dtype`` selects the compute precision (None: the input's, the fp32
    parity path; ``torch.bfloat16`` for throughput). A forward that runs a
    kernel needs ``params`` from :func:`prep_trunk_ct` at that precision."""
    kdt = dtype or x.dtype
    cuda_trunk = use_cuda_trunk(cfg, x.device, kdt)
    cuda_tail = use_cuda_tail(cfg, x.device, kdt)
    if (cuda_trunk or cuda_tail) and params.get("trunk_ct", {}).get("dtype") != kdt:
        raise ValueError(f"the kernel path at {kdt} needs the kernels' weights: pass "
                         f"prep_trunk_ct(params, cfg, {kdt}) (converted once, at load)")
    with fp32_exact():
        fea = conv2d(x, params["fea_conv"], dtype=dtype)
        if cuda_trunk:
            fea = _trunk_cuda(params["trunk_ct"], fea.to(kdt).contiguous(), cfg)
        else:
            trunk = fea
            for i in range(cfg.nb):
                trunk = _rrdb_forward(trunk, block_params(params["trunk"], i), cfg, dtype)
            fea = fea + conv2d(trunk, params["trunk_conv"], dtype=dtype)
        if cuda_tail:
            return _tail_cuda(params["tail_ct"], fea.to(kdt).contiguous(), cfg)
        return _tail_plain(params, fea, cfg, dtype)


def rrdbnet_activations(params: dict, x: torch.Tensor, cfg: RRDBNetConfig, *,
                        dtype: Optional[torch.dtype] = None) -> dict:
    """Eval-mode forward returning every named intermediate on the plain
    graph, for parity localisation against a torch reference run. Stage
    names as ``esrganplus_tpu``'s: ``fea_conv``, ``rrdb_XX``, ``trunk``,
    ``upconv_K`` (post-lrelu), ``hr_conv0`` (post-lrelu), ``hr_conv1``."""
    acts = {}
    with fp32_exact():
        fea = conv2d(x, params["fea_conv"], dtype=dtype)
        acts["fea_conv"] = fea
        trunk = fea
        for i in range(cfg.nb):
            trunk = _rrdb_forward(trunk, block_params(params["trunk"], i), cfg, dtype)
            acts[f"rrdb_{i:02d}"] = trunk
        fea = fea + conv2d(trunk, params["trunk_conv"], dtype=dtype)
        acts["trunk"] = fea
        factor = 3 if cfg.upscale == 3 else 2
        for i, up in enumerate(params["upconvs"]):
            fea = act(conv2d(upsample_nearest(fea, factor), up, dtype=dtype),
                      cfg.act_type, cfg.act_slope)
            acts[f"upconv_{i}"] = fea
        fea = act(conv2d(fea, params["hr_conv0"], dtype=dtype), cfg.act_type,
                  cfg.act_slope)
        acts["hr_conv0"] = fea
        acts["hr_conv1"] = conv2d(fea, params["hr_conv1"], dtype=dtype).float()
    return acts
