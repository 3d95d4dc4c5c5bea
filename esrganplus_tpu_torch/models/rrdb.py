"""RRDB generator (ESRGAN / ESRGAN+ / nESRGAN+), inference and training.

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
    Its inference weights are converted once, by :func:`prep_trunk_ct`.

With ``train=True`` the nESRGAN+ noise sites act (after each RDB, and with
``rrdb_noise`` after each RRDB), and the kernel path runs the differentiable
twins: three ``rdb_ct_diff`` per RRDB, the RRDB epilogue ``h·β + h0`` as a
plain tensor op between them (the fold is inference-only, as in the JAX
package), ``conv3x3_ct_diff`` with the global residual, then
``upfold_ct_diff`` and ``conv_hr_ct_diff``. The canonical fp32 masters cross
every kernel boundary and are cast inside. Noise is drawn under the step's
site keys (``rng``: the trainers'; ``train.rng.noise_site_words``) or from a
``torch.Generator``, or is handed in pre-drawn (``noise``, see
:func:`draw_noise`), and ``noise_kernel`` says where the kernel path applies
the per-RDB sites, as in the JAX package:

  * ``"input"``: the pre-drawn noise rides in the kernel's epilogue;
  * ``"xla"``: it is applied between kernel calls (:func:`gaussian_noise`);
  * ``"fused"``: the kernel draws it from each site's two Philox seed words
    (``noise_seeds``, :func:`esrganplus_tpu_torch.train.rng.site_seeds`) and
    the backward regenerates it; the plain graph draws the same numbers
    (``kernels/philox.py``) and applies them in the same rounding order.
    That is under ``noise_prng="rbg"``, the default, where the seeds are
    required; under ``"threefry"`` (the JAX package's threefry keys) it is
    the ``"xla"`` path and no seeds are read.

The per-RRDB site (``rrdb_noise``) is always applied between kernel calls.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from esrganplus_tpu_torch.kernels.build import KERNEL_WIDTHS
from esrganplus_tpu_torch.kernels.philox import philox_normal, standard_normal
from esrganplus_tpu_torch.parallel import mesh
from esrganplus_tpu_torch.models.layers import (
    act,
    conv2d,
    fp32_exact,
    fused_relative_noise,
    gaussian_noise,
    kaiming_conv_init,
    pixel_shuffle,
    upsample_nearest,
)

_KERNEL_ALIASES = {"xla": "plain", "pallas": "cuda"}
NOISE_KERNELS = ("input", "xla", "fused")


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
    # Noise sites (nESRGAN+): active only when train=True.
    rdb_noise: bool = True
    rrdb_noise: bool = False
    noise_sigma: float = 0.1
    noise_relative_detach: bool = False
    res_scale: float = 0.2
    # The JAX package's trunk unroll (0 = auto, n = scan unroll, >= nb = a
    # Python loop): it shapes JAX's compile, not the values. Here the trunk is
    # always a Python loop, so any value >= 0 is accepted and changes nothing.
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
    # Where the kernel path applies the per-RDB noise: "input" | "xla" |
    # "fused" (see the module docstring).
    noise_kernel: str = "input"

    def __post_init__(self):
        for f in ("trunk_kernel", "tail_kernel"):
            v = _KERNEL_ALIASES.get(getattr(self, f), getattr(self, f))
            if v not in ("auto", "plain", "cuda"):
                raise ValueError(f"{f} must be auto|plain|cuda, got {v!r}")
            object.__setattr__(self, f, v)
        if self.noise_kernel not in NOISE_KERNELS:
            raise ValueError(f"noise_kernel must be one of {NOISE_KERNELS}, "
                             f"got {self.noise_kernel!r}")
        if not isinstance(self.unroll, int) or self.unroll < 0:
            raise ValueError(f"unroll must be an int >= 0, got {self.unroll!r}")

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


def _rdb_forward(x, p: dict, cfg: RRDBNetConfig, dtype, noise=None, seed=None):
    """Residual dense block with ESRGAN+'s two extra residual paths;
    ``noise`` (train mode) perturbs the output, or the fused mode's draws
    for the site ``seed``."""
    a = lambda t: act(t, cfg.act_type, cfg.act_slope)
    x1 = a(conv2d(x, p["conv1"], dtype=dtype))
    x2 = a(conv2d(torch.cat([x, x1], -1), p["conv2"], dtype=dtype))
    if cfg.conv1x1:
        x2 = x2 + conv2d(x, p["conv1x1"], dtype=dtype)
    x3 = a(conv2d(torch.cat([x, x1, x2], -1), p["conv3"], dtype=dtype))
    x4 = a(conv2d(torch.cat([x, x1, x2, x3], -1), p["conv4"], dtype=dtype)) + x2
    x5 = conv2d(torch.cat([x, x1, x2, x3, x4], -1), p["conv5"], dtype=dtype)
    out = x5 * cfg.res_scale + x
    if seed is not None:
        b0 = mesh.row_offset(out.shape[0])  # this rank's rows of the global draw
        out = fused_relative_noise(out, philox_normal(seed, out.shape, out.device, b0),
                                   cfg.noise_sigma, cfg.noise_relative_detach)
    elif noise is not None:
        out = gaussian_noise(out, noise, cfg.noise_sigma, cfg.noise_relative_detach)
    return out


def _rrdb_forward(x, p: dict, cfg: RRDBNetConfig, dtype, noise=(None,) * 4,
                  seeds=(None,) * 3):
    h = _rdb_forward(x, p["rdb1"], cfg, dtype, noise[0], seeds[0])
    h = _rdb_forward(h, p["rdb2"], cfg, dtype, noise[1], seeds[1])
    h = _rdb_forward(h, p["rdb3"], cfg, dtype, noise[2], seeds[2])
    out = h * cfg.res_scale + x
    if noise[3] is not None:
        out = gaussian_noise(out, noise[3], cfg.noise_sigma, cfg.noise_relative_detach)
    return out


def noise_active(cfg: RRDBNetConfig, train: bool) -> bool:
    return train and cfg.noise_sigma > 0 and (cfg.rdb_noise or cfg.rrdb_noise)


def draw_noise(cfg: RRDBNetConfig, shape, rng, dtype: torch.dtype, device, *,
               rdb_sites: bool = True) -> list:
    """Standard normals for every active noise site of one train-mode
    forward: ``[nb][4]`` tensors of ``shape`` = (B, H, W, nf) (sites rdb1,
    rdb2, rdb3, rrdb; None where a site is off) on ``device``. ``rng`` is a
    ``torch.Generator`` (drawn in forward order) or the step's site keys,
    an int32 tensor ``[nb, 4, 2]`` (``train.rng.noise_site_words``): each
    site then is Philox of its key (``kernels/philox.py``, the kernel on a
    CUDA tensor), what the trainers draw; under a process group each rank
    draws its rows of the global batch's sites (``parallel/mesh.py``
    ``row_offset``). ``rdb_sites=False`` leaves the
    per-RDB sites to the fused mode's in-kernel draws."""
    if isinstance(rng, torch.Generator):
        draw = lambda on, b, i: (torch.randn(shape, generator=rng, device=device,
                                             dtype=torch.float32).to(dtype) if on else None)
    else:
        b0 = mesh.row_offset(shape[0])  # this rank's rows of the global draw
        draw = lambda on, b, i: standard_normal(rng[b, i], shape, b0).to(dtype) if on else None
    rdb = cfg.rdb_noise and rdb_sites
    return [[draw(rdb, b, 0), draw(rdb, b, 1), draw(rdb, b, 2), draw(cfg.rrdb_noise, b, 3)]
            for b in range(cfg.nb)]


def fused_noise_active(cfg: RRDBNetConfig, train: bool, noise_prng: str) -> bool:
    """The per-RDB sites draw in-kernel: ``noise_kernel="fused"`` under
    "rbg" keys, as the JAX gate ``models/rrdb.py:525-527``."""
    if noise_prng not in ("rbg", "threefry"):
        raise ValueError(f"noise_prng must be 'rbg' or 'threefry', got {noise_prng!r}")
    return (noise_active(cfg, train) and cfg.rdb_noise and cfg.noise_kernel == "fused"
            and noise_prng == "rbg")


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


def needs_kernel_weights(cfg, device, dtype) -> bool:
    """Whether a forward on ``device`` at ``dtype`` runs a kernel, and so
    needs :func:`prep_trunk_ct`'s weights. Only an RRDBNet does: another
    generator (SRResNet) runs no kernel."""
    if not isinstance(cfg, RRDBNetConfig):
        return False
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


def _unbind_blocks(trunk) -> list:
    """The nb-stacked trunk as a list of per-block trees. ``unbind`` gives
    every leaf one backward node (a stack of the blocks' gradients) where
    nb separate selects would each scatter into a zero tensor of full size."""
    if isinstance(trunk, dict):
        cols = {k: _unbind_blocks(v) for k, v in trunk.items()}
        n = len(next(iter(cols.values())))
        return [{k: v[i] for k, v in cols.items()} for i in range(n)]
    return list(torch.unbind(trunk, 0))


def _trunk_cuda_train(params: dict, fea, cfg: RRDBNetConfig, noise, seeds):
    """Training twin of :func:`_trunk_cuda` on the canonical fp32 masters:
    no RRDB-epilogue fold; the per-RDB noise drawn in the kernel from the
    site's seeds, pre-drawn in the kernels' epilogue ("input"), or applied
    between kernel calls ("xla", and "fused" under threefry)."""
    from esrganplus_tpu_torch.kernels.rdb_ct import conv3x3_ct_diff, rdb_ct_diff

    kw = dict(noise_sigma=cfg.noise_sigma, noise_detach=cfg.noise_relative_detach,
              slope=_slope(cfg), res_scale=cfg.res_scale)
    in_kernel = cfg.noise_kernel == "input"
    beta = torch.tensor(cfg.res_scale, dtype=fea.dtype)
    h = fea
    for bp, sites, keys in zip(_unbind_blocks(params["trunk"]), noise, seeds):
        h0 = h
        for name, n, key in zip(("rdb1", "rdb2", "rdb3"), sites, keys):
            if key is not None:
                h = rdb_ct_diff(h, bp[name], noise_seed=key,
                                noise_b0=mesh.row_offset(h.shape[0]), **kw)
            elif in_kernel:
                h = rdb_ct_diff(h, bp[name], n, **kw)
            else:
                h = rdb_ct_diff(h, bp[name], **kw)
                if n is not None:
                    h = gaussian_noise(h, n, cfg.noise_sigma, cfg.noise_relative_detach)
        h = h * beta + h0
        if sites[3] is not None:
            h = gaussian_noise(h, sites[3], cfg.noise_sigma, cfg.noise_relative_detach)
    tc = params["trunk_conv"]
    return conv3x3_ct_diff(h, tc["w"], tc["b"], fea)


def _tail_cuda_train(params: dict, fea, cfg: RRDBNetConfig):
    from esrganplus_tpu_torch.kernels.tail_ct import (conv_hr_ct_diff, prepare_upfold_ct,
                                                      upfold_ct_diff)

    for up in params["upconvs"]:
        # folded in fp32 by differentiable tensor ops: autograd carries dWf
        # back through the fold to the canonical weight
        wf, b = prepare_upfold_ct(up["w"], up.get("b"), torch.float32)
        fea = upfold_ct_diff(fea, wf, b, slope=_slope(cfg))
    hr0, hr1 = params["hr_conv0"], params["hr_conv1"]
    return conv_hr_ct_diff(fea, hr0["w"], hr0["b"], hr1["w"], hr1["b"],
                           slope=_slope(cfg)).float()


def rrdbnet_forward(params: dict, x: torch.Tensor, cfg: RRDBNetConfig, *,
                    train: bool = False, rng=None,
                    noise: Optional[list] = None, noise_seeds=None,
                    noise_prng: str = "rbg",
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """×``cfg.upscale`` super-resolution of NHWC RGB [0,1] input → fp32.

    ``dtype`` selects the compute precision (None: the input's, the fp32
    parity path; ``torch.bfloat16`` for throughput). An inference forward
    that runs a kernel needs ``params`` from :func:`prep_trunk_ct` at that
    precision; a training forward (``train=True``, differentiable on both
    paths) takes the canonical fp32 masters. Train-mode noise needs ``rng``
    (a generator on x's device, or the step's site keys: see
    :func:`draw_noise`) or pre-drawn ``noise``;
    with ``noise_kernel="fused"`` under ``noise_prng="rbg"``, ``noise_seeds``
    (``[nb][3]`` pairs of uint32 words, ``train.rng.site_seeds``, or the
    keys' int32 tensor ``[nb, 3, 2]`` on x's device) key the
    per-RDB sites and must be given; under ``"threefry"`` the fused mode
    applies them between kernel calls, as ``"xla"``, and reads no seeds."""
    kdt = dtype or x.dtype
    cuda_trunk = use_cuda_trunk(cfg, x.device, kdt)
    cuda_tail = use_cuda_tail(cfg, x.device, kdt)
    if not train and (cuda_trunk or cuda_tail) \
            and params.get("trunk_ct", {}).get("dtype") != kdt:
        raise ValueError(f"the kernel path at {kdt} needs the kernels' weights: pass "
                         f"prep_trunk_ct(params, cfg, {kdt}) (converted once, at load)")
    fused = fused_noise_active(cfg, train, noise_prng)
    seeds = [(None,) * 3] * cfg.nb
    if fused:
        if noise_seeds is None:
            raise ValueError('rrdbnet_forward: noise_kernel="fused" under noise_prng "rbg" '
                             "draws in the kernel and needs noise_seeds (train.rng.site_seeds)")
        if len(noise_seeds) != cfg.nb or any(len(s) != 3 for s in noise_seeds):
            raise ValueError(f"noise_seeds: expected [{cfg.nb}][3] seed pairs")
        seeds = noise_seeds
    if noise_active(cfg, train):
        if noise is None:
            if rng is None and not (fused and not cfg.rrdb_noise):
                raise ValueError("rrdbnet_forward: train-mode noise needs an rng "
                                 "(torch.Generator or site keys) or pre-drawn noise")
            noise = draw_noise(cfg, (*x.shape[:3], cfg.nf), rng, kdt, x.device,
                               rdb_sites=not fused)
        elif fused and any(n is not None for sites in noise for n in sites[:3]):
            raise ValueError("rrdbnet_forward: the fused mode draws the per-RDB sites "
                             "itself; pass None there in `noise`")
    else:
        noise = [(None,) * 4] * cfg.nb
    with fp32_exact():
        fea = conv2d(x, params["fea_conv"], dtype=dtype)
        if cuda_trunk and train:
            fea = _trunk_cuda_train(params, fea.to(kdt).contiguous(), cfg, noise, seeds)
        elif cuda_trunk:
            fea = _trunk_cuda(params["trunk_ct"], fea.to(kdt).contiguous(), cfg)
        else:
            trunk = fea
            for i in range(cfg.nb):
                trunk = _rrdb_forward(trunk, block_params(params["trunk"], i), cfg, dtype,
                                      noise[i], seeds[i])
            fea = fea + conv2d(trunk, params["trunk_conv"], dtype=dtype)
        if cuda_tail and train:
            return _tail_cuda_train(params, fea.to(kdt).contiguous(), cfg)
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


# ---------------------------------------------------------------------------
# the JAX package's trainer-master layout ("trunk_ct" of its prep_trunk_ct)
# ---------------------------------------------------------------------------
#
# The JAX trainers may keep their fp32 masters, and Adam's moments with them,
# in the TPU kernel's column-merged layout (``esrganplus_tpu/models/rrdb.py``
# ``prep_trunk_ct`` / ``unprep_trunk_ct``, ``kernels/rdb_ct.py``
# ``prepare_rdb_ct_weights``): per RDB the matrices w1..w5 ``[3·S_k (+gc at
# k=2), 3·C_prefix_k]`` and a packed bias, stacked over nb, and the trunk conv
# as ``lr_conv``. That layout is NOT this package's kernel weights
# (:func:`prep_trunk_ct` above); these two functions exist only to read states
# the JAX package wrote (``train/checkpoint.py::load_state_auto``). The layout
# is a permutation of the canonical entries plus structural zeros (stage 2's
# 1×1-shortcut rows outside x's centre-tap columns), which the inverse drops.


def _jax_master_prep_rdb(p: dict, nf: int, gc: int, conv1x1: bool) -> tuple:
    """One (unstacked) RDB → (w1, .., w5, bias) of ``prepare_rdb_ct_weights``
    in fp32."""
    def wk(k):
        w = p[f"conv{k}"]["w"].float()  # [3, 3, C_prefix, S]
        cp, s = w.shape[2], w.shape[3]
        blocks, off = [], 0
        for c in [nf] + [gc] * ((cp - nf) // gc):
            blocks.append(w[:, :, off:off + c, :].permute(1, 3, 0, 2).reshape(3 * s, 3 * c))
            off += c
        out = torch.cat(blocks, 1)
        if k == 2:
            extra = torch.zeros((gc, out.shape[1]), dtype=out.dtype, device=out.device)
            if conv1x1:
                extra[:, nf:2 * nf] = p["conv1x1"]["w"][0, 0].float().T
            out = torch.cat([out, extra], 0)
        return out

    bias = torch.cat([p["conv5"]["b"]] + [p[f"conv{t}"]["b"] for t in (4, 3, 2, 1)])
    return (*(wk(k) for k in range(1, 6)), bias.float().reshape(-1, 1))


def _jax_master_unprep_rdb(mats, cfg: RRDBNetConfig) -> dict:
    """Exact inverse of :func:`_jax_master_prep_rdb` for one RDB (the JAX
    package's ``_unprep_rdb_ct``)."""
    nf, gc = cfg.nf, cfg.gc
    w1, w2, w3, w4, w5, bias = mats
    bias = bias.reshape(-1).float()
    biases, off = {}, 0
    for k in (5, 4, 3, 2, 1):  # packed (b5|b4|b3|b2|b1)
        n = nf if k == 5 else gc
        biases[k] = bias[off:off + n]
        off += n
    rdb = {}
    for k, m in ((1, w1), (2, w2), (3, w3), (4, w4), (5, w5)):
        s = nf if k == 5 else gc
        if k == 2:
            extra, m = m[3 * s:], m[:3 * s]
            if cfg.conv1x1:
                rdb["conv1x1"] = {"w": extra[:, nf:2 * nf].T.reshape(1, 1, nf, gc).float()}
        blocks, coff = [], 0
        for c in [nf] + [gc] * (k - 1):
            blocks.append(m[:, coff:coff + 3 * c].reshape(3, s, 3, c).permute(2, 0, 3, 1))
            coff += 3 * c
        rdb[f"conv{k}"] = {"w": torch.cat(blocks, 2).float(), "b": biases[k]}
    return rdb


def jax_master_prep_trunk(params: dict, cfg: RRDBNetConfig) -> dict:
    """Canonical params → the JAX trainers' prepared-master tree (``trunk``
    and ``trunk_conv`` replaced by ``trunk_ct``), as its ``prep_trunk_ct``
    builds it. Works on a parameter tree and on an Adam moment tree alike."""
    if "trunk_ct" in params:
        return params
    trunk_ct = {}
    for name in ("rdb1", "rdb2", "rdb3"):
        per_block = [_jax_master_prep_rdb(block_params(params["trunk"][name], i), cfg.nf,
                                          cfg.gc, cfg.conv1x1) for i in range(cfg.nb)]
        trunk_ct[name] = [torch.stack([blk[j] for blk in per_block]) for j in range(6)]
    tc = params["trunk_conv"]
    cin, cout = tc["w"].shape[2], tc["w"].shape[3]
    trunk_ct["lr_conv"] = {"w": tc["w"].float().permute(1, 3, 0, 2).reshape(3 * cout, 3 * cin)}
    if "b" in tc:
        trunk_ct["lr_conv"]["b"] = tc["b"].float().reshape(-1, 1)
    out = {k: v for k, v in params.items() if k not in ("trunk", "trunk_conv")}
    out["trunk_ct"] = trunk_ct
    return out


def jax_master_unprep_trunk(params: dict, cfg: RRDBNetConfig) -> dict:
    """The JAX trainers' prepared-master tree → canonical params (the JAX
    package's ``unprep_trunk_ct``); exact, the structural zeros dropped."""
    if "trunk_ct" not in params:
        return params
    ct = params["trunk_ct"]
    trunk = {}
    for name in ("rdb1", "rdb2", "rdb3"):
        per_block = [_jax_master_unprep_rdb([m[i] for m in ct[name]], cfg)
                     for i in range(cfg.nb)]
        trunk[name] = _stack(per_block)
    wm = ct["lr_conv"]["w"]
    trunk_conv = {"w": wm.reshape(3, cfg.nf, 3, cfg.nf).permute(2, 0, 3, 1).float()}
    if "b" in ct["lr_conv"]:
        trunk_conv["b"] = ct["lr_conv"]["b"].reshape(-1).float()
    out = {k: v for k, v in params.items() if k != "trunk_ct"}
    out["trunk"] = trunk
    out["trunk_conv"] = trunk_conv
    return out
