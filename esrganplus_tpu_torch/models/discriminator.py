"""VGG-style discriminators (inputs 128/96/192, plus the spectral-norm variant).

Counterpart of ``esrganplus_tpu/models/discriminator.py``: one parametric
implementation of the reference's three copies
(``codes/models/modules/architecture.py:87-270``): n stages of
[k3-s1 conv → norm → lrelu, k4-s2-pad1 conv → norm → lrelu] with channels
64,64,128,128,256,256,512,512,…; the very first conv is never normalised;
classifier = Linear(512·f·f → 100) → lrelu → Linear(100 → 1) on the
NCHW-ordered flatten (so torch classifier weights convert 1:1). Parameters
are the JAX package's tree (``convs``/``bn``/``fc0``/``fc1``, HWIO weights).

The ≤128-channel stages 0-1 can run through the hand-written stage kernels
(``kernels/stage_ct.py``: ``conv_s1_ct_diff`` / ``conv_s2_ct_diff``; batch
norm and lrelu between them stay PyTorch, with the statistics reduced in fp32
and one rounding). ``stage_kernel`` selects: ``"cuda"`` wherever the JAX
package's forced gate would run its kernels, ``"plain"`` never, ``"auto"``
(the default) like ``"cuda"`` on a CUDA device and like ``"plain"`` on the
CPU. This differs from the JAX package, whose ``"auto"`` resolves to XLA
because its TPU plane kernels lost to XLA there; that finding says nothing
about this card. Where the gate itself says no (spectral norm, another
activation, a size not divisible by 4) the plain graph runs.

The SN variant (``architecture.py:133-175``) has the same topology, no norm,
and spectral normalisation by one power-iteration step per forward on every
conv and linear weight.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from esrganplus_tpu_torch.models.layers import (
    act,
    batchnorm,
    batchnorm_init,
    conv2d,
    global_moments,
    kaiming_conv_init,
    kaiming_linear_init,
    linear,
)
from esrganplus_tpu_torch.models.rrdb import _KERNEL_ALIASES


def normalize_stage_kernel(value: str) -> str:
    v = _KERNEL_ALIASES.get(value, value)
    if v not in ("auto", "plain", "cuda"):
        raise ValueError(f"stage_kernel must be auto|plain|cuda, got {value!r}")
    return v


@dataclasses.dataclass(frozen=True)
class DiscriminatorVGGConfig:
    input_size: int = 128  # 96 | 128 | 192
    in_nc: int = 3
    base_nf: int = 64
    norm_type: Optional[str] = "batch"  # 'batch' | None
    act_type: str = "leakyrelu"
    act_slope: float = 0.2
    spectral_norm: bool = False
    sn_power_iters: int = 1
    # the stage kernels for the ≤128-channel stages: "auto" | "plain" | "cuda"
    # ("xla" and "pallas" are accepted aliases); see the module docstring
    stage_kernel: str = "auto"

    def __post_init__(self):
        object.__setattr__(self, "stage_kernel", normalize_stage_kernel(self.stage_kernel))

    @property
    def n_stages(self) -> int:
        return {96: 5, 128: 5, 192: 6}[self.input_size]

    @property
    def stage_channels(self):
        nf = self.base_nf
        chans = [nf, nf * 2, nf * 4, nf * 8, nf * 8, nf * 8]
        return chans[: self.n_stages]

    @property
    def final_spatial(self) -> int:
        return self.input_size // (2 ** self.n_stages)

    @property
    def use_bn(self) -> bool:
        return self.norm_type == "batch" and not self.spectral_norm


def init_discriminator(seed: int, cfg: DiscriminatorVGGConfig, init_scale: float = 1.0,
                       dtype: torch.dtype = torch.float32) -> dict:
    """Kaiming-initialised parameters on the CPU from an integer seed."""
    gen = torch.Generator().manual_seed(seed)
    u = lambda n: torch.randn((n,), generator=gen, dtype=torch.float32).to(dtype)
    convs, bns = [], []
    cin = cfg.in_nc
    for i, cout in enumerate(cfg.stage_channels):
        c_a = kaiming_conv_init(gen, 3, 3, cin, cout, init_scale, dtype=dtype)
        c_b = kaiming_conv_init(gen, 4, 4, cout, cout, init_scale, dtype=dtype)
        if cfg.spectral_norm:
            c_a["u"], c_b["u"] = u(cout), u(cout)
        convs.append({"a": c_a, "b": c_b})
        if cfg.use_bn:
            bns.append({"a": None if i == 0 else batchnorm_init(cout, dtype),
                        "b": batchnorm_init(cout, dtype)})
        cin = cout
    f = cfg.final_spatial
    fc0 = kaiming_linear_init(gen, cfg.stage_channels[-1] * f * f, 100, init_scale, dtype)
    fc1 = kaiming_linear_init(gen, 100, 1, init_scale, dtype)
    if cfg.spectral_norm:
        fc0["u"], fc1["u"] = u(100), u(1)
    params = {"convs": convs, "fc0": fc0, "fc1": fc1}
    if cfg.use_bn:
        params["bn"] = bns
    return params


def _sn_weight(p: dict, n_iters: int):
    """One (or more) power-iteration steps on w reshaped to [out, -1] →
    (w / sigma, new u). torch's spectral_norm semantics: the iteration runs
    without gradients, only the direct uᵀ W v term carries one."""
    w = p["w"]
    w2d = w.reshape(-1, w.shape[-1]).T  # [out, in*]
    with torch.no_grad():
        u = p["u"]
        for _ in range(n_iters):
            v = w2d.T @ u
            v = v / (torch.linalg.vector_norm(v) + 1e-12)
            u = w2d @ v
            u = u / (torch.linalg.vector_norm(u) + 1e-12)
    sigma = u @ (w2d @ v)
    return w / sigma, u


def n_kernel_stages(cfg: DiscriminatorVGGConfig, device, h: int, w: int) -> int:
    """Number of leading stages (conv-a + conv-b pairs) that run the stage
    kernels for an ``h``×``w`` input on ``device``."""
    if cfg.stage_kernel == "plain" or (cfg.stage_kernel == "auto"
                                       and torch.device(device).type != "cuda"):
        return 0
    if cfg.spectral_norm or cfg.act_type != "leakyrelu" or h % 4 or w % 4:
        return 0  # the JAX package's own routing: these run the plain graph
    return sum(1 for c in cfg.stage_channels[:2] if c <= 128)


def _batchnorm_stage(h: torch.Tensor, p: dict, train: bool, momentum: float = 0.9,
                     eps: float = 1e-5):
    """The batch norm between two stage kernel calls: statistics and the
    affine map in fp32 on the working-dtype activations, one rounding back
    (torch semantics and the global batch's statistics, as
    :func:`layers.batchnorm`)."""
    dt = h.dtype
    hf = h.float()
    if train:
        # within a rank the one-pass E[x²] − E[x]² the stage path has always
        # taken; across the ranks the centred combination of global_moments
        mean, var, n = global_moments(hf, lambda x, m: (x * x).mean((0, 1, 2)) - m * m)
        with torch.no_grad():
            new_stats = {
                "mean": (momentum * p["mean"] + (1 - momentum) * mean).to(p["mean"].dtype),
                "var": (momentum * p["var"]
                        + (1 - momentum) * (var * n / max(n - 1, 1))).to(p["var"].dtype)}
    else:
        mean, var = p["mean"].float(), p["var"].float()
        new_stats = {"mean": p["mean"], "var": p["var"]}
    inv = torch.rsqrt(var + eps) * p["scale"].float()
    shift = p["bias"].float() - mean * inv
    return (hf * inv + shift).to(dt), new_stats


def _early_stages_kernel(params: dict, x: torch.Tensor, cfg: DiscriminatorVGGConfig,
                         n_k: int, train: bool, dtype):
    """Stages 0..n_k-1 through the stage kernels: conv-a (3×3 s1) → BN →
    lrelu → conv-b (4×4 s2) → BN → lrelu. The convs take the fp32 master
    weights and cast inside; each rounds its output to the working dtype
    once. Returns (NHWC activations, BN update dicts)."""
    from esrganplus_tpu_torch.kernels.stage_ct import conv_s1_ct_diff, conv_s2_ct_diff

    slope = cfg.act_slope
    lrelu = lambda t: torch.where(t >= 0, t, t * slope)
    h = x.to(dtype if dtype is not None else x.dtype)
    bn_updates = []
    for i in range(n_k):
        stage = params["convs"][i]
        upd = {}
        h = conv_s1_ct_diff(h, stage["a"]["w"], stage["a"]["b"], act=None, slope=slope)
        if cfg.use_bn and params["bn"][i]["a"] is not None:
            h, upd["a"] = _batchnorm_stage(h, params["bn"][i]["a"], train)
        h = conv_s2_ct_diff(lrelu(h), stage["b"]["w"], stage["b"]["b"], act=None, slope=slope)
        if cfg.use_bn:
            h, upd["b"] = _batchnorm_stage(h, params["bn"][i]["b"], train)
        h = lrelu(h)
        bn_updates.append(upd)
    return h, bn_updates


def discriminator_forward(params: dict, x: torch.Tensor, cfg: DiscriminatorVGGConfig,
                          train: bool = False, dtype: Optional[torch.dtype] = None):
    """NHWC image → (fp32 logits ``[B, 1]``, new_state). ``new_state``
    carries updated BN running statistics (train mode) or SN power-iteration
    vectors; fold it in with :func:`apply_state_updates`."""
    a = lambda t: act(t, cfg.act_type, cfg.act_slope)
    new_state: dict = {}

    def apply_conv(h, p, stride, pad, name):
        if cfg.spectral_norm:
            w_bar, u = _sn_weight(p, cfg.sn_power_iters)
            new_state.setdefault("u", {})[name] = u
            p = {**p, "w": w_bar}
        return conv2d(h, p, stride=stride, pad=pad, dtype=dtype)

    n_k = n_kernel_stages(cfg, x.device, x.shape[1], x.shape[2])
    h = x
    bn_updates = []
    if n_k:
        h, bn_updates = _early_stages_kernel(params, x, cfg, n_k, train, dtype)
    for i, stage in enumerate(params["convs"][n_k:], start=n_k):
        h = apply_conv(h, stage["a"], 1, "same", f"conv{i}a")
        upd = {}
        if cfg.use_bn and params["bn"][i]["a"] is not None:
            h, upd["a"] = batchnorm(h, params["bn"][i]["a"], train)
        h = a(h)
        # k4-s2 pads 1 on both sides (torch's get_valid_padding)
        h = apply_conv(h, stage["b"], 2, 1, f"conv{i}b")
        if cfg.use_bn:
            h, upd["b"] = batchnorm(h, params["bn"][i]["b"], train)
        h = a(h)
        bn_updates.append(upd)
    if cfg.use_bn:
        new_state["bn"] = bn_updates

    # NCHW flatten order, so torch classifier weights convert 1:1
    h = h.permute(0, 3, 1, 2).reshape(h.shape[0], -1)
    fc0, fc1 = params["fc0"], params["fc1"]
    if cfg.spectral_norm:
        w0, u0 = _sn_weight(fc0, cfg.sn_power_iters)
        w1, u1 = _sn_weight(fc1, cfg.sn_power_iters)
        new_state.setdefault("u", {})["fc0"] = u0
        new_state["u"]["fc1"] = u1
        fc0, fc1 = {**fc0, "w": w0}, {**fc1, "w": w1}
    h = a(linear(h, fc0, dtype=dtype))
    return linear(h, fc1, dtype=dtype).float(), new_state


def apply_state_updates(params: dict, new_state: dict, cfg: DiscriminatorVGGConfig) -> dict:
    """Fold BN running-statistic / SN u-vector updates into a new param tree
    (leaves that do not change are shared with ``params``)."""
    out = dict(params)
    if cfg.use_bn and "bn" in new_state:
        bns = []
        for old, upd in zip(params["bn"], new_state["bn"]):
            entry = {}
            for side in ("a", "b"):
                if old[side] is None:
                    entry[side] = None
                elif side in upd:
                    entry[side] = {**old[side], **upd[side]}
                else:
                    entry[side] = old[side]
            bns.append(entry)
        out["bn"] = bns
    if cfg.spectral_norm and "u" in new_state:
        out["convs"] = [{"a": {**stage["a"], "u": new_state["u"][f"conv{i}a"]},
                         "b": {**stage["b"], "u": new_state["u"][f"conv{i}b"]}}
                        for i, stage in enumerate(params["convs"])]
        out["fc0"] = {**params["fc0"], "u": new_state["u"]["fc0"]}
        out["fc1"] = {**params["fc1"], "u": new_state["u"]["fc1"]}
    return out


@torch.no_grad()
def merge_sequential_bn(params: dict, st_first: dict, st_second: dict,
                        cfg: DiscriminatorVGGConfig, momentum: float = 0.9) -> dict:
    """Fold two train-forward BN updates as if applied one after the other.

    torch updates the running statistics on every forward: after D(real) then
    D(fake), new = m·(m·old + (1−m)·real) + (1−m)·fake. Both updates here were
    computed against the SAME old statistics (u_i = m·old + (1−m)·batch_i), so
    the sequential result is m·u1 + (u2 − m·old)."""
    if not (cfg.use_bn and "bn" in st_first and "bn" in st_second):
        return apply_state_updates(params, st_second, cfg)
    out = dict(params)
    bns = []
    for old, u1, u2 in zip(params["bn"], st_first["bn"], st_second["bn"]):
        entry = {}
        for side in ("a", "b"):
            if old[side] is None:
                entry[side] = None
            elif side in u1 and side in u2:
                merged = {k: momentum * u1[side][k] + (u2[side][k] - momentum * old[side][k])
                          for k in ("mean", "var")}
                entry[side] = {**old[side], **merged}
            else:
                entry[side] = old[side]
        bns.append(entry)
    out["bn"] = bns
    return out
