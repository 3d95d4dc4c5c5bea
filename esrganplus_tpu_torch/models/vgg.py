"""VGG-19 feature extractor for the perceptual loss (netF).

Counterpart of ``esrganplus_tpu/models/vgg.py`` (reference
``codes/models/modules/architecture.py:279-307``): torchvision VGG19
truncated after layer index ``feature_layer`` (34 = conv5_4 before its
activation; 49 for the BN variant), ImageNet mean/std normalisation of [0,1]
RGB inputs, frozen weights. NHWC activations, HWIO weights.

Weights load from a user-provided ``.pth`` of a torchvision-format state dict
(``features.N.weight``); without one the net is initialised from a seed, for
plumbing and smoke runs, and flagged ``pretrained: False``.

The ≤128-channel early blocks can run through the hand-written stage kernel
(``kernels/stage_ct.py::conv_s1_ct_diff`` with the relu fused; the 2×2 max
pools between them stay PyTorch). ``stage_kernel``: ``"cuda"`` wherever the
JAX package's forced gate would run its kernels, ``"plain"`` never,
``"auto"`` (the default) like ``"cuda"`` on a CUDA device and like
``"plain"`` on the CPU; the JAX package's ``"auto"`` resolves to XLA instead,
a finding about its TPU plane kernels that says nothing about this card. The
BN variant always runs the plain graph, as there.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from esrganplus_tpu_torch.models.discriminator import normalize_stage_kernel
from esrganplus_tpu_torch.models.layers import batchnorm, batchnorm_init, conv2d, kaiming_conv_init

# Channels per VGG-19 conv, 'M' = 2×2 maxpool. (Standard VGG-E configuration.)
VGG19_LAYOUT: Tuple = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
                       512, 512, 512, 512, "M", 512, 512, 512, 512, "M")

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class VGGFeatConfig:
    feature_layer: int = 34  # torchvision features index to truncate AFTER
    use_bn: bool = False
    use_input_norm: bool = True
    # Conv plan; override only for width-reduced test fixtures.
    layout: Tuple = VGG19_LAYOUT
    # the stage kernel for the ≤128-channel blocks: "auto" | "plain" | "cuda"
    # ("xla" and "pallas" are accepted aliases); see the module docstring
    stage_kernel: str = "auto"

    def __post_init__(self):
        object.__setattr__(self, "stage_kernel", normalize_stage_kernel(self.stage_kernel))


def _torchvision_plan(cfg: VGGFeatConfig) -> List[tuple]:
    """Expand the layout into torchvision ``features`` entries:
    ('conv', cin, cout) / ('bn', c) / ('relu',) / ('pool',), one per index."""
    plan = []
    cin = 3
    for item in cfg.layout:
        if item == "M":
            plan.append(("pool",))
        else:
            plan.append(("conv", cin, item))
            if cfg.use_bn:
                plan.append(("bn", item))
            plan.append(("relu",))
            cin = item
    return plan


def init_vgg_feat(seed: int = 0, cfg: VGGFeatConfig = VGGFeatConfig(),
                  dtype: torch.dtype = torch.float32) -> dict:
    """Random-init params on the CPU (plumbing/tests only: not a trained
    perceptual net)."""
    gen = torch.Generator().manual_seed(seed)
    params = {"layers": [], "pretrained": False}
    for entry in _torchvision_plan(cfg)[: cfg.feature_layer + 1]:
        if entry[0] == "conv":
            params["layers"].append(kaiming_conv_init(gen, 3, 3, entry[1], entry[2], dtype=dtype))
        elif entry[0] == "bn":
            params["layers"].append(batchnorm_init(entry[1], dtype))
        else:
            params["layers"].append(None)
    return params


def vgg_feat_from_state_dict(sd, cfg: VGGFeatConfig = VGGFeatConfig(),
                             dtype: torch.dtype = torch.float32) -> dict:
    """Convert a torchvision vgg19(_bn) state dict ({'features.N.weight': …})."""
    t = lambda v: torch.as_tensor(v).detach().to(dtype)
    params = {"layers": [], "pretrained": True}
    for i, entry in enumerate(_torchvision_plan(cfg)[: cfg.feature_layer + 1]):
        if entry[0] == "conv":
            params["layers"].append({
                "w": t(sd[f"features.{i}.weight"]).permute(2, 3, 1, 0).contiguous(),
                "b": t(sd[f"features.{i}.bias"])})
        elif entry[0] == "bn":
            params["layers"].append({
                "scale": t(sd[f"features.{i}.weight"]), "bias": t(sd[f"features.{i}.bias"]),
                "mean": t(sd[f"features.{i}.running_mean"]),
                "var": t(sd[f"features.{i}.running_var"])})
        else:
            params["layers"].append(None)
    return params


def load_vgg_feat(path: Optional[str], cfg: VGGFeatConfig = VGGFeatConfig(),
                  dtype: torch.dtype = torch.float32) -> dict:
    """Load from a .pth path if given, else random init (flagged in 'pretrained')."""
    if path:
        from esrganplus_tpu_torch.convert.pth import load_state_dict

        return vgg_feat_from_state_dict(load_state_dict(path), cfg, dtype)
    return init_vgg_feat(0, cfg, dtype)


def use_stage_kernels(cfg: VGGFeatConfig, device, h: int, w: int) -> bool:
    """Whether the ≤128-channel early blocks of an ``h``×``w`` input on
    ``device`` run the stage kernel."""
    if cfg.stage_kernel == "plain" or (cfg.stage_kernel == "auto"
                                       and torch.device(device).type != "cuda"):
        return False
    if cfg.use_bn:
        return False  # the JAX package's own routing: the BN variant is plain
    return not (h % 4 or w % 4)


def _pool2(h: torch.Tensor) -> torch.Tensor:
    """2×2 max pool, stride 2 (floor mode), NHWC."""
    return F.max_pool2d(h.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).contiguous()


def _early_stages_kernel(params: dict, x: torch.Tensor, plan, dtype):
    """Run the leading conv/relu/pool segment through the stage kernel.
    Returns (NHWC activations, number of plan entries consumed). Stops before
    the first conv with more than 128 channels, before a third pool (where
    the JAX package's plane layout ends), or at the plan's end (a trailing
    conv without its relu, the feature_layer=34 truncation, runs with
    ``act=None``)."""
    from esrganplus_tpu_torch.kernels.stage_ct import conv_s1_ct_diff

    h = None
    pools = 0
    i = 0
    while i < len(plan):
        entry = plan[i]
        if entry[0] == "conv":
            if entry[2] > 128:
                break
            fused = "relu" if i + 1 < len(plan) and plan[i + 1][0] == "relu" else None
            if h is None:
                h = x.to(dtype if dtype is not None else x.dtype)
            p = params["layers"][i]
            h = conv_s1_ct_diff(h, p["w"], p["b"], act=fused)
            i += 2 if fused else 1
        elif entry[0] == "pool":
            if pools == 2:
                break
            h = _pool2(h)
            pools += 1
            i += 1
        else:
            break
    if h is None:
        return x, 0
    return h, i


def vgg_feat_forward(params: dict, x: torch.Tensor, cfg: VGGFeatConfig = VGGFeatConfig(),
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """NHWC RGB [0,1] → feature map at the truncation point. The weights are
    frozen: callers hand in parameters that do not require gradients, and the
    stage kernel's backward then launches no weight gradient."""
    if cfg.use_input_norm:
        mean = torch.tensor(_IMAGENET_MEAN, dtype=x.dtype, device=x.device)
        std = torch.tensor(_IMAGENET_STD, dtype=x.dtype, device=x.device)
        x = (x - mean) / std
    plan = _torchvision_plan(cfg)[: cfg.feature_layer + 1]
    h = x
    start = 0
    if use_stage_kernels(cfg, x.device, x.shape[1], x.shape[2]):
        h, start = _early_stages_kernel(params, x, plan, dtype)
    for entry, p in zip(plan[start:], params["layers"][start:]):
        if entry[0] == "conv":
            h = conv2d(h, p, dtype=dtype)
        elif entry[0] == "bn":
            h, _ = batchnorm(h, p, train=False)
        elif entry[0] == "relu":
            h = torch.relu(h)
        else:
            h = _pool2(h)
    return h
