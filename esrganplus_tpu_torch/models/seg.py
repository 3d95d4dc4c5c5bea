"""Outdoor-scene segmentation network (SFT-GAN's conditioning front end).

Counterpart of ``esrganplus_tpu/models/seg.py`` (reference
``codes/models/modules/seg_arch.py``): a dilated ResNet-101-style backbone of
Res131 bottlenecks (1×1-BN-relu → 3×3-BN-relu, dilated → 1×1-BN, a
projection shortcut where the width changes, relu after the residual add), a
512-channel head, an 8-class 1×1 classifier, a grouped 16×16 stride-8
transposed conv for the ×8 upsampling, and a softmax (``seg_arch.py:8-70``).
It runs offline to produce the 8-class seg maps SFT-GAN consumes
(``cli/test_seg.py``). Eval mode only: frozen batch norm, no dropout.

The JAX package writes the transposed conv as an lhs-dilated depthwise conv
with the kernel flipped; here it is ``F.conv_transpose2d(groups=8)`` on the
reference's unflipped ``[8, 1, 16, 16]`` weight. Parameters keep the JAX
package's tree: ``deconv_w`` is ``[k, k, 1, 8]``. Library calls only (cuDNN
on the card).
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch
import torch.nn.functional as F

from esrganplus_tpu_torch.models.layers import (act, batchnorm, batchnorm_init, conv2d,
                                                fp32_exact, kaiming_conv_init)

# Backbone plan: ('conv', cin, cout, k, stride) | ('pool',) | ('res', in, mid, out, dilation, stride)
PLAN: List[tuple] = (
    [("conv", 3, 64, 3, 2), ("conv", 64, 64, 3, 1), ("conv", 64, 128, 3, 1), ("pool",)]
    + [("res", 128, 64, 256, 1, 1)] + [("res", 256, 64, 256, 1, 1)] * 2
    + [("res", 256, 128, 512, 1, 2)] + [("res", 512, 128, 512, 1, 1)] * 3
    + [("res", 512, 256, 1024, 2, 1)] + [("res", 1024, 256, 1024, 2, 1)] * 22
    + [("res", 1024, 512, 2048, 4, 1)] + [("res", 2048, 512, 2048, 4, 1)] * 2
    + [("conv", 2048, 512, 3, 1)]
)


@dataclasses.dataclass(frozen=True)
class SegConfig:
    n_classes: int = 8
    deconv_kernel: int = 16
    deconv_stride: int = 8
    deconv_pad: int = 4


def _init_bn_conv(gen, cin, cout, k, dtype):
    return {"conv": kaiming_conv_init(gen, k, k, cin, cout, bias=False, dtype=dtype),
            "bn": batchnorm_init(cout, dtype)}


def init_seg(cfg: SegConfig = SegConfig(), seed: int = 0,
             dtype: torch.dtype = torch.float32) -> dict:
    """Seeded parameters (CPU) in the JAX package's layout: He-normal
    convs, identity batch norms, a zero transposed conv as there (a
    checkpoint supplies the trained one)."""
    gen = torch.Generator().manual_seed(seed)
    layers = []
    for entry in PLAN:
        if entry[0] == "conv":
            _, cin, cout, k, _s = entry
            layers.append(_init_bn_conv(gen, cin, cout, k, dtype))
        elif entry[0] == "pool":
            layers.append(None)
        else:
            _, cin, mid, cout, _dil, _s = entry
            blk = {"c0": _init_bn_conv(gen, cin, mid, 1, dtype),
                   "c1": _init_bn_conv(gen, mid, mid, 3, dtype),
                   "c2": _init_bn_conv(gen, mid, cout, 1, dtype)}
            if cin != cout:
                blk["proj"] = _init_bn_conv(gen, cin, cout, 1, dtype)
            layers.append(blk)
    k = cfg.deconv_kernel
    return {"layers": layers,
            "classifier": kaiming_conv_init(gen, 1, 1, 512, cfg.n_classes, dtype=dtype),
            "deconv_w": torch.zeros((k, k, 1, cfg.n_classes), dtype=dtype)}


def maxpool_ceil(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """MaxPool(k, s, pad 0, ceil_mode=True) on NHWC: the last partial
    window counts."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), k, s, ceil_mode=True)
    return y.permute(0, 2, 3, 1).contiguous()


def bn_conv(x, p, stride=1, dilation=1, relu=True, dtype=None):
    """conv (no bias) → frozen batch norm → relu (optional)."""
    x = conv2d(x, p["conv"], stride=stride, dilation=dilation, dtype=dtype)
    x, _ = batchnorm(x, p["bn"], train=False)
    return act(x, "relu") if relu else x


def res131(h, p, entry, dtype=None):
    """One Res131 bottleneck of ``PLAN`` ``entry``."""
    _, _cin, _mid, _cout, dil, s = entry
    res = bn_conv(h, p["c0"], dtype=dtype)
    res = bn_conv(res, p["c1"], stride=s, dilation=dil, dtype=dtype)
    res = bn_conv(res, p["c2"], relu=False, dtype=dtype)
    shortcut = bn_conv(h, p["proj"], stride=s, relu=False, dtype=dtype) if "proj" in p else h
    return act(shortcut + res, "relu")


def deconv_upsample(h: torch.Tensor, deconv_w: torch.Tensor, cfg: SegConfig = SegConfig()
                    ) -> torch.Tensor:
    """The grouped ``ConvTranspose2d(8, 8, k, stride, pad, groups=8)``, no
    bias, on NHWC in fp32; ``deconv_w`` in the tree's ``[k, k, 1, 8]``."""
    w = deconv_w.float().permute(3, 2, 0, 1)  # the reference's [8, 1, k, k]
    with fp32_exact():
        y = F.conv_transpose2d(h.float().permute(0, 3, 1, 2), w, stride=cfg.deconv_stride,
                               padding=cfg.deconv_pad, groups=cfg.n_classes)
    return y.permute(0, 2, 3, 1).contiguous()


def seg_forward(params: dict, x: torch.Tensor, cfg: SegConfig = SegConfig(),
                dtype=None) -> torch.Tensor:
    """``[B, H, W, 3]`` image (the reference feeds BGR [0, 255] less the
    Caffe means) → ``[B, H, W, 8]`` fp32 softmax class probabilities."""
    h = x
    for entry, p in zip(PLAN, params["layers"]):
        if entry[0] == "conv":
            h = bn_conv(h, p, stride=entry[4], dtype=dtype)
        elif entry[0] == "pool":
            h = maxpool_ceil(h)
        else:
            h = res131(h, p, entry, dtype)
    h = conv2d(h, params["classifier"], dtype=dtype)
    return torch.softmax(deconv_upsample(h, params["deconv_w"], cfg), dim=-1)


# ---------------------------------------------------------------------------
# torch .pth conversion: the reference's flattened ``feature.{i}`` indices.
# conv blocks emit [conv, bn, act]; a Res131 is one module whose res.{0,1,3,
# 4,6,7} are its conv / bn pairs, with an optional proj.{0,1}; the pool one
# index; the head conv's block three; then a dropout slot and the classifier.
# ---------------------------------------------------------------------------


def _plan_indices():
    """(plan entry, its ``feature`` index), then the classifier's index."""
    out, idx = [], 0
    for entry in PLAN:
        out.append((entry, idx))
        idx += 3 if entry[0] == "conv" else 1
    return out, idx + 1  # the dropout slot, then the 1×1 classifier


_RES_SLOTS = (("c0", 0, 1), ("c1", 3, 4), ("c2", 6, 7), ("proj", "proj.0", "proj.1"))


def seg_from_state_dict(sd, cfg: SegConfig = SegConfig(),
                        dtype: torch.dtype = torch.float32) -> dict:
    """Reference OutdoorSceneSeg state dict → params on the CPU, by replaying
    the reference's ``feature.{i}`` flattening."""
    from esrganplus_tpu_torch.convert.pth import _oihw_to_hwio

    t = lambda v: torch.as_tensor(v).detach().to(dtype)

    def bn_conv_p(conv_key, bn_key):
        return {"conv": {"w": _oihw_to_hwio(t(sd[conv_key + ".weight"]))},
                "bn": {"scale": t(sd[bn_key + ".weight"]), "bias": t(sd[bn_key + ".bias"]),
                       "mean": t(sd[bn_key + ".running_mean"]),
                       "var": t(sd[bn_key + ".running_var"])}}

    layers = []
    plan, cls_idx = _plan_indices()
    for entry, idx in plan:
        if entry[0] == "conv":
            layers.append(bn_conv_p(f"feature.{idx}", f"feature.{idx + 1}"))
        elif entry[0] == "pool":
            layers.append(None)
        else:
            base = f"feature.{idx}"
            blk = {}
            for name, ci, bi in _RES_SLOTS:
                cpre = f"{base}.proj.0" if name == "proj" else f"{base}.res.{ci}"
                if cpre + ".weight" in sd:
                    bpre = f"{base}.proj.1" if name == "proj" else f"{base}.res.{bi}"
                    blk[name] = bn_conv_p(cpre, bpre)
            layers.append(blk)
    return {"layers": layers,
            "classifier": {"w": _oihw_to_hwio(t(sd[f"feature.{cls_idx}.weight"])),
                           "b": t(sd[f"feature.{cls_idx}.bias"])},
            # torch ConvTranspose2d weight [in=8, out/groups=1, k, k] → [k, k, 1, 8]
            "deconv_w": t(sd["deconv.weight"]).permute(2, 3, 1, 0).contiguous()}


def seg_to_state_dict(params: dict) -> dict:
    """Export params → the reference key layout (fp32 CPU tensors), the
    inverse of :func:`seg_from_state_dict`."""
    from esrganplus_tpu_torch.convert.pth import _hwio_to_oihw

    cpu = lambda v: torch.as_tensor(v).detach().to("cpu", torch.float32).contiguous()
    sd = {}

    def put(p, conv_key, bn_key):
        sd[conv_key + ".weight"] = _hwio_to_oihw(cpu(p["conv"]["w"]))
        for ours, theirs in (("scale", "weight"), ("bias", "bias"),
                             ("mean", "running_mean"), ("var", "running_var")):
            sd[f"{bn_key}.{theirs}"] = cpu(p["bn"][ours])
        sd[bn_key + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)

    plan, cls_idx = _plan_indices()
    for (entry, idx), p in zip(plan, params["layers"]):
        if entry[0] == "conv":
            put(p, f"feature.{idx}", f"feature.{idx + 1}")
        elif entry[0] == "res":
            base = f"feature.{idx}"
            for name, ci, bi in _RES_SLOTS:
                if name in p:
                    if name == "proj":
                        put(p[name], f"{base}.proj.0", f"{base}.proj.1")
                    else:
                        put(p[name], f"{base}.res.{ci}", f"{base}.res.{bi}")
    sd[f"feature.{cls_idx}.weight"] = _hwio_to_oihw(cpu(params["classifier"]["w"]))
    sd[f"feature.{cls_idx}.bias"] = cpu(params["classifier"]["b"])
    sd["deconv.weight"] = cpu(params["deconv_w"]).permute(3, 2, 0, 1).contiguous()
    return sd
