"""Alternative perceptual-loss feature extractors (netF variants).

Counterpart of ``esrganplus_tpu/models/feature_extractors.py``:

  * :func:`minc_forward`: the MINC material-classification VGG-16 variant
    (reference ``codes/models/modules/architecture.py:335-394``): 13 convs
    with relu, 2×2 ceil-mode max pools, the last conv without activation;
    weights in the reference's ``VGG16minc_53.pth`` layout
    (``conv11.weight`` … ``conv53.bias``);
  * :func:`resnet101_feat_forward`: torchvision's ResNet-101 truncated
    after layer4 (``children[:8]``, reference ``architecture.py:311-332``),
    ImageNet-normalised [0,1] input, frozen; the stride on the 3×3 conv of a
    bottleneck, as torchvision v1.5.

Both were alternative netF choices upstream that no shipped recipe selects;
they are here for parity with the JAX package. Library calls only (cuDNN on
the card).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from esrganplus_tpu_torch.models.layers import batchnorm, conv2d

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)

# ---------------------------------------------------------------------------
# MINC
# ---------------------------------------------------------------------------

MINC_PLAN = [  # (name, cin, cout) per conv; 'M' = 2×2 ceil max pool
    ("conv11", 3, 64), ("conv12", 64, 64), "M",
    ("conv21", 64, 128), ("conv22", 128, 128), "M",
    ("conv31", 128, 256), ("conv32", 256, 256), ("conv33", 256, 256), "M",
    ("conv41", 256, 512), ("conv42", 512, 512), ("conv43", 512, 512), "M",
    ("conv51", 512, 512), ("conv52", 512, 512), ("conv53", 512, 512),
]


def maxpool2_ceil(x: torch.Tensor) -> torch.Tensor:
    """2×2 stride-2 max pool with ``ceil_mode=True`` on NHWC."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2, ceil_mode=True)
    return y.permute(0, 2, 3, 1).contiguous()


def _t(v, dtype):
    return torch.as_tensor(v).detach().to(dtype)


def minc_from_state_dict(sd: Dict[str, torch.Tensor], dtype: torch.dtype = torch.float32
                         ) -> dict:
    from esrganplus_tpu_torch.convert.pth import _oihw_to_hwio

    return {name: {"w": _oihw_to_hwio(_t(sd[name + ".weight"], dtype)),
                   "b": _t(sd[name + ".bias"], dtype)}
            for name, _, _ in (e for e in MINC_PLAN if e != "M")}


def minc_forward(params: dict, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """``[B, H, W, 3]`` RGB [0,1] (no input norm upstream) →
    ``[B, H/16, W/16, 512]``."""
    h = x
    last = MINC_PLAN[-1][0]
    for entry in MINC_PLAN:
        if entry == "M":
            h = maxpool2_ceil(h)
            continue
        h = conv2d(h, params[entry[0]], dtype=dtype)
        if entry[0] != last:
            h = torch.relu(h)
    return h


# ---------------------------------------------------------------------------
# ResNet-101 (torchvision layout)
# ---------------------------------------------------------------------------


def resnet101_from_state_dict(sd: Dict[str, torch.Tensor], dtype: torch.dtype = torch.float32
                              ) -> dict:
    """Convert a torchvision resnet101 state dict (the ``children[:8]``
    slice); each stage's depth is read from the keys (3 / 4 / 23 / 3)."""
    from esrganplus_tpu_torch.convert.pth import _oihw_to_hwio

    conv = lambda prefix: {"w": _oihw_to_hwio(_t(sd[prefix + ".weight"], dtype))}
    bn = lambda prefix: {"scale": _t(sd[prefix + ".weight"], dtype),
                         "bias": _t(sd[prefix + ".bias"], dtype),
                         "mean": _t(sd[prefix + ".running_mean"], dtype),
                         "var": _t(sd[prefix + ".running_var"], dtype)}
    params = {"stem_conv": conv("conv1"), "stem_bn": bn("bn1"), "blocks": []}
    for stage in (1, 2, 3, 4):
        depth = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith(f"layer{stage}."))
        for i in range(depth):
            base = f"layer{stage}.{i}"
            blk = {"c1": conv(base + ".conv1"), "b1": bn(base + ".bn1"),
                   "c2": conv(base + ".conv2"), "b2": bn(base + ".bn2"),
                   "c3": conv(base + ".conv3"), "b3": bn(base + ".bn3"),
                   "stride": 1 if (i > 0 or stage == 1) else 2}
            if f"{base}.downsample.0.weight" in sd:
                blk["proj"] = conv(base + ".downsample.0")
                blk["proj_bn"] = bn(base + ".downsample.1")
            params["blocks"].append(blk)
    return params


def resnet101_feat_forward(params: dict, x: torch.Tensor, use_input_norm: bool = True,
                           dtype=None) -> torch.Tensor:
    """``[B, H, W, 3]`` RGB [0,1] → layer4 features ``[B, H/32, W/32, 2048]``."""
    if use_input_norm:
        mean = torch.tensor(_IMAGENET_MEAN, dtype=x.dtype, device=x.device)
        std = torch.tensor(_IMAGENET_STD, dtype=x.dtype, device=x.device)
        x = (x - mean) / std
    bn = lambda h, p: batchnorm(h, p, train=False)[0]
    h = torch.relu(bn(conv2d(x, params["stem_conv"], stride=2, pad=3, dtype=dtype),
                      params["stem_bn"]))
    # 3×3 stride-2 max pool, pad 1 (the torch ResNet stem)
    h = F.max_pool2d(h.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1).contiguous()
    for blk in params["blocks"]:
        s = blk["stride"]
        r = torch.relu(bn(conv2d(h, blk["c1"], dtype=dtype), blk["b1"]))
        r = torch.relu(bn(conv2d(r, blk["c2"], stride=s, dtype=dtype), blk["b2"]))
        r = bn(conv2d(r, blk["c3"], dtype=dtype), blk["b3"])
        sc = bn(conv2d(h, blk["proj"], stride=s, dtype=dtype), blk["proj_bn"]) \
            if "proj" in blk else h
        h = torch.relu(sc + r)
    return h
