"""F: VGG19's features to conv5_4 (torchvision's ``features[:35]``),
frozen, on the input normalised by ImageNet's mean and std."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference.layers import conv

LAYOUT = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M")
FEATURE_LAYER = 34  # torchvision features index: conv5_4, before its relu
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def plan(layout=LAYOUT, last: int = FEATURE_LAYER) -> list:
    """torchvision's ``features`` entries up to index ``last``: ("conv",
    cin, cout), ("relu",) or ("pool",)."""
    out, cin = [], 3
    for item in layout:
        if item == "M":
            out.append(("pool",))
        else:
            out += [("conv", cin, item), ("relu",)]
            cin = item
    return out[:last + 1]


def spec(layout=LAYOUT, last=FEATURE_LAYER) -> dict:
    """A conv leaf for each conv of the plan, None for relu and pool."""
    return {"layers": [conv(3, 3, e[1], e[2]) if e[0] == "conv" else None
                       for e in plan(layout, last)]}


def forward(params: dict, x, pr):
    """NCHW RGB [0, 1] → the feature map after ``features[34]``."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
    h = (x - mean) / std
    for entry, p in zip(plan(), params["layers"]):
        if entry[0] == "conv":
            h = pr.conv(h, p)
        elif entry[0] == "relu":
            h = F.relu(h)
        else:
            h = F.max_pool2d(h, 2)
    return h
