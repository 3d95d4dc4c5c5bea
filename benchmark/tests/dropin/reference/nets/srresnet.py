"""G of SRGAN: SRResNet (``codes/models/modules/architecture.py``), dropped
in as a new file: fea_conv, nb residual blocks of [conv, relu, conv], the
trunk conv with the long skip, pixel-shuffle ×2 stages, two HR convs. The
weight tree stacks the blocks over their count."""

from __future__ import annotations

import torch.nn.functional as F

from reference.layers import block, conv


def spec(nf=64, nb=16, in_nc=3, out_nc=3, n_up=2) -> dict:
    return {"fea_conv": conv(3, 3, in_nc, nf),
            "trunk": {"conv0": conv(3, 3, nf, nf, stack=nb), "conv1": conv(3, 3, nf, nf, stack=nb)},
            "trunk_conv": conv(3, 3, nf, nf),
            "upconvs": [conv(3, 3, nf, nf * 4) for _ in range(n_up)],
            "hr_conv0": conv(3, 3, nf, nf), "hr_conv1": conv(3, 3, nf, out_nc)}


def forward(params: dict, x, pr):
    """NCHW LR [0, 1] → ×4 NCHW."""
    fea = pr.conv(x, params["fea_conv"])
    h = fea
    for i in range(params["trunk"]["conv0"]["w"].shape[0]):
        b = block(params["trunk"], i)
        h = h + pr.conv(F.relu(pr.conv(h, b["conv0"])), b["conv1"])
    fea = fea + pr.conv(h, params["trunk_conv"])
    for up in params["upconvs"]:
        fea = F.relu(F.pixel_shuffle(pr.conv(fea, up), 2))
    fea = F.relu(pr.conv(fea, params["hr_conv0"]))
    return pr.conv(fea, params["hr_conv1"])
