"""G: ESRGAN+'s RRDBNet with its 1×1 dense-block shortcut and nESRGAN+'s
noise (ncarraz/ESRGANplus ``codes/models/modules/{architecture,block}.py``).
The weight tree stacks the trunk over its blocks."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference.layers import block, conv, lrelu


def spec(nf=64, nb=23, gc=32, in_nc=3, out_nc=3, n_up=2) -> dict:
    rdb = {f"conv{k}": conv(3, 3, nf + (k - 1) * gc, nf if k == 5 else gc, stack=nb)
           for k in range(1, 6)}
    rdb["conv1x1"] = conv(1, 1, nf, gc, bias=False, stack=nb)
    return {"fea_conv": conv(3, 3, in_nc, nf),
            "trunk": {name: dict(rdb) for name in ("rdb1", "rdb2", "rdb3")},
            "trunk_conv": conv(3, 3, nf, nf),
            "hr_conv0": conv(3, 3, nf, nf), "hr_conv1": conv(3, 3, nf, out_nc),
            "upconvs": [conv(3, 3, nf, nf) for _ in range(n_up)]}


def rdb(x, p: dict, pr, noise=None, sigma: float = 0.1, beta: float = 0.2):
    """ESRGAN+'s residual dense block: the 1×1 shortcut into x2, x4 + x2,
    the β-scaled residual; ``noise`` (standard normals of the output's shape)
    adds ``noise·σ·out`` (nESRGAN+)."""
    x1 = lrelu(pr.conv(x, p["conv1"]))
    x2 = lrelu(pr.conv(torch.cat([x, x1], 1), p["conv2"])) + pr.conv(x, p["conv1x1"])
    x3 = lrelu(pr.conv(torch.cat([x, x1, x2], 1), p["conv3"]))
    x4 = lrelu(pr.conv(torch.cat([x, x1, x2, x3], 1), p["conv4"])) + x2
    x5 = pr.conv(torch.cat([x, x1, x2, x3, x4], 1), p["conv5"])
    out = x5 * beta + x
    if noise is not None:
        out = out + noise * (sigma * out)
    return pr.store(out)


def forward(params: dict, x, pr, noise=None, beta: float = 0.2):
    """NCHW LR [0, 1] → ×4 NCHW. ``noise``: per block a list of three NCHW
    normals (the three RDB sites), or None (inference)."""
    fea = pr.conv(x, params["fea_conv"])
    trunk = params["trunk"]
    nb = trunk["rdb1"]["conv1"]["w"].shape[0]
    h = fea
    for i in range(nb):
        h0 = h
        for k, name in enumerate(("rdb1", "rdb2", "rdb3")):
            h = rdb(h, block(trunk[name], i), pr, None if noise is None else noise[i][k])
        h = pr.store(h * beta + h0)
    fea = pr.store(fea + pr.conv(h, params["trunk_conv"]))
    for up in params["upconvs"]:
        fea = lrelu(pr.conv(F.interpolate(fea, scale_factor=2, mode="nearest"), up))
    fea = lrelu(pr.conv(fea, params["hr_conv0"]))
    return pr.conv(fea, params["hr_conv1"])
