"""G of SFT-GAN: SFT_Net ×4 with its CondNet (``codes/models/modules/
sft_arch.py``). The weight tree stacks the SFT resblocks over their count."""

from __future__ import annotations

import torch.nn.functional as F

from reference.layers import block, conv, lrelu


def spec(nf=64, nb=16, cond_in=8, cond_nf=32, cond_hidden=128, in_nc=3, out_nc=3) -> dict:
    sft = lambda s: {"scale0": conv(1, 1, cond_nf, cond_nf, stack=s),
                     "scale1": conv(1, 1, cond_nf, nf, stack=s),
                     "shift0": conv(1, 1, cond_nf, cond_nf, stack=s),
                     "shift1": conv(1, 1, cond_nf, nf, stack=s)}
    ch = cond_hidden
    return {"conv0": conv(3, 3, in_nc, nf),
            "blocks": {"sft0": sft(nb), "conv0": conv(3, 3, nf, nf, stack=nb),
                       "sft1": sft(nb), "conv1": conv(3, 3, nf, nf, stack=nb)},
            "final_sft": sft(None), "final_conv": conv(3, 3, nf, nf),
            "hr": {"up0": conv(3, 3, nf, nf * 4), "up1": conv(3, 3, nf, nf * 4),
                   "conv0": conv(3, 3, nf, nf), "conv1": conv(3, 3, nf, out_nc)},
            "cond": {"c0": conv(4, 4, cond_in, ch), "c1": conv(1, 1, ch, ch),
                     "c2": conv(1, 1, ch, ch), "c3": conv(1, 1, ch, ch),
                     "c4": conv(1, 1, ch, cond_nf)}}


def sft_layer(fea, cond, p: dict, pr):
    """``fea·(scale + 1) + shift``, both from the condition by two 1×1 convs
    with lrelu(0.1) between."""
    scale = pr.conv(lrelu(pr.conv(cond, p["scale0"]), 0.1), p["scale1"])
    shift = pr.conv(lrelu(pr.conv(cond, p["shift0"]), 0.1), p["shift1"])
    return fea * (scale + 1.0) + shift


def forward(params: dict, img, seg, pr):
    """img NCHW LR; seg NCHW ×4 seg probabilities → ×4 NCHW."""
    c = params["cond"]
    cond = pr.conv(seg, c["c0"], stride=4, padding=0)
    for name in ("c1", "c2", "c3", "c4"):
        cond = pr.conv(lrelu(cond, 0.1), c[name])
    fea0 = pr.conv(img, params["conv0"])
    fea = fea0
    blocks = params["blocks"]
    for i in range(blocks["conv0"]["w"].shape[0]):
        b = block(blocks, i)
        h = sft_layer(fea, cond, b["sft0"], pr)
        h = F.relu(pr.conv(h, b["conv0"]))
        h = sft_layer(h, cond, b["sft1"], pr)
        fea = fea + pr.conv(h, b["conv1"])
    fea = sft_layer(fea, cond, params["final_sft"], pr)
    fea = fea0 + pr.conv(fea, params["final_conv"])
    hr = params["hr"]
    fea = F.relu(F.pixel_shuffle(pr.conv(fea, hr["up0"]), 2))
    fea = F.relu(F.pixel_shuffle(pr.conv(fea, hr["up1"]), 2))
    fea = F.relu(pr.conv(fea, hr["conv0"]))
    return pr.conv(fea, hr["conv1"])
