"""D of SFT-GAN: ACD_VGG_BN_96, the auxiliary-classifier discriminator
(``codes/models/modules/sft_arch.py``): a GAN head and an 8-class head."""

from __future__ import annotations

from reference.layers import bn, bn_train, conv, linear, lrelu

# (kernel, stride, channels, batch norm) of each conv
PLAN = ((3, 1, 64, False), (4, 2, 64, True), (3, 1, 128, True), (4, 2, 128, True),
        (3, 1, 256, True), (4, 2, 256, True), (3, 1, 512, True), (4, 2, 512, True))


def spec(width=1, in_nc=3, classes=8, final=6) -> dict:
    """``width`` divides the channels, for small tests."""
    convs, bns, cin = [], [], in_nc
    for k, _s, c, has_bn in PLAN:
        c //= width
        convs.append(conv(k, k, cin, c))
        bns.append(bn(c) if has_bn else None)
        cin = c
    flat = cin * final * final
    return {"convs": convs, "bn": bns, "gan0": linear(flat, 100), "gan1": linear(100, 1),
            "cls0": linear(flat, 100), "cls1": linear(100, classes)}


def forward(params: dict, x, pr):
    """NCHW 96² image → (gan logits ``[B, 1]``, class logits ``[B, 8]``)."""
    h = x
    for p, norm, (_k, s, _c, has_bn) in zip(params["convs"], params["bn"], PLAN):
        h = pr.conv(h, p, stride=s, padding=1)
        if has_bn:
            h = bn_train(h, norm)
        h = lrelu(h, 0.1)
    h = h.reshape(h.shape[0], -1)
    head = lambda a, b: pr.linear(lrelu(pr.linear(h, params[a]), 0.1), params[b])
    return head("gan0", "gan1"), head("cls0", "cls1")
