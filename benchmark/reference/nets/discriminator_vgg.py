"""D: discriminator_vgg_128 / _96 / _192 with batch norm and lrelu 0.2
(``codes/models/modules/architecture.py``)."""

from __future__ import annotations

from reference.layers import bn, bn_train, conv, linear, lrelu


def spec(input_size=128, base_nf=64, in_nc=3) -> dict:
    n_stages = {96: 5, 128: 5, 192: 6}[input_size]
    chans = [base_nf, base_nf * 2, base_nf * 4, base_nf * 8, base_nf * 8, base_nf * 8][:n_stages]
    convs, bns, cin = [], [], in_nc
    for i, c in enumerate(chans):
        convs.append({"a": conv(3, 3, cin, c), "b": conv(4, 4, c, c)})
        bns.append({"a": None if i == 0 else bn(c), "b": bn(c)})
        cin = c
    f = input_size // 2 ** n_stages
    return {"convs": convs, "bn": bns, "fc0": linear(chans[-1] * f * f, 100),
            "fc1": linear(100, 1)}


def forward(params: dict, x, pr):
    """NCHW image → logits ``[B, 1]``: stages of [3×3 conv, BN, lrelu, 4×4
    stride-2 conv, BN, lrelu] (no BN after the very first conv), then
    Linear → lrelu → Linear on the NCHW flatten."""
    h = x
    for cv, norm in zip(params["convs"], params["bn"]):
        h = pr.conv(h, cv["a"])
        if norm["a"] is not None:
            h = bn_train(h, norm["a"])
        h = pr.conv(lrelu(h), cv["b"], stride=2, padding=1)
        h = lrelu(bn_train(h, norm["b"]))
    h = h.reshape(h.shape[0], -1)
    return pr.linear(lrelu(pr.linear(h, params["fc0"])), params["fc1"])
