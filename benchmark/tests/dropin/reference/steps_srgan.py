"""Reference SRGAN steps (``model: "srgan"``), dropped in as a new file:
G's pixel L1, VGG19 feature L1 and the standard GAN loss with D frozen,
then D's on real and the (detached) fake; each network its own Adam."""

from __future__ import annotations

import os

import torch.nn.functional as F

from reference import layers, optim

G = layers.net("srresnet", os.path.dirname(__file__))
D = layers.net("discriminator_vgg", os.path.dirname(__file__))
VGG = layers.net("vgg19", os.path.dirname(__file__))
LOSSES = ("l_g_pix", "l_g_fea", "l_g_gan", "l_d_total")


def draw_noise(seed: int, step: int, recipe: dict, batch: int, hr: int, device):
    """SRResNet has no noise sites."""
    return None


def _bce(logits, target: float):
    return F.binary_cross_entropy_with_logits(logits, logits.new_full(logits.shape, target))


def run(weights: dict, recipe: dict, batches: list, noise: list, pr) -> dict:
    t = recipe["train"]
    g, d, f = weights["g"], weights["d"], optim.detached(weights["f"])
    gp, dp = optim.trainable(g), optim.trainable(d)
    adam_g = optim.Adam(gp, t["lr_G"], t.get("beta1_G", 0.9))
    adam_d = optim.Adam(dp, t["lr_D"], t.get("beta1_D", 0.9))
    logs = []
    with pr.flags():
        for b in batches:
            lr, hr = b["LR"], b["HR"]
            fake = G.forward(g, lr, pr)
            l_pix = t["pixel_weight"] * (fake - hr).abs().mean()
            real_fea = VGG.forward(f, hr, pr).detach()
            l_fea = t["feature_weight"] * (VGG.forward(f, fake, pr) - real_fea).abs().mean()
            l_gan = t["gan_weight"] * _bce(D.forward(optim.detached(d), fake, pr), 1.0)
            adam_g.step(optim.grads_of(l_pix + l_fea + l_gan, gp))
            l_d = (_bce(D.forward(d, hr, pr), 1.0)
                   + _bce(D.forward(d, fake.detach(), pr), 0.0))
            adam_d.step(optim.grads_of(l_d, dp))
            logs.append({"l_g_pix": float(l_pix.detach()), "l_g_fea": float(l_fea.detach()),
                         "l_g_gan": float(l_gan.detach()), "l_d_total": float(l_d.detach())})
    return {"logs": logs, "first_grads": {"g": adam_g.first_grads, "d": adam_d.first_grads},
            "params": {"g": gp, "d": dp}}
