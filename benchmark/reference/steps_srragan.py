"""Reference ESRGAN+ GAN steps (``model: "srragan"``): G's pixel L1, VGG19
feature L1 and relativistic-average GAN loss with D frozen, then D's RaGAN
loss on the same (detached) fake; each network its own Adam. D's batch
norms use the batch's statistics (training mode), so their running
statistics take no part in a step."""

from __future__ import annotations

import os

import torch.nn.functional as F

from reference import draws, layers, optim

G = layers.net("rrdbnet", os.path.dirname(__file__))
D = layers.net("discriminator_vgg", os.path.dirname(__file__))
VGG = layers.net("vgg19", os.path.dirname(__file__))
draw_noise = draws.recipe_noise  # the noise sites of the recipe's G
LOSSES = ("l_g_pix", "l_g_fea", "l_g_gan", "l_d_total")


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
        for b, n in zip(batches, noise):
            lr, hr = b["LR"], b["HR"]
            d_real = D.forward(d, hr, pr)
            fake = G.forward(g, lr, pr, n)
            l_pix = t["pixel_weight"] * (fake - hr).abs().mean()
            real_fea = VGG.forward(f, hr, pr).detach()
            l_fea = t["feature_weight"] * (VGG.forward(f, fake, pr) - real_fea).abs().mean()
            d_fake = D.forward(optim.detached(d), fake, pr)
            dr = d_real.detach()
            l_gan = t["gan_weight"] * (_bce(dr - d_fake.mean(), 0.0)
                                       + _bce(d_fake - dr.mean(), 1.0)) / 2
            adam_g.step(optim.grads_of(l_pix + l_fea + l_gan, gp))
            d_fake = D.forward(d, fake.detach(), pr)
            l_d = (_bce(d_real - d_fake.mean(), 1.0) + _bce(d_fake - d_real.mean(), 0.0)) / 2
            adam_d.step(optim.grads_of(l_d, dp))
            logs.append({"l_g_pix": float(l_pix.detach()), "l_g_fea": float(l_fea.detach()),
                         "l_g_gan": float(l_gan.detach()), "l_d_total": float(l_d.detach())})
    return {"logs": logs, "first_grads": {"g": adam_g.first_grads, "d": adam_d.first_grads},
            "params": {"g": gp, "d": dp}}
