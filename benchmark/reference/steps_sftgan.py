"""Reference SFT-GAN steps (``model: "sftgan"``, SFTGAN_ACD_model): G's
pixel L1, VGG19 feature L1, GAN BCE and the masked class cross entropy
(category 0, background, ignored) with the ACD frozen; then the ACD's BCE
and cross entropy on real and (detached) fake. In the first 20 000 steps
only the SFT layers and CondNet (every leaf whose path holds "sft" or
"cond") update, at 5× ``lr_G``; the rest of G waits."""

from __future__ import annotations

import os

import torch.nn.functional as F

from reference import layers, optim

G = layers.net("sftnet", os.path.dirname(__file__))
D = layers.net("acd", os.path.dirname(__file__))
VGG = layers.net("vgg19", os.path.dirname(__file__))

LOSSES = ("l_g_pix", "l_g_fea", "l_g_gan", "l_g_cls", "l_d_total")
OTHER_START = 20_000
SFT_LR_MULT = 5.0


def _bce(logits, target: float):
    return F.binary_cross_entropy_with_logits(logits, logits.new_full(logits.shape, target))


def draw_noise(seed: int, step: int, recipe: dict, batch: int, hr: int, device):
    """SFT_Net has no noise sites."""
    return None


def masked_ce(logits, labels):
    keep = labels != 0
    if not bool(keep.any()):
        return logits.sum() * 0.0
    return F.cross_entropy(logits[keep], labels[keep])


def run(weights: dict, recipe: dict, batches: list, noise: list, pr, first_step: int = 1) -> dict:
    t = recipe["train"]
    g, d, f = weights["g"], weights["d"], optim.detached(weights["f"])
    dp = optim.trainable(d)
    sft = {k: v.requires_grad_(True) for k, v in optim.tensor_leaves(g)
           if "sft" in k.lower() or "cond" in k.lower()}
    adam_sft = optim.Adam(sft, t["lr_G"] * SFT_LR_MULT, t.get("beta1_G", 0.9))
    adam_d = optim.Adam(dp, t["lr_D"], t.get("beta1_D", 0.9))
    logs = []
    with pr.flags():
        for i, b in enumerate(batches):
            if first_step + i > OTHER_START:
                raise NotImplementedError("the reference follows the first 20 000 steps only")
            lr, seg, hr, cat = b["LR"], b["seg"], b["HR"], b["category"]
            fake = G.forward(g, lr, seg, pr)
            l_pix = t["pixel_weight"] * (fake - hr).abs().mean()
            real_fea = VGG.forward(f, hr, pr).detach()
            l_fea = t["feature_weight"] * (VGG.forward(f, fake, pr) - real_fea).abs().mean()
            gan, cls = D.forward(optim.detached(d), fake, pr)
            l_gan = t["gan_weight"] * _bce(gan, 1.0)
            l_cls = t["gan_weight"] * masked_ce(cls, cat)
            adam_sft.step(optim.grads_of(l_pix + l_fea + l_gan + l_cls, sft))
            gan_r, cls_r = D.forward(d, hr, pr)
            gan_f, cls_f = D.forward(d, fake.detach(), pr)
            l_d = (_bce(gan_r, 1.0) + masked_ce(cls_r, cat) + _bce(gan_f, 0.0)
                   + masked_ce(cls_f, cat))
            adam_d.step(optim.grads_of(l_d, dp))
            logs.append({"l_g_pix": float(l_pix.detach()), "l_g_fea": float(l_fea.detach()),
                         "l_g_gan": float(l_gan.detach()), "l_g_cls": float(l_cls.detach()),
                         "l_d_total": float(l_d.detach())})
    return {"logs": logs, "first_grads": {"sft": adam_sft.first_grads, "d": adam_d.first_grads},
            "params": {"sft": sft, "d": dp}}
