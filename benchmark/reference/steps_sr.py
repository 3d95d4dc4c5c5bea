"""Reference PSNR pretraining steps (``model: "sr"``): L1 pixel loss of the
nESRGAN+ generator with its noise sites, Adam at the recipe's ``lr_G``."""

from __future__ import annotations

import os

from reference import draws, layers, optim

G = layers.net("rrdbnet", os.path.dirname(__file__))

draw_noise = draws.recipe_noise  # the noise sites of the recipe's G
LOSSES = ("l_pix",)


def run(weights: dict, recipe: dict, batches: list, noise: list, pr) -> dict:
    t = recipe["train"]
    g = weights["g"]
    gp = optim.trainable(g)
    adam = optim.Adam(gp, t.get("lr_G", 2e-4), t.get("beta1_G", 0.9))
    logs = []
    with pr.flags():
        for b, n in zip(batches, noise):
            fake = G.forward(g, b["LR"], pr, n)
            loss = t.get("pixel_weight", 1.0) * (fake - b["HR"]).abs().mean()
            adam.step(optim.grads_of(loss, gp))
            logs.append({"l_pix": float(loss.detach())})
    return {"logs": logs, "first_grads": {"g": adam.first_grads}, "params": {"g": gp}}
