"""FLOPs and bytes of the SFT-GAN configuration's work, from its shapes.

G is SFT_Net (nf 64, nb resblocks of two SFT layers and two 3×3 convs,
CondNet on the ×4 seg map, a ×4 pixel-shuffle HR branch), D the ACD
(ACD_VGG_BN_96 with a GAN and a class head), F VGG19 to conv5_4. In the
first 20 000 steps only the SFT layers and CondNet learn: G's weight
gradients are theirs alone, and its data gradient runs back from the loss
to every layer they feed. The stage work is VGG19's ≤128-channel
convolutions, which the program's stage kernels compute.
"""

from __future__ import annotations

from core.counting import ITEMSIZE, Conv, Linear, Tally, vgg19_convs

ACD_PLAN = ((3, 1, 64), (4, 2, 64), (3, 1, 128), (4, 2, 128), (3, 1, 256), (4, 2, 256),
            (3, 1, 512), (4, 2, 512))


def sftnet(n, h, w, nf=64, nb=16, cond_in=8, cond_nf=32, hidden=128) -> dict:
    """{"cond0", "cond", "sft", "conv0", "body", "hr"}: SFT_Net's
    convolutions on an (n, h, w) LR batch (the seg map at 4h × 4w)."""
    sft = lambda tag: [Conv(f"{tag}.scale0", cond_nf, cond_nf, 1, 1, n, h, w),
                       Conv(f"{tag}.scale1", cond_nf, nf, 1, 1, n, h, w),
                       Conv(f"{tag}.shift0", cond_nf, cond_nf, 1, 1, n, h, w),
                       Conv(f"{tag}.shift1", cond_nf, nf, 1, 1, n, h, w)]
    body, sfts = [], []
    for i in range(nb):
        sfts += sft(f"b{i}.sft0") + sft(f"b{i}.sft1")
        body += [Conv(f"b{i}.conv0", nf, nf, 3, 1, n, h, w),
                 Conv(f"b{i}.conv1", nf, nf, 3, 1, n, h, w)]
    sfts += sft("final_sft")
    body.append(Conv("final_conv", nf, nf, 3, 1, n, h, w))
    hr = [Conv("up0", nf, nf * 4, 3, 1, n, h, w), Conv("up1", nf, nf * 4, 3, 1, n, 2 * h, 2 * w),
          Conv("hr0", nf, nf, 3, 1, n, 4 * h, 4 * w), Conv("hr1", nf, 3, 3, 1, n, 4 * h, 4 * w)]
    cond = [Conv(f"c{i}", hidden, hidden if i < 4 else cond_nf, 1, 1, n, h, w)
            for i in range(1, 5)]
    return {"cond0": [Conv("c0", cond_in, hidden, 4, 4, n, 4 * h, 4 * w, pad=0)],
            "cond": cond, "sft": sfts, "conv0": [Conv("conv0", 3, nf, 3, 1, n, h, w)],
            "body": body, "hr": hr}


def acd(n, size=96) -> list:
    out, cin, hw = [], 3, size
    for i, (k, s, c) in enumerate(ACD_PLAN):
        out.append(Conv(f"acd{i}", cin, c, k, s, n, hw, hw, pad=1))
        cin, hw = c, out[-1].ho
    flat = cin * hw * hw
    return out + [Linear("gan0", flat, 100, n), Linear("gan1", 100, 1, n),
                  Linear("cls0", flat, 100, n), Linear("cls1", 100, 8, n)]


def train_step(config: dict, recipe_key: str, batch: int, hr: int) -> dict:
    """{"total", "stage"} tallies of one optimizer step (the SFT group
    and D learning)."""
    recipe = config["recipes"][recipe_key]
    it = ITEMSIZE[recipe["train"].get("compute_dtype") or "float32"]
    g = sftnet(batch, hr // 4, hr // 4, nb=recipe["network_G"].get("nb", 16))
    total = Tally(it)
    total.add(g["cond0"] + g["cond"] + g["conv0"] + g["sft"] + g["body"] + g["hr"],
              dx=False, dw=False)
    # G's backward: weight gradients of the SFT layers and CondNet, data
    # gradients wherever they lead to one (not into the LR image or the seg map)
    total.add(g["cond"] + g["sft"] + g["body"] + g["hr"], fwd=False, dw=False)
    total.add(g["cond0"] + g["cond"] + g["sft"], fwd=False, dx=False)
    f, d = vgg19_convs(batch, hr, hr), acd(batch)
    total.add(f, dx=False, dw=False).add(f, dw=False)  # F(real); F(fake) with dx
    total.add(d, dw=False)                             # D(fake), D frozen
    total.add(d, dx=False, dw=False).add(d, dx=False, dw=False)  # D(real), D(fake detached)
    total.add(d, fwd=False, skip_first_dx=True).add(d, fwd=False, skip_first_dx=True)
    f_k = [c for c in f if c.cout <= 128][:4]
    stage = Tally(it).add(f_k, dx=False, dw=False).add(f_k, dw=False)
    return {"total": total, "stage": stage}
