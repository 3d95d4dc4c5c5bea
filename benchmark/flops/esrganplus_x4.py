"""FLOPs and bytes of the ESRGAN+ configuration's work, from its shapes.

G is RRDBNet (nf, nb, gc of ``network_G``; ×4 by two nearest-×2 upconvs),
D ``discriminator_vgg_128`` (``network_D``'s nf), F VGG19 to conv5_4. What
a step computes follows the recipe's losses: for ``srragan`` G's forward
and gradients, F on the real batch (no gradient) and on the fake (data
gradient only), D three times (on the real batch with its graph; on the
fake with D frozen, data gradient only; on the detached fake), and D's
weight gradients of its two D-phase forwards. The trunk is the 69 RDBs and
the trunk conv; the stage work is what the program's stage kernels compute
in a bf16 step: D's and F's ≤128-channel convolutions and the tail's
``hr_conv0``.
"""

from __future__ import annotations

from core.counting import ITEMSIZE, Conv, Linear, Tally, vgg19_convs


def rrdbnet(n, h, w, nf=64, nb=23, gc=32, in_nc=3, out_nc=3, n_up=2) -> dict:
    """{"fea", "trunk", "tail"}: G's convolutions on an (n, h, w) LR batch."""
    trunk = []
    for b in range(3 * nb):
        for k in range(1, 6):
            trunk.append(Conv(f"rdb{b}.conv{k}", nf + (k - 1) * gc, nf if k == 5 else gc,
                              3, 1, n, h, w))
        trunk.append(Conv(f"rdb{b}.conv1x1", nf, gc, 1, 1, n, h, w))
    trunk.append(Conv("trunk_conv", nf, nf, 3, 1, n, h, w))
    tail = []
    for i in range(n_up):
        tail.append(Conv(f"upconv{i}", nf, nf, 3, 1, n, h * 2 ** (i + 1), w * 2 ** (i + 1)))
    s = 2 ** n_up
    tail += [Conv("hr_conv0", nf, nf, 3, 1, n, h * s, w * s),
             Conv("hr_conv1", nf, out_nc, 3, 1, n, h * s, w * s)]
    return {"fea": [Conv("fea_conv", in_nc, nf, 3, 1, n, h, w)], "trunk": trunk, "tail": tail}


def discriminator(n, size=128, nf=64, in_nc=3) -> list:
    """discriminator_vgg_<size>'s layers in order, the linears last."""
    chans = [nf, nf * 2, nf * 4, nf * 8, nf * 8, nf * 8][:{96: 5, 128: 5, 192: 6}[size]]
    out, cin, hw = [], in_nc, size
    for i, c in enumerate(chans):
        out.append(Conv(f"d{i}a", cin, c, 3, 1, n, hw, hw))
        out.append(Conv(f"d{i}b", c, c, 4, 2, n, hw, hw, pad=1))
        cin, hw = c, hw // 2
    return out + [Linear("fc0", cin * hw * hw, 100, n), Linear("fc1", 100, 1, n)]


def _g(recipe, n, h, w):
    g = recipe["network_G"]
    return rrdbnet(n, h, w, g.get("nf", 64), g.get("nb", 23), g.get("gc", 32),
                   g.get("in_nc", 3), g.get("out_nc", 3))


def _dtype(recipe) -> str:
    return recipe["train"].get("compute_dtype") or "float32"


def train_step(config: dict, recipe_key: str, batch: int, hr: int) -> dict:
    """{"total", "trunk", "stage"} tallies of one optimizer step."""
    recipe = config["recipes"][recipe_key]
    it = ITEMSIZE[_dtype(recipe)]
    g = _g(recipe, batch, hr // 4, hr // 4)
    g_all = g["fea"] + g["trunk"] + g["tail"]
    total = Tally(it).add(g_all, skip_first_dx=True)
    trunk = Tally(it).add(g["trunk"])
    stage = Tally(it)
    if recipe["model"] == "srragan":
        d = discriminator(batch, 128, recipe["network_D"].get("nf", 64))
        f = vgg19_convs(batch, hr, hr)
        total.add(f, dx=False, dw=False).add(f, dw=False)  # F(real); F(fake) with dx
        total.add(d, dx=False, dw=False)                   # D(real), its graph kept
        total.add(d, dw=False)                             # D(fake), D frozen
        total.add(d, dx=False, dw=False)                   # D(fake detached)
        total.add(d, fwd=False, skip_first_dx=True)        # D's loss: real branch
        total.add(d, fwd=False, skip_first_dx=True)        # and fake branch
        d_k, f_k = d[:4], [c for c in f if c.cout <= 128][:4]
        stage.add(f_k, dx=False, dw=False).add(f_k, dw=False)
        stage.add(d_k, dx=False, dw=False).add(d_k, dw=False).add(d_k, dx=False, dw=False)
        stage.add(d_k, fwd=False, skip_first_dx=True).add(d_k, fwd=False, skip_first_dx=True)
    if _dtype(recipe) == "bfloat16":
        stage.add([c for c in g["tail"] if c.name == "hr_conv0"])
    return {"total": total, "trunk": trunk, "stage": stage}


def image(config: dict, h: int, w: int) -> dict:
    """{"total", "trunk"} tallies of one ×4 forward of an h×w LR image."""
    recipe = config["recipes"][config["infer"]["recipe"]]
    it = ITEMSIZE[config["infer"]["compute_dtype"]]
    g = _g(recipe, 1, h, w)
    return {"total": Tally(it).add(g["fea"] + g["trunk"] + g["tail"], dx=False, dw=False),
            "trunk": Tally(it).add(g["trunk"], dx=False, dw=False)}
