"""Adam and the batches of the reference's training steps.

Adam as torch's (and the reference repository's) ``torch.optim.Adam``
without weight decay: ``m ← β1·m + (1−β1)·g``, ``v ← β2·v + (1−β2)·g²``,
``p ← p − lr·(m / (1−β1ᵗ)) / (√(v / (1−β2ᵗ)) + ε)``, ε = 1e-8. A tree leaf
that the loss does not reach gets a zero gradient.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import draws


def tensor_leaves(tree, path=""):
    """(path, tensor) of every tensor of a tree, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tensor_leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tensor_leaves(v, f"{path}/{i}")
    elif torch.is_tensor(tree):
        yield path, tree


def detached(tree):
    if isinstance(tree, dict):
        return {k: detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [detached(v) for v in tree]
    return tree.detach() if torch.is_tensor(tree) else tree


class Adam:
    """Adam over the leaves of one parameter group (a dict path → tensor)."""

    def __init__(self, params: dict, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, b1, b2, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0
        self.first_grads = None  # {path: the gradient of the first update}

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        if self.first_grads is None:
            self.first_grads = {k: g.clone() for k, g in grads.items()}
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + self.eps))


def grads_of(loss, params: dict) -> dict:
    """{path: gradient} of ``loss``, zeros where the loss does not reach."""
    keys = list(params)
    got = torch.autograd.grad(loss, [params[k] for k in keys], allow_unused=True)
    return {k: torch.zeros_like(params[k]) if g is None else g for k, g in zip(keys, got)}


def trainable(tree, skip=("mean", "var")) -> dict:
    """{path: leaf} of a tree's tensors, each set to require gradients; the
    batch-norm running statistics (``skip``) are left out."""
    out = {}
    for path, t in tensor_leaves(tree):
        if path.rsplit("/", 1)[-1] in skip:
            continue
        t.requires_grad_(True)
        out[path] = t
    return out


def batch(dataset, pool_seed: int, run_seed: int, step: int, batch_size: int,
          n_crops: int, flip: bool, rot: bool, device, seg: bool = False) -> dict:
    """The resident batch of 0-based step ``step`` from pool 0, as NCHW
    float32 tensors (and the seg map and category for SFT-GAN)."""
    key = draws.sample_key(run_seed, step)
    idx, (h, v, t) = draws.sampler_draw(key, batch_size, n_crops, flip, rot)
    order_rng, crop_rng = draws.pool_generators(pool_seed, 0)
    where = pool_crops(dataset, order_rng, crop_rng, set(idx.tolist()))
    crops = [dataset.crop(*where[i]) for i in idx.tolist()]
    nchw = lambda a: a.permute(0, 3, 1, 2).contiguous()
    stack = lambda k: draws.augment(torch.from_numpy(np.stack([c[k] for c in crops])),
                                    h, v, t)
    out = {"LR": stack("LR").float(), "HR": stack("HR").float() / 255.0}
    if not seg:
        out["LR"] = out["LR"] / 255.0
    else:
        out["seg"] = stack("seg").float()
        out["category"] = torch.tensor([c["category"] for c in crops], dtype=torch.int64)
    return {k: (nchw(x) if x.dim() == 4 else x).to(device) for k, x in out.items()}


def pool_crops(dataset, order_rng, crop_rng, needed) -> dict:
    """{pool index: (source index, crop position)} of the crops in
    ``needed``: crop i of the pool is source ``order[i mod n]``, its
    position the i-th that ``crop_rng`` draws."""
    order = order_rng.permutation(len(dataset))
    out = {}
    for i in range(max(needed) + 1):
        pos = dataset.positions(crop_rng)
        if i in needed:
            out[i] = (int(order[i % len(dataset)]), pos)
    return out
