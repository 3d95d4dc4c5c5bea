"""Carry parameters across from the JAX package.

``esrganplus_tpu``'s ``init_rrdbnet`` pytree (HWIO weights, the ``trunk``
subtree stacked over nb) is the port's layout too, so the conversion is a
tree walk from numpy arrays to fp32 CPU tensors plus a shape check against
the config. The caller turns JAX arrays into numpy first
(``jax.tree.map(np.asarray, params)``); this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from esrganplus_tpu_torch.models.rrdb import RRDBNetConfig


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def from_jax_params(tree: dict, cfg: RRDBNetConfig) -> dict:
    """JAX RRDBNet parameter pytree (numpy leaves) → the port's params."""
    params = _to_torch(tree)
    nf, gc, nb = cfg.nf, cfg.gc, cfg.nb
    expect = {
        ("fea_conv",): (3, 3, cfg.in_nc, nf),
        ("trunk_conv",): (3, 3, nf, nf),
        ("hr_conv1",): (3, 3, nf, cfg.out_nc),
        ("trunk", "rdb1", "conv1"): (nb, 3, 3, nf, gc),
        ("trunk", "rdb3", "conv5"): (nb, 3, 3, nf + 4 * gc, nf),
    }
    for path, shape in expect.items():
        node = params
        for k in path:
            node = node[k]
        if tuple(node["w"].shape) != shape:
            raise ValueError(f"{'/'.join(path)}: weight {tuple(node['w'].shape)}, "
                             f"config expects {shape}")
    if len(params["upconvs"]) != cfg.n_upscale_stages:
        raise ValueError(f"{len(params['upconvs'])} upconvs, config expects "
                         f"{cfg.n_upscale_stages}")
    if cfg.conv1x1 != ("conv1x1" in params["trunk"]["rdb1"]):
        raise ValueError("conv1x1 weights do not match cfg.conv1x1")
    return params
