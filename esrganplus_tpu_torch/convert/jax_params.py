"""Carry parameters across from the JAX package.

``esrganplus_tpu``'s ``init_rrdbnet`` pytree (HWIO weights, the ``trunk``
subtree stacked over nb) is the port's layout too, so the conversion is a
tree walk from numpy arrays to fp32 CPU tensors plus a shape check against
the config. The caller turns JAX arrays into numpy first
(``jax.tree.map(np.asarray, params)``); this module imports no JAX. A whole
trainer state (parameters, Adam moments, step) crosses through
:func:`trainer_state_from_jax`.
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


def _find_adam(opt_state):
    """The ``ScaleByAdamState(count, mu, nu)`` inside an optax state: the
    state itself, or one element of a chain's tuple."""
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (list, tuple)):
        for s in opt_state:
            found = _find_adam(s)
            if found is not None:
                return found
    return None


def trainer_state_from_jax(state: dict, cfg: RRDBNetConfig) -> dict:
    """A JAX ``SRTrainer`` state with numpy leaves (``params`` canonical,
    ``opt_state`` optax's ``ScaleByAdamState`` possibly inside a chain,
    ``step``) → the port's trainer state on the CPU: ``{"params",
    "opt_state": {"count", "mu", "nu"}, "step"}``. Hand the result's
    ``params`` to ``SRTrainer.ingest_params`` and the moments to the device
    to continue the run (``tests/test_torch_trainer.py`` shows it).

    A state that holds the JAX package's prepared ``trunk_ct`` masters is
    refused: convert it there first, with ``unprep_trunk_ct``."""
    if "trunk_ct" in state["params"]:
        raise ValueError("this state holds prepared trunk_ct masters (the JAX package's "
                         "kernel layout); convert it with "
                         "esrganplus_tpu.models.rrdb.unprep_trunk_ct (params and both "
                         "Adam moments) before carrying it across")
    adam = _find_adam(state["opt_state"])
    if adam is None:
        raise ValueError("no ScaleByAdamState(count, mu, nu) in opt_state")
    return {"params": from_jax_params(state["params"], cfg),
            "opt_state": {"count": int(np.asarray(adam.count)),
                          "mu": from_jax_params(adam.mu, cfg),
                          "nu": from_jax_params(adam.nu, cfg)},
            "step": int(np.asarray(state["step"]))}
