"""Carry parameters across from the JAX package.

``esrganplus_tpu``'s ``init_rrdbnet`` pytree (HWIO weights, the ``trunk``
subtree stacked over nb) is the port's layout too, so the conversion is a
tree walk from numpy arrays to fp32 CPU tensors plus a shape check against
the config. The caller turns JAX arrays into numpy first
(``jax.tree.map(np.asarray, params)``); this module imports no JAX. A whole
trainer state (parameters, Adam moments, step) crosses through
:func:`trainer_state_from_jax` (PSNR trainer) or
:func:`gan_trainer_state_from_jax` (GAN trainer: generator, discriminator,
both Adam states); the discriminator's and the perceptual net's trees
through :func:`discriminator_from_jax` and :func:`vgg_feat_from_jax`; the
matrices of ``esrganplus_tpu.kernels.rdb_t.prepare_rdb_t_weights`` through
:func:`rdb_t_weights_from_jax`.
"""

from __future__ import annotations

import numpy as np
import torch

from esrganplus_tpu_torch.models.rrdb import RRDBNetConfig


def _to_torch(tree):
    if tree is None or isinstance(tree, bool):
        return tree
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


def discriminator_from_jax(tree: dict, cfg) -> dict:
    """JAX discriminator parameter pytree (numpy leaves; ``bn[0]["a"]`` is
    None) → the port's params, shape-checked against ``cfg``
    (a ``DiscriminatorVGGConfig``)."""
    params = _to_torch(tree)
    if len(params["convs"]) != cfg.n_stages:
        raise ValueError(f"{len(params['convs'])} stages, config expects {cfg.n_stages}")
    cin = cfg.in_nc
    for i, cout in enumerate(cfg.stage_channels):
        for side, shape in (("a", (3, 3, cin, cout)), ("b", (4, 4, cout, cout))):
            got = tuple(params["convs"][i][side]["w"].shape)
            if got != shape:
                raise ValueError(f"convs/{i}/{side}: weight {got}, config expects {shape}")
        cin = cout
    f = cfg.final_spatial
    if tuple(params["fc0"]["w"].shape) != (cfg.stage_channels[-1] * f * f, 100):
        raise ValueError(f"fc0: weight {tuple(params['fc0']['w'].shape)} does not match "
                         f"input_size={cfg.input_size}")
    if cfg.use_bn != ("bn" in params) or cfg.spectral_norm != ("u" in params["fc0"]):
        raise ValueError("batch-norm / spectral-norm entries do not match the config")
    return params


def vgg_feat_from_jax(tree: dict) -> dict:
    """JAX perceptual-net pytree (``{"layers": [...], "pretrained": bool}``,
    numpy leaves) → the port's params."""
    return {"layers": _to_torch(list(tree["layers"])), "pretrained": bool(tree["pretrained"])}


def gan_trainer_state_from_jax(state: dict, net_g: RRDBNetConfig, net_d) -> dict:
    """A JAX ``GANTrainer`` state with numpy leaves (``g_params`` canonical,
    ``d_params``, ``g_opt`` / ``d_opt`` optax ``ScaleByAdamState``s, ``step``)
    → the port's GAN trainer state on the CPU. ``f_params``, if present,
    crosses through :func:`vgg_feat_from_jax`. Hand the parameter trees to
    ``GANTrainer.ingest_params`` / ``ingest_d_params`` to continue the run."""
    if "trunk_ct" in state["g_params"]:
        raise ValueError("this state holds prepared trunk_ct masters (the JAX package's "
                         "kernel layout); convert it with "
                         "esrganplus_tpu.models.rrdb.unprep_trunk_ct (params and both "
                         "Adam moments) before carrying it across")
    out = {"step": int(np.asarray(state["step"]))}
    for key, opt_key, conv in (("g_params", "g_opt", lambda t: from_jax_params(t, net_g)),
                               ("d_params", "d_opt", lambda t: discriminator_from_jax(t, net_d))):
        adam = _find_adam(state[opt_key])
        if adam is None:
            raise ValueError(f"no ScaleByAdamState(count, mu, nu) in {opt_key}")
        out[key] = conv(state[key])
        out[opt_key] = {"count": int(np.asarray(adam.count)), "mu": conv(adam.mu),
                        "nu": conv(adam.nu)}
    if "f_params" in state:
        out["f_params"] = vgg_feat_from_jax(state["f_params"])
    return out


def rdb_t_weights_from_jax(ws) -> tuple:
    """The JAX package's ``prepare_rdb_t_weights`` output as numpy arrays,
    ``(w1, .., w5, w11, bias)`` → the port's tensors for
    ``kernels/rdb_t.py``: the same layouts (``w_k`` ``[S_k, 9·C_prefix_k]``,
    ``w11`` ``[gc, nf]``, ``bias`` ``[nf + 4·gc, 1]`` packed b5 first), each
    in its array's dtype (the bias in fp32), contiguous on the CPU."""
    if len(ws) != 7:
        raise ValueError(f"expected (w1, .., w5, w11, bias), got {len(ws)} arrays")
    *mats, bias = ws
    gc, nf = np.shape(mats[5])
    for k, w in enumerate(mats[:5], 1):
        want = (nf if k == 5 else gc, 9 * (nf + (k - 1) * gc))
        if np.shape(w) != want:
            raise ValueError(f"w{k}: shape {np.shape(w)}, expected {want}")
    if np.shape(bias) != (nf + 4 * gc, 1):
        raise ValueError(f"bias: shape {np.shape(bias)}, expected {(nf + 4 * gc, 1)}")
    conv = lambda a: (torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
                      if np.asarray(a).dtype.name == "bfloat16"
                      else torch.from_numpy(np.array(a, np.float32)))
    return (*(conv(w).contiguous() for w in mats),
            torch.from_numpy(np.array(bias, np.float32)).contiguous())
