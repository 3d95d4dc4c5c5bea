"""Checkpoint / resume.

Counterpart of ``esrganplus_tpu/train/checkpoint.py`` (reference semantics,
``codes/models/base_model.py:50-85``): per-network weight files
``<iter>_G.pth`` / ``<iter>_D.pth`` plus a trainer-state file with iteration, optimizer state and
parameters, saved every ``save_checkpoint_freq`` and restored via
``resume_state``.

The full train state is one ``<iter>.state.npz``: leaves flattened in a
fixed order (dict keys sorted, the order ``jax.tree_util.tree_flatten`` gives
the JAX package's files), restored against a template state from
``trainer.init_state``. Generator (and, for the GAN trainers, discriminator)
weights are additionally exported as reference-layout ``.pth`` so the upstream tools and both packages can consume
the checkpoints.

The port's trainers keep one layout, the canonical tree. :func:`load_state`
reads what they wrote; :func:`load_state_auto` also reads what the JAX
package's trainers wrote: a canonical state (the same leaf order), a state
whose generator masters and Adam moments are in its prepared-trunk layout
(converted back exactly), and a GAN state that carries ``f_params``, the
frozen VGG19, which the port keeps on the trainer (dropped by the template's
structure: where that key sorts among its keys, as many leaves as the file
has beyond it). An SFT-GAN state crosses the same way: the port's two-group
``g_opt`` (``{"other", "sft"}``, each ``{"count", "mu", "nu"}`` with None at
the other group's leaves) flattens in the order of the JAX package's
``multi_transform`` state, whose masked leaves have no entries.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

import numpy as np
import torch

from esrganplus_tpu_torch.train.sr_model import tree_unflatten_like, tree_leaves, tree_map

STATE_SUFFIX = ".state.npz"


def _to_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_state(path: str, state) -> None:
    leaves = [_to_numpy(l) for l in tree_leaves(state)]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = {f"leaf_{i}": leaf for i, leaf in enumerate(leaves)}
    meta = {"n_leaves": len(leaves)}
    # write-then-rename: a crash mid-write must not leave a truncated file
    # where resume expects a checkpoint (np.savez appends '.npz' to bare
    # paths, so hand it an open handle)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __meta__=json.dumps(meta), **arrays)
    os.replace(tmp, path)


def device_snapshot(tree):
    """A copy of every tensor leaf on its device. The train step updates its
    state in place, so a background write must read from a snapshot."""
    return tree_map(lambda a: a.detach().clone() if torch.is_tensor(a) else a, tree)


class AsyncCheckpointer:
    """Background checkpoint writer: ``save()`` snapshots the state on the
    device (fast), then fetches and writes it, plus any caller-supplied
    export, in a daemon thread, so the train loop only pays the device copy.
    One write in flight at a time: a new save first waits out the previous
    one; call ``wait()`` before process exit so the last write lands."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: str, state, export_fn=None) -> None:
        self.wait()
        snap = device_snapshot(state)
        done = None
        if torch.cuda.is_available() and any(
                torch.is_tensor(l) and l.is_cuda for l in tree_leaves(snap)):
            done = torch.cuda.Event()
            done.record()  # the copies are queued on this thread's stream

        def work():
            try:
                if done is not None:
                    done.synchronize()
                save_state(path, snap)
                if export_fn is not None:
                    export_fn(snap)
            except BaseException as e:  # surfaced on the next wait()/save()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the in-flight write (if any) finished; re-raise its
        error, if it had one, on the caller's thread."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def load_state(path: str, template_state):
    """Restore into the structure of ``template_state`` (shape-checked):
    tensors land on the template leaf's device with its dtype and
    ``requires_grad``, integers stay integers."""
    return _restore(_read_leaves(path)[0], template_state)


# Top-level state entries a JAX trainer saves and the port keeps elsewhere:
# the GAN trainer's frozen perceptual net (the port's ``GANTrainer.f_params``).
HELD_ON_TRAINER = ("f_params",)


def _read_leaves(path: str):
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        leaves = [data[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    return leaves, meta


def _restore(leaves, template_state):
    t_leaves = tree_leaves(template_state)
    if len(t_leaves) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves but template has {len(t_leaves)} "
            "— config mismatch?")
    restored = []
    for i, (a, b) in enumerate(zip(leaves, t_leaves)):
        if tuple(a.shape) != tuple(np.shape(b) if not torch.is_tensor(b) else b.shape):
            raise ValueError(f"leaf {i} shape {a.shape} != template {tuple(np.shape(b))}")
        if torch.is_tensor(b):
            t = torch.from_numpy(np.array(a)).to(b.device, b.dtype)
            restored.append(t.requires_grad_(b.requires_grad))
        else:
            restored.append(type(b)(a))
    return tree_unflatten_like(template_state, iter(restored))


def _toggle_g_repr(tree, net_cfg):
    """Every generator-shaped subtree (params and Adam moments alike) to the
    JAX trainers' prepared-master layout, or back from it."""
    from esrganplus_tpu_torch.models.rrdb import jax_master_prep_trunk, jax_master_unprep_trunk

    if isinstance(tree, dict):
        if "trunk" in tree and "trunk_conv" in tree:
            return jax_master_prep_trunk(tree, net_cfg)
        if "trunk_ct" in tree:
            return jax_master_unprep_trunk(tree, net_cfg)
        return {k: _toggle_g_repr(v, net_cfg) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_toggle_g_repr(v, net_cfg) for v in tree]
    return tree


def _without_held(leaves, template):
    """``leaves`` less the block of the top-level entry a JAX trainer saves
    and the template lacks (``HELD_ON_TRAINER``), or None where there is
    none. Leaves are flattened with sorted keys, so the block starts after
    the template's leaves under keys that sort before it, and its length is
    the file's surplus over the template."""
    held = [k for k in HELD_ON_TRAINER if k not in template] if isinstance(template, dict) else []
    surplus = len(leaves) - len(tree_leaves(template))
    if len(held) != 1 or surplus <= 0:
        return None
    off = sum(len(tree_leaves(v)) for k, v in template.items() if k < held[0])
    return leaves[:off] + leaves[off + surplus:]


def load_state_auto(path: str, template_state, net_cfg=None):
    """:func:`load_state` that also reads the states the JAX package's
    trainers write (the role of its ``load_state_auto``):

    * top-level entries the port holds on the trainer (``HELD_ON_TRAINER``:
      a GAN state's ``f_params``) are dropped where the template lacks them
      (:func:`_without_held`);
    * a state saved with prepared-trunk masters (an RRDBNet ``net_cfg``) is
      restored into the template toggled to that layout and converted back,
      Adam moments included; the result lands on the template's devices,
      dtypes and ``requires_grad``.

    A genuine config mismatch raises the plain restore's error."""
    from esrganplus_tpu_torch.models.rrdb import RRDBNetConfig

    leaves, _ = _read_leaves(path)
    try:
        return _restore(leaves, template_state)
    except ValueError as orig:
        plain_error = orig
    dropped = _without_held(leaves, template_state)
    if dropped is not None:
        try:
            return _restore(dropped, template_state)
        except ValueError:
            pass
    if isinstance(net_cfg, RRDBNetConfig):
        with torch.no_grad():
            alt = _toggle_g_repr(template_state, net_cfg)
        for cand in (leaves, _without_held(leaves, alt)):
            if cand is None:
                continue
            try:
                loaded = _toggle_g_repr(_restore(cand, alt), net_cfg)
            except ValueError:
                continue
            back = [a.detach().to(b.device, b.dtype).contiguous()
                    .requires_grad_(b.requires_grad) if torch.is_tensor(b) else a
                    for a, b in zip(tree_leaves(loaded), tree_leaves(template_state))]
            return tree_unflatten_like(template_state, iter(back))
    raise plain_error


def save_networks_pth(models_dir: str, tag, g_params, g_cfg, d_params=None, d_cfg=None) -> None:
    """Export network weights in reference-layout .pth: ``<tag>_G.pth`` and,
    with a discriminator, ``<tag>_D.pth`` (by ``d_cfg``; SFT-GAN's ACD,
    which has no config, where ``g_cfg`` is an ``SFTNetConfig``)."""
    from esrganplus_tpu_torch.convert.pth import (discriminator_sn_to_state_dict,
                                                  discriminator_to_state_dict,
                                                  generator_to_state_dict)
    from esrganplus_tpu_torch.models.sft import SFTNetConfig, acd_to_state_dict

    os.makedirs(models_dir, exist_ok=True)
    cpu = lambda tree: tree_map(lambda p: p.detach().cpu(), tree)
    sd = {k: v.clone() for k, v in generator_to_state_dict(cpu(g_params), g_cfg).items()}
    torch.save(sd, os.path.join(models_dir, f"{tag}_G.pth"))
    if d_params is None:
        return
    if isinstance(g_cfg, SFTNetConfig):
        sd_d = acd_to_state_dict(cpu(d_params))
    elif d_cfg is not None:
        to_sd = (discriminator_sn_to_state_dict if d_cfg.spectral_norm
                 else discriminator_to_state_dict)
        sd_d = to_sd(cpu(d_params), d_cfg)
    else:
        return
    torch.save({k: v.clone() for k, v in sd_d.items()}, os.path.join(models_dir, f"{tag}_D.pth"))


def latest_state_path(state_dir: str) -> Optional[str]:
    if not os.path.isdir(state_dir):
        return None
    states = [f for f in os.listdir(state_dir) if f.endswith(STATE_SUFFIX)]
    if not states:
        return None
    states.sort(key=lambda f: int(f.split(".")[0]))
    return os.path.join(state_dir, states[-1])
