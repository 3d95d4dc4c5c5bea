"""PSNR-oriented L1/L2 trainer for the RRDB and SRResNet generators.

Counterpart of ``esrganplus_tpu/train/sr_model.py`` (the reference's
``SRModel``, ``codes/models/SR_model.py:15-151``): pixel loss (L1 or MSE),
Adam, MultiStepLR, the nESRGAN+ noise sites active during training. One
device; data parallelism comes with the DDP slice.

What differs from the JAX trainer, by design:

  * The state is updated in place: ``train_step`` returns the dict it was
    given (parameters and Adam moments are the same tensors, advanced), where
    the JAX step donates its buffers and returns new ones.
  * The CUDA kernels take the canonical HWIO weights directly, so there is no
    "prepared master" layout: ``prep_trunk`` is carried in the config and read
    by nothing, ``mask_trunk_ct_grads`` has no counterpart, and
    ``ingest_params`` / ``canonical_params`` only place the tree on the device.
  * ``train_step_resident`` (both trainers) samples the step's batch on the
    device from a ``data.resident.ResidentCropStore`` and runs ``train_step``
    on it: one step a call, where the JAX package runs a burst of
    ``steps_per_dispatch`` steps in one compiled loop.
  * ``rng`` is the run's integer noise seed; the trainer folds the step into
    a device generator (``train/rng.py``) where JAX folds it into a key. With
    ``noise_kernel="fused"`` under ``noise_prng: "rbg"`` it also derives each
    per-RDB site's Philox key from (seed, step) (``site_seeds``), which the
    kernels draw from; under "threefry" the fused mode takes the
    between-kernels path, as the JAX gate does for threefry keys.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from esrganplus_tpu_torch.infer import resolve_device
from esrganplus_tpu_torch.models import generator_forward, generator_init
from esrganplus_tpu_torch.models.layers import deterministic_convs, fp32_exact
from esrganplus_tpu_torch.models.rrdb import (RRDBNetConfig, needs_kernel_weights,
                                              prep_trunk_ct)
from esrganplus_tpu_torch.train.rng import noise_generator, sample_seed, site_seeds
from esrganplus_tpu_torch.train.schedule import multistep_lr


@dataclasses.dataclass(frozen=True)
class SRTrainConfig:
    lr: float = 2e-4
    beta1: float = 0.9
    beta2: float = 0.999
    milestones: Sequence[int] = (200_000, 400_000, 600_000, 800_000)
    lr_gamma: float = 0.5
    pixel_criterion: str = "l1"  # 'l1' | 'l2'
    pixel_weight: float = 1.0
    weight_decay: float = 0.0
    grad_clip: Optional[float] = None
    compute_dtype: Optional[str] = None  # None (fp32) | 'bfloat16'
    init_scale: float = 0.1
    # 'rbg' | 'threefry' in the JAX package; both map to the port's per-step
    # generator (train/rng.py)
    noise_prng: str = "rbg"
    # the JAX package's prepared-trunk master layout; nothing to prepare here
    prep_trunk: Optional[bool] = None


def pixel_loss(pred, target, criterion: str):
    if criterion == "l1":
        return (pred - target).abs().mean()
    if criterion == "l2":
        return ((pred - target) ** 2).mean()
    raise NotImplementedError(f"pixel criterion [{criterion}]")


def tree_leaves(tree) -> list:
    """Leaves of a dict/list tree in a fixed order: dict keys sorted, None
    an empty subtree, as ``jax.tree_util.tree_flatten`` orders them."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_unflatten_like(tree, it):
    """A tree shaped like ``tree`` filled from ``it`` in :func:`tree_leaves` order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: tree_unflatten_like(tree[k], it) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return [tree_unflatten_like(v, it) for v in tree]
    return next(it)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum((l.float() ** 2).sum() for l in tree_leaves(tree)))


class AdamTransform:
    """The Adam-moment transform WITHOUT the lr scaling, as
    ``optax.chain(add_decayed_weights, clip_by_global_norm, scale_by_adam)``:
    L2 weight decay added to the gradient first (torch Adam's
    ``weight_decay``), then the global-norm clip, then
    ``m̂ / (√v̂ + eps)`` with eps = 1e-8 outside the root and the bias
    correction driven by the count of applied updates."""

    def __init__(self, b1: float, b2: float, weight_decay: float = 0.0,
                 grad_clip: Optional[float] = None, eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.grad_clip = weight_decay, grad_clip

    def init(self, params) -> dict:
        zeros = lambda p: torch.zeros_like(p, requires_grad=False)
        return {"count": 0, "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def update(self, grads, opt_state: dict, params):
        """→ (updates, new_opt_state). The moments are advanced in place."""
        if self.weight_decay:
            grads = tree_map(lambda g, p: g + self.weight_decay * p, grads, params)
        if self.grad_clip:
            norm = global_norm(grads)
            scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                                self.grad_clip / norm)
            grads = tree_map(lambda g: g * scale, grads)
        count = opt_state["count"] + 1
        c1, c2 = 1.0 - self.b1 ** count, 1.0 - self.b2 ** count

        def one(g, mu, nu):
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            return (mu / c1) / ((nu / c2).sqrt() + self.eps)

        updates = tree_map(one, grads, opt_state["mu"], opt_state["nu"])
        return updates, {"count": count, "mu": opt_state["mu"], "nu": opt_state["nu"]}


def make_optimizer(cfg: SRTrainConfig):
    """(Adam-moment transform, lr schedule).

    Trainers apply ``-lr(global_step)`` themselves so MultiStepLR follows the
    global iteration (torch semantics: the reference steps every scheduler
    each iteration, ``base_model.py:35-40``); Adam's bias-correction count
    advances per applied update."""
    sched = multistep_lr(cfg.lr, cfg.milestones, cfg.lr_gamma)
    return AdamTransform(cfg.beta1, cfg.beta2, cfg.weight_decay, cfg.grad_clip), sched


class GeneratorTrainerBase:
    """What the PSNR and the GAN trainer share: the device, the compute
    dtype, the per-step noise generator, and the generator's parameter
    representation and eval-mode forward."""

    def __init__(self, net_cfg, compute_dtype: Optional[str], device):
        self.net_cfg = net_cfg
        self.device = resolve_device(device)
        if compute_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(f"compute_dtype {compute_dtype!r}: None or 'bfloat16'")
        self._dtype = torch.bfloat16 if compute_dtype == "bfloat16" else None
        self._noise_gen = torch.Generator(device=self.device)
        self._eval_weights = None  # (params version, kernels' inference weights)
        self._version = 0

    def _as_leaves(self, params):
        """A parameter tree as fp32 leaf tensors on the device."""
        return tree_map(lambda p: p.detach().to(self.device, torch.float32).clone()
                        .requires_grad_(True), params)

    def ingest_params(self, params):
        """Canonical generator params → the trainer's representation: the
        same tree as fp32 leaf tensors on the device (nothing is re-laid
        out; see the module docstring)."""
        self._version += 1
        return self._as_leaves(params)

    def canonical_params(self, params):
        """State representation → canonical tree (detached; the identity
        otherwise)."""
        return tree_map(lambda p: p.detach(), params)

    def _site_seeds(self, seed: int, step: int, impl: str):
        """The fused noise mode's per-RDB Philox keys for ``step`` (Python
        ints, no device work), or None where the mode does not draw
        in-kernel: another ``noise_kernel``, the "threefry" contract, or a
        generator without noise sites (SRResNet)."""
        if (not isinstance(self.net_cfg, RRDBNetConfig) or self.net_cfg.noise_kernel != "fused"
                or impl != "rbg"):
            return None
        return site_seeds(seed, step, self.net_cfg.nb)

    def train_step_resident(self, state: dict, store, rng: int, batch_size: int):
        """``train_step`` on a batch sampled on the device from ``store``
        (``data/resident.py``) with a generator seeded from (``rng``, the
        state's step) → (state, logs). The batch never leaves the device."""
        batch = store.make_sampler(batch_size)(sample_seed(rng, int(state["step"])))
        return self.train_step(state, batch, rng)

    def predict(self, params, lr_img) -> torch.Tensor:
        """Eval-mode forward of NHWC [0,1] input (numpy or tensor) → fp32
        tensor on the device. On the card this is the inference kernel path;
        its weights are converted once per parameter version (an RRDBNet's
        only: SRResNet runs no kernel)."""
        x = torch.as_tensor(lr_img, dtype=torch.float32).to(self.device)
        kdt = self._dtype or torch.float32
        with torch.inference_mode():
            p = self.canonical_params(params)
            if needs_kernel_weights(self.net_cfg, self.device, kdt):
                if self._eval_weights is None or self._eval_weights[0] != self._version:
                    self._eval_weights = (self._version, prep_trunk_ct(p, self.net_cfg, kdt))
                p = self._eval_weights[1]
            return generator_forward(p, x, self.net_cfg, train=False, dtype=self._dtype)


class SRTrainer(GeneratorTrainerBase):
    """PSNR pretrainer on one device (the card unless ``device="cpu"``);
    ``net_cfg`` an ``RRDBNetConfig`` or an ``SRResNetConfig``."""

    def __init__(self, net_cfg, train_cfg: SRTrainConfig = SRTrainConfig(),
                 device="cuda"):
        super().__init__(net_cfg, train_cfg.compute_dtype, device)
        self.train_cfg = train_cfg
        self.tx, self.lr_schedule = make_optimizer(train_cfg)

    # -- state -------------------------------------------------------------

    def init_state(self, seed: int) -> dict:
        params = self.ingest_params(
            generator_init(seed, self.net_cfg, init_scale=self.train_cfg.init_scale))
        return {"params": params, "opt_state": self.tx.init(params), "step": 0}

    # -- steps -------------------------------------------------------------

    def _loss_fn(self, params, lr_img, hr_img, rng, noise_seeds=None):
        fake = generator_forward(params, lr_img, self.net_cfg, train=True, rng=rng,
                                 noise_seeds=noise_seeds,
                                 noise_prng=self.train_cfg.noise_prng, dtype=self._dtype)
        l_pix = self.train_cfg.pixel_weight * pixel_loss(
            fake.float(), hr_img.float(), self.train_cfg.pixel_criterion)
        return l_pix, fake

    def train_step(self, state: dict, batch, rng: int):
        """One optimizer step, in place. ``batch`` = (LR NHWC, HR NHWC)
        float32 [0,1] (tensors or numpy); ``rng`` the run's noise seed.
        Returns (state, logs); the logs are 0-dim tensors on the device, so
        nothing here waits for the card."""
        lr_img, hr_img = (torch.as_tensor(a, dtype=torch.float32).to(self.device)
                          for a in batch)
        step = int(state["step"])
        gen = noise_generator(self._noise_gen, rng, step, self.train_cfg.noise_prng)
        seeds = self._site_seeds(rng, step, self.train_cfg.noise_prng)
        gstep = step + 1  # 1-based, the reference's current_step
        leaves = tree_leaves(state["params"])
        # fea_conv is cuDNN's, forward and backward: full fp32 where fp32 is
        # asked for, and algorithms that repeat bit for bit
        with fp32_exact(), deterministic_convs():
            loss, _ = self._loss_fn(state["params"], lr_img, hr_img, gen, seeds)
            flat = torch.autograd.grad(loss, leaves)
        grads = tree_unflatten_like(state["params"], iter(flat))
        updates, new_opt = self.tx.update(grads, state["opt_state"], state["params"])
        lr = self.lr_schedule(gstep)
        with torch.no_grad():
            tree_map(lambda p, u: p.add_(u, alpha=-lr), state["params"], updates)
            grad_norm = global_norm(grads)
        self._version += 1
        logs = {"l_pix": loss.detach(), "lr": torch.tensor(lr), "grad_norm": grad_norm}
        state["opt_state"] = new_opt
        state["step"] = step + 1
        return state, logs
