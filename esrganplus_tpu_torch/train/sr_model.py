"""PSNR-oriented L1/L2 trainer for the RRDB and SRResNet generators.

Counterpart of ``esrganplus_tpu/train/sr_model.py`` (the reference's
``SRModel``, ``codes/models/SR_model.py:15-151``): pixel loss (L1 or MSE),
Adam, MultiStepLR, the nESRGAN+ noise sites active during training. One
device a process; under a process group (``parallel/mesh.py``) each rank
steps on its rows of the global batch, the gradients are all-reduced
before the clip and Adam, and the logs are the global batch's.

What differs from the JAX trainer, by design:

  * The state is updated in place: ``train_step`` returns the dict it was
    given (parameters and Adam moments are the same tensors, advanced), where
    the JAX step donates its buffers and returns new ones.
  * The CUDA kernels take the canonical HWIO weights directly, so there is no
    "prepared master" layout: ``prep_trunk`` is carried in the config and read
    by nothing, ``mask_trunk_ct_grads`` has no counterpart, and
    ``ingest_params`` / ``canonical_params`` only place the tree on the device.
  * Every value of a step that varies by step (the learning rates, Adam's
    bias corrections, the keys of every random draw) is read from one row of
    device scalars (``train/step_scalars.py``) that the host fills and
    uploads; the host keeps ``state["step"]``, each Adam ``count`` and the
    parameter version as Python ints and advances them itself
    (:meth:`GeneratorTrainerBase.advance`). The eager ``train_step`` and the
    resident step, which on the card is a replay of a captured CUDA graph
    (``train/resident_exec.py``), run the same body (``_step``).
  * ``train_step_resident`` (all three trainers) samples each step's batch
    on the device from a ``data.resident.ResidentCropStore`` and runs a burst
    of ``n_steps`` steps: one dispatch of a captured graph a step on the card,
    where the JAX package runs the burst in one compiled loop.
  * ``rng`` is the run's integer seed. Every draw of step s is Philox under a
    key derived from (seed, s) (``train/rng.py``) where JAX folds s into a
    key. With ``noise_kernel="fused"`` under ``noise_prng: "rbg"`` the
    per-RDB sites are drawn inside the kernels from their keys; under
    "threefry" the fused mode takes the between-kernels path, as the JAX
    gate does for threefry keys.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from esrganplus_tpu_torch.infer import resolve_device
from esrganplus_tpu_torch.models import generator_forward, generator_init
from esrganplus_tpu_torch.models.layers import deterministic_convs, fp32_exact
from esrganplus_tpu_torch.parallel import mesh
from esrganplus_tpu_torch.models.rrdb import (RRDBNetConfig, fused_noise_active,
                                              needs_kernel_weights, noise_active,
                                              prep_trunk_ct)
from esrganplus_tpu_torch.train.schedule import multistep_lr
from esrganplus_tpu_torch.train.step_scalars import RowUploader, ScalarLayout, adam_bias
from esrganplus_tpu_torch.utils.trace import end_phase, phase, phase_at_grad


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

    def bias(self, count: int) -> tuple:
        """The fp32 bias corrections of the ``count``-th update."""
        return adam_bias(self.b1, self.b2, count)

    @torch.no_grad()
    def moments(self, grads, opt_state: dict, params, c1, c2):
        """Advance the moments in place → the updates, with the bias
        corrections ``c1``, ``c2`` (0-dim fp32 tensors on the device, or
        floats) of this update. The count is the caller's to advance."""
        if self.weight_decay:
            grads = tree_map(lambda g, p: g + self.weight_decay * p, grads, params)
        if self.grad_clip:
            norm = global_norm(grads)
            scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                                self.grad_clip / norm)
            grads = tree_map(lambda g: g * scale, grads)

        def one(g, mu, nu):
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            return (mu / c1) / ((nu / c2).sqrt() + self.eps)

        return tree_map(one, grads, opt_state["mu"], opt_state["nu"])


@torch.no_grad()
def apply_updates(params, updates, lr: torch.Tensor) -> None:
    """``p ← p − lr·u`` in place (optax's ``-lr·u`` added: the same bits);
    ``lr`` a 0-dim tensor on the device."""
    tree_map(lambda p, u: p.sub_(u.mul_(lr)), params, updates)


def make_optimizer(cfg: SRTrainConfig):
    """(Adam-moment transform, lr schedule).

    Trainers apply ``-lr(global_step)`` themselves so MultiStepLR follows the
    global iteration (torch semantics: the reference steps every scheduler
    each iteration, ``base_model.py:35-40``); Adam's bias-correction count
    advances per applied update."""
    sched = multistep_lr(cfg.lr, cfg.milestones, cfg.lr_gamma)
    return AdamTransform(cfg.beta1, cfg.beta2, cfg.weight_decay, cfg.grad_clip), sched


class GeneratorTrainerBase:
    """What the three trainers share: the device, the compute dtype, the
    host's side of a step (its row of device scalars, the gates, the Adam
    counts, the step), the eager and the resident step around the body each
    trainer writes (``_step``), and the generator's parameter representation
    and eval-mode forward.

    A subclass names its optimizer groups (``GROUPS``), their Adam transform,
    lr schedule and state (:meth:`_group`), the gates of a 1-based step
    (:meth:`gates`, a tuple of bools: part of a captured step's key) and the
    groups a step with those gates updates (:meth:`open_groups`)."""

    GROUPS = ("g",)
    G_GROUPS = ("g",)  # the groups whose update changes the generator

    def __init__(self, net_cfg, compute_dtype: Optional[str], device):
        self.net_cfg = net_cfg
        self.device = resolve_device(device)
        if compute_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(f"compute_dtype {compute_dtype!r}: None or 'bfloat16'")
        self._dtype = torch.bfloat16 if compute_dtype == "bfloat16" else None
        self._eval_weights = None  # (params version, kernels' inference weights)
        self._version = 0
        self._uploader = RowUploader(self.device)
        self._resident = None  # train/resident_exec.ResidentExecutor, at first use
        noisy = isinstance(net_cfg, RRDBNetConfig) and noise_active(net_cfg, True)
        self.scalars = ScalarLayout(self.GROUPS, net_cfg.nb if noisy else 0)

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

    # -- the host's side of a step ----------------------------------------

    def _group(self, state: dict, group: str) -> tuple:
        """(Adam transform, lr schedule, its optimizer state) of ``group``."""
        return self.tx, self.lr_schedule, state["opt_state"]

    def gates(self, gstep: int) -> tuple:
        """The host gates of the 1-based step ``gstep``."""
        return ()

    def open_groups(self, gates: tuple) -> tuple:
        """The groups a step with ``gates`` updates."""
        return self.GROUPS

    def plan(self, state: dict, rng: int) -> tuple:
        """The row of device scalars of the state's next step and its gates →
        (int32 row, gates), from (``rng``, the step, each open group's next
        Adam count): nothing is advanced."""
        step = int(state["step"])
        gates = self.gates(step + 1)
        lrs, bias = {}, {}
        for g in self.GROUPS:
            tx, sched, opt = self._group(state, g)
            lrs[g] = sched(step + 1)
            if g in self.open_groups(gates):
                bias[g] = tx.bias(int(opt["count"]) + 1)
        return self.scalars.row(rng, step, lrs, bias), gates

    def advance(self, state: dict, gates: tuple) -> None:
        """The host's mirror of one step with ``gates``: the step, each open
        group's Adam count and the generator's parameter version."""
        opened = self.open_groups(gates)
        for g in opened:
            opt = self._group(state, g)[2]
            opt["count"] = int(opt["count"]) + 1
        if any(g in self.G_GROUPS for g in opened):
            self._version += 1
        state["step"] = int(state["step"]) + 1

    def _fused(self, impl: str) -> bool:
        """The fused noise mode draws the per-RDB sites in the kernels: an
        RRDBNet with ``noise_kernel="fused"`` under the "rbg" contract (under
        "threefry" it takes the between-kernels path, as the JAX gate does)."""
        return (isinstance(self.net_cfg, RRDBNetConfig) and self.scalars.n_blocks > 0
                and fused_noise_active(self.net_cfg, True, impl))

    def _noise(self, sc, impl: str) -> dict:
        """The generator's noise keywords from the step's scalars ``sc``:
        the site keys as its ``rng``, and under the fused mode the per-RDB
        ones as ``noise_seeds``."""
        if not self.scalars.n_blocks:
            return {}
        keys = sc.site_keys
        return {"rng": keys, "noise_seeds": keys[:, :3] if self._fused(impl) else None}

    # -- steps ---------------------------------------------------------------

    def _to_device(self, batch) -> tuple:
        """A host-fed batch (LR, HR) as float32 tensors on the device."""
        return tuple(torch.as_tensor(a, dtype=torch.float32).to(self.device) for a in batch)

    def train_step(self, state: dict, batch, rng: int = 0):
        """One optimizer step, in place, on ``batch`` (tensors or numpy, as
        :meth:`_to_device` takes them); ``rng`` the run's seed. Its scalars
        are uploaded as one row, then the body runs eagerly. Returns (state,
        logs); the logs are 0-dim tensors on the device, so nothing here
        waits for the card."""
        batch = self._to_device(batch)
        row, gates = self.plan(state, rng)
        try:
            logs = self._step(state, batch, self.scalars.view(self._uploader.upload(row)), gates)
        finally:
            end_phase()
        self.advance(state, gates)
        return state, logs

    def train_step_resident(self, state: dict, store, rng: int, batch_size: int,
                            n_steps: int = 1):
        """``n_steps`` steps, each on a batch sampled on the device from
        ``store`` (``data/resident.py``) under the step's key → (state, the
        last step's logs). On the card each step is a replay of a captured
        CUDA graph (``train/resident_exec.py``); on the CPU the same body
        runs eagerly. The batch never leaves the device."""
        from esrganplus_tpu_torch.train.resident_exec import train_step_resident

        return train_step_resident(self, state, store, rng, batch_size, n_steps)

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
    """PSNR pretrainer on one device a process (the card unless ``device="cpu"``);
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

    def _loss_fn(self, params, lr_img, hr_img, noise: dict):
        phase("g.fwd")
        fake = phase_at_grad(generator_forward(params, lr_img, self.net_cfg, train=True,
                                               noise_prng=self.train_cfg.noise_prng,
                                               dtype=self._dtype, **noise), "g.bwd")
        phase("loss")
        l_pix = self.train_cfg.pixel_weight * pixel_loss(
            fake.float(), hr_img.float(), self.train_cfg.pixel_criterion)
        return l_pix, fake

    def _step(self, state: dict, batch: tuple, sc, gates: tuple) -> dict:
        """The step's body on device tensors (LR, HR NHWC float32 [0,1]),
        its every step-dependent value read from the scalars ``sc``: the
        parameters and the moments advance in place; nothing on the host
        changes (:meth:`advance` does that). → logs, 0-dim tensors."""
        lr_img, hr_img = batch
        leaves = tree_leaves(state["params"])
        # fea_conv is cuDNN's, forward and backward: full fp32 where fp32 is
        # asked for, and algorithms that repeat bit for bit
        with fp32_exact(), deterministic_convs():
            loss, _ = self._loss_fn(state["params"], lr_img, hr_img,
                                    self._noise(sc, self.train_cfg.noise_prng))
            flat = torch.autograd.grad(loss, leaves)
        phase("g.opt")
        grads = tree_unflatten_like(state["params"], iter(mesh.all_reduce_grads(list(flat))))
        updates = self.tx.moments(grads, state["opt_state"], state["params"], *sc.bias("g"))
        apply_updates(state["params"], updates, sc.lr("g"))
        phase("logs")
        with torch.no_grad():
            grad_norm = global_norm(grads)
        return mesh.reduce_logs({"l_pix": loss.detach(), "lr": sc.lr("g"),
                                 "grad_norm": grad_norm})
