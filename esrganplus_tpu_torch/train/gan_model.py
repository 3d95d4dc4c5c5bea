"""GAN trainers: standard SRGAN and the ESRGAN+ relativistic-average (SRRaGAN).

Counterpart of ``esrganplus_tpu/train/gan_model.py`` (the reference wrappers
``codes/models/SRGAN_model.py``, ``codes/models/SRRaGAN_model.py``), one
device a process (data parallelism as in ``train/sr_model.py``: the RaGAN
pairing's means, D's batch statistics and WGAN-GP's draws are the global
batch's):

  * G loss = pixel (L1/L2) + VGG-perceptual L1 (real features detached) + GAN
    term: relativistic pairing for srragan, plain D(fake)-vs-real for srgan;
  * D loss = RaGAN pair / standard BCE with the fake branch detached, plus
    optional WGAN-GP;
  * G updates are gated by ``D_update_ratio`` / ``D_init_iters`` on the
    1-based step; D updates every step;
  * D is frozen during the G phase: its parameters enter that forward
    detached, so no D weight gradient is computed (and the stage kernels
    launch only their data-gradient half); the perceptual net's weights never
    require gradients.

One step runs D three times: D(real) once with a graph to D's parameters (its
value, detached, pairs the RaGAN G loss; its graph serves the D loss),
D(fake) in the G phase with D frozen, and D(fake detached) in the D phase.
The JAX step writes four D forwards and lets XLA merge two of them; the values
are the same.

As in the JAX trainer, D's BatchNorm *running* statistics advance with the
two D-phase forwards (real then fake, merged sequentially) and not with the
G-phase one; train-mode BN uses batch statistics, so the training math is the
reference's.

What differs from the JAX trainer, by design: the state is updated in place
and every step-dependent value is read from the step's row of device scalars
(``sr_model.py``); ``rng`` is the run's integer seed; the gate ``do_g`` is
known on the host, so a gated step does not compute G's update at all (and
on the card it is its own captured step); the perceptual net's parameters
live on the trainer (``f_params``), not in the state, so a checkpoint does
not carry the frozen VGG19.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Sequence

import torch

from esrganplus_tpu_torch.infer import params_to
from esrganplus_tpu_torch.losses import gan_loss, gradient_penalty, ragan_d_loss, ragan_g_loss
from esrganplus_tpu_torch.models import generator_forward, generator_init
from esrganplus_tpu_torch.models.discriminator import (DiscriminatorVGGConfig,
                                                       discriminator_forward,
                                                       init_discriminator,
                                                       merge_sequential_bn)
from esrganplus_tpu_torch.models.layers import deterministic_convs, fp32_exact
from esrganplus_tpu_torch.kernels.philox import random_bits
from esrganplus_tpu_torch.models.vgg import VGGFeatConfig, load_vgg_feat, vgg_feat_forward
from esrganplus_tpu_torch.parallel import mesh
from esrganplus_tpu_torch.train.schedule import multistep_lr
from esrganplus_tpu_torch.train.sr_model import (AdamTransform, GeneratorTrainerBase,
                                                 apply_updates, pixel_loss, tree_leaves,
                                                 tree_map, tree_unflatten_like)
from esrganplus_tpu_torch.utils.trace import phase, phase_at_grad


@dataclasses.dataclass(frozen=True)
class GANTrainConfig:
    variant: str = "srragan"  # 'srragan' (ESRGAN+) | 'srgan'
    gan_type: str = "vanilla"  # 'vanilla' | 'lsgan' | 'wgan-gp'
    lr_g: float = 1e-4
    lr_d: float = 1e-4
    beta1_g: float = 0.9
    beta1_d: float = 0.9
    beta2: float = 0.999
    milestones: Sequence[int] = (50_000, 100_000, 200_000, 300_000)
    lr_gamma: float = 0.5
    pixel_criterion: str = "l1"
    pixel_weight: float = 1e-2
    feature_criterion: str = "l1"
    feature_weight: float = 1.0
    gan_weight: float = 5e-3
    d_update_ratio: int = 1
    d_init_iters: int = 0
    gp_weight: float = 10.0
    vgg_path: Optional[str] = None
    compute_dtype: Optional[str] = None
    # 'rbg' | 'threefry' in the JAX package; both map to the port's per-step
    # generator (train/rng.py)
    noise_prng: str = "rbg"
    # the JAX package's prepared-trunk master layout; nothing to prepare here
    prep_trunk: Optional[bool] = None
    init_scale_g: float = 0.1
    init_scale_d: float = 1.0


class GANTrainer(GeneratorTrainerBase):
    """ESRGAN+/SRGAN trainer on one device a process (the card unless
    ``device="cpu"``);
    ``net_g`` an ``RRDBNetConfig`` or an ``SRResNetConfig``."""

    GROUPS = ("g", "d")

    def __init__(self, net_g, net_d: DiscriminatorVGGConfig,
                 cfg: GANTrainConfig = GANTrainConfig(), device="cuda",
                 vgg_cfg: VGGFeatConfig = VGGFeatConfig()):
        super().__init__(net_g, cfg.compute_dtype, device)
        if cfg.gan_type == "wgan-gp" and net_d.stage_kernel != "plain":
            # the gradient penalty differentiates THROUGH D(x) a second time,
            # which the stage kernels' once-differentiable backward cannot do
            if net_d.stage_kernel == "cuda":
                raise ValueError(
                    "gan_type='wgan-gp' needs second-order autodiff through D, which the "
                    "forced stage kernels do not support: use stage_kernel='auto'/'plain' "
                    "for the wgan-gp D")
            net_d = dataclasses.replace(net_d, stage_kernel="plain")
            if self.device.type == "cuda":
                logging.getLogger("base").info(
                    "gan_type='wgan-gp': the discriminator runs the plain graph (the "
                    "gradient penalty needs second-order gradients, which the stage "
                    "kernels do not give)")
        self.net_g = net_g
        self.net_d = net_d
        self.cfg = cfg
        self.vgg_cfg = vgg_cfg
        # the lr schedules follow the GLOBAL step (the reference steps every
        # scheduler each iteration), not Adam's update count, which stands
        # still whenever the G update is gated
        self.sched_g = multistep_lr(cfg.lr_g, cfg.milestones, cfg.lr_gamma)
        self.sched_d = multistep_lr(cfg.lr_d, cfg.milestones, cfg.lr_gamma)
        self.lr_schedule = self.sched_g
        self.tx_g = AdamTransform(cfg.beta1_g, cfg.beta2)
        self.tx_d = AdamTransform(cfg.beta1_d, cfg.beta2)
        self.use_feature = cfg.feature_weight > 0
        self.f_params = (params_to(load_vgg_feat(cfg.vgg_path, vgg_cfg), self.device)
                         if self.use_feature else None)

    # -- state -------------------------------------------------------------

    def init_state(self, seed: int) -> dict:
        g_params = self.ingest_params(
            generator_init(seed, self.net_g, init_scale=self.cfg.init_scale_g))
        d_params = self.ingest_d_params(
            init_discriminator(seed + 1, self.net_d, init_scale=self.cfg.init_scale_d))
        return {"g_params": g_params, "d_params": d_params,
                "g_opt": self.tx_g.init(g_params), "d_opt": self.tx_d.init(d_params),
                "step": 0}

    def ingest_d_params(self, params):
        """Discriminator params → fp32 leaf tensors on the device."""
        return self._as_leaves(params)

    def _group(self, state: dict, group: str) -> tuple:
        if group == "g":
            return self.tx_g, self.sched_g, state["g_opt"]
        return self.tx_d, self.sched_d, state["d_opt"]

    def gates(self, gstep: int) -> tuple:
        """(do_g,): G updates on every ``D_update_ratio``-th 1-based step past
        ``D_init_iters``; D updates every step."""
        return (gstep % self.cfg.d_update_ratio == 0 and gstep > self.cfg.d_init_iters,)

    def open_groups(self, gates: tuple) -> tuple:
        return ("g", "d") if gates[0] else ("d",)

    # -- loss pieces -------------------------------------------------------

    def _d_logits(self, d_params, x, train=True):
        return discriminator_forward(d_params, x, self.net_d, train=train, dtype=self._dtype)

    def _features(self, x):
        return vgg_feat_forward(self.f_params, x, self.vgg_cfg, dtype=self._dtype)

    def _g_loss(self, g_params, d_params, lr_img, hr_img, d_real, noise: dict):
        """(total, fake, logs). ``d_params`` are frozen (detached) here;
        ``d_real`` is D(real)'s detached value for the RaGAN pairing;
        ``noise`` the generator's noise keywords (``rng`` and the fused
        mode's ``noise_seeds``, or pre-drawn ``noise``)."""
        cfg = self.cfg
        phase("g.fwd")
        fake = phase_at_grad(generator_forward(g_params, lr_img, self.net_g, train=True,
                                               noise_prng=cfg.noise_prng, dtype=self._dtype,
                                               **noise), "g.bwd")
        logs = {}
        total = 0.0
        if cfg.pixel_weight > 0:
            phase("loss")
            l_pix = cfg.pixel_weight * pixel_loss(fake.float(), hr_img, cfg.pixel_criterion)
            total = total + l_pix
            logs["l_g_pix"] = l_pix
        if self.use_feature:
            phase("f.fwd")
            with torch.no_grad():
                real_fea = self._features(hr_img)
            fake_fea = phase_at_grad(self._features(fake), "f.bwd")
            phase("loss")
            l_fea = cfg.feature_weight * pixel_loss(
                fake_fea.float(), real_fea.float(), cfg.feature_criterion)
            total = total + l_fea
            logs["l_g_fea"] = l_fea
        phase("d.fwd")
        d_fake = phase_at_grad(self._d_logits(d_params, fake)[0], "d.bwd")
        phase("loss")
        if cfg.variant == "srragan":
            l_gan = cfg.gan_weight * ragan_g_loss(d_real, d_fake, cfg.gan_type)
        else:
            l_gan = cfg.gan_weight * gan_loss(d_fake, True, cfg.gan_type)
        total = total + l_gan
        logs["l_g_gan"] = l_gan
        return total, fake, logs

    def _d_loss(self, d_params, fake, hr_img, key, real=None):
        """(loss, (st_real, st_fake), logs); ``real`` = (logits, new_state)
        of a D(real) forward already made from these ``d_params``; ``key``
        the step's sampler key, whose counter stream 1 gives WGAN-GP's
        interpolation weights."""
        cfg = self.cfg
        phase("d.fwd")
        d_real, st_real = real if real is not None else self._d_logits(d_params, hr_img)
        d_fake, st_fake = self._d_logits(d_params, fake)
        d_real, d_fake = (phase_at_grad(t, "d.bwd") for t in (d_real, d_fake))
        phase("loss")
        if cfg.variant == "srragan":
            loss = ragan_d_loss(d_real, d_fake, cfg.gan_type)
        else:
            loss = (gan_loss(d_real, True, cfg.gan_type)
                    + gan_loss(d_fake, False, cfg.gan_type))
        if cfg.gan_type == "wgan-gp":
            # the global batch's draw, this rank's rows of it
            bits = mesh.local_rows(random_bits(key, mesh.global_rows(hr_img.shape[0]),
                                               stream=1))[:, 0]
            eps = ((bits >> 8).float() * 2.0 ** -24).view(-1, 1, 1, 1)  # U[0, 1)
            loss = loss + cfg.gp_weight * gradient_penalty(
                lambda p, x: self._d_logits(p, x)[0], d_params, hr_img, fake, eps)
        logs = {"l_d_total": loss, "D_real": d_real.mean(), "D_fake": d_fake.mean()}
        return loss, (st_real, st_fake), logs

    # -- step --------------------------------------------------------------

    @staticmethod
    def _apply(tx, params, opt_state, flat_grads, sc, group):
        """One Adam step on ``params`` in place, at ``group``'s lr and bias
        corrections of the step's scalars ``sc``. A leaf the loss does not
        reach (BN running statistics, SN vectors) has a zero gradient."""
        flat = mesh.all_reduce_grads([torch.zeros_like(p) if g is None else g
                                      for g, p in zip(flat_grads, tree_leaves(params))])
        grads = tree_unflatten_like(params, iter(flat))
        apply_updates(params, tx.moments(grads, opt_state, params, *sc.bias(group)),
                      sc.lr(group))

    def _step(self, state: dict, batch: tuple, sc, gates: tuple) -> dict:
        """One G+D step's body on device tensors (LR, HR NHWC float32 [0,1]),
        in place, every step-dependent value read from the scalars ``sc``;
        ``gates`` = (do_g,). → logs, 0-dim tensors on the device."""
        cfg = self.cfg
        lr_img, hr_img = batch
        (do_g,) = gates
        noise = self._noise(sc, cfg.noise_prng)
        g_params, d_params = state["g_params"], state["d_params"]

        # cuDNN runs the deep stages of D and F and fea_conv, forward and
        # backward: full fp32 where fp32 is asked for, and algorithms that
        # repeat bit for bit
        with fp32_exact(), deterministic_convs():
            real = None
            if do_g:
                d_real_value = None
                if cfg.variant == "srragan":
                    phase("d.fwd")
                    real = self._d_logits(d_params, hr_img)
                    d_real_value = real[0].detach()
                frozen = tree_map(lambda p: p.detach(), d_params)
                g_total, fake, g_logs = self._g_loss(g_params, frozen, lr_img, hr_img,
                                                     d_real_value, noise)
                g_grads = torch.autograd.grad(g_total, tree_leaves(g_params))
                phase("g.opt")
                self._apply(self.tx_g, g_params, state["g_opt"], g_grads, sc, "g")
                g_logs = {k: v.detach() for k, v in g_logs.items()}
                g_logs["l_g_total"] = g_total.detach()
            else:
                phase("g.fwd")
                with torch.no_grad():
                    fake = generator_forward(g_params, lr_img, self.net_g, train=True,
                                             noise_prng=cfg.noise_prng, dtype=self._dtype,
                                             **noise)
                keys = (["l_g_pix"] if cfg.pixel_weight > 0 else []) \
                    + (["l_g_fea"] if self.use_feature else []) + ["l_g_gan", "l_g_total"]
                g_logs = {k: torch.zeros((), device=self.device) for k in keys}

            # ---- D update (every step; fake detached) ----
            d_total, (st_real, st_fake), d_logs = self._d_loss(d_params, fake.detach(), hr_img,
                                                               sc.sample_key, real)
            d_grads = torch.autograd.grad(d_total, tree_leaves(d_params), allow_unused=True)
            phase("d.opt")
            self._apply(self.tx_d, d_params, state["d_opt"], d_grads, sc, "d")
        # running statistics as torch leaves them after D(real) then D(fake)
        phase("bn")
        with torch.no_grad():
            merged = merge_sequential_bn(d_params, st_real, st_fake, self.net_d)
            tree_map(lambda p, m: p if p is m else p.copy_(m), d_params, merged)

        phase("logs")
        return mesh.reduce_logs({**g_logs, **{k: v.detach() for k, v in d_logs.items()},
                                 "lr": sc.lr("g")})
