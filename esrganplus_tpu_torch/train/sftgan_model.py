"""SFT-GAN trainer with the auxiliary-classifier discriminator.

Counterpart of ``esrganplus_tpu/train/sftgan_model.py`` (reference
``codes/models/SFTGAN_ACD_model.py``), one device a process (data
parallelism as in ``train/sr_model.py``: the ACD's batch statistics and the
masked cross entropy's count are the global batch's):

  * two generator parameter groups, each with its own Adam state: ``sft``
    (every leaf whose tree path holds ``sft`` or ``cond``: the SFT layers
    and CondNet) at ``sft_lr_mult``× (5×) the lr, and ``other``
    (``SFTGAN_ACD_model.py:81-93``);
  * the gates on the 1-based step: ``sft`` updates when ``step %
    D_update_ratio == 0 and step > D_init_iters``, ``other`` only once
    ``step > other_start_iter`` (20 000, not an option key;
    ``SFTGAN_ACD_model.py:134,148-149``). A gated group keeps its
    parameters AND its Adam moments and count (the reference skips
    ``optimizer.step()``); the lr schedules run off the global step;
  * G loss = pixel + VGG-feature L1 (real features detached) + vanilla GAN
    + ``gan_weight``·CE(cls, category); D loss = BCE on real and fake + CE
    on both class heads; the CE ignores category 0, background, which
    conflicts with the real classes (``SFTGAN_ACD_model.py:74-76``);
  * D's BN running statistics advance with D(real) then D(fake) of the D
    phase (``acd_merge_sequential``), not with the G phase's forward.

As in the port's other trainers: the gates are known on the host, so a
gated group's update is not computed at all where the JAX step selects
with ``jnp.where`` (on the card each gate pattern is its own captured step);
the state is updated in place and every step-dependent value is read from
the step's row of device scalars (``sr_model.py``); the frozen VGG19 lives on
the trainer (``f_params``), not in the state. SFT-GAN has no noise site, so
a step is deterministic given its batch (``deterministic_convs`` covers the
whole step). On the card the SFT net, the ACD and VGG19's deeper stages run
cuDNN / cuBLAS; VGG19's ≤128-channel stages run the stage kernels
(``models/vgg.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from esrganplus_tpu_torch.infer import params_to
from esrganplus_tpu_torch.losses import gan_loss
from esrganplus_tpu_torch.models import generator_init
from esrganplus_tpu_torch.models.layers import deterministic_convs, fp32_exact
from esrganplus_tpu_torch.models.sft import (SFTNetConfig, acd_forward, acd_merge_sequential,
                                             init_acd, is_sft_param, sftnet_forward)
from esrganplus_tpu_torch.models.vgg import VGGFeatConfig, load_vgg_feat, vgg_feat_forward
from esrganplus_tpu_torch.parallel import mesh
from esrganplus_tpu_torch.train.schedule import multistep_lr
from esrganplus_tpu_torch.train.sr_model import (AdamTransform, GeneratorTrainerBase,
                                                 apply_updates, pixel_loss, tree_leaves,
                                                 tree_map, tree_unflatten_like)
from esrganplus_tpu_torch.utils.trace import phase, phase_at_grad

G_GROUPS = ("other", "sft")


@dataclasses.dataclass(frozen=True)
class SFTGANTrainConfig:
    lr_g: float = 1e-4
    lr_d: float = 1e-4
    sft_lr_mult: float = 5.0
    other_start_iter: int = 20_000
    beta1_g: float = 0.9
    beta1_d: float = 0.9
    milestones: Sequence[int] = (50_000, 100_000, 200_000, 300_000)
    lr_gamma: float = 0.5
    pixel_criterion: str = "l1"
    pixel_weight: float = 1e-2
    feature_weight: float = 1.0
    gan_type: str = "vanilla"
    gan_weight: float = 5e-3
    d_update_ratio: int = 1
    d_init_iters: int = 0
    vgg_path: Optional[str] = None
    compute_dtype: Optional[str] = None


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int = 0) -> torch.Tensor:
    """Cross entropy over classes with torch's ``ignore_index`` semantics,
    the mean over the kept entries of the global batch; 0 where every label
    is ignored (a background-only batch), where ``F.cross_entropy`` gives
    NaN. Under a process group the sum and the count of kept entries are
    all-reduced (the sum with its gradient): the ranks keep unequal counts,
    so a mean of the ranks' means would be another loss."""
    logp = F.log_softmax(logits.float(), dim=-1)
    keep = labels != ignore_index
    picked = logp.gather(-1, torch.where(keep, labels, 0).long()[:, None])[:, 0]
    kept = keep.float()
    return -mesh.all_reduce((picked * kept).sum()) / mesh.all_reduce(kept.sum()).clamp_min(1.0)


def group_mask(tree, group: str, path: str = ""):
    """``tree`` with None at every leaf outside ``group`` ("sft" or
    "other", by :func:`models.sft.is_sft_param` on the leaf's path)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: group_mask(v, group, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [group_mask(v, group, f"{path}/{i}") for i, v in enumerate(tree)]
    return tree if (("sft" if is_sft_param(path) else "other") == group) else None


class SFTGANTrainer(GeneratorTrainerBase):
    """SFT-GAN trainer on one device a process (the card unless
    ``device="cpu"``)."""

    GROUPS = G_GROUPS + ("d",)
    G_GROUPS = G_GROUPS

    def __init__(self, net_g: SFTNetConfig = SFTNetConfig(),
                 cfg: SFTGANTrainConfig = SFTGANTrainConfig(), device="cuda",
                 vgg_cfg: VGGFeatConfig = VGGFeatConfig()):
        super().__init__(net_g, cfg.compute_dtype, device)
        self.net_g = net_g
        self.cfg = cfg
        self.vgg_cfg = vgg_cfg
        self.sched_g = multistep_lr(cfg.lr_g, cfg.milestones, cfg.lr_gamma)
        self.sched_sft = multistep_lr(cfg.lr_g * cfg.sft_lr_mult, cfg.milestones, cfg.lr_gamma)
        self.sched_d = multistep_lr(cfg.lr_d, cfg.milestones, cfg.lr_gamma)
        self.lr_schedule = self.sched_g
        self.tx_g = AdamTransform(cfg.beta1_g, 0.999)
        self.tx_d = AdamTransform(cfg.beta1_d, 0.999)
        self.use_feature = cfg.feature_weight > 0
        self.f_params = (params_to(load_vgg_feat(cfg.vgg_path, vgg_cfg), self.device)
                         if self.use_feature else None)

    # -- state -------------------------------------------------------------

    def init_state(self, seed: int) -> dict:
        g_params = self.ingest_params(generator_init(seed, self.net_g))
        d_params = self.ingest_d_params(init_acd(seed + 1))
        return {"g_params": g_params, "d_params": d_params,
                "g_opt": {g: self.tx_g.init(group_mask(g_params, g)) for g in G_GROUPS},
                "d_opt": self.tx_d.init(d_params), "step": 0}

    def ingest_d_params(self, params):
        """ACD params → fp32 leaf tensors on the device."""
        return self._as_leaves(params)

    def _group(self, state: dict, group: str) -> tuple:
        if group == "d":
            return self.tx_d, self.sched_d, state["d_opt"]
        return self.tx_g, self.sched_sft if group == "sft" else self.sched_g, \
            state["g_opt"][group]

    def gates(self, gstep: int) -> tuple:
        """(sft open, other open) of the 1-based step ``gstep``."""
        cfg = self.cfg
        return (gstep % cfg.d_update_ratio == 0 and gstep > cfg.d_init_iters,
                gstep > cfg.other_start_iter)

    def open_groups(self, gates: tuple) -> tuple:
        return tuple(g for g, o in zip(("sft", "other"), gates) if o) + ("d",)

    def _to_device(self, batch) -> tuple:
        """(LR, seg, HR float32, category int64) on the device."""
        return (*(torch.as_tensor(a, dtype=torch.float32).to(self.device) for a in batch[:3]),
                torch.as_tensor(batch[3]).to(self.device, torch.int64))

    # -- loss pieces -------------------------------------------------------

    def _features(self, x):
        return vgg_feat_forward(self.f_params, x, self.vgg_cfg, dtype=self._dtype)

    def _g_loss(self, g_params, d_params, lr_img, seg, hr_img, cat):
        """(total, fake, logs); ``d_params`` enter detached (D is frozen in
        the G phase; its BN updates of this forward are dropped)."""
        cfg = self.cfg
        phase("g.fwd")
        fake = phase_at_grad(sftnet_forward(g_params, lr_img, seg, self.net_g, dtype=self._dtype),
                             "g.bwd")
        logs = {}
        total = 0.0
        if cfg.pixel_weight > 0:
            phase("loss")
            l_pix = cfg.pixel_weight * pixel_loss(fake, hr_img, cfg.pixel_criterion)
            total = total + l_pix
            logs["l_g_pix"] = l_pix
        if self.use_feature:
            phase("f.fwd")
            with torch.no_grad():
                real_fea = self._features(hr_img)
            fake_fea = phase_at_grad(self._features(fake), "f.bwd")
            phase("loss")
            l_fea = cfg.feature_weight * pixel_loss(fake_fea.float(), real_fea.float(), "l1")
            total = total + l_fea
            logs["l_g_fea"] = l_fea
        phase("d.fwd")
        gan_logits, cls_logits, _ = acd_forward(d_params, fake, train=True, dtype=self._dtype)
        gan_logits, cls_logits = (phase_at_grad(t, "d.bwd") for t in (gan_logits, cls_logits))
        phase("loss")
        l_gan = cfg.gan_weight * gan_loss(gan_logits, True, cfg.gan_type)
        l_cls = cfg.gan_weight * masked_cross_entropy(cls_logits, cat)
        total = total + l_gan + l_cls
        logs.update(l_g_gan=l_gan, l_g_cls=l_cls, l_g_total=total)
        return total, fake, logs

    def _d_loss(self, d_params, fake, hr_img, cat):
        cfg = self.cfg
        phase("d.fwd")
        gan_r, cls_r, upd_r = acd_forward(d_params, hr_img, train=True, dtype=self._dtype)
        gan_f, cls_f, upd_f = acd_forward(d_params, fake, train=True, dtype=self._dtype)
        gan_r, cls_r, gan_f, cls_f = (phase_at_grad(t, "d.bwd")
                                      for t in (gan_r, cls_r, gan_f, cls_f))
        phase("loss")
        loss = (gan_loss(gan_r, True, cfg.gan_type) + masked_cross_entropy(cls_r, cat)
                + gan_loss(gan_f, False, cfg.gan_type) + masked_cross_entropy(cls_f, cat))
        logs = {"l_d_total": loss, "D_real": gan_r.mean(), "D_fake": gan_f.mean()}
        return loss, (upd_r, upd_f), logs

    # -- step --------------------------------------------------------------

    @staticmethod
    def _adam_step(tx, params, opt_state, grads, sc, group):
        """One Adam step on ``params`` (None leaves skipped) in place, at
        ``group``'s lr and bias corrections of the step's scalars ``sc``. A
        leaf the loss does not reach (BN running statistics) has a zero
        gradient."""
        grads = tree_map(lambda p, g: torch.zeros_like(p) if g is None else g, params, grads)
        grads = tree_unflatten_like(grads, iter(mesh.all_reduce_grads(tree_leaves(grads))))
        apply_updates(params, tx.moments(grads, opt_state, params, *sc.bias(group)),
                      sc.lr(group))

    def _step(self, state: dict, batch: tuple, sc, gates: tuple) -> dict:
        """One G+D step's body on device tensors (LR, seg, HR, category), in
        place, every step-dependent value read from the scalars ``sc``;
        ``gates`` = (sft open, other open). → logs, 0-dim tensors."""
        lr_img, seg, hr_img, cat = batch
        open_ = dict(zip(("sft", "other"), gates))
        g_params, d_params = state["g_params"], state["d_params"]

        with fp32_exact(), deterministic_convs():
            frozen = tree_map(lambda p: p.detach(), d_params)
            with torch.set_grad_enabled(any(gates)):
                g_total, fake, g_logs = self._g_loss(g_params, frozen, lr_img, seg, hr_img, cat)
            if any(gates):
                flat = torch.autograd.grad(g_total, tree_leaves(g_params))
                phase("g.opt")
                grads = tree_unflatten_like(g_params, iter(flat))
                for g in G_GROUPS:
                    if open_[g]:
                        self._adam_step(self.tx_g, group_mask(g_params, g), state["g_opt"][g],
                                        group_mask(grads, g), sc, g)

            d_total, (upd_r, upd_f), d_logs = self._d_loss(d_params, fake.detach(), hr_img, cat)
            d_flat = torch.autograd.grad(d_total, tree_leaves(d_params), allow_unused=True)
            phase("d.opt")
            self._adam_step(self.tx_d, d_params, state["d_opt"],
                            tree_unflatten_like(d_params, iter(d_flat)), sc, "d")
        phase("bn")
        with torch.no_grad():
            merged = acd_merge_sequential(d_params, upd_r, upd_f)
            tree_map(lambda p, m: p if p is m else p.copy_(m), d_params, merged)

        phase("logs")
        return mesh.reduce_logs({**{k: v.detach() for k, v in g_logs.items()},
                                 **{k: v.detach() for k, v in d_logs.items()},
                                 "lr": sc.lr("other")})

    def predict(self, params, lr_img, seg) -> torch.Tensor:
        """Eval-mode fp32 forward (as the JAX trainer's ``predict``) of NHWC
        LR [0,1] and its HR seg map (numpy or tensors) → fp32 tensor on the
        device."""
        x = torch.as_tensor(lr_img, dtype=torch.float32).to(self.device)
        s = torch.as_tensor(seg, dtype=torch.float32).to(self.device)
        with torch.inference_mode(), fp32_exact():
            return sftnet_forward(self.canonical_params(params), x, s, self.net_g)
