"""GAN losses, relativistic (RaGAN) pairing, gradient penalty, Charbonnier.

Counterpart of ``esrganplus_tpu/losses.py``. Specs from the reference:
``GANLoss`` (``codes/models/modules/loss.py:6-38``): vanilla =
BCE-with-logits against constant real/fake labels, lsgan = MSE, wgan-gp =
±mean; ``GradientPenaltyLoss`` (``loss.py:41-60``) = (‖∇D(x̂)‖₂ − 1)²; the
RaGAN pairing lives in the trainer in the reference
(``codes/models/SRRaGAN_model.py:133-138,149-154``) and is exposed here as
composable helpers.
"""

from __future__ import annotations

import torch

from esrganplus_tpu_torch.parallel import mesh


def gan_loss(logits: torch.Tensor, target_is_real: bool, kind: str = "vanilla",
             real_label: float = 1.0, fake_label: float = 0.0) -> torch.Tensor:
    """Scalar GAN loss for a batch of critic outputs."""
    if kind == "wgan-gp":
        return -logits.mean() if target_is_real else logits.mean()
    target = real_label if target_is_real else fake_label
    if kind == "vanilla":
        # BCE with logits in the numerically stable softplus form
        return (torch.clamp_min(logits, 0) - logits * target
                + torch.log1p(torch.exp(-logits.abs()))).mean()
    if kind == "lsgan":
        return ((logits - target) ** 2).mean()
    raise NotImplementedError(f"gan type [{kind}]")


def batch_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the GLOBAL batch: ``t.mean()`` in one process;
    under a process group the mean of the ranks' means (equal shards), all-
    reduced with its gradient."""
    return mesh.all_reduce(t.mean(), "mean")


def ragan_g_loss(d_real: torch.Tensor, d_fake: torch.Tensor,
                 kind: str = "vanilla") -> torch.Tensor:
    """Relativistic-average generator loss:
    (L(D(real) − E[D(fake)], fake) + L(D(fake) − E[D(real)], real)) / 2,
    the expectations over the global batch (:func:`batch_mean`)."""
    return (gan_loss(d_real - batch_mean(d_fake), False, kind)
            + gan_loss(d_fake - batch_mean(d_real), True, kind)) / 2.0


def ragan_d_loss(d_real: torch.Tensor, d_fake: torch.Tensor,
                 kind: str = "vanilla") -> torch.Tensor:
    """Relativistic-average discriminator loss:
    (L(D(real) − E[D(fake)], real) + L(D(fake) − E[D(real)], fake)) / 2,
    the expectations over the global batch (:func:`batch_mean`)."""
    return (gan_loss(d_real - batch_mean(d_fake), True, kind)
            + gan_loss(d_fake - batch_mean(d_real), False, kind)) / 2.0


def gradient_penalty(d_apply, params, real: torch.Tensor, fake: torch.Tensor,
                     eps: torch.Tensor) -> torch.Tensor:
    """WGAN-GP penalty at the interpolates ``real·eps + fake·(1 − eps)``.
    ``d_apply(params, x) → logits``; ``eps`` is ``[B, 1, 1, 1]`` uniform
    draws (the caller's generator makes them, where the JAX package takes a
    key). Differentiable with respect to ``params`` (a second-order graph)."""
    interp = (real * eps + fake * (1.0 - eps)).detach().requires_grad_(True)
    grads, = torch.autograd.grad(d_apply(params, interp).sum(), interp, create_graph=True)
    norms = torch.sqrt((grads ** 2).sum((1, 2, 3)) + 1e-12)
    return ((norms - 1.0) ** 2).mean()


def charbonnier_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return torch.sqrt((pred - target) ** 2 + eps * eps).mean()
