import torch

from esrganplus_tpu_torch.models.rrdb import (
    RRDBNetConfig,
    count_params,
    init_rrdbnet,
    rrdbnet_forward,
)
from esrganplus_tpu_torch.models.sft import SFTNetConfig, init_sftnet, sftnet_forward
from esrganplus_tpu_torch.models.srresnet import SRResNetConfig, init_srresnet, srresnet_forward

__all__ = ["RRDBNetConfig", "SFTNetConfig", "SRResNetConfig", "count_params",
           "generator_forward", "generator_init", "init_rrdbnet", "init_sftnet",
           "init_srresnet", "rrdbnet_forward", "sftnet_forward", "srresnet_forward"]


def generator_forward(params, x, cfg, *, train=False, rng=None, noise=None,
                      noise_seeds=None, noise_prng="rbg", dtype=None, side=None):
    """Dispatch on the generator config type (RRDBNet / SRResNet / SFT-GAN).
    SRResNet and SFT-GAN have no noise sites and ignore the noise arguments,
    as the JAX package does. SFT-GAN's segmentation side input goes in
    ``side`` (``[B, 4h, 4w, 8]`` HR seg probabilities), which it requires
    and the others refuse."""
    if isinstance(cfg, SFTNetConfig):
        if side is None:
            raise ValueError("SFT-GAN's forward needs its seg side input: pass side=seg")
        return sftnet_forward(params, x, side, cfg, dtype=dtype)
    if side is not None:
        raise ValueError(f"{type(cfg).__name__} takes no side input")
    if isinstance(cfg, RRDBNetConfig):
        return rrdbnet_forward(params, x, cfg, train=train, rng=rng, noise=noise,
                               noise_seeds=noise_seeds, noise_prng=noise_prng, dtype=dtype)
    if isinstance(cfg, SRResNetConfig):
        return srresnet_forward(params, x, cfg, dtype=dtype)
    raise NotImplementedError(f"unknown generator config {type(cfg).__name__}")


def generator_init(seed: int, cfg, init_scale: float = 0.1, dtype=None):
    """Seeded random generator parameters on the CPU (fp32 unless
    ``dtype``). SFT-GAN is initialised unscaled, as the JAX package's
    trainer initialises it, whatever ``init_scale`` says."""
    dt = dtype or torch.float32
    if isinstance(cfg, RRDBNetConfig):
        return init_rrdbnet(cfg, seed=seed, init_scale=init_scale, dtype=dt)
    if isinstance(cfg, SRResNetConfig):
        return init_srresnet(cfg, seed=seed, init_scale=init_scale, dtype=dt)
    if isinstance(cfg, SFTNetConfig):
        return init_sftnet(cfg, seed=seed, dtype=dt)
    raise NotImplementedError(f"unknown generator config {type(cfg).__name__}")
