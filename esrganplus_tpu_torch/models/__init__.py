import torch

from esrganplus_tpu_torch.models.rrdb import (
    RRDBNetConfig,
    count_params,
    init_rrdbnet,
    rrdbnet_forward,
)
from esrganplus_tpu_torch.models.srresnet import SRResNetConfig, init_srresnet, srresnet_forward

__all__ = ["RRDBNetConfig", "SRResNetConfig", "count_params", "generator_forward",
           "generator_init", "init_rrdbnet", "init_srresnet", "rrdbnet_forward",
           "srresnet_forward"]


def generator_forward(params, x, cfg, *, train=False, rng=None, noise=None,
                      noise_seeds=None, noise_prng="rbg", dtype=None):
    """Dispatch on the generator config type (RRDBNet / SRResNet). SRResNet
    has no noise sites and ignores the noise arguments, as the JAX package
    does; SFT-GAN is not ported yet."""
    if isinstance(cfg, RRDBNetConfig):
        return rrdbnet_forward(params, x, cfg, train=train, rng=rng, noise=noise,
                               noise_seeds=noise_seeds, noise_prng=noise_prng, dtype=dtype)
    if isinstance(cfg, SRResNetConfig):
        return srresnet_forward(params, x, cfg, dtype=dtype)
    raise NotImplementedError(f"generator config {type(cfg).__name__} is not ported yet")


def generator_init(seed: int, cfg, init_scale: float = 0.1, dtype=None):
    """Seeded random generator parameters on the CPU (fp32 unless ``dtype``)."""
    if isinstance(cfg, RRDBNetConfig):
        return init_rrdbnet(cfg, seed=seed, init_scale=init_scale,
                            dtype=dtype or torch.float32)
    if isinstance(cfg, SRResNetConfig):
        return init_srresnet(cfg, seed=seed, init_scale=init_scale,
                             dtype=dtype or torch.float32)
    raise NotImplementedError(f"generator config {type(cfg).__name__} is not ported yet")
