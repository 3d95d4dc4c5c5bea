from esrganplus_tpu_torch.models.rrdb import (
    RRDBNetConfig,
    count_params,
    init_rrdbnet,
    rrdbnet_forward,
)

__all__ = ["RRDBNetConfig", "count_params", "generator_forward", "init_rrdbnet",
           "rrdbnet_forward"]


def generator_forward(params, x, cfg, *, dtype=None):
    """Dispatch on the generator config type (RRDBNet only in this port so
    far; SRResNet and SFT-GAN are not ported yet)."""
    if isinstance(cfg, RRDBNetConfig):
        return rrdbnet_forward(params, x, cfg, dtype=dtype)
    raise NotImplementedError(f"generator config {type(cfg).__name__} is not ported yet")
