from esrganplus_tpu_torch.convert.jax_params import from_jax_params, trainer_state_from_jax
from esrganplus_tpu_torch.convert.pth import (
    generator_from_state_dict,
    infer_rrdbnet_config,
    load_state_dict,
    rrdbnet_from_state_dict,
    rrdbnet_to_state_dict,
)

__all__ = [
    "from_jax_params",
    "generator_from_state_dict",
    "infer_rrdbnet_config",
    "load_state_dict",
    "rrdbnet_from_state_dict",
    "rrdbnet_to_state_dict",
    "trainer_state_from_jax",
]
