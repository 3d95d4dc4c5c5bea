from esrganplus_tpu_torch.convert.jax_params import (
    discriminator_from_jax,
    from_jax_params,
    gan_trainer_state_from_jax,
    rdb_t_weights_from_jax,
    trainer_state_from_jax,
    vgg_feat_from_jax,
)
from esrganplus_tpu_torch.convert.pth import (
    discriminator_from_state_dict,
    discriminator_sn_from_state_dict,
    discriminator_sn_to_state_dict,
    discriminator_to_state_dict,
    generator_from_state_dict,
    infer_rrdbnet_config,
    load_state_dict,
    rrdbnet_from_state_dict,
    rrdbnet_to_state_dict,
)

__all__ = [
    "discriminator_from_jax",
    "discriminator_from_state_dict",
    "discriminator_sn_from_state_dict",
    "discriminator_sn_to_state_dict",
    "discriminator_to_state_dict",
    "from_jax_params",
    "gan_trainer_state_from_jax",
    "generator_from_state_dict",
    "infer_rrdbnet_config",
    "load_state_dict",
    "rdb_t_weights_from_jax",
    "rrdbnet_from_state_dict",
    "rrdbnet_to_state_dict",
    "trainer_state_from_jax",
    "vgg_feat_from_jax",
]
