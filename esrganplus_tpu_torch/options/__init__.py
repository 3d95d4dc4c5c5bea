from esrganplus_tpu_torch.options.options import (
    OptionDict,
    build_net_d_config,
    build_net_g_config,
    build_train_config,
    check_resume,
    dict2str,
    parse,
    wrap_nonedict,
)

__all__ = ["OptionDict", "parse", "dict2str", "check_resume", "wrap_nonedict",
           "build_net_d_config", "build_net_g_config", "build_train_config"]
