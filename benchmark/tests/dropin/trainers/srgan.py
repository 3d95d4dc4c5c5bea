"""The program's trainer for ``model: "srgan"`` (standard SRGAN,
``GANTrainer``'s ``srgan`` variant), dropped in as a new file: the names as
in ``trainers/sr.py``."""

GROUPS = {"g": {"net": "g", "params": ("g_params",), "mu": ("g_opt", "mu"),
                "beta1": "beta1_G"},
          "d": {"net": "d", "params": ("d_params",), "mu": ("d_opt", "mu"),
                "beta1": "beta1_D"}}
WEIGHTS = {"g": ("state", "g_params"), "d": ("state", "d_params"),
           "f": ("trainer", "f_params")}


def build(opt, device):
    from esrganplus_tpu_torch.options.options import (build_net_d_config, build_net_g_config,
                                                      build_train_config)
    from esrganplus_tpu_torch.train import GANTrainer

    return GANTrainer(build_net_g_config(opt), build_net_d_config(opt), build_train_config(opt),
                      device=device)


def store(dataset, device, **kw):
    from esrganplus_tpu_torch.data.resident import ResidentCropStore

    return ResidentCropStore(dataset, device, **kw)
