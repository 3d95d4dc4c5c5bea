"""The program's trainer for ``model: "sftgan"`` (``SFTGANTrainer``): before
step 20,000 only G's SFT layers and CondNet learn, as the group ``sft``; the
names as in ``sr.py``."""

GROUPS = {"sft": {"net": "g", "params": ("g_params",), "mu": ("g_opt", "sft", "mu"),
                  "beta1": "beta1_G"},
          "d": {"net": "d", "params": ("d_params",), "mu": ("d_opt", "mu"),
                "beta1": "beta1_D"}}
WEIGHTS = {"g": ("state", "g_params"), "d": ("state", "d_params"),
           "f": ("trainer", "f_params")}


def build(opt, device):
    from esrganplus_tpu_torch.options.options import build_net_g_config, build_train_config
    from esrganplus_tpu_torch.train import SFTGANTrainer

    return SFTGANTrainer(build_net_g_config(opt), build_train_config(opt), device=device)


def store(dataset, device, **kw):
    from esrganplus_tpu_torch.data.resident import ResidentSegStore

    return ResidentSegStore(dataset, device, **kw)
