"""The program's trainer for ``model: "sr"`` (PSNR pretraining,
``SRTrainer``): how the training driver builds it, where its state keeps
each parameter group and Adam's first moment, which object takes each
network's weights, and the resident store it samples from.

A trainer kind is a file of its own, ``trainers/<model>.py``, with the same
names; its plain reference is ``reference/steps_<model>.py``, whose groups
carry the same names.
"""

# group: the network its parameters start from, their path in the state,
# the path of Adam's first moment, the recipe key of Adam's β1
GROUPS = {"g": {"net": "g", "params": ("params",), "mu": ("opt_state", "mu"),
                "beta1": "beta1_G"}}
# network: ("state" or "trainer", the key that holds its weights)
WEIGHTS = {"g": ("state", "params")}


def build(opt, device):
    from esrganplus_tpu_torch.options.options import build_net_g_config, build_train_config
    from esrganplus_tpu_torch.train import SRTrainer

    return SRTrainer(build_net_g_config(opt), build_train_config(opt), device=device)


def store(dataset, device, **kw):
    from esrganplus_tpu_torch.data.resident import ResidentCropStore

    return ResidentCropStore(dataset, device, **kw)
