"""JSON-with-comments option system (reference ``codes/options/options.py``).

Behavioural parity: ``//`` comment stripping (``options.py:10-14``), key order
preserved, ``scale``/``is_train`` propagation into datasets and network_G
(``options.py:18-24,65``), LMDB detection by path suffix (``options.py:25-36``),
``~`` expansion, the experiment directory tree (``options.py:45-51``), debug-name
frequency overrides (``options.py:53-58``), missing-key access returning None
(NoneDict, ``options.py:75-90``), and ``check_resume`` path rewriting
(``options.py:106-120``).

On top of the dict surface, typed builders map options onto the framework's
config dataclasses (the reference's ``define_G`` factory role,
``networks.py:83-139``). Counterpart of ``esrganplus_tpu/options/options.py``.
"""

from __future__ import annotations

import json
import os
from typing import Optional


class OptionDict(dict):
    """dict returning None for missing keys, recursively wrapped."""

    def __missing__(self, key):
        return None

    def __getattr__(self, key):
        return self[key] if key in self else None


def wrap_nonedict(obj):
    if isinstance(obj, dict):
        return OptionDict({k: wrap_nonedict(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return [wrap_nonedict(v) for v in obj]
    return obj


def _strip_comments(text: str) -> str:
    # Remove // comments with the reference's exact semantics
    # (``options.py:10-14``: everything from the first '//' on a line is
    # dropped, quotes notwithstanding).
    return "\n".join(line.split("//")[0] for line in text.splitlines())


def parse(opt_path: str, is_train: bool = True) -> OptionDict:
    with open(opt_path) as f:
        opt = json.loads(_strip_comments(f.read()))
    opt["is_train"] = is_train
    scale = opt.get("scale", 4)

    for phase, dataset in (opt.get("datasets") or {}).items():
        phase = phase.split("_")[0]
        dataset["phase"] = phase
        dataset["scale"] = scale
        if dataset.get("dataroot_HR"):
            dataset["dataroot_HR"] = os.path.expanduser(dataset["dataroot_HR"])
            if dataset["dataroot_HR"].endswith("lmdb"):
                dataset["data_type"] = "lmdb"
        if dataset.get("dataroot_LR"):
            dataset["dataroot_LR"] = os.path.expanduser(dataset["dataroot_LR"])
        dataset.setdefault("data_type", "img")

    for key, path in (opt.get("path") or {}).items():
        if path and isinstance(path, str):
            opt["path"][key] = os.path.expanduser(path)

    opt.setdefault("path", {})
    root = opt["path"].get("root", ".")
    if is_train:
        experiments_root = os.path.join(root, "experiments", opt["name"])
        opt["path"]["experiments_root"] = experiments_root
        opt["path"]["models"] = os.path.join(experiments_root, "models")
        opt["path"]["training_state"] = os.path.join(experiments_root, "training_state")
        opt["path"]["log"] = experiments_root
        opt["path"]["val_images"] = os.path.join(experiments_root, "val_images")
        if "debug" in opt["name"]:
            train = opt.setdefault("train", {})
            train["val_freq"] = 8
            opt.setdefault("logger", {})["print_freq"] = 2
            train["save_checkpoint_freq"] = 8
    else:
        results_root = os.path.join(root, "results", opt["name"])
        opt["path"]["results_root"] = results_root
        opt["path"]["log"] = results_root

    if opt.get("network_G") is not None:
        opt["network_G"]["scale"] = scale

    return wrap_nonedict(opt)


def dict2str(opt, indent_l: int = 1) -> str:
    msg = ""
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += " " * (indent_l * 2) + f"{k}:[\n" + dict2str(v, indent_l + 1)
            msg += " " * (indent_l * 2) + "]\n"
        else:
            msg += " " * (indent_l * 2) + f"{k}: {v}\n"
    return msg


def check_resume(opt, resume_iter: Optional[int] = None) -> None:
    """When resuming, point pretrain paths at the matching checkpoint step so
    weights and optimizer state stay in sync."""
    if opt["path"].get("resume_state"):
        it = resume_iter
        if it is None:
            base = os.path.basename(opt["path"]["resume_state"])
            it = int(base.split(".")[0])
        opt["path"]["pretrain_model_G"] = os.path.join(opt["path"]["models"], f"{it}_G.pth")
        if "gan" in (opt.get("model") or ""):
            opt["path"]["pretrain_model_D"] = os.path.join(opt["path"]["models"], f"{it}_D.pth")


# ---------------------------------------------------------------------------
# Typed builders: options → framework configs
# ---------------------------------------------------------------------------


def build_net_g_config(opt):
    """network_G options → RRDBNetConfig, SRResNetConfig or SFTNetConfig."""
    from esrganplus_tpu_torch.models.rrdb import RRDBNetConfig

    g = opt["network_G"]
    which = g["which_model_G"]
    if which in ("RRDB_net", "rrdb", "rrdb_net"):
        return RRDBNetConfig(
            in_nc=g.get("in_nc", 3),
            out_nc=g.get("out_nc", 3),
            nf=g.get("nf", 64),
            nb=g.get("nb", 23),
            gc=g.get("gc", 32),
            upscale=g.get("scale", 4),
            conv1x1=g.get("conv1x1", True),
            rdb_noise=g.get("gaussian_noise", True),
            rrdb_noise=g.get("rrdb_noise", False),
            noise_sigma=g.get("noise_sigma", 0.1),
            unroll=g.get("unroll", 0),
            noise_kernel=g.get("noise_kernel", "input"),
        )
    if which in ("sr_resnet", "srresnet"):
        from esrganplus_tpu_torch.models.srresnet import SRResNetConfig

        return SRResNetConfig(
            in_nc=g.get("in_nc", 3),
            out_nc=g.get("out_nc", 3),
            nf=g.get("nf", 64),
            nb=g.get("nb", 16),
            upscale=g.get("scale", 4),
        )
    if which == "sft_arch":
        from esrganplus_tpu_torch.models.sft import SFTNetConfig

        return SFTNetConfig(
            nb=g.get("nb", 16) or 16,
            legacy=bool(g.get("legacy", False)),
        )
    raise NotImplementedError(f"Generator model [{which}] not recognized")


def build_net_d_config(opt):
    """network_D options → DiscriminatorVGGConfig. SFT-GAN's ACD
    (``"dis_acd"``) is fixed by the model and has no config: the train
    CLI does not call this for ``model: "sftgan"``, as the JAX package's
    does not."""
    from esrganplus_tpu_torch.models.discriminator import DiscriminatorVGGConfig

    d = opt["network_D"]
    which = d["which_model_D"]
    size = {"discriminator_vgg_128": 128, "discriminator_vgg_96": 96,
            "discriminator_vgg_192": 192, "discriminator_vgg_128_SN": 128}.get(which)
    if size is None:
        raise NotImplementedError(f"Discriminator model [{which}] not recognized")
    return DiscriminatorVGGConfig(
        input_size=size,
        in_nc=d.get("in_nc", 3),
        base_nf=d.get("nf", 64),
        norm_type=d.get("norm_type", "batch"),
        spectral_norm=which.endswith("_SN"),
    )


def build_train_config(opt):
    """train options → SRTrainConfig (``model: "sr"``), GANTrainConfig
    (``"srgan"`` | ``"srragan"``) or SFTGANTrainConfig (``"sftgan"``)."""
    t = opt["train"] or {}
    model = opt["model"]
    if model == "sr":
        from esrganplus_tpu_torch.train.sr_model import SRTrainConfig

        return SRTrainConfig(
            lr=t.get("lr_G", 2e-4),
            weight_decay=t.get("weight_decay_G", 0) or 0,
            beta1=t.get("beta1_G", 0.9),
            milestones=tuple(t.get("lr_steps", (200_000, 400_000, 600_000, 800_000))),
            lr_gamma=t.get("lr_gamma", 0.5),
            pixel_criterion=t.get("pixel_criterion", "l1"),
            pixel_weight=t.get("pixel_weight", 1.0),
            compute_dtype=t.get("compute_dtype"),
            noise_prng=t.get("noise_prng") or "rbg",
        )
    if model in ("srgan", "srragan"):
        from esrganplus_tpu_torch.train.gan_model import GANTrainConfig

        return GANTrainConfig(
            variant=model,
            gan_type=t.get("gan_type", "vanilla"),
            lr_g=t.get("lr_G", 1e-4),
            lr_d=t.get("lr_D", 1e-4),
            beta1_g=t.get("beta1_G", 0.9),
            beta1_d=t.get("beta1_D", 0.9),
            milestones=tuple(t.get("lr_steps", (50_000, 100_000, 200_000, 300_000))),
            lr_gamma=t.get("lr_gamma", 0.5),
            pixel_criterion=t.get("pixel_criterion", "l1"),
            pixel_weight=t.get("pixel_weight", 1e-2),
            feature_criterion=t.get("feature_criterion", "l1"),
            feature_weight=t.get("feature_weight", 1.0),
            gan_weight=t.get("gan_weight", 5e-3),
            d_update_ratio=t.get("D_update_ratio", 1),
            d_init_iters=t.get("D_init_iters", 0),
            gp_weight=t.get("gp_weigth_loss", 10.0),  # the reference's spelling
            vgg_path=(opt["path"] or {}).get("vgg19"),
            compute_dtype=t.get("compute_dtype"),
            noise_prng=t.get("noise_prng") or "rbg",
        )
    if model == "sftgan":
        from esrganplus_tpu_torch.train.sftgan_model import SFTGANTrainConfig

        return SFTGANTrainConfig(
            lr_g=t.get("lr_G", 1e-4),
            lr_d=t.get("lr_D", 1e-4),
            beta1_g=t.get("beta1_G", 0.9),
            beta1_d=t.get("beta1_D", 0.9),
            milestones=tuple(t.get("lr_steps", (50_000, 100_000, 200_000, 300_000))),
            lr_gamma=t.get("lr_gamma", 0.5),
            pixel_criterion=t.get("pixel_criterion", "l1"),
            pixel_weight=t.get("pixel_weight", 1e-2),
            feature_weight=t.get("feature_weight", 1.0),
            gan_type=t.get("gan_type", "vanilla"),
            gan_weight=t.get("gan_weight", 5e-3),
            d_update_ratio=t.get("D_update_ratio", 1),
            d_init_iters=t.get("D_init_iters", 0),
            vgg_path=(opt["path"] or {}).get("vgg19"),
            compute_dtype=t.get("compute_dtype"),
        )
    raise NotImplementedError(f"Model [{model}] not recognized")
