"""End-to-end debug GAN fine-tuning runs through the port's CLI
(``esrganplus_tpu_torch.cli.train`` with ``model: "srragan"``) on
``--device cpu``: the debug cycle (G nf=8, nb=1, gc=4; ``discriminator_vgg_96``
at base_nf=8; batch 2 of 96×96 crops; the perceptual net, which is the
full-width VGG19, only in the run that checks its warning), a resume from
step 8 that must end on bit-equal G and D weights, and the exported
``latest_D.pth`` loaded by both packages."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrganplus_tpu.convert import load_state_dict as j_load_state_dict
from esrganplus_tpu.convert.pth import discriminator_from_state_dict as j_d_from_sd
from esrganplus_tpu.models.discriminator import DiscriminatorVGGConfig as JDCfg
from esrganplus_tpu.models.discriminator import discriminator_forward as j_d_forward
from esrganplus_tpu_torch.cli.train import main
from esrganplus_tpu_torch.convert import discriminator_from_state_dict, load_state_dict
from esrganplus_tpu_torch.models.discriminator import (DiscriminatorVGGConfig,
                                                       discriminator_forward)
from esrganplus_tpu_torch.train.checkpoint import STATE_SUFFIX
from test_torch_train_cli import _log_text, _make_dataset

D_KW = dict(input_size=96, base_nf=8)


def _options(root, hr_dir, lr_dir, model="srragan", **train):
    return {
        "name": "debug_gan", "model": model, "scale": 4, "use_tb_logger": False,
        "datasets": {
            "train": {"name": "synthetic", "mode": "LRHR", "dataroot_HR": hr_dir,
                      "dataroot_LR": lr_dir, "n_workers": 1, "batch_size": 2, "HR_size": 96,
                      "use_flip": True, "use_rot": True},
            "val": {"name": "synthetic_val", "mode": "LRHR", "dataroot_HR": hr_dir,
                    "dataroot_LR": lr_dir},
        },
        "path": {"root": root},
        "network_G": {"which_model_G": "RRDB_net", "norm_type": None, "mode": "CNA",
                      "nf": 8, "nb": 1, "in_nc": 3, "out_nc": 3, "gc": 4,
                      "gaussian_noise": True},
        "network_D": {"which_model_D": "discriminator_vgg_96", "norm_type": "batch",
                      "act_type": "leakyrelu", "mode": "CNA", "nf": 8, "in_nc": 3},
        "train": {"lr_G": 1e-3, "lr_D": 1e-3, "lr_scheme": "MultiStepLR", "lr_steps": [1000],
                  "lr_gamma": 0.5, "pixel_criterion": "l1", "pixel_weight": 1e-2,
                  "feature_criterion": "l1", "feature_weight": 0, "gan_type": "vanilla",
                  "gan_weight": 5e-3, "D_update_ratio": 1, "D_init_iters": 0,
                  "manual_seed": 0, "niter": 10, **train},
        "logger": {"print_freq": 2},
    }


def _run(root, opt):
    path = os.path.join(root, "opt.json")
    with open(path, "w") as f:
        json.dump(opt, f)
    main(["-opt", path, "--device", "cpu"])
    return os.path.join(root, "experiments", "debug_gan")


def test_debug_srragan_train_cycle(tmp_path):
    root = str(tmp_path)
    exp = _run(root, _options(root, *_make_dataset(root, n=3, hr=128)))
    for f in ("training_state/8" + STATE_SUFFIX, "models/8_G.pth", "models/8_D.pth",
              "models/latest_G.pth", "models/latest_D.pth"):
        assert os.path.exists(os.path.join(exp, f)), f
    text = _log_text(exp)
    assert "Validation # PSNR" in text and "<step:      10," in text
    for key in ("l_g_pix", "l_g_gan", "l_g_total", "l_d_total", "D_real", "D_fake"):
        assert f"{key}: " in text, key
    assert "l_g_fea" not in text and "VGG19 weights not provided" not in text

    # the exported discriminator loads in both packages and gives the same
    # eval-mode logits (running statistics included), ≤1e-5
    latest = os.path.join(exp, "models", "latest_D.pth")
    pp = discriminator_from_state_dict(load_state_dict(latest), DiscriminatorVGGConfig(**D_KW))
    jp = j_d_from_sd(j_load_state_dict(latest), JDCfg(**D_KW))
    assert float(pp["bn"][1]["a"]["mean"].abs().max()) > 0  # the running statistics moved
    x = np.random.RandomState(5).rand(2, 96, 96, 3).astype(np.float32)
    got, _ = discriminator_forward(pp, torch.from_numpy(x), DiscriminatorVGGConfig(**D_KW))
    want, _ = j_d_forward(jp, jnp.asarray(x), JDCfg(**D_KW))
    assert got.shape == (2, 1)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5 * max(1, np.abs(want).max())


def test_debug_srragan_with_perceptual_loss_warns_without_vgg_weights(tmp_path):
    """feature_weight > 0 without path.vgg19: the seeded random VGG19 runs,
    the log says so, and ``l_g_fea`` is logged."""
    root = str(tmp_path)
    opt = _options(root, *_make_dataset(root, n=3, hr=128), feature_weight=1, niter=2)
    exp = _run(root, opt)
    text = _log_text(exp)
    assert "VGG19 weights not provided" in text and "l_g_fea: " in text


def test_debug_srragan_resume(tmp_path):
    root = str(tmp_path)
    hr_dir, lr_dir = _make_dataset(root, n=3, hr=128)
    full = _run(root, _options(root, hr_dir, lr_dir, niter=12))
    want = {n: torch.load(os.path.join(full, "models", f"latest_{n}.pth")) for n in "GD"}
    os.rename(full, full + "_uninterrupted")

    opt = _options(root, hr_dir, lr_dir, niter=8)
    exp = _run(root, opt)
    state_file = os.path.join(exp, "training_state", "8" + STATE_SUFFIX)
    assert os.path.exists(state_file)
    opt["path"]["resume_state"] = state_file
    opt["train"]["niter"] = 12
    _run(root, opt)
    text = _log_text(exp)
    assert "resumed" in text and "<step:      12," in text and "<step:       8," not in text
    for n in "GD":
        got = torch.load(os.path.join(exp, "models", f"latest_{n}.pth"))
        assert set(got) == set(want[n])
        for k in want[n]:
            assert torch.equal(got[k], want[n][k]), (n, k)


def test_pretrain_model_d_is_loaded(tmp_path):
    root = str(tmp_path)
    hr_dir, lr_dir = _make_dataset(root, n=3, hr=128)
    exp = _run(root, _options(root, hr_dir, lr_dir, niter=2))
    d_path = os.path.join(root, "d.pth")
    os.rename(os.path.join(exp, "models", "latest_D.pth"), d_path)
    opt = _options(root, hr_dir, lr_dir, model="srgan", niter=2)
    opt["path"]["pretrain_model_D"] = d_path
    exp = _run(root, opt)
    assert "loaded pretrained D" in _log_text(exp)


def test_sftgan_still_exits_saying_so(tmp_path):
    """``model: "sftgan"`` is ported (tests/test_torch_sftgan_trainer.py
    trains it through this CLI); with an RRDBNet generator it exits saying
    it trains an SFT_Net, before any directory is made."""
    root = str(tmp_path)
    opt = _options(root, root, root, model="sftgan")
    path = os.path.join(root, "opt.json")
    with open(path, "w") as f:
        json.dump(opt, f)
    with pytest.raises(ValueError, match="sft_arch"):
        main(["-opt", path, "--device", "cpu"])
    assert not os.path.exists(os.path.join(root, "experiments"))


def test_gan_cli_needs_a_card_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    root = str(tmp_path)
    path = os.path.join(root, "opt.json")
    with open(path, "w") as f:
        json.dump(_options(root, root, root), f)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["-opt", path])
