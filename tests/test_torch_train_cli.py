"""End-to-end debug training runs through the port's CLI
(``esrganplus_tpu_torch.cli.train``) on ``--device cpu``: the debug cycle of
tests/test_e2e_train.py (nf=8, nb=1, gc=4, niter 10), a resume from step 8,
and the exported ``latest_G.pth`` loaded by both packages."""

import json
import os

import numpy as np
import pytest
import torch

from esrganplus_tpu import infer as jinfer
from esrganplus_tpu_torch import infer as pinfer
from esrganplus_tpu_torch.cli.train import main
from esrganplus_tpu_torch.ops.image_io import save_img
from esrganplus_tpu_torch.ops.resize import imresize_np
from esrganplus_tpu_torch.train.checkpoint import (STATE_SUFFIX, latest_state_path,
                                                   load_state, save_state)


def _make_dataset(root, n=4, hr=64):
    hr_dir, lr_dir = os.path.join(root, "HR"), os.path.join(root, "LR")
    rng = np.random.RandomState(7)
    for i in range(n):
        img = (rng.rand(hr, hr, 3) * 255).astype(np.uint8)
        save_img(img, os.path.join(hr_dir, f"img{i}.png"))
        lr = np.clip(imresize_np(img.astype(np.float32) / 255.0, 0.25), 0, 1)
        save_img((lr * 255).round().astype(np.uint8), os.path.join(lr_dir, f"img{i}.png"))
    return hr_dir, lr_dir


def _options(root, hr_dir, lr_dir, **train):
    return {
        "name": "debug_e2e", "model": "sr", "scale": 4, "use_tb_logger": False,
        "datasets": {
            "train": {"name": "synthetic", "mode": "LRHR", "dataroot_HR": hr_dir,
                      "dataroot_LR": lr_dir, "n_workers": 1, "batch_size": 8, "HR_size": 32,
                      "use_flip": True, "use_rot": True},
            "val": {"name": "synthetic_val", "mode": "LRHR", "dataroot_HR": hr_dir,
                    "dataroot_LR": lr_dir},
        },
        "path": {"root": root},
        "network_G": {"which_model_G": "RRDB_net", "norm_type": None, "mode": "CNA",
                      "nf": 8, "nb": 1, "in_nc": 3, "out_nc": 3, "gc": 4,
                      "gaussian_noise": True},
        "train": {"lr_G": 1e-3, "lr_scheme": "MultiStepLR", "lr_steps": [1000],
                  "lr_gamma": 0.5, "pixel_criterion": "l1", "pixel_weight": 1.0,
                  "manual_seed": 0, "niter": 10, **train},
        "logger": {"print_freq": 2},
    }


def _run(root, opt):
    path = os.path.join(root, "opt.json")
    with open(path, "w") as f:
        json.dump(opt, f)
    main(["-opt", path, "--device", "cpu"])
    return os.path.join(root, "experiments", "debug_e2e")


def _log_text(exp):
    logs = sorted(f for f in os.listdir(exp) if f.endswith(".log"))
    return open(os.path.join(exp, logs[-1])).read()


def test_debug_sr_train_cycle(tmp_path):
    root = str(tmp_path)
    exp = _run(root, _options(root, *_make_dataset(root)))
    # debug mode: val/ckpt every 8 iters → one checkpoint at step 8
    assert os.path.exists(os.path.join(exp, "training_state", "8" + STATE_SUFFIX))
    assert latest_state_path(os.path.join(exp, "training_state")).endswith("8" + STATE_SUFFIX)
    assert os.path.exists(os.path.join(exp, "models", "8_G.pth"))
    assert os.path.exists(os.path.join(exp, "models", "latest_G.pth"))
    assert len(os.listdir(os.path.join(exp, "val_images"))) == 4
    text = _log_text(exp)
    assert "Validation # PSNR" in text and "<step:      10," in text

    # the exported checkpoint loads in both packages and gives the same ×4 output
    latest = os.path.join(exp, "models", "latest_G.pth")
    jp, jcfg, _ = jinfer.load_generator(latest)
    pp, pcfg, _ = pinfer.load_generator(latest, device="cpu")
    assert (pcfg.nb, pcfg.nf, pcfg.gc) == (jcfg.nb, jcfg.nf, jcfg.gc) == (1, 8, 4)
    img = np.random.RandomState(3).rand(9, 11, 3).astype(np.float32)
    want = jinfer.SRInferencer(jp, jcfg).upscale(img)
    got = pinfer.SRInferencer(pp, pcfg, device="cpu").upscale(img)
    assert got.shape == want.shape == (36, 44, 3)
    assert np.abs(got - want).max() <= 1e-5


def test_debug_sr_resume(tmp_path):
    root = str(tmp_path)
    hr_dir, lr_dir = _make_dataset(root)
    full = _run(root, _options(root, hr_dir, lr_dir, niter=12))
    want = torch.load(os.path.join(full, "models", "latest_G.pth"))
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
    # one loader worker: the resumed run sees the batches and the noise an
    # uninterrupted run would, so it ends on the same weights
    got = torch.load(os.path.join(exp, "models", "latest_G.pth"))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_state_file_roundtrip(tmp_path):
    state = {"params": {"b": torch.arange(6.0).reshape(2, 3).requires_grad_(),
                        "a": [torch.ones(2), torch.zeros(1)]},
             "opt_state": {"count": 3, "mu": {"x": torch.full((2,), 0.5)}}, "step": 7}
    path = str(tmp_path / "s" / ("7" + STATE_SUFFIX))
    save_state(path, state)
    template = {"params": {"b": torch.zeros(2, 3, requires_grad=True),
                           "a": [torch.zeros(2), torch.ones(1)]},
                "opt_state": {"count": 0, "mu": {"x": torch.zeros(2)}}, "step": 0}
    back = load_state(path, template)
    assert back["step"] == 7 and back["opt_state"]["count"] == 3
    assert isinstance(back["step"], int) and back["params"]["b"].requires_grad
    assert torch.equal(back["params"]["b"], state["params"]["b"])
    assert torch.equal(back["params"]["a"][0], torch.ones(2))
    template["params"]["b"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="shape"):
        load_state(path, template)
    del template["opt_state"]["mu"]
    with pytest.raises(ValueError, match="leaves"):
        load_state(path, template)


@pytest.mark.parametrize("case", ["profile", "dist", "resident", "dispatch", "srragan"])
def test_unported_training_options_exit_saying_so(tmp_path, case, capsys):
    """Every option once refused here now runs: ``--profile``, the resident
    crop store, ``steps_per_dispatch``, the resident store under a GAN
    model, and the multi-process launch (``--dist-*``: here a world-size-1
    gloo group), whose three flags are refused, before anything starts,
    when one is given without the others."""
    root = str(tmp_path)
    opt = _options(root, *_make_dataset(root, n=2, hr=96 if case == "srragan" else 64), niter=2)
    argv = []
    if case == "profile":
        argv = ["--profile", os.path.join(root, "trace"), "--profile-steps", "1"]
    elif case == "dist":
        import socket

        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        argv = ["--dist-coordinator", f"localhost:{port}", "--dist-num-processes", "1",
                "--dist-process-id", "0"]
    elif case == "resident":
        opt["datasets"]["train"]["resident_crops"] = 64
    elif case == "dispatch":
        opt["datasets"]["train"]["resident_crops"] = 16
        opt["train"]["steps_per_dispatch"] = 4
    else:
        opt["model"] = "srragan"
        opt["network_D"] = {"which_model_D": "discriminator_vgg_96", "nf": 8}
        opt["datasets"]["train"].update(resident_crops=8, batch_size=2, HR_size=96)
        opt["train"]["feature_weight"] = 0
    path = os.path.join(root, "opt.json")
    with open(path, "w") as f:
        json.dump(opt, f)
    if case == "dist":
        with pytest.raises(SystemExit):
            main(["-opt", path, "--device", "cpu", *argv[:2]])
        assert "go together" in capsys.readouterr().err
        assert not os.path.exists(os.path.join(root, "experiments"))  # nothing was started
    main(["-opt", path, "--device", "cpu", *argv])
    text = _log_text(os.path.join(root, "experiments", "debug_e2e"))
    assert "End of training." in text and "<step:       2," in text
    assert ("resident crop store" in text) == (case not in ("profile", "dist"))
    assert ("process 0 of 1 (gloo)" in text) == (case == "dist")


def test_cli_needs_a_card_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    root = str(tmp_path)
    path = os.path.join(root, "opt.json")
    with open(path, "w") as f:
        json.dump(_options(root, root, root), f)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["-opt", path])
