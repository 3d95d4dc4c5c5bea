"""The device-resident crop store (esrganplus_tpu_torch/data/resident.py), the
trainers' resident step and the train CLI's resident mode, against the JAX
package where it has the same function and against the port's own host-fed
step where it does not (the two packages draw batches from different
generators):

  (a) ``build_crop_pool`` bit-equal to JAX's on the same dataset and
      ``RandomState``; ``_apply_augment`` bit-equal to JAX's for each of the
      eight flip/transpose decisions; ``_bypass_host_augment``'s restore;
  (b) the sampler's batch equals the pool gathered at its indices, augmented
      and cast; a resident step is bit-equal to ``train_step`` on that batch
      (SR, and GAN with an SRResNet G);
  (c) ``train.steps_per_dispatch`` takes an integer >= 1 and refuses
      anything else before the run touches a directory;
  (d) an asynchronous refresh equals a synchronous one after
      ``flush_refresh``, a build error surfaces there, and a store started at
      a step past a refresh holds the pool a refreshed store holds;
  (e) ``cli.train --device cpu`` with ``resident_crops`` and
      ``steps_per_dispatch: 2`` (one step a call), and a resume from step 8 (past a
      synchronous refresh at step 6) bit-equal to the uninterrupted run.
"""

import itertools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrganplus_tpu.data import datasets as jds
from esrganplus_tpu.data import resident as jres
from esrganplus_tpu_torch.data import datasets as pds
from esrganplus_tpu_torch.data import resident as pres
from esrganplus_tpu_torch.data.resident import ResidentCropStore
from esrganplus_tpu_torch.ops.image_io import save_img
from esrganplus_tpu_torch.ops.resize import imresize_np
from esrganplus_tpu_torch.train.rng import sample_seed
from esrganplus_tpu_torch.train.sr_model import tree_leaves

NET = dict(nf=8, nb=1, gc=4, upscale=4, rdb_noise=False)


def _write_pngs(root, n=4, hr=32):
    hr_dir, lr_dir = os.path.join(root, "HR"), os.path.join(root, "LR")
    rng = np.random.RandomState(7)
    for i in range(n):
        img = (rng.rand(hr, hr, 3) * 255).astype(np.uint8)
        save_img(img, os.path.join(hr_dir, f"img{i}.png"))
        lr = np.clip(imresize_np(img.astype(np.float32) / 255.0, 0.25), 0, 1)
        save_img((lr * 255).round().astype(np.uint8), os.path.join(lr_dir, f"img{i}.png"))
    return hr_dir, lr_dir


def _opt(hr_dir, lr_dir, hr_size=16):
    return {"phase": "train", "dataroot_HR": hr_dir, "dataroot_LR": lr_dir, "scale": 4,
            "HR_size": hr_size, "use_flip": True, "use_rot": True}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return _write_pngs(str(tmp_path_factory.mktemp("resident")))


def test_build_crop_pool_matches_jax(dirs):
    ds = pds.LRHRDataset(_opt(*dirs))
    # the dataset's own crop stream, the one JAX's build_crop_pool draws from
    got = pres.build_crop_pool(ds, 10, np.random.RandomState(3), ds._rng)
    want = jres.build_crop_pool(jds.LRHRDataset(_opt(*dirs)), 10, np.random.RandomState(3))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (10, 4, 4, 3) and got[1].shape == (10, 16, 16, 3)


@pytest.mark.parametrize("do_h,do_v,do_r", list(itertools.product((False, True), repeat=3)))
def test_apply_augment_matches_jax(do_h, do_v, do_r):
    img = np.random.RandomState(0).randint(0, 256, (3, 5, 5, 3)).astype(np.uint8)
    dec = [np.array([d, not d, d]) for d in (do_h, do_v, do_r)]
    got = pres._apply_augment(torch.from_numpy(img), *(torch.from_numpy(d) for d in dec))
    want = np.asarray(jres._apply_augment(jnp.asarray(img), *(jnp.asarray(d) for d in dec)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("before", [{}, {"use_flip": True}, {"use_flip": False, "use_rot": True}])
def test_bypass_host_augment_restores_as_jax(before):
    class D:
        pass

    got, want = D(), D()
    got.opt, want.opt = dict(before, other=1), dict(before, other=1)
    restore_p, restore_j = pres._bypass_host_augment(got), jres._bypass_host_augment(want)
    assert got.opt == want.opt == {"use_flip": False, "use_rot": False, "other": 1}
    restore_p()
    restore_j()
    assert got.opt == want.opt == dict(before, other=1)  # absent keys deleted, not None


def test_sampler_is_the_pool_gathered_augmented_and_cast(dirs):
    store = ResidentCropStore(pds.LRHRDataset(_opt(*dirs)), "cpu", n_crops=12, refresh_steps=0)
    lr, hr = store.make_sampler(16)(1234)
    gen = torch.Generator().manual_seed(1234)
    idx = torch.randint(0, 12, (16,), generator=gen)
    dec = pres._augment_decisions(gen, 16, True, True, "cpu")
    assert lr.dtype == hr.dtype == torch.float32
    assert torch.equal(lr, pres._apply_augment(store.lr[idx], *dec).float() / 255.0)
    assert torch.equal(hr, pres._apply_augment(store.hr[idx], *dec).float() / 255.0)
    assert any(d.any() for d in dec) and not all(d.all() for d in dec)
    # every sample is one of the eight transforms of its pool pair, LR and HR alike
    for b in range(16):
        lr_u8 = (lr[b] * 255).round().to(torch.uint8)
        hr_u8 = (hr[b] * 255).round().to(torch.uint8)
        hit = [t for t in itertools.product((False, True), repeat=3)
               if torch.equal(hr_u8, pres._apply_augment(store.hr[idx[b]][None],
                                                         *(torch.tensor([x]) for x in t))[0])]
        assert any(torch.equal(lr_u8, pres._apply_augment(store.lr[idx[b]][None],
                                                          *(torch.tensor([x]) for x in t))[0])
                   for t in hit)
    off = ResidentCropStore(pds.LRHRDataset(_opt(*dirs)), "cpu", n_crops=12, refresh_steps=0,
                            use_flip=False, use_rot=False)
    lr, hr = off.make_sampler(4)(9)
    idx = torch.randint(0, 12, (4,), generator=torch.Generator().manual_seed(9))
    assert torch.equal(hr, off.hr[idx].float() / 255.0)


def _sr_trainer():
    from esrganplus_tpu_torch.models import RRDBNetConfig
    from esrganplus_tpu_torch.train import SRTrainConfig, SRTrainer

    return SRTrainer(RRDBNetConfig(**NET), SRTrainConfig(lr=1e-3), device="cpu")


def _gan_trainer():
    from esrganplus_tpu_torch.models import SRResNetConfig
    from esrganplus_tpu_torch.models.discriminator import DiscriminatorVGGConfig
    from esrganplus_tpu_torch.train import GANTrainConfig, GANTrainer

    return GANTrainer(SRResNetConfig(nf=8, nb=1), DiscriminatorVGGConfig(input_size=96, base_nf=8),
                      GANTrainConfig(variant="srgan", feature_weight=0.0), device="cpu")


def _same_state(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert (torch.equal(x, y) if torch.is_tensor(x) else x == y)


def test_resident_step_is_train_step_on_the_sampled_batch(dirs):
    store = ResidentCropStore(pds.LRHRDataset(_opt(*dirs)), "cpu", n_crops=8, refresh_steps=0)
    a, b = _sr_trainer(), _sr_trainer()
    sa, sb = a.init_state(0), b.init_state(0)
    sa, la = a.train_step_resident(sa, store, 5, batch_size=4)
    sb, lb = b.train_step(sb, store.make_sampler(4)(sample_seed(5, 0)), 5)
    _same_state(sa, sb)
    assert all(torch.equal(la[k], lb[k]) for k in la)


def test_gan_resident_step_is_train_step_on_the_sampled_batch(tmp_path):
    hr_dir, lr_dir = _write_pngs(str(tmp_path), n=2, hr=96)
    store = ResidentCropStore(pds.LRHRDataset(_opt(hr_dir, lr_dir, hr_size=96)), "cpu",
                              n_crops=6, refresh_steps=0)
    a, b = _gan_trainer(), _gan_trainer()
    sa, sb = a.init_state(0), b.init_state(0)
    for step in range(2):
        sa, la = a.train_step_resident(sa, store, 3, batch_size=2)
        sb, lb = b.train_step(sb, store.make_sampler(2)(sample_seed(3, step)), 3)
    assert sa["step"] == sb["step"] == 2
    _same_state(sa, sb)
    assert set(la) == set(lb) and all(torch.equal(la[k], lb[k]) for k in la)


def test_async_refresh_matches_sync_and_errors_surface(dirs, monkeypatch):
    def store(**kw):
        return ResidentCropStore(pds.LRHRDataset(_opt(*dirs)), "cpu", n_crops=8, refresh_steps=2,
                                 seed=3, **kw)

    sync, asy = store(async_refresh=False), store(async_refresh=True)
    assert torch.equal(sync.hr, asy.hr)
    first = sync.hr.clone()
    sync.maybe_refresh(2)
    asy.maybe_refresh(2)
    asy.flush_refresh()
    assert asy.pool_index == sync.pool_index == 1
    assert torch.equal(sync.hr, asy.hr) and torch.equal(sync.lr, asy.lr)
    assert not torch.equal(sync.hr, first)
    # a run resumed at step 3 starts on the pool the refreshed run holds
    resumed = store(async_refresh=False, start_step=3)
    assert resumed.pool_index == 1 and torch.equal(resumed.hr, sync.hr)
    resumed.maybe_refresh(3)  # not a boundary: nothing rebuilt
    assert torch.equal(resumed.lr, sync.lr)

    def boom(*a, **k):
        raise RuntimeError("decode exploded")

    monkeypatch.setattr(pres, "build_crop_pool", boom)
    asy.maybe_refresh(4)  # schedules the failing build
    with pytest.raises(RuntimeError, match="decode exploded"):
        asy.flush_refresh()


def _cli_options(root, hr_dir, lr_dir, niter):
    return {
        "name": "debug_resident", "model": "sr", "scale": 4, "use_tb_logger": False,
        "datasets": {
            "train": {"name": "s", "mode": "LRHR", "dataroot_HR": hr_dir,
                      "dataroot_LR": lr_dir, "n_workers": 1, "batch_size": 4, "HR_size": 16,
                      "use_flip": True, "use_rot": True, "resident_crops": 16,
                      "resident_refresh": 6, "resident_async_refresh": False},
            "val": {"name": "v", "mode": "LRHR", "dataroot_HR": hr_dir, "dataroot_LR": lr_dir},
        },
        "path": {"root": root},
        "network_G": {"which_model_G": "RRDB_net", "nf": 8, "nb": 1, "gc": 4},
        "train": {"lr_G": 1e-3, "lr_scheme": "MultiStepLR", "lr_steps": [100],
                  "pixel_criterion": "l1", "manual_seed": 0, "niter": niter,
                  "steps_per_dispatch": 2},
        "logger": {"print_freq": 2},
    }


def test_cli_resident_and_bit_equal_resume(tmp_path, dirs):
    from esrganplus_tpu_torch.cli.train import main

    root = str(tmp_path)

    def run(opt):
        path = os.path.join(root, "opt.json")
        with open(path, "w") as f:
            json.dump(opt, f)
        main(["-opt", path, "--device", "cpu"])
        return os.path.join(root, "experiments", "debug_resident")

    full = run(_cli_options(root, *dirs, niter=12))
    want = torch.load(os.path.join(full, "models", "latest_G.pth"))
    text = open(os.path.join(full, sorted(f for f in os.listdir(full) if f.endswith(".log"))[-1])).read()
    assert "resident crop store: 16 pairs" in text and "<step:      12," in text
    assert "steps_per_dispatch 2: an eager step is one call" in text
    os.rename(full, full + "_uninterrupted")

    opt = _cli_options(root, *dirs, niter=8)
    exp = run(opt)
    opt["path"]["resume_state"] = os.path.join(exp, "training_state", "8.state.npz")
    opt["train"]["niter"] = 12
    run(opt)
    got = torch.load(os.path.join(exp, "models", "latest_G.pth"))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("k", [0, -2, 1.5, "4", True])
def test_steps_per_dispatch_is_validated(tmp_path, dirs, k):
    from esrganplus_tpu_torch.cli.train import main

    root = str(tmp_path)
    opt = _cli_options(root, *dirs, niter=2)
    opt["train"]["steps_per_dispatch"] = k
    path = os.path.join(root, "opt.json")
    with open(path, "w") as f:
        json.dump(opt, f)
    with pytest.raises(ValueError, match="steps_per_dispatch must be an integer >= 1"):
        main(["-opt", path, "--device", "cpu"])
    assert not os.path.exists(os.path.join(root, "experiments"))
