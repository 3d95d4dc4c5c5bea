"""The port's options, datasets, loaders and host numerics
(esrganplus_tpu_torch/{options,data,ops}) against the JAX package's on the
same inputs, and against the reference goldens (tests/golden)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from esrganplus_tpu import data as jdata
from esrganplus_tpu import options as jopt
from esrganplus_tpu.ops import color as jcolor
from esrganplus_tpu.ops import metrics as jmetrics
from esrganplus_tpu.ops import resize as jresize
from esrganplus_tpu_torch import data as pdata
from esrganplus_tpu_torch import options as popt
from esrganplus_tpu_torch.ops import color as pcolor
from esrganplus_tpu_torch.ops import metrics as pmetrics
from esrganplus_tpu_torch.ops import resize as presize
from esrganplus_tpu_torch.ops.image_io import save_img

OPTDIR = os.path.join(os.path.dirname(__file__), "..", "esrganplus_tpu", "options")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


# ---------------------------------------------------------------------------
# options
# ---------------------------------------------------------------------------


def _plain(o):
    if isinstance(o, dict):
        return {k: _plain(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_plain(v) for v in o]
    return o


@pytest.mark.parametrize("rel,is_train", [("train/train_sr.json", True),
                                          ("train/train_ESRGANplus.json", True),
                                          ("test/test_ESRGANplus.json", False)])
def test_parse_matches_jax(rel, is_train):
    path = os.path.join(OPTDIR, rel)
    got, want = popt.parse(path, is_train=is_train), jopt.parse(path, is_train=is_train)
    assert _plain(got) == _plain(want)
    assert got["nonexistent_key"] is None and got["path"]["nope"] is None
    assert popt.dict2str(got) == jopt.dict2str(want)


def _sr_options(tmp_path, name="debug_run", **train):
    src = json.loads(jopt.options._strip_comments(
        open(os.path.join(OPTDIR, "train", "train_sr.json")).read()))
    src["name"] = name
    src["train"].update(train)
    p = tmp_path / "o.json"
    p.write_text(json.dumps(src))
    return str(p)


def test_builders_match_jax_field_by_field(tmp_path):
    path = _sr_options(tmp_path, compute_dtype="bfloat16", weight_decay_G=1e-4,
                       noise_prng="threefry")
    got, want = popt.parse(path), jopt.parse(path)
    assert got["train"]["val_freq"] == 8 and got["logger"]["print_freq"] == 2  # debug name
    g_p, g_j = popt.build_net_g_config(got), jopt.build_net_g_config(want)
    for f in dataclasses.fields(g_j):
        if f.name in ("trunk_kernel", "tail_kernel"):  # "auto" in both; other spellings
            assert getattr(g_p, f.name) == getattr(g_j, f.name) == "auto"
        else:
            assert getattr(g_p, f.name) == getattr(g_j, f.name), f.name
    t_p, t_j = popt.build_train_config(got), jopt.build_train_config(want)
    for f in dataclasses.fields(t_j):
        assert getattr(t_p, f.name) == getattr(t_j, f.name), f.name
    assert t_p.compute_dtype == "bfloat16" and t_p.noise_prng == "threefry"


def test_check_resume_matches_jax(tmp_path):
    path = _sr_options(tmp_path)
    got, want = popt.parse(path), jopt.parse(path)
    for o in (got, want):
        o["path"]["resume_state"] = os.path.join(o["path"]["training_state"], "12.state.npz")
    popt.check_resume(got)
    jopt.check_resume(want)
    assert got["path"]["pretrain_model_G"] == want["path"]["pretrain_model_G"]
    assert got["path"]["pretrain_model_G"].endswith("12_G.pth")


@pytest.mark.parametrize("model,which", [("srgan", None), ("srragan", None), ("sftgan", None),
                                         ("sr", "sr_resnet"), ("sr", "sft_arch")])
def test_unported_models_name_the_roadmap(tmp_path, model, which):
    opt = popt.parse(_sr_options(tmp_path))
    opt["model"] = model
    if which:
        opt["network_G"]["which_model_G"] = which
    if model in ("srgan", "srragan"):  # ported with the GAN slice: no longer refused
        assert popt.build_train_config(opt).variant == model
        return
    if which == "sr_resnet":  # ported with SRResNet: no longer refused
        assert type(popt.build_net_g_config(opt)).__name__ == "SRResNetConfig"
        return
    # SFT-GAN ported with its slice: no longer refused; a name neither
    # package knows still is
    if model == "sftgan":
        assert type(popt.build_train_config(opt)).__name__ == "SFTGANTrainConfig"
    else:
        assert type(popt.build_net_g_config(opt)).__name__ == "SFTNetConfig"
    opt["model"] = "sftgan_v2"
    with pytest.raises(NotImplementedError, match="not recognized"):
        popt.build_train_config(opt)


# ---------------------------------------------------------------------------
# host numerics
# ---------------------------------------------------------------------------


def test_imresize_np_matches_jax_and_golden():
    g = np.load(os.path.join(GOLDEN, "bicubic.npz"))
    for i in range(int(g["n"])):
        inp, scale = g[f"in_{i}"], float(g[f"scale_{i}"])
        got = presize.imresize_np(inp, scale)
        np.testing.assert_allclose(got, jresize.imresize_np(inp, scale), atol=1e-6)
        np.testing.assert_allclose(got, g[f"out_{i}"], atol=2e-5)
    noaa = np.load(os.path.join(GOLDEN, "bicubic_noaa.npz"))
    np.testing.assert_allclose(presize.imresize_np(noaa["inp"], 0.25, antialiasing=False),
                               noaa["out"], atol=2e-5)


def test_imresize_torch_matches_jax():
    batch = np.random.RandomState(1).rand(2, 32, 40, 3).astype(np.float32)
    got = presize.imresize(torch.from_numpy(batch), 0.25).numpy()
    assert got.shape == (2, 8, 10, 3)
    np.testing.assert_allclose(got, np.asarray(jresize.imresize(batch, 0.25)), atol=1e-5)
    np.testing.assert_allclose(got[1], presize.imresize_np(batch[1], 0.25), atol=1e-5)


def test_color_matches_jax_and_golden():
    g = np.load(os.path.join(GOLDEN, "color.npz"))
    for fn, args, key in (("rgb2ycbcr", ("imgf", True), "rgb2y_f"),
                          ("rgb2ycbcr", ("imgf", False), "rgb2ycc_f"),
                          ("rgb2ycbcr", ("imgu", True), "rgb2y_u"),
                          ("bgr2ycbcr", ("imgf", True), "bgr2y_f"),
                          ("bgr2ycbcr", ("imgu", False), "bgr2ycc_u"),
                          ("ycbcr2rgb", ("imgf",), "ycbcr2rgb_f"),
                          ("ycbcr2rgb", ("imgu",), "ycbcr2rgb_u")):
        a = (g[args[0]],) + args[1:]
        got = getattr(pcolor, fn)(*a)
        np.testing.assert_allclose(got, getattr(jcolor, fn)(*a), atol=1e-6)
        np.testing.assert_allclose(got, g[key], atol=1e-6)
        assert got.dtype == g[key].dtype or got.dtype == np.float32
    y = pcolor.y_channel(torch.from_numpy(g["imgf"]), "rgb").numpy()
    np.testing.assert_allclose(y, np.asarray(jcolor.y_channel_jax(g["imgf"], "rgb")), atol=1e-6)


@pytest.mark.parametrize("target", ["gray", "y", "RGB"])
def test_channel_convert_and_modcrop_match_jax(target):
    rs = np.random.RandomState(2)
    in_c = 1 if target == "RGB" else 3
    imgs = [rs.rand(9, 11, in_c).astype(np.float32) for _ in range(2)]
    for a, b in zip(pcolor.channel_convert(in_c, target, imgs),
                    jcolor.channel_convert(in_c, target, imgs)):
        np.testing.assert_allclose(a, b, atol=1e-6)
    img = np.zeros((37, 53, 3))
    assert pcolor.modcrop(img, 4).shape == jcolor.modcrop(img, 4).shape == (36, 52, 3)
    assert pcolor.modcrop(img[:, :, 0], 8).shape == (32, 48)


def test_metrics_match_jax_and_golden():
    g = np.load(os.path.join(GOLDEN, "metrics.npz"))
    assert abs(pmetrics.calculate_psnr(g["a"], g["b"]) - float(g["psnr"])) < 1e-9
    assert pmetrics.calculate_psnr(g["a"], g["b"]) == jmetrics.calculate_psnr(g["a"], g["b"])
    assert abs(pmetrics.calculate_ssim(g["a"], g["b"]) - float(g["ssim_rgb"])) < 1e-8
    assert abs(pmetrics.calculate_ssim(g["a"][:, :, 0], g["b"][:, :, 0])
               - float(g["ssim_gray"])) < 1e-8
    assert pmetrics.calculate_psnr(g["a"], g["a"]) == float("inf")


# ---------------------------------------------------------------------------
# datasets and loaders
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def img_root(tmp_path_factory):
    """Synthetic paired dataset: 4 HR 64×64 images + matching ×4-down LR."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.RandomState(0)
    for i in range(4):
        hr = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
        save_img(hr, str(root / "HR" / f"img{i}.png"))
        lr = np.clip(presize.imresize_np(hr.astype(np.float32) / 255.0, 0.25), 0, 1)
        save_img((lr * 255).round().astype(np.uint8), str(root / "LR" / f"img{i}.png"))
    return str(root / "HR"), str(root / "LR")


def _train_opt(hr_dir, lr_dir, **kw):
    return {"mode": "LRHR", "phase": "train", "scale": 4, "HR_size": 32,
            "dataroot_HR": hr_dir, "dataroot_LR": lr_dir, "seed": 1, **kw}


@pytest.mark.parametrize("aug", [True, False])
def test_lrhr_dataset_crops_match_jax(img_root, aug):
    hr_dir, lr_dir = img_root
    opt = _train_opt(hr_dir, lr_dir, use_flip=aug, use_rot=aug)
    got, want = pdata.create_dataset(opt), jdata.create_dataset(opt)
    assert len(got) == len(want) == 4
    for i in (0, 1, 2, 3, 1):  # the same seeded crop/augment stream
        a, b = got[i], want[i]
        assert a["LR"].shape == (8, 8, 3) and a["HR"].shape == (32, 32, 3)
        np.testing.assert_array_equal(a["LR"], b["LR"])
        np.testing.assert_array_equal(a["HR"], b["HR"])
        assert a["HR_path"] == b["HR_path"] and a["LR_path"] == b["LR_path"]


def test_val_and_lr_datasets_match_jax(img_root):
    hr_dir, lr_dir = img_root
    opt = {"mode": "LRHR", "phase": "val", "scale": 4, "dataroot_HR": hr_dir}
    a, b = pdata.create_dataset(opt)[0], jdata.create_dataset(opt)[0]
    assert a["LR"].shape == (16, 16, 3)  # on-the-fly bicubic LR
    np.testing.assert_allclose(a["LR"], b["LR"], atol=1e-6)
    np.testing.assert_array_equal(a["HR"], b["HR"])
    opt = {"mode": "LR", "phase": "test", "dataroot_LR": lr_dir}
    np.testing.assert_array_equal(pdata.create_dataset(opt)[2]["LR"],
                                  jdata.create_dataset(opt)[2]["LR"])


def test_unported_data_sources_are_refused(img_root):
    """Nothing is refused any more: the segmentation dataset (mode
    ``LRHRseg_bg``) is the SFT-GAN slice's (tests/test_torch_sftgan_trainer.py
    holds it against the JAX package) and builds as JAX's does. LMDB roots
    are ported (tests/test_torch_data_prep.py); one that holds no LMDB
    environment fails on open, as the JAX package's does."""
    hr_dir, lr_dir = img_root
    with pytest.raises(FileNotFoundError, match="data.mdb"):
        pdata.create_dataset(_train_opt(hr_dir, lr_dir, data_type="lmdb"))
    with pytest.raises(FileNotFoundError, match="data.mdb"):
        jdata.create_dataset(_train_opt(hr_dir, lr_dir, data_type="lmdb"))
    seg_opt = {"mode": "LRHRseg_bg", "phase": "val", "dataroot_HR": hr_dir}
    got, want = pdata.create_dataset(seg_opt), jdata.create_dataset(seg_opt)
    assert type(got).__name__ == type(want).__name__ == "LRHRSegBGDataset"
    assert len(got) == len(want) > 0
    with pytest.raises(NotImplementedError):
        pdata.create_dataset({"mode": "LRHRseg"})


def _first_batches(hr_dir, lr_dir, n, start=0, workers=1):
    ds = pdata.create_dataset(_train_opt(hr_dir, lr_dir))
    loader = pdata.TrainLoader(ds, batch_size=2, num_workers=workers, seed=5,
                               start_batch=start)
    it = iter(loader)
    out = [next(it) for _ in range(n)]
    loader.stop()
    return out


def test_train_loader_batches_are_a_function_of_seed_and_index(img_root):
    """Same seed, same stream; every epoch (2 batches of 2 over 4 images)
    visits each image once, as the JAX loader's epochs do; a loader started
    at batch 3 yields batch 3 on, without producing the first three; and
    three workers hand out the same batches in the same order."""
    hr_dir, lr_dir = img_root
    a, b = _first_batches(hr_dir, lr_dir, 6), _first_batches(hr_dir, lr_dir, 6)
    for x, y in zip(a, b):
        assert x["LR"].shape == (2, 8, 8, 3) and x["HR"].shape == (2, 32, 32, 3)
        np.testing.assert_array_equal(x["HR"], y["HR"])
        assert x["HR_path"] == y["HR_path"]
    for e in range(3):
        assert len(set(a[2 * e]["HR_path"] + a[2 * e + 1]["HR_path"])) == 4
    assert [x["HR_path"] for x in a[:2]] != [x["HR_path"] for x in a[2:4]] \
        or [x["HR_path"] for x in a[:2]] != [x["HR_path"] for x in a[4:]]
    for x, y in zip(a[3:], _first_batches(hr_dir, lr_dir, 3, start=3)):
        np.testing.assert_array_equal(x["LR"], y["LR"])
        np.testing.assert_array_equal(x["HR"], y["HR"])
    # three workers may finish out of turn; the loader hands batches out in
    # the order of their index all the same
    for x, y in zip(a, _first_batches(hr_dir, lr_dir, 6, workers=3)):
        np.testing.assert_array_equal(x["HR"], y["HR"])
        assert x["HR_path"] == y["HR_path"]


@pytest.mark.parametrize("workers", [1, 3])
def test_train_loader_holds_back_a_bounded_number_of_batches(workers):
    """While the consumer waits on one slow batch, the workers make no more
    than the queue's depth plus one batch each beyond the batches yielded:
    the batches held back for their turn do not grow without bound."""
    import itertools
    import threading
    import time

    release, lock, calls = threading.Event(), threading.Lock(), [0]

    class SlowFirst:
        def __len__(self):
            return 64

        def sample(self, i, rng):
            with lock:
                calls[0] += 1
                first = calls[0] == 1
            if first:
                release.wait(10)
            return {"x": np.zeros(1, np.float32)}

    loader = pdata.TrainLoader(SlowFirst(), batch_size=1, num_workers=workers, queue_depth=2)
    got = []
    consumer = threading.Thread(target=lambda: got.extend(itertools.islice(loader, 3)),
                                daemon=True)
    consumer.start()
    time.sleep(1.0)
    made = calls[0]
    release.set()
    consumer.join(10)
    loader.stop()
    assert len(got) == 3
    # the slow batch is batch 0, or batch 1 when another worker started first
    assert made <= 2 + workers + 1, made


def test_collate_eval_loader_and_device_feeder(img_root):
    out = pdata.collate([{"a": np.zeros((2, 2)), "p": "x", "n": 1},
                         {"a": np.ones((2, 2)), "p": "y", "n": 2}])
    assert out["a"].shape == (2, 2, 2) and out["p"] == ["x", "y"] and out["n"].tolist() == [1, 2]
    hr_dir, lr_dir = img_root
    val = pdata.create_dataset({"mode": "LRHR", "phase": "val", "scale": 4,
                                "dataroot_HR": hr_dir, "dataroot_LR": lr_dir})
    ev = pdata.create_dataloader(val, {"phase": "val"})
    assert isinstance(ev, pdata.EvalLoader) and len(ev) == 4 and len(list(ev)) == 4
    ds = pdata.create_dataset(_train_opt(hr_dir, lr_dir))
    loader = pdata.create_dataloader(ds, {"phase": "train", "batch_size": 2, "n_workers": 1},
                                     seed=5)
    feeder = pdata.DeviceFeeder(loader, "cpu")
    it = iter(feeder)
    want = _first_batches(hr_dir, lr_dir, 3)
    for w in want:
        (lr, hr), host = next(it)
        assert lr.dtype == torch.float32 and lr.shape == (2, 8, 8, 3)
        np.testing.assert_array_equal(hr.numpy(), w["HR"])
        assert host["HR_path"] == w["HR_path"]
    feeder.stop()
    loader.stop()
