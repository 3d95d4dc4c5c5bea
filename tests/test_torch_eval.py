"""The port's evaluation slice against the JAX package's, on the CPU: the
device metrics (``ops.metrics.psnr_torch`` / ``ssim_torch``), batched
evaluation (``infer.BatchedEvaluator`` against ``ShardedEvaluator`` on a
4-device CPU mesh), ``cli/test.py``, ``cli/calculate_metrics.py`` and
``cli/parity_check.py``, on a tiny ×4 RRDBNet (nf 8, nb 1, gc 4)."""

import glob
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from esrganplus_tpu.models.rrdb import RRDBNetConfig, init_rrdbnet
from esrganplus_tpu.ops.image_io import save_img

CFG = RRDBNetConfig(nf=8, nb=1, gc=4, upscale=4)
SIZES = ((64, 64), (64, 64), (44, 60))  # HR; LR 16², 16², 11×15
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A tiny seeded checkpoint and a three-image LRHR set (HR 64², 64², 44×60;
    LR by the port's bicubic), plus both packages' inferencers on it."""
    from esrganplus_tpu.convert.pth import generator_to_state_dict
    from esrganplus_tpu.infer import SRInferencer as JInf
    from esrganplus_tpu.infer import load_generator as jload
    from esrganplus_tpu_torch.infer import load_generator as pload
    from esrganplus_tpu_torch.ops.resize import imresize_np

    root = str(tmp_path_factory.mktemp("eval"))
    params = init_rrdbnet(jax.random.PRNGKey(0), CFG)
    pth = os.path.join(root, "tiny.pth")
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in generator_to_state_dict(params, CFG).items()}, pth)
    hr_dir, lr_dir = os.path.join(root, "HR"), os.path.join(root, "LR")
    rng = np.random.RandomState(3)
    for i, (h, w) in enumerate(SIZES):
        yy, xx = np.mgrid[0:h, 0:w] / 8.0
        hr = 0.5 + 0.25 * np.sin(yy[..., None] + xx[..., None] * (1 + np.arange(3)))
        hr = np.clip(hr + rng.rand(h, w, 3) * 0.1, 0, 1)
        save_img((hr * 255).round().astype(np.uint8), os.path.join(hr_dir, f"img{i}.png"))
        lr = np.clip(imresize_np(hr.astype(np.float32), 0.25), 0, 1)
        save_img((lr * 255).round().astype(np.uint8), os.path.join(lr_dir, f"img{i}.png"))
    jp, jcfg, _ = jload(pth)
    pp, pcfg, _ = pload(pth, device="cpu")
    return {"root": root, "pth": pth, "hr": hr_dir, "lr": lr_dir,
            "jinf": JInf(jp, jcfg), "pp": pp, "pcfg": pcfg}


# ---------------------------------------------------------------------------
# psnr_torch / ssim_torch
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(GOLDEN, "metrics.npz"))


@pytest.mark.parametrize("case", ["rgb", "gray", "batch"])
def test_device_metrics_match_jax(golden, case):
    """float32 on the tensors' device: within 1e-4 dB / 1e-6 of psnr_jax /
    ssim_jax on the same inputs (HWC, HW1 and [B, H, W, C])."""
    from esrganplus_tpu.ops.metrics import psnr_jax, ssim_jax
    from esrganplus_tpu_torch.ops.metrics import psnr_torch, ssim_torch

    a, b = golden["a"].astype(np.float32), golden["b"].astype(np.float32)
    if case == "gray":
        a, b = a[..., :1], b[..., :1]
    elif case == "batch":
        a = np.stack([a, a[::-1]])
        b = np.stack([b, b[:, ::-1]])
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    p, s = psnr_torch(ta, tb), ssim_torch(ta, tb)
    assert p.dtype == s.dtype == torch.float32 and p.dim() == s.dim() == 0
    assert abs(float(p) - float(psnr_jax(a, b))) <= 1e-4
    assert abs(float(s) - float(ssim_jax(a, b))) <= 1e-6


def test_device_metrics_close_to_host_golden(golden):
    """JAX's own bars against the float64 host protocol (test_color_metrics)."""
    from esrganplus_tpu_torch.ops import psnr_torch, ssim_torch

    a, b = torch.from_numpy(golden["a"]), torch.from_numpy(golden["b"])
    assert abs(float(psnr_torch(a, b)) - float(golden["psnr"])) < 1e-3
    assert abs(float(ssim_torch(a, b)) - float(golden["ssim_rgb"])) < 1e-4
    assert float(psnr_torch(a, a)) == pytest.approx(20 * np.log10(255.0) + 120.0)


# ---------------------------------------------------------------------------
# BatchedEvaluator against ShardedEvaluator
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sharded(env):
    """JAX's ShardedEvaluator on a 4-device CPU mesh (4 images a forward, as
    the port's default batch) and its results on both image sets."""
    from esrganplus_tpu.infer import ShardedEvaluator
    from esrganplus_tpu.parallel import make_mesh

    jinf = env["jinf"]
    ev = ShardedEvaluator(jinf.cfg, make_mesh(data=4, devices=jax.devices()[:4]))
    rng = np.random.RandomState(7)
    same = [rng.rand(16, 24, 3).astype(np.float32) for _ in range(10)]
    mixed = [rng.rand(16, 24, 3).astype(np.float32), rng.rand(12, 17, 3).astype(np.float32)]
    outs = {"same": ev.upscale_batch(jinf.params, same)}
    calls = ev.calls
    outs["mixed"] = ev.upscale_batch(jinf.params, mixed)
    return {"imgs": {"same": same, "mixed": mixed}, "outs": outs, "calls": calls}


def test_batched_evaluator_matches_sharded_same_size(env, sharded):
    """Ten same-size images (no padding): within 1e-5 of JAX's sharded
    results, in as many forwards (3), each also equal to the port's own
    sequential upscale."""
    from esrganplus_tpu_torch.infer import BatchedEvaluator, SRInferencer

    ev = BatchedEvaluator(env["pp"], env["pcfg"], device="cpu")
    got = ev.upscale_batch(sharded["imgs"]["same"])
    assert ev.calls == sharded["calls"] == 3
    seq = SRInferencer(env["pp"], env["pcfg"], device="cpu")
    for img, a, b in zip(sharded["imgs"]["same"], got, sharded["outs"]["same"]):
        assert a.dtype == np.float32 and a.shape == b.shape == (64, 96, 3)
        assert np.abs(a - b).max() <= 1e-5
        assert np.abs(a - seq.upscale(img)).max() <= 1e-5


def test_batched_evaluator_mixed_sizes_interior(env, sharded):
    """Mixed sizes are edge-padded to the set's max (a multiple of 8) and
    cropped back: equal to JAX's sharded results (the same padding), and
    within 2e-3 of whole-image inference away from the pad edge's receptive
    radius; one short forward."""
    from esrganplus_tpu_torch.infer import BatchedEvaluator

    ev = BatchedEvaluator(env["pp"], env["pcfg"], device="cpu")
    got = ev.upscale_batch(sharded["imgs"]["mixed"])
    assert ev.calls == 1
    jinf = env["jinf"]
    m = jinf.derive_halo(eps=1e-3, probe=32) * CFG.upscale
    for img, a, b in zip(sharded["imgs"]["mixed"], got, sharded["outs"]["mixed"]):
        want = jinf.upscale(img)
        assert a.shape == b.shape == want.shape
        assert np.abs(a - b).max() <= 1e-5
        assert a.min() >= 0.0 and a.max() <= 1.0
        np.testing.assert_allclose(a[:-m, :-m], want[:-m, :-m], atol=2e-3)


# ---------------------------------------------------------------------------
# cli/test.py
# ---------------------------------------------------------------------------


def _test_options(env, tag, **extra):
    opt = {"name": f"eval_{tag}", "model": "sr", "scale": 4,
           "datasets": {"test_1": {"name": "tiny", "mode": "LRHR", "dataroot_HR": env["hr"],
                                   "dataroot_LR": env["lr"]}},
           "path": {"root": os.path.join(env["root"], tag), "pretrain_model_G": env["pth"]},
           "network_G": {"which_model_G": "RRDB_net", "norm_type": None, "mode": "CNA",
                         "nf": 8, "nb": 1, "in_nc": 3, "out_nc": 3, "gc": 4,
                         "gaussian_noise": True},
           **extra}
    path = os.path.join(env["root"], f"{tag}.json")
    with open(path, "w") as f:
        json.dump(opt, f)
    return path, os.path.join(env["root"], tag, "results", f"eval_{tag}")


_LINE = re.compile(r"(img\d)\s+- PSNR: ([\d.]+) dB; SSIM: ([\d.]+); "
                   r"PSNR_Y: ([\d.]+) dB; SSIM_Y: ([\d.]+)\.")


def _logged(results):
    """{image: (PSNR, SSIM, PSNR_Y, SSIM_Y)} from a test run's log."""
    (log,) = glob.glob(os.path.join(results, "test_*.log"))
    return {m.group(1): tuple(float(v) for v in m.groups()[1:])
            for m in _LINE.finditer(open(log).read())}


def _pngs(results):
    from esrganplus_tpu_torch.ops.image_io import read_img

    return {os.path.basename(p): (read_img(p) * 255).round().astype(int)
            for p in sorted(glob.glob(os.path.join(results, "tiny", "*.png")))}


@pytest.fixture(scope="module")
def jax_test_run(env):
    """JAX's cli.test on the set, one image at a time (``eval_sharded``
    false: the 8-device test mesh would otherwise shard it)."""
    from esrganplus_tpu.cli.test import main

    path, results = _test_options(env, "jax", eval_sharded=False)
    main(["-opt", path])
    return results


@pytest.fixture(scope="module")
def jax_sharded_run(env):
    """JAX's cli.test on the set sharded over the 8-device test mesh: every
    LR edge-padded to the set's max (16², a multiple of 8), as the port's
    batched path pads it."""
    from esrganplus_tpu.cli.test import main

    path, results = _test_options(env, "jax_sharded")
    main(["-opt", path])
    return results


@pytest.mark.parametrize("batched", [False, True], ids=["sequential", "batched"])
def test_cli_test_matches_jax(env, batched, request):
    """The port's cli.test on --device cpu: the same three PNGs (±1 level)
    and the same logged PSNR / SSIM / PSNR_Y / SSIM_Y to 1e-4 as JAX's
    cli.test, one image at a time; batched (``"eval_sharded": true``, four
    images a forward) as JAX's sharded evaluation, which pads alike."""
    from esrganplus_tpu_torch.cli.test import main

    tag = "port_batched" if batched else "port"
    path, results = _test_options(env, tag, **({"eval_sharded": True} if batched else {}))
    main(["-opt", path, "--device", "cpu"])
    jax_results = request.getfixturevalue("jax_sharded_run" if batched else "jax_test_run")
    got, want = _pngs(results), _pngs(jax_results)
    assert sorted(got) == sorted(want) == ["img0.png", "img1.png", "img2.png"]
    lg, lw = _logged(results), _logged(jax_results)
    assert sorted(lg) == sorted(lw) == ["img0", "img1", "img2"]
    for name in sorted(got):
        assert got[name].shape == want[name].shape == (SIZES[int(name[3])] + (3,))
        assert np.abs(got[name] - want[name]).max() <= 1, name
        np.testing.assert_allclose(lg[name[:-4]], lw[name[:-4]], atol=1e-4)


def test_cli_test_x8_and_tiled_modes(env):
    """test_mode x8 and tiled run and log every image (the modes themselves
    are held against JAX in test_torch_infer.py)."""
    from esrganplus_tpu_torch.cli.test import main

    for mode in ("x8", "tiled"):
        path, results = _test_options(env, f"port_{mode}", test_mode=mode, tile_size=8)
        main(["-opt", path, "--device", "cpu"])
        assert sorted(_logged(results)) == ["img0", "img1", "img2"]


def test_cli_test_needs_a_card_unless_asked_for_cpu(env):
    from esrganplus_tpu_torch.cli.test import main

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    path, _ = _test_options(env, "nocard")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["-opt", path])


# ---------------------------------------------------------------------------
# cli/calculate_metrics.py and cli/parity_check.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags", [[], ["--test-y"], ["--crop-border", "0", "--test-y"]])
def test_calculate_metrics_matches_jax(env, jax_test_run, flags, capsys):
    from esrganplus_tpu.cli.calculate_metrics import main as jmain
    from esrganplus_tpu_torch.cli.calculate_metrics import main as pmain

    args = [env["hr"], os.path.join(jax_test_run, "tiny")] + flags
    pmain(args)
    got = capsys.readouterr().out
    jmain(args)
    want = capsys.readouterr().out
    assert got == want and got.count("PSNR") == 4  # three images and the average


@pytest.fixture(scope="module")
def parity_ref(env):
    """The port's fp32 outputs over the LR set, renamed as a reference
    implementation's (``_nESRGANplus``), and JAX's activation dump."""
    from esrganplus_tpu.cli.test_image import main as jti
    from esrganplus_tpu_torch.cli.parity_check import main

    root = env["root"]
    out = os.path.join(root, "parity_ref_run")
    assert main([env["pth"], "--lr", env["lr"], "--hr", env["hr"], "--out", out,
                 "--device", "cpu"]) == 0
    ref_dir = os.path.join(root, "parity_ref")
    os.makedirs(ref_dir)
    for f in os.listdir(os.path.join(out, "sr")):
        os.rename(os.path.join(out, "sr", f),
                  os.path.join(ref_dir, f.replace("_rlt", "_nESRGANplus")))
    acts = os.path.join(root, "jax_acts.json")
    jti([env["pth"], "--input", env["lr"], "--output", os.path.join(root, "jax_sr"),
         "--dump-activations", acts])
    return ref_dir, acts


def _parity(env, tag, *extra):
    from esrganplus_tpu_torch.cli.parity_check import main

    out = os.path.join(env["root"], tag)
    rc = main([env["pth"], "--lr", env["lr"], "--out", out, "--device", "cpu", *extra])
    return rc, json.load(open(os.path.join(out, "summary.json")))["failures"]


def test_parity_check_passes_against_jax(env, parity_ref):
    """Self-consistent against the port's own outputs, and against the JAX
    package's: its outputs as the reference (|ΔPSNR| ≤ 0.01 dB) and its
    activation dump (every stage within 1e-4)."""
    from esrganplus_tpu.cli.parity_check import main as jmain

    ref_dir, acts = parity_ref
    assert _parity(env, "parity_self", "--hr", env["hr"], "--ref-results", ref_dir) == (0, [])
    assert _parity(env, "parity_acts", "--torch-acts", acts) == (0, [])
    out = os.path.join(env["root"], "parity_jax")
    assert jmain([env["pth"], "--lr", env["lr"], "--hr", env["hr"], "--ref-results", ref_dir,
                  "--out", out]) == 0


def test_parity_check_fails_on_wrong_reference(env, parity_ref):
    bad = os.path.join(env["root"], "parity_bad")
    rng = np.random.RandomState(9)
    for i, (h, w) in enumerate(SIZES):
        save_img((rng.rand(h, w, 3) * 255).astype(np.uint8),
                 os.path.join(bad, f"img{i}_nESRGANplus.png"))
    rc, failures = _parity(env, "parity_bad_run", "--hr", env["hr"], "--ref-results", bad)
    assert rc == 1 and any("PSNR delta" in f for f in failures)


def test_parity_check_fails_on_disjoint_basenames(env, parity_ref):
    import shutil

    alien, hr_plus = (os.path.join(env["root"], d) for d in ("parity_alien", "parity_hr"))
    shutil.copytree(env["hr"], hr_plus)
    rng = np.random.RandomState(7)
    for i in range(2):
        for d, name in ((alien, f"other{i}_nESRGANplus.png"), (hr_plus, f"other{i}.png")):
            save_img((rng.rand(48, 48, 3) * 255).astype(np.uint8), os.path.join(d, name))
    rc, failures = _parity(env, "parity_disjoint", "--hr", hr_plus, "--ref-results", alien)
    assert rc == 1 and any("share no basenames" in f for f in failures)


def test_parity_check_ref_results_requires_hr(env):
    from esrganplus_tpu_torch.cli.parity_check import main

    with pytest.raises(SystemExit):
        main([env["pth"], "--lr", env["lr"], "--ref-results", env["root"],
              "--out", os.path.join(env["root"], "noop"), "--device", "cpu"])
