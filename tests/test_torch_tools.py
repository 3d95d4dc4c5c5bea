"""The port's offline tools against the JAX package's on the same inputs:
``ops/back_projection.py`` (``back_projection`` and ``reverse_filter`` within
1e-5, on the CPU here), ``cli/net_interp.py`` and ``cli/transfer_params.py``
(exact: the same bytes of every tensor; ``srgan_to_sft_map`` against the
reference golden), the seven ``cli/image_tools.py`` subcommands (the same
output files), and ``cli/auto_test.py`` sweeping the port's ``cli.test``
over two checkpoints and a missing one."""

import json
import os

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _pair(seed, hr=32, scale=4):
    from esrganplus_tpu_torch.ops.resize import imresize_np

    rng = np.random.RandomState(seed)
    img = rng.rand(hr, hr, 3).astype(np.float32)
    lr = imresize_np(img, 1.0 / scale)
    sr = np.clip(img + rng.randn(hr, hr, 3).astype(np.float32) * 0.05, 0, 1)
    return sr, lr


@pytest.mark.parametrize("fn", ["back_projection", "reverse_filter"])
@pytest.mark.parametrize("hr,scale,iters", [(32, 4, 10), (48, 4, 20), (30, 2, 5)])
def test_filters_match_jax(fn, hr, scale, iters):
    import esrganplus_tpu.ops.back_projection as J
    import esrganplus_tpu_torch.ops.back_projection as P

    sr, lr = _pair(hr + scale, hr, scale)
    want = getattr(J, fn)(sr, lr, scale, iters)
    got = getattr(P, fn)(sr, lr, scale, iters, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5


def test_gaussian_factor_matches_jax():
    from esrganplus_tpu.ops.back_projection import _fspecial_gaussian_sq as j
    from esrganplus_tpu_torch.ops.back_projection import _fspecial_gaussian_sq as p

    assert np.array_equal(p(), j())


def test_filters_need_a_card_unless_asked_for_cpu():
    from esrganplus_tpu_torch.ops.back_projection import back_projection

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        back_projection(*_pair(0), 4, 1)


def _state_dicts():
    rs = np.random.RandomState(2)
    a = {"k": rs.randn(3, 4).astype(np.float32), "only_a": rs.randn(5).astype(np.float32)}
    b = {"k": rs.randn(3, 4).astype(np.float32), "only_b": rs.randn(2, 2).astype(np.float32)}
    return a, b


def _saved(path):
    return {k: v.numpy() for k, v in torch.load(path).items()}


def _same_files(a, b):
    sa, sb = _saved(a), _saved(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and np.array_equal(sa[k], sb[k]), k


def test_net_interp_matches_jax(tmp_path):
    from esrganplus_tpu.cli import net_interp as J
    from esrganplus_tpu_torch.cli import net_interp as P

    a, b = _state_dicts()
    for alpha in (0.0, 0.3, 1.0):
        want, got = J.interpolate_state_dicts(a, b, alpha), P.interpolate_state_dicts(a, b, alpha)
        assert want.keys() == got.keys()
        for k in want:
            assert np.array_equal(got[k], want[k]), (alpha, k)
    for name, sd in (("a", a), ("b", b)):
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / f"{name}.pth")
    args = lambda out: ["0.25", str(tmp_path / "a.pth"), str(tmp_path / "b.pth"), str(out)]
    J.main(args(tmp_path / "j.pth"))
    P.main(args(tmp_path / "p.pth"))
    _same_files(tmp_path / "p.pth", tmp_path / "j.pth")


def test_srgan_to_sft_map_matches_reference_golden():
    from esrganplus_tpu.cli.transfer_params import srgan_to_sft_map as jmap
    from esrganplus_tpu_torch.cli.transfer_params import srgan_to_sft_map

    with open(os.path.join(GOLDEN, "transfer_sft_map.json")) as f:
        golden = json.load(f)
    ours = {dst + suf: src + suf for dst, src in srgan_to_sft_map(16).items()
            for suf in (".weight", ".bias")}
    assert ours == golden
    assert srgan_to_sft_map(3) == jmap(3)


@pytest.mark.parametrize("sft", [False, True])
def test_transfer_params_matches_jax(tmp_path, sft):
    from esrganplus_tpu.cli import transfer_params as J
    from esrganplus_tpu_torch.cli import transfer_params as P

    rs = np.random.RandomState(4)
    if sft:
        mapping = {d + s: k + s for d, k in P.srgan_to_sft_map(16).items()
                   for s in (".weight", ".bias")}
        src = {k: rs.randn(2).astype(np.float32) for k in sorted(set(mapping.values()))}
        dst = {k: np.zeros(2, np.float32) for k in mapping}
        dst["CondNet.0.weight"] = np.full(3, 0.25, np.float32)
    else:
        src = {"a": rs.randn(3).astype(np.float32), "b": rs.randn(2, 2).astype(np.float32)}
        dst = {"a": np.zeros(3, np.float32), "b": np.zeros(3, np.float32),
               "c": np.ones(1, np.float32)}
        want, got = J.transfer(src, dst), P.transfer(src, dst)
        assert want[1:] == got[1:] == (["a"], ["b", "c"])
        for k in want[0]:
            assert np.array_equal(got[0][k], want[0][k])
    torch.save({k: torch.from_numpy(v) for k, v in src.items()}, tmp_path / "s.pth")
    torch.save({k: torch.from_numpy(v) for k, v in dst.items()}, tmp_path / "t.pth")
    args = lambda out: [str(tmp_path / "s.pth"), str(tmp_path / "t.pth"), str(out)] + \
        (["--sft"] if sft else [])
    J.main(args(tmp_path / "j.pth"))
    P.main(args(tmp_path / "p.pth"))
    _same_files(tmp_path / "p.pth", tmp_path / "j.pth")


# ---------------------------------------------------------------------------
# image_tools: each subcommand of both packages on copies of one input
# ---------------------------------------------------------------------------


def _frames(d, n=3, h=64, w=48, seed=11):
    import cv2

    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n):
        cv2.imwrite(os.path.join(d, f"x{i}.png"), (rng.rand(h, w, 3) * 255).astype(np.uint8))
    return d


def _tree(d) -> dict:
    """Every file under ``d`` → its bytes (PNGs → their decoded pixels)."""
    import cv2

    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            key = os.path.relpath(p, d)
            out[key] = (cv2.imread(p, cv2.IMREAD_UNCHANGED).tobytes() if f.endswith(".png")
                        else open(p, "rb").read())
    return out


SUBCOMMANDS = {
    "color2gray": lambda i, o: ["color2gray", i, o],
    "rename": lambda i, o: ["rename", i, "--pattern", "{base}_x4"],
    "patches": lambda i, o: ["patches", i, o, "--x", "5", "--y", "7", "--w", "16", "--h", "12",
                             "--enlarge", "3"],
    "video": lambda i, o: ["video", i, os.path.join(o, "v.avi"), "--fps", "5"],
    "annotate": lambda i, o: ["annotate", i, o, "--text", "a", "b", "c", "--crop-x", "2",
                              "--crop-y", "3", "--crop-w", "30", "--crop-h", "40",
                              "--enlarge", "2", "--color", "matlab_blue"],
    "gif": lambda i, o: ["gif", i, os.path.join(o, "a.gif"), "--duration", "0.5"],
}


@pytest.mark.parametrize("cmd", list(SUBCOMMANDS))
def test_image_tools_match_jax(tmp_path, cmd):
    from esrganplus_tpu.cli.image_tools import main as jmain
    from esrganplus_tpu_torch.cli.image_tools import main as pmain

    outs = {}
    for tag, main in (("jax", jmain), ("port", pmain)):
        inp = _frames(str(tmp_path / tag / "in"))
        out = str(tmp_path / tag / "out")
        os.makedirs(out, exist_ok=True)
        main(SUBCOMMANDS[cmd](inp, out))
        outs[tag] = _tree(str(tmp_path / tag))
    assert outs["port"] and outs["port"] == outs["jax"]


def test_image_tools_backproject_matches_jax(tmp_path):
    import cv2

    from esrganplus_tpu.cli.image_tools import main as jmain
    from esrganplus_tpu_torch.cli.image_tools import main as pmain
    from esrganplus_tpu_torch.ops.image_io import read_img

    sr_dir, lr_dir = tmp_path / "sr", tmp_path / "lr"
    os.makedirs(sr_dir)
    os.makedirs(lr_dir)
    for i in range(2):
        sr, lr = _pair(20 + i, 32)
        cv2.imwrite(str(sr_dir / f"img{i}_rlt.png"), (sr * 255).round().astype(np.uint8))
        cv2.imwrite(str(lr_dir / f"img{i}.png"), (lr.clip(0, 1) * 255).round().astype(np.uint8))
    for flags in ([], ["--reverse-filter"]):
        args = lambda out: ["backproject", str(sr_dir), str(lr_dir), str(out), "--scale", "4",
                            "--iters", "5", *flags]
        jmain(args(tmp_path / "j"))
        pmain(args(tmp_path / "p") + ["--device", "cpu"])
        for f in sorted(os.listdir(tmp_path / "j")):
            want, got = read_img(str(tmp_path / "j" / f)), read_img(str(tmp_path / "p" / f))
            # 8-bit output of values within 1e-5: at most one step apart
            assert np.abs(got - want).max() <= 1.0 / 255 + 1e-6, f


# ---------------------------------------------------------------------------
# auto_test: the sweep through the port's cli.test
# ---------------------------------------------------------------------------


def test_auto_test_sweeps_checkpoints(tmp_path, capsys):
    from esrganplus_tpu_torch.cli.auto_test import main
    from esrganplus_tpu_torch.convert import generator_to_state_dict
    from esrganplus_tpu_torch.models import RRDBNetConfig, generator_init
    from esrganplus_tpu_torch.ops.image_io import save_img

    cfg = RRDBNetConfig(nf=8, nb=1, gc=4)
    models = tmp_path / "experiments" / "exp" / "models"
    os.makedirs(models)
    for it, seed in (("8", 1), ("latest", 2)):
        sd = generator_to_state_dict(generator_init(seed, cfg), cfg)
        torch.save(sd, models / f"{it}_G.pth")
    rng = np.random.RandomState(5)
    for d, size in (("HR", 32), ("LR", 8)):
        os.makedirs(tmp_path / d)
        save_img((rng.rand(size, size, 3) * 255).astype(np.uint8), str(tmp_path / d / "a.png"))
    opt = {"name": "base", "model": "sr", "scale": 4,
           "datasets": {"test_1": {"name": "tiny", "mode": "LRHR",
                                   "dataroot_HR": str(tmp_path / "HR"),
                                   "dataroot_LR": str(tmp_path / "LR")}},
           "path": {"root": str(tmp_path)},
           "network_G": {"which_model_G": "RRDB_net", "norm_type": None, "mode": "CNA",
                         "nf": 8, "nb": 1, "in_nc": 3, "out_nc": 3, "gc": 4}}
    with open(tmp_path / "t.json", "w") as f:
        json.dump(opt, f)
    main(["-opt", str(tmp_path / "t.json"), "--models-root", str(tmp_path / "experiments"),
          "--names", "exp", "--iters", "8", "16", "latest", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "=== testing exp @ 8 ===" in printed and "=== testing exp @ latest ===" in printed
    assert "skip exp@16: no checkpoint" in printed
    outs = {it: tmp_path / "results" / f"exp_{it}" / "tiny" for it in ("8", "latest")}
    imgs = {it: [f for f in os.listdir(d) if f.endswith(".png")] for it, d in outs.items()}
    assert all(imgs.values()), imgs
    assert not os.path.exists(tmp_path / "results" / "exp_16")
