"""The port's OutdoorSceneSeg net (esrganplus_tpu_torch/models/seg.py), the
MINC and ResNet-101 feature extractors (models/feature_extractors.py) and
the two SFT-GAN inference CLIs against the JAX package on the CPU:

  (a) the building blocks: Res131 with and without a projection (dilated
      and strided), the ceil-mode max pool at odd sizes, and the grouped
      16×16 stride-8 transposed conv at an odd size against JAX's
      lhs-dilated, flipped-kernel formulation, each within 1e-5;
  (b) the whole plan at 24×24 from one numpy state dict of 52 M parameters
      read by both packages' ``seg_from_state_dict``: probabilities within
      1e-4, each pixel's summing to 1 within 1e-5; the port's export of it
      bit-equal to the state dict;
  (c) MINC (the fixed 13-conv plan, at an odd size) and ResNet-101 at
      narrow depth (one or two bottlenecks a stage, torchvision widths)
      through their converters, within 1e-5 of max|ref|;
  (d) ``cli.test_seg --device cpu`` writes the three folders, its
      probability map equal to JAX's forward within 1e-4 on the same input
      (the port's input pipeline bit-equal to JAX's ops);
      ``cli.test_sftgan --device cpu`` consumes that map and writes the PNG
      JAX's ``cli.test_sftgan`` writes, within one level.
"""

import os

import cv2
import jax
import numpy as np
import pytest
import torch

from esrganplus_tpu.models import feature_extractors as jfe
from esrganplus_tpu.models import layers as jl
from esrganplus_tpu.models import seg as jseg
from esrganplus_tpu.ops.color import modcrop as jmodcrop
from esrganplus_tpu.ops.resize import imresize_np as jimresize
from esrganplus_tpu_torch.cli import test_seg as pcli_seg
from esrganplus_tpu_torch.cli import test_sftgan as pcli_sft
from esrganplus_tpu_torch.models import feature_extractors as pfe
from esrganplus_tpu_torch.models import seg as pseg
from esrganplus_tpu_torch.models import sft as psft
from esrganplus_tpu_torch.ops.image_io import read_img
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SEG_TOL = 1e-4
TOL = 1e-5


def _rel_close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_t(v) for v in tree]
    return tree if isinstance(tree, (int, type(None))) else torch.from_numpy(np.asarray(tree))


def _bn_conv_np(rs, cin, cout, k, bn_scale=1.0):
    return {"conv": {"w": (rs.randn(k, k, cin, cout) * np.sqrt(2.0 / (k * k * cin)))
                     .astype(np.float32)},
            "bn": {"scale": (rs.uniform(0.5, 1.0, cout) * bn_scale).astype(np.float32),
                   "bias": (rs.randn(cout) * 0.1).astype(np.float32),
                   "mean": (rs.randn(cout) * 0.1).astype(np.float32),
                   "var": rs.uniform(0.5, 1.5, cout).astype(np.float32)}}


def _jax_res131(h, p, dil, s):
    """JAX's Res131 as ``esrganplus_tpu/models/seg.py`` seg_forward runs it."""
    res = jseg._bn_conv(h, p["c0"])
    res = jseg._bn_conv(res, p["c1"], stride=s, dilation=dil)
    res = jseg._bn_conv(res, p["c2"], relu=False)
    shortcut = jseg._bn_conv(h, p["proj"], stride=s, relu=False) if "proj" in p else h
    return jl.act(shortcut + res, "relu")


@pytest.mark.parametrize("cin,mid,cout,dil,s", [(8, 4, 16, 1, 1), (8, 4, 16, 1, 2),
                                                (16, 4, 16, 2, 1), (16, 8, 16, 4, 1),
                                                (8, 4, 16, 2, 1)])
def test_res131_matches_jax(cin, mid, cout, dil, s):
    rs = np.random.RandomState(cin + mid + dil + s)
    p = {"c0": _bn_conv_np(rs, cin, mid, 1), "c1": _bn_conv_np(rs, mid, mid, 3),
         "c2": _bn_conv_np(rs, mid, cout, 1)}
    if cin != cout:
        p["proj"] = _bn_conv_np(rs, cin, cout, 1)
    x = rs.randn(2, 13, 11, cin).astype(np.float32)
    want = np.asarray(_jax_res131(x, p, dil, s))
    got = pseg.res131(torch.from_numpy(x), _t(p), ("res", cin, mid, cout, dil, s)).numpy()
    _rel_close(got, want)


@pytest.mark.parametrize("h,w", [(7, 9), (8, 8), (5, 6), (11, 4), (3, 3)])
def test_maxpool_ceil_matches_jax(h, w):
    x = np.random.RandomState(h * w).randn(2, h, w, 3).astype(np.float32)
    want = np.asarray(jseg._maxpool_ceil(x))
    got = pseg.maxpool_ceil(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w", [(5, 7), (4, 4), (3, 6)])
def test_grouped_deconv_matches_jax(h, w):
    """JAX writes the transposed conv as an lhs-dilated depthwise conv with
    the kernel flipped (``esrganplus_tpu/models/seg.py:113-123``)."""
    cfg = jseg.SegConfig()
    rs = np.random.RandomState(h + w)
    x = rs.randn(2, h, w, 8).astype(np.float32)
    wt = rs.randn(16, 16, 1, 8).astype(np.float32)
    k, st, p_ = cfg.deconv_kernel, cfg.deconv_stride, cfg.deconv_pad
    pad = k - 1 - p_
    dn = jax.lax.conv_dimension_numbers(x.shape, wt.shape, ("NHWC", "HWIO", "NHWC"))
    want = np.asarray(jax.lax.conv_general_dilated(
        x, wt[::-1, ::-1], (1, 1), ((pad, pad), (pad, pad)), lhs_dilation=(st, st),
        dimension_numbers=dn, feature_group_count=8, precision=jax.lax.Precision.HIGHEST))
    got = pseg.deconv_upsample(torch.from_numpy(x), torch.from_numpy(wt)).numpy()
    assert got.shape == (2, 8 * h, 8 * w, 8)
    _rel_close(got, want)


def _seg_numpy_state_dict(seed=0):
    """A reference-layout state dict with seeded numpy values: He-normal
    convs, batch norms near identity, the last BN of each bottleneck scaled
    by 0.2 (its residual adds stay bounded over 33 blocks)."""
    keys = pseg.seg_to_state_dict(pseg.init_seg())
    rs = np.random.RandomState(seed)
    sd = {}
    for k, v in keys.items():
        shp = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            sd[k] = np.asarray(0, np.int64)
        elif k == "deconv.weight":
            sd[k] = (rs.randn(*shp) / 16).astype(np.float32)
        elif v.dim() == 4:
            sd[k] = (rs.randn(*shp) * np.sqrt(2.0 / np.prod(shp[1:]))).astype(np.float32)
        elif k.endswith("running_var"):
            sd[k] = rs.uniform(0.5, 1.5, shp).astype(np.float32)
        elif k.endswith(".weight"):
            sd[k] = (rs.uniform(0.5, 1.0, shp) * (0.2 if ".res.7." in k else 1.0)).astype(
                np.float32)
        else:  # biases and running means
            sd[k] = (rs.randn(*shp) * 0.1).astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def seg_case(tmp_path_factory):
    """A 24×24 HR PNG, the seg state dict saved as .pth, the JAX package's
    seg input for that image (its own ops) and its forward."""
    root = tmp_path_factory.mktemp("seg")
    img = (np.random.RandomState(5).rand(27, 30, 3) * 255).round().astype(np.uint8)
    img = cv2.GaussianBlur(img, (5, 5), 1.5)
    os.makedirs(root / "hr")
    cv2.imwrite(str(root / "hr" / "scene_sky.png"), img)
    sd = _seg_numpy_state_dict()
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(root / "seg.pth"))
    bgr = jmodcrop(read_img(str(root / "hr" / "scene_sky.png")), 8)
    x = (jimresize(jimresize(bgr, 0.25), 4.0) * 255.0
         - np.asarray(pcli_seg.BGR_MEANS, np.float32)).astype(np.float32)
    want = np.asarray(jax.jit(jseg.seg_forward)(jseg.seg_from_state_dict(sd), x[None]))[0]
    return root, sd, x, want


def test_whole_plan_seg_forward_matches_jax(seg_case):
    _, sd, x, want = seg_case
    params = pseg.seg_from_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    got = pseg.seg_forward(params, torch.from_numpy(x[None]))[0].numpy()
    assert got.shape == want.shape == (24, 24, 8)
    assert np.abs(got - want).max() <= SEG_TOL
    assert np.abs(got.sum(-1) - 1.0).max() <= 1e-5
    assert 0.2 < want.max(-1).mean() < 0.99  # not saturated: the check has teeth
    back = pseg.seg_to_state_dict(params)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_cli_test_seg_then_test_sftgan_match_jax(seg_case, tmp_path):
    root, _, x, want = seg_case
    np.testing.assert_array_equal(
        pcli_seg.seg_input(read_img(str(root / "hr" / "scene_sky.png"))), x)
    out = str(tmp_path / "ost")
    pcli_seg.main([str(root / "seg.pth"), "--input", str(root / "hr"), "--output", out,
                   "--device", "cpu"])
    prob = torch.load(out + "_segprob/scene_sky_bic.pth", weights_only=True).numpy()
    assert prob.shape == (8, 24, 24)
    assert np.abs(np.transpose(prob, (1, 2, 0)) - want).max() <= SEG_TOL
    byte = cv2.imread(out + "_byteimg/scene_sky.png", cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(byte, prob.argmax(0).astype(np.uint8))
    assert cv2.imread(out + "_colorimg/scene_sky.png").shape == (24, 24, 3)

    # SFT-GAN (nb 1 at the shipped widths) on that map, both packages' CLIs
    cfg = psft.SFTNetConfig(nb=1)
    torch.save(psft.sftnet_to_state_dict(psft.init_sftnet(cfg, seed=4), cfg),
               str(tmp_path / "sft.pth"))
    from esrganplus_tpu.cli import test_sftgan as jcli_sft

    for cli, name in ((pcli_sft, "port"), (jcli_sft, "jax")):
        argv = [str(tmp_path / "sft.pth"), "--input", str(root / "hr"), "--segprob",
                out + "_segprob", "--output", str(tmp_path / name)]
        cli.main(argv + (["--device", "cpu"] if name == "port" else []))
    got, ref = (cv2.imread(str(tmp_path / n / "scene_sky_rlt.png")).astype(int)
                for n in ("port", "jax"))
    assert got.shape == ref.shape == (24, 24, 3)
    assert np.abs(got - ref).max() <= 1


def test_minc_matches_jax():
    rs = np.random.RandomState(0)
    sd = {}
    for name, cin, cout in (e for e in pfe.MINC_PLAN if e != "M"):
        sd[name + ".weight"] = (rs.randn(cout, cin, 3, 3) * np.sqrt(2.0 / (9 * cin))).astype(
            np.float32)
        sd[name + ".bias"] = (rs.randn(cout) * 0.1).astype(np.float32)
    x = rs.rand(2, 37, 45, 3).astype(np.float32)  # odd: every pool rounds up
    want = np.asarray(jax.jit(jfe.minc_forward)(jfe.minc_from_state_dict(sd), x))
    params = pfe.minc_from_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    got = pfe.minc_forward(params, torch.from_numpy(x)).numpy()
    assert got.shape == (2, 3, 3, 512)
    _rel_close(got, want)


def _resnet_sd(rs, depths=(2, 1, 1, 1)):
    sd = {}

    def conv(name, cout, cin, k):
        sd[name + ".weight"] = (rs.randn(cout, cin, k, k) * np.sqrt(2.0 / (k * k * cin))).astype(
            np.float32)

    def bn(name, c, scale=1.0):
        sd[name + ".weight"] = (rs.uniform(0.5, 1.0, c) * scale).astype(np.float32)
        sd[name + ".bias"] = (rs.randn(c) * 0.1).astype(np.float32)
        sd[name + ".running_mean"] = (rs.randn(c) * 0.1).astype(np.float32)
        sd[name + ".running_var"] = rs.uniform(0.5, 1.5, c).astype(np.float32)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    inplanes = 64
    for stage, (planes, depth) in enumerate(zip((64, 128, 256, 512), depths), start=1):
        for i in range(depth):
            base = f"layer{stage}.{i}"
            conv(base + ".conv1", planes, inplanes, 1)
            bn(base + ".bn1", planes)
            conv(base + ".conv2", planes, planes, 3)
            bn(base + ".bn2", planes)
            conv(base + ".conv3", planes * 4, planes, 1)
            bn(base + ".bn3", planes * 4, 0.2)
            if i == 0:
                conv(base + ".downsample.0", planes * 4, inplanes, 1)
                bn(base + ".downsample.1", planes * 4)
            inplanes = planes * 4
    return sd


def test_resnet101_features_match_jax():
    rs = np.random.RandomState(1)
    sd = _resnet_sd(rs)
    x = rs.rand(2, 64, 64, 3).astype(np.float32)
    jp = jfe.resnet101_from_state_dict(sd)
    want = np.asarray(jfe.resnet101_feat_forward(jp, x))
    params = pfe.resnet101_from_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    assert [b["stride"] for b in params["blocks"]] == [b["stride"] for b in jp["blocks"]] \
        == [1, 1, 2, 2, 2]
    got = pfe.resnet101_feat_forward(params, torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2, 2, 2048)
    _rel_close(got, want)
