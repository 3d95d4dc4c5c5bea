"""The port's SFT-GAN models (esrganplus_tpu_torch/models/sft.py, the new
layers, the dispatch, the converters and the evaluator's side input)
against the JAX package on the CPU, on the same seeded numpy parameters and
inputs:

  (a) ``sftnet_forward`` (nb 2, nf 16, cond_nf 8, LR 8×8) in both ``legacy``
      modes: fp32 within 1e-5 of max|ref|, bf16 within 2e-2 of
      max(1, max|ref|) (the bf16 bar of the other generators' tests);
  (b) ``acd_forward`` at 96² in train and eval mode, fp32 and bf16, its BN
      updates, ``acd_apply_updates`` and ``acd_merge_sequential``. bf16 is
      held at 5e-2 of max(1, max|ref|), the repo's end-to-end bf16 bar: on
      the same bf16 input a conv's output differs from XLA's in ≤0.05 % of
      entries (one ulp, the summation order), and eight conv + train-mode
      BN layers at batch 2 carry that to 2.4 % at the heads;
  (c) the four ``.pth`` converters: keys equal to JAX's export, tensors
      bit-equal, ``nb`` inferred; the generator dispatch on ``sft_branch.``;
  (d) ``conv2d`` with dilation (odd and even extents);
  (e) the option builders on ``train_sftgan.json`` equal to JAX's;
  (f) ``BatchedEvaluator`` with ``side_scale``: the interior of each image
      equal to the sequential forward's, sides required exactly when set.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrganplus_tpu.models import layers as jl
from esrganplus_tpu.models import sft as jsft
from esrganplus_tpu.options import options as jopt
from esrganplus_tpu_torch.convert import (acd_from_jax, generator_from_state_dict,
                                          generator_to_state_dict, sftnet_from_jax)
from esrganplus_tpu_torch.infer import BatchedEvaluator, SRInferencer
from esrganplus_tpu_torch.models import generator_forward
from esrganplus_tpu_torch.models import layers as pl
from esrganplus_tpu_torch.models import sft as psft
from esrganplus_tpu_torch.options import options as popt
from esrganplus_tpu_torch.train.sr_model import tree_leaves

NET = dict(nb=2, nf=16, cond_nf=8)
FP32_TOL = 1e-5
BF16_TOL = 2e-2
ACD_BF16_TOL = 5e-2  # see (b) above
OPTDIR = os.path.join(os.path.dirname(__file__), "..", "esrganplus_tpu", "options")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch ops on one thread while the module runs. The test workers share
    the machine's cores, and a torch thread pool as wide as the machine in
    each of them spins against the others': six workers ran one of these
    files 7× slower with it than on one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs(seed=1, b=2, h=8, w=8):
    rs = np.random.RandomState(seed)
    img = rs.rand(b, h, w, 3).astype(np.float32)
    logits = rs.randn(b, 4 * h, 4 * w, 8).astype(np.float32)
    seg = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return img, seg.astype(np.float32)


@pytest.fixture(scope="module")
def jax_sft():
    """{legacy: (numpy params, {dtype: JAX output})} on one input pair."""
    img, seg = _inputs()
    out = {}
    for legacy in (False, True):
        cfg = jsft.SFTNetConfig(legacy=legacy, **NET)
        p = _np(jsft.init_sftnet(jax.random.PRNGKey(3), cfg))
        fwd = jax.jit(jsft.sftnet_forward, static_argnums=(3, 4))
        out[legacy] = (p, {d: np.asarray(fwd(p, img, seg, cfg, dt))
                           for d, dt in (("float32", None), ("bfloat16", jnp.bfloat16))})
    return img, seg, out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("legacy", [False, True])
def test_sftnet_forward_matches_jax(jax_sft, legacy, dtype):
    img, seg, out = jax_sft
    p, ys = out[legacy]
    cfg = psft.SFTNetConfig(legacy=legacy, **NET)
    got = generator_forward(sftnet_from_jax(p, cfg), torch.from_numpy(img), cfg,
                            side=torch.from_numpy(seg),
                            dtype=torch.bfloat16 if dtype == "bfloat16" else None).numpy()
    want = ys[dtype]
    assert got.shape == want.shape == (2, 32, 32, 3)
    err = np.abs(got - want).max()
    if dtype == "float32":
        assert err <= FP32_TOL * np.abs(want).max(), err
    else:
        assert err <= BF16_TOL * max(1.0, np.abs(want).max()), err


def test_generator_forward_side_input_contract():
    cfg = psft.SFTNetConfig(**NET)
    p = psft.init_sftnet(cfg, seed=0)
    img, seg = _inputs(b=1, h=4, w=4)
    with pytest.raises(ValueError, match="side"):
        generator_forward(p, torch.from_numpy(img), cfg)
    from esrganplus_tpu_torch.models import SRResNetConfig, generator_init

    rcfg = SRResNetConfig(nf=8, nb=1)
    with pytest.raises(ValueError, match="no side input"):
        generator_forward(generator_init(0, rcfg), torch.from_numpy(img), rcfg,
                          side=torch.from_numpy(seg))
    assert {k for k in p} == {"conv0", "blocks", "final_sft", "final_conv", "hr", "cond"}
    assert p["blocks"]["sft0"]["scale1"]["w"].shape == (2, 1, 1, 8, 16)


@pytest.fixture(scope="module")
def jax_acd():
    p = _np(jsft.init_acd(jax.random.PRNGKey(5)))
    x = np.random.RandomState(2).rand(2, 96, 96, 3).astype(np.float32)
    fwd = jax.jit(jsft.acd_forward, static_argnums=(2, 3))
    res = {}
    for d, dt in (("float32", None), ("bfloat16", jnp.bfloat16)):
        for train in (True, False):
            g, c, upd = fwd(p, x, train, dt)
            res[(d, train)] = (np.asarray(g), np.asarray(c), _np(upd))
    x2 = np.random.RandomState(9).rand(2, 96, 96, 3).astype(np.float32)
    res["second"] = _np(fwd(p, x2, True, None)[2])
    return p, x, x2, res


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_acd_forward_matches_jax(jax_acd, dtype, train):
    p, x, _, res = jax_acd
    gan, cls, upd = psft.acd_forward(acd_from_jax(p), torch.from_numpy(x), train=train,
                                     dtype=torch.bfloat16 if dtype == "bfloat16" else None)
    jg, jc, jupd = res[(dtype, train)]
    assert gan.shape == (2, 1) and cls.shape == (2, 8)
    tol = FP32_TOL if dtype == "float32" else ACD_BF16_TOL
    for got, want in ((gan, jg), (cls, jc)):
        assert np.abs(got.numpy() - want).max() <= tol * max(1.0, np.abs(want).max())
    assert [u is None for u in upd] == [u is None for u in jupd] == [True] + [False] * 7
    for pu, ju in zip(upd[1:], jupd[1:]):
        for k in ("mean", "var"):
            want = ju[k]
            assert np.abs(pu[k].float().numpy() - want).max() <= tol * max(
                1.0, np.abs(want).max()), k


def test_acd_bn_updates_and_sequential_merge_match_jax(jax_acd):
    p, x, x2, res = jax_acd
    u1, u2 = res[("float32", True)][2], res["second"]
    j_applied = _np(jsft.acd_apply_updates(p, u1))
    j_merged = _np(jsft.acd_merge_sequential(p, u1, u2))
    pp = acd_from_jax(p)
    _, _, v1 = psft.acd_forward(pp, torch.from_numpy(x), train=True)
    _, _, v2 = psft.acd_forward(pp, torch.from_numpy(x2), train=True)
    for got, want in ((psft.acd_apply_updates(pp, v1), j_applied),
                      (psft.acd_merge_sequential(pp, v1, v2), j_merged)):
        gl, wl = tree_leaves(got), jax.tree.leaves(want)
        assert len(gl) == len(wl)
        for a, b in zip(gl, wl):
            assert np.abs(a.numpy() - b).max() <= FP32_TOL * max(1.0, np.abs(b).max())
    # the merge is m·u1 + (u2 − m·old): not u2 alone
    assert not np.allclose(j_merged["bn"][1]["mean"], _np(u2)[1]["mean"])


def test_sftnet_state_dict_converters_match_jax():
    for legacy in (False, True):
        jcfg = jsft.SFTNetConfig(legacy=legacy, **NET)
        p = _np(jsft.init_sftnet(jax.random.PRNGKey(7), jcfg))
        want = jsft.sftnet_to_state_dict(p, jcfg)
        cfg = psft.SFTNetConfig(legacy=legacy, **NET)
        params = sftnet_from_jax(p, cfg)
        got = generator_to_state_dict(params, cfg)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
        # nb inferred from the sft_branch indices, the rest taken from the cfg
        back, bcfg, info = generator_from_state_dict(
            got, psft.SFTNetConfig(legacy=legacy, nb=5, nf=16, cond_nf=8))
        assert bcfg == cfg and info == {}
        for a, b in zip(tree_leaves(back), tree_leaves(params)):
            assert torch.equal(a, b)
    jback, jbcfg = jsft.sftnet_from_state_dict({k: v.numpy() for k, v in got.items()})
    assert jbcfg.nb == 2
    for a, b in zip(jax.tree.leaves(jback), tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the dispatch also recognises a checkpoint without a cfg
    assert isinstance(generator_from_state_dict(got)[1], psft.SFTNetConfig)


def test_acd_state_dict_converters_match_jax():
    p = _np(jsft.init_acd(jax.random.PRNGKey(4)))
    want = jsft.acd_to_state_dict(p)
    params = acd_from_jax(p)
    got = psft.acd_to_state_dict(params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    back = psft.acd_from_state_dict(got)
    jback = jsft.acd_from_state_dict({k: v.numpy() for k, v in got.items()})
    for a, b, c in zip(tree_leaves(back), tree_leaves(params), jax.tree.leaves(jback)):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))


def test_sftnet_from_jax_checks_shapes():
    p = _np(jsft.init_sftnet(jax.random.PRNGKey(0), jsft.SFTNetConfig(**NET)))
    with pytest.raises(ValueError, match="config expects"):
        sftnet_from_jax(p, psft.SFTNetConfig(nb=3, nf=16, cond_nf=8))
    bad = _np(jsft.init_acd(jax.random.PRNGKey(0)))
    bad["cls1"]["w"] = bad["cls1"]["w"][:, :4]
    with pytest.raises(ValueError, match="cls1"):
        acd_from_jax(bad)


@pytest.mark.parametrize("k,dilation,stride", [(3, 2, 1), (3, 4, 1), (1, 1, 2), (3, 2, 2),
                                               (2, 1, 1), (4, 2, 1)])
def test_conv2d_dilation_matches_jax(k, dilation, stride):
    rs = np.random.RandomState(k * 10 + dilation)
    x = rs.randn(2, 11, 9, 5).astype(np.float32)
    p = {"w": rs.randn(k, k, 5, 6).astype(np.float32), "b": rs.randn(6).astype(np.float32)}
    want = np.asarray(jl.conv2d(x, p, stride=stride, dilation=dilation))
    got = pl.conv2d(torch.from_numpy(x), {n: torch.from_numpy(v) for n, v in p.items()},
                    stride=stride, dilation=dilation).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_options_build_matches_jax(tmp_path):
    src = json.loads(jopt._strip_comments(
        open(os.path.join(OPTDIR, "train", "train_sftgan.json")).read()))
    src["path"]["root"] = str(tmp_path)
    path = tmp_path / "o.json"
    path.write_text(json.dumps(src))
    popts, jopts = popt.parse(str(path)), jopt.parse(str(path))
    got, want = popt.build_net_g_config(popts), jopt.build_net_g_config(jopts)
    assert isinstance(got, psft.SFTNetConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    got, want = popt.build_train_config(popts), jopt.build_train_config(jopts)
    assert type(got).__name__ == "SFTGANTrainConfig"
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_batched_evaluator_side_input_matches_sequential_interior():
    cfg = psft.SFTNetConfig(**NET)
    params = psft.init_sftnet(cfg, seed=2)
    rs = np.random.RandomState(3)
    sizes = ((24, 24), (20, 22), (22, 18))
    imgs = [rs.rand(h, w, 3).astype(np.float32) for h, w in sizes]
    sides = [_inputs(seed=i, b=1, h=h, w=w)[1][0] for i, (h, w) in enumerate(sizes)]
    ev = BatchedEvaluator(params, cfg, device="cpu", batch=2, side_scale=4)
    outs = ev.upscale_batch(imgs, sides=sides)
    assert ev.calls == 2
    seq = SRInferencer(params, cfg, device="cpu")
    for img, side, out in zip(imgs, sides, outs):
        ref = seq.upscale(img, side=side)
        assert out.shape == ref.shape == (img.shape[0] * 4, img.shape[1] * 4, 3)
        # the edge padding reaches in from the right/bottom only; the top-left
        # 8×8 LR pixels sit beyond the tiny net's receptive radius (about 8 LR
        # pixels) of the pad, which starts at LR column 18 or row 20
        np.testing.assert_allclose(out[:32, :32], ref[:32, :32], atol=1e-5)
    with pytest.raises(ValueError, match="side_scale"):
        ev.upscale_batch(imgs)
    with pytest.raises(ValueError, match="side_scale"):
        BatchedEvaluator(params, cfg, device="cpu").upscale_batch(imgs, sides=sides)
