"""Card tests: each CUDA kernel against its plain PyTorch twin, and the
flagship kernel path against the plain graph, on an NVIDIA GPU.

Every test here is marked ``cuda`` and skips without a card (the kernels
have no CPU mode). The module imports neither JAX nor the JAX package, so it
runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances, relative to max(1, max|ref|): fp32 1e-4 (TF32 off; only the
summation order differs); bf16 2e-2 (same rounding points, so an fp32
summation-order difference can flip a bf16 rounding, a few ulps downstream),
and at most 1 % of the bf16 outputs may differ from the twin at all.
"""

import dataclasses

import numpy as np
import pytest
import torch

from esrganplus_tpu_torch.infer import params_to
from esrganplus_tpu_torch.kernels import rdb_ct as K
from esrganplus_tpu_torch.kernels import tail_ct as T
from esrganplus_tpu_torch.models.layers import fp32_exact
from esrganplus_tpu_torch.models.rrdb import (RRDBNetConfig, init_rrdbnet, prep_trunk_ct,
                                              rrdbnet_forward)

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _conv(rs, cin, cout):
    return {"w": torch.from_numpy((rs.randn(3, 3, cin, cout) * np.sqrt(2.0 / (9 * cin)))
                                  .astype(np.float32)).cuda(),
            "b": torch.from_numpy((rs.randn(cout) * 0.1).astype(np.float32)).cuda()}


def _case(name, dtype):
    rs = np.random.RandomState(0)
    act = lambda *s: torch.from_numpy(rs.rand(*s).astype(np.float32)).to("cuda", dtype)
    x, res = act(2, 37, 53, 64), act(2, 37, 53, 64)
    if name == "rdb_ct":
        p = {f"conv{k}": _conv(rs, 64 + (k - 1) * 32, 64 if k == 5 else 32)
             for k in range(1, 6)}
        p["conv1x1"] = {"w": torch.from_numpy(
            (rs.randn(1, 1, 64, 32) / 8).astype(np.float32)).cuda()}
        w = K.prepare_rdb_ct_weights(p, dtype)
        return (lambda: K.rdb_ct(x, w, res, rrdb_scale=0.2),
                lambda: K.rdb_ct_plain(x, w, res, rrdb_scale=0.2))
    if name == "conv3x3_ct":
        c = _conv(rs, 64, 64)
        w, b = K.prepare_conv_ct_weights(c["w"], c["b"], dtype)
        return lambda: K.conv3x3_ct(x, w, b, res), lambda: K.conv3x3_ct_plain(x, w, b, res)
    if name == "upfold_ct":
        c = _conv(rs, 64, 64)
        wf, b = T.prepare_upfold_ct(c["w"], c["b"], dtype)
        return lambda: T.upfold_ct(x, wf, b), lambda: T.upfold_ct_plain(x, wf, b)
    hw = T.prepare_conv_hr_ct(_conv(rs, 64, 64), _conv(rs, 64, 3), dtype)
    return lambda: T.conv_hr_ct(x, *hw), lambda: T.conv_hr_ct_plain(x, *hw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", ["rdb_ct", "conv3x3_ct", "upfold_ct", "conv_hr_ct"])
def test_cuda_kernel_matches_plain_twin(name, dtype):
    _need_card()
    kern, plain = _case(name, dtype)
    with fp32_exact():
        got = kern().float()
        want = plain().float()
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL[dtype] * max(1.0, want.abs().max().item())
    if dtype == torch.bfloat16:  # same rounding points: few outputs differ at all
        assert (got != want).float().mean().item() <= 0.01


@pytest.mark.cuda
def test_cuda_wrapper_rejects_cpu_weights():
    _need_card()
    w = K.prepare_rdb_ct_weights({f"conv{k}": {"w": torch.zeros(3, 3, 64 + (k - 1) * 32,
                                                                 64 if k == 5 else 32)}
                                  for k in range(1, 6)}, torch.float32)
    with pytest.raises(ValueError):
        K.rdb_ct(torch.zeros(1, 8, 8, 64, device="cuda"), w)


@pytest.mark.cuda
def test_flagship_kernel_path_matches_plain_graph_and_counts_launches():
    """nb=23, nf=64, gc=32, ×4 at 33×41 LR: the fp32 kernel path within 1e-4
    (relative) of the plain fp32 graph, the bf16 one within 5e-2, and one
    forward launches rdb_ct 69×, conv3x3_ct 1×, upfold_ct 2×, conv_hr_ct 1×."""
    _need_card()
    cfg = RRDBNetConfig()
    params = params_to(init_rrdbnet(cfg, seed=0, init_scale=0.5), "cuda")
    x = torch.from_numpy(np.random.RandomState(1).rand(1, 33, 41, 3).astype(np.float32)).cuda()
    with torch.inference_mode():
        ref = rrdbnet_forward(params, x, dataclasses.replace(cfg, trunk_kernel="plain",
                                                             tail_kernel="plain"))
        counted = (K.rdb_ct, K.conv3x3_ct, T.upfold_ct, T.conv_hr_ct)
        for fn in counted:
            fn.launches = 0
        got32 = rrdbnet_forward(prep_trunk_ct(params, cfg, torch.float32), x, cfg)
        assert [fn.launches for fn in counted] == [69, 1, 2, 1]
        got16 = rrdbnet_forward(prep_trunk_ct(params, cfg, torch.bfloat16), x, cfg,
                                dtype=torch.bfloat16)
    scale = ref.abs().max().item()
    assert got32.shape == ref.shape == (1, 132, 164, 3)
    assert (got32 - ref).abs().max().item() <= 1e-4 * scale
    assert (got16 - ref).abs().max().item() <= 5e-2 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fp16", "nf48"])
def test_auto_on_card_raises_where_kernels_do_not_fit(case):
    """On the card "auto" never gives way to the plain graph: a dtype or a
    width the kernels do not take raises, and "plain" is the way round."""
    _need_card()
    cfg = RRDBNetConfig(nb=1, nf=48 if case == "nf48" else 64)
    dtype = torch.float16 if case == "fp16" else None
    params = params_to(init_rrdbnet(cfg, seed=0), "cuda")
    x = torch.rand(1, 8, 8, 3, device="cuda")
    with torch.inference_mode():
        with pytest.raises(ValueError, match="trunk_kernel='auto'"):
            rrdbnet_forward(params, x, cfg, dtype=dtype)
        plain = dataclasses.replace(cfg, trunk_kernel="plain", tail_kernel="plain")
        assert rrdbnet_forward(params, x, plain, dtype=dtype).shape == (1, 32, 32, 3)
