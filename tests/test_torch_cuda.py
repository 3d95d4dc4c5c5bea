"""Card tests: each CUDA kernel, forward and backward, against its plain
PyTorch twin, the flagship kernel path against the plain graph (inference,
and value and gradients in train mode), and the trainer, on an NVIDIA GPU.

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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 37, 53), (16, 32, 32)], ids=["odd", "train"])
def test_cuda_rdb_ct_training_forward_matches_plain_twin(shape, dtype):
    """The training mode of rdb_ct (noise epilogue, saved x1..x4 and the
    pre-residual l2|l4 the backward takes its masks from): output and both
    saved buffers against the twin's, at the forward kernels' bars."""
    _need_card()
    rs = np.random.RandomState(2)
    B, H, W = shape
    act = lambda: torch.from_numpy(rs.randn(B, H, W, 64).astype(np.float32)).to("cuda", dtype)
    p = {f"conv{k}": _conv(rs, 64 + (k - 1) * 32, 64 if k == 5 else 32) for k in range(1, 6)}
    p["conv1x1"] = {"w": torch.from_numpy((rs.randn(1, 1, 64, 32) / 8).astype(np.float32)).cuda()}
    w = K.prepare_rdb_ct_weights(p, dtype)
    x, noise = act(), act()
    with fp32_exact():
        got = K._rdb_ct_cuda(x, w, None, noise, sigma=0.1, save=True)
        want = K._rdb_ct_train_plain(x, w, None, noise, sigma=0.1)
    for name, a, b in zip(("out", "cat", "lsv"), got, want):
        a, b = a.float(), b.float()
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        assert (a - b).abs().max().item() <= TOL[dtype] * max(1.0, b.abs().max().item()), name
        if dtype == torch.bfloat16:
            assert (a != b).float().mean().item() <= 0.01, name


def _bwd_case(name, dtype, shape=(2, 37, 53), nf=64, gc=32):
    """(kernel call, twin call) for a backward wrapper; both return the
    wrapper's dict of gradients. The saved buffers come from the forward
    kernel in its training mode (held against the twin's by the test above):
    fed its own, the twin would differ wherever a saved activation is within
    a summation-order difference of 0 and its lrelu mask flips."""
    rs = np.random.RandomState(1)
    B, H, W = shape
    act = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32)).to("cuda", dtype)
    x = act(B, H, W, nf)
    if name.startswith("rdb_ct_bwd"):
        p = {f"conv{k}": _conv(rs, nf + (k - 1) * gc, nf if k == 5 else gc)
             for k in range(1, 6)}
        if "no1x1" not in name:
            p["conv1x1"] = {"w": torch.from_numpy(
                (rs.randn(1, 1, nf, gc) / 8).astype(np.float32)).cuda()}
        w = K.prepare_rdb_ct_weights(p, dtype)
        noise = act(B, H, W, nf) if "noise" in name else None
        _, cat, lsv = K._rdb_ct_cuda(x, w, None, noise, sigma=0.1, save=True)
        g = act(B, H, W, nf)
        args = (x, w, cat, lsv, g, noise)
        return (lambda: K.rdb_ct_bwd(*args, sigma=0.1),
                lambda: K.rdb_ct_bwd_plain(*args, sigma=0.1))
    if name == "conv3x3_ct_bwd":
        c = _conv(rs, nf, nf)
        w, _ = K.prepare_conv_ct_weights(c["w"], c["b"], dtype)
        g = act(B, H, W, nf)
        return lambda: K.conv3x3_ct_bwd(x, w, g), lambda: K.conv3x3_ct_bwd_plain(x, w, g)
    if name == "upfold_ct_bwd":
        c = _conv(rs, nf, nf)
        wf, b = T.prepare_upfold_ct(c["w"], c["b"], dtype)
        out = T.upfold_ct(x, wf, b)
        g = act(B, 2 * H, 2 * W, nf)
        return (lambda: T.upfold_ct_bwd(x, wf, out, g),
                lambda: T.upfold_ct_bwd_plain(x, wf, out, g))
    w0, b0, w1, _ = T.prepare_conv_hr_ct(_conv(rs, nf, nf), _conv(rs, nf, 3), dtype)
    g = act(B, H, W, 3)
    return (lambda: T.conv_hr_ct_bwd(x, w0, b0, w1, g),
            lambda: T.conv_hr_ct_bwd_plain(x, w0, b0, w1, g))


BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # of max|ref|, per gradient


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", ["rdb_ct_bwd", "rdb_ct_bwd_noise", "rdb_ct_bwd_no1x1",
                                  "conv3x3_ct_bwd", "upfold_ct_bwd", "conv_hr_ct_bwd"])
def test_cuda_backward_kernel_matches_plain_twin(name, dtype):
    """Every gradient of each backward wrapper against its plain twin on the
    same saved buffers: fp32 1e-4 of max|ref| (summation order only); bf16
    2e-2 (a flipped rounding of a dz or of the recomputed activation moves a
    product by one bf16 ulp of its operand)."""
    _need_card()
    kern, plain = _bwd_case(name, dtype)
    with fp32_exact():
        got, want = kern(), plain()
    torch.cuda.synchronize()
    assert set(got) == set(want)
    for k, ref in want.items():
        if ref is None:
            assert got[k] is None
            continue
        a, b = got[k].float(), ref.float()
        assert a.shape == b.shape and torch.isfinite(a).all(), k
        err = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        assert err <= BWD_TOL[dtype], (k, err)


@pytest.mark.cuda
@pytest.mark.parametrize("C,co2", [(64, 3), (16, 3), (8, 1), (32, 8)])
def test_cuda_conv_hr_bwd_design_and_repeat(C, co2):
    """bf16 takes the tensor-core design (its four launches), within the bf16
    bar of the twin at a ragged shape, and a second call gives the same
    bits; fp32 stays on the FMA design at 1e-4."""
    _need_card()
    rs = np.random.RandomState(4)
    for dtype, design in ((torch.bfloat16, "mma"), (torch.float32, "fma")):
        act = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32)).to("cuda", dtype)
        w0, b0, w1, _ = T.prepare_conv_hr_ct(_conv(rs, C, C), _conv(rs, C, co2), dtype)
        x, g = act(2, 37, 53, C), act(2, 37, 53, co2)
        T.reset_design_counts()
        with fp32_exact():
            got, want = T.conv_hr_ct_bwd(x, w0, b0, w1, g), T.conv_hr_ct_bwd_plain(x, w0, b0, w1, g)
        again = T.conv_hr_ct_bwd(x, w0, b0, w1, g)
        assert T.conv_hr_ct_bwd.launches_by_design == {"fma": 0, "mma": 0, design: 2}
        for k, ref in want.items():
            a, b = got[k].float(), ref.float()
            assert a.shape == b.shape and torch.isfinite(a).all(), k
            assert (a - b).abs().max().item() <= BWD_TOL[dtype] * b.abs().max().item(), k
            assert torch.equal(again[k], got[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("C,CO", [(64, 64), (16, 8), (8, 16), (32, 32), (64, 8)])
@pytest.mark.parametrize("shape", [(2, 37, 53), (16, 32, 32)], ids=["odd", "train"])
def test_cuda_upfold_bwd_design_and_repeat(C, CO, shape):
    """bf16 takes the tensor-core design (gate pass, dx, dW), within the bf16
    bar of the twin on the forward kernel's saved output, db from the
    unrounded dz (1e-4 of the twin's), and a second call gives the same
    bits; fp32 stays on the FMA design at 1e-4."""
    _need_card()
    rs = np.random.RandomState(6)
    B, H, W = shape
    for dtype, design in ((torch.bfloat16, "mma"), (torch.float32, "fma")):
        act = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32)).to("cuda", dtype)
        c = _conv(rs, C, CO)
        wf, bias = T.prepare_upfold_ct(c["w"], c["b"], dtype)
        x, g = act(B, H, W, C), act(B, 2 * H, 2 * W, CO)
        out = T.upfold_ct(x, wf, bias)
        T.reset_design_counts()
        with fp32_exact():
            got, want = T.upfold_ct_bwd(x, wf, out, g), T.upfold_ct_bwd_plain(x, wf, out, g)
        again = T.upfold_ct_bwd(x, wf, out, g)
        assert T.upfold_ct_bwd.launches_by_design == {"fma": 0, "mma": 0, design: 2}
        assert T.upfold_ct_bwd.launches == 2
        for k, ref in want.items():
            a, b = got[k].float(), ref.float()
            assert a.shape == b.shape and torch.isfinite(a).all(), k
            tol = 1e-4 if k == "b" else BWD_TOL[dtype]
            assert (a - b).abs().max().item() <= tol * b.abs().max().item(), k
            assert torch.equal(again[k], got[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("C,co2", [(64, 3), (16, 3), (8, 1), (32, 8)])
@pytest.mark.parametrize("shape", [(2, 37, 53), (1, 128, 128)], ids=["odd", "bench"])
def test_cuda_conv_hr_design_and_repeat(C, co2, shape):
    """bf16 takes the tensor-core design (the stage forward for hid, then
    conv1 on the tensor cores), within the bf16 bar of the twin with at most
    1 % of outputs differing at all, and a second call gives the same bits;
    fp32 stays on the fused FMA kernel at 1e-4."""
    _need_card()
    rs = np.random.RandomState(7)
    for dtype, design in ((torch.bfloat16, "mma"), (torch.float32, "fma")):
        hw = T.prepare_conv_hr_ct(_conv(rs, C, C), _conv(rs, C, co2), dtype)
        x = torch.from_numpy(rs.rand(*shape, C).astype(np.float32)).to("cuda", dtype)
        T.reset_design_counts()
        with fp32_exact():
            got, want = T.conv_hr_ct(x, *hw), T.conv_hr_ct_plain(x, *hw)
        again = T.conv_hr_ct(x, *hw)
        assert T.conv_hr_ct.launches_by_design == {"fma": 0, "mma": 0, design: 2}
        assert got.shape == want.shape and torch.isfinite(got.float()).all()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= TOL[dtype] * max(1.0, want.float().abs().max().item())
        if dtype == torch.bfloat16:
            assert (got != want).float().mean().item() <= 0.01
        assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("C,CO", [(64, 64), (8, 8), (3, 16), (16, 32), (100, 64), (432, 64),
                                  (448, 64), (457, 64), (512, 64), (520, 8)])
@pytest.mark.parametrize("shape", [(2, 37, 53), (1, 128, 128)], ids=["odd", "bench"])
def test_cuda_upfold_design_and_repeat(C, CO, shape):
    """bf16 takes the tensor-core design (the phase fold), within the bf16
    bar of the twin with at most 1 % of outputs differing at all, and a
    second call and the launch alone give the same bits; fp32 stays on the
    FMA design at 1e-4. The odd LR shape (37x53: neither a whole 8x16 tile)
    and the width edges (C = CO = 8; C = 3, 100 and 457, staged a pixel at
    a time; C = 432, the widest tile of all C that fits a block at CO = 64,
    and 448, 457, 512 and 520, whose tile is restaged in slices of 128
    channels)."""
    _need_card()
    rs = np.random.RandomState(C + CO)
    for dtype, design in ((torch.bfloat16, "mma"), (torch.float32, "fma")):
        c = _conv(rs, C, CO)
        wf, bias = T.prepare_upfold_ct(c["w"], c["b"], dtype)
        x = torch.from_numpy(rs.rand(*shape, C).astype(np.float32)).to("cuda", dtype)
        T.reset_design_counts()
        with fp32_exact():
            got, want = T.upfold_ct(x, wf, bias), T.upfold_ct_plain(x, wf, bias)
        again = T.upfold_ct(x, wf, bias)
        launch, out = T.upfold_launch(x, wf, bias)
        launch()
        assert T.upfold_ct.launches_by_design == {"fma": 0, "mma": 0, design: 2}
        assert got.shape == want.shape and torch.isfinite(got.float()).all()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= TOL[dtype] * max(1.0, want.float().abs().max().item())
        if dtype == torch.bfloat16:
            assert (got != want).float().mean().item() <= 0.01
        assert torch.equal(again, got) and torch.equal(out, got)


@pytest.mark.cuda
def test_cuda_tail_wrappers_raise_for_widths_they_do_not_take():
    _need_card()
    bf = torch.bfloat16
    z = lambda *s, dt=bf: torch.zeros(*s, device="cuda", dtype=dt)
    with pytest.raises(ValueError, match="C=48"):  # the bf16 adjoint's N: 8..64 by powers of 2
        T.upfold_ct_bwd(z(1, 8, 8, 48), z(2, 2, 2, 2, 48, 64), z(1, 16, 16, 64), z(1, 16, 16, 64))
    with pytest.raises(ValueError, match="CO=24"):
        T.upfold_ct_bwd(z(1, 8, 8, 64), z(2, 2, 2, 2, 64, 24), z(1, 16, 16, 24), z(1, 16, 16, 24))
    with pytest.raises(ValueError, match="CO=24"):
        T.upfold_ct(z(1, 8, 8, 64), z(2, 2, 2, 2, 64, 24), z(24, dt=torch.float32))
    with pytest.raises(ValueError, match="C=48"):
        T.conv_hr_ct(z(1, 8, 8, 48), z(3, 3, 48, 48), z(48, dt=torch.float32), z(3, 3, 48, 3),
                     z(3, dt=torch.float32))
    with pytest.raises(ValueError, match="CO2=9"):
        T.conv_hr_ct(z(1, 8, 8, 64), z(3, 3, 64, 64), z(64, dt=torch.float32), z(3, 3, 64, 9),
                     z(9, dt=torch.float32))
    with pytest.raises(TypeError):
        T.conv_hr_ct(z(1, 8, 8, 64, dt=torch.float16), z(3, 3, 64, 64, dt=torch.float16),
                     z(64, dt=torch.float32), z(3, 3, 64, 3, dt=torch.float16),
                     z(3, dt=torch.float32))


@pytest.mark.cuda
def test_cuda_tail_entries_refuse_another_design():
    """Each C entry runs one design: the upconv's refuses fma in bf16 and mma
    in fp32, the FMA conv_hr entry refuses the mma code and bf16, the
    tensor-core entries refuse the fma code (``build.check`` raises)."""
    _need_card()
    from esrganplus_tpu_torch.kernels import build

    lib = build.load("tail_ct")
    s = torch.cuda.current_stream().cuda_stream
    fma, mma = T.S.DESIGNS["fma"], T.S.DESIGNS["mma"]
    x = torch.zeros(1, 8, 8, 16, device="cuda", dtype=torch.bfloat16)
    xf, w0, w1 = x.float(), torch.zeros(3, 3, 16, 16, device="cuda"), torch.zeros(3, 3, 16, 3,
                                                                                  device="cuda")
    b, part, o = torch.zeros(64, device="cuda"), torch.zeros(4096, device="cuda"), torch.empty(
        4096, device="cuda")
    codes = [
        lib.esr_upfold(build.dtype_code(x), fma, 16, 16, x.data_ptr(), x.data_ptr(), b.data_ptr(),
                       o.data_ptr(), 1, 4, 4, 0.2, s),
        lib.esr_upfold(build.dtype_code(xf), mma, 16, 16, xf.data_ptr(), xf.data_ptr(),
                       b.data_ptr(), o.data_ptr(), 1, 4, 4, 0.2, s),
        lib.esr_conv_hr(build.dtype_code(xf), mma, 16, 3, xf.data_ptr(), w0.data_ptr(),
                        b.data_ptr(), w1.data_ptr(), b.data_ptr(), o.data_ptr(), 1, 8, 8, 0.2, s),
        lib.esr_conv_hr(build.dtype_code(x), fma, 16, 3, x.data_ptr(), w0.data_ptr(),
                        b.data_ptr(), w1.data_ptr(), b.data_ptr(), o.data_ptr(), 1, 8, 8, 0.2, s),
        lib.esr_conv_hr_out(fma, 16, 3, x.data_ptr(), w1.data_ptr(), b.data_ptr(), o.data_ptr(),
                            1, 8, 8, s),
        lib.esr_upfold_dz(fma, 16, x.data_ptr(), x.data_ptr(), o.data_ptr(), part.data_ptr(), 1,
                          b.data_ptr(), 1, 4, 4, 0.2, s),
        lib.esr_upfold_dgrad(fma, 16, 16, x.data_ptr(), x.data_ptr(), o.data_ptr(), 1, 4, 4, s),
        lib.esr_upfold_wgrad(fma, 16, 16, x.data_ptr(), x.data_ptr(), part.data_ptr(), 1,
                             o.data_ptr(), 1, 4, 4, s)]
    for code in codes:
        with pytest.raises(RuntimeError, match="cudaError"):
            build.check(code, "tail_ct entry")


@pytest.mark.cuda
def test_cuda_backward_is_deterministic():
    """The weight gradient's split reduction has a fixed order: two runs on
    the same inputs give the same bits."""
    _need_card()
    kern, _ = _bwd_case("rdb_ct_bwd_noise", torch.bfloat16, shape=(4, 32, 32))
    a, b = kern(), kern()
    for k in a:
        assert a[k] is None or torch.equal(a[k], b[k]), k


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


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["noise", "detach", "rrdb_noise"])
def test_train_kernel_path_grads_match_plain_graph(variant):
    """nb=1 at flagship widths, batch 2 of 16×16, fp32, the same noise fed to
    both: the kernel path's loss (≤1e-5 relative) and every gradient leaf
    (≤1e-3 of max|ref|) against autograd of the plain cuDNN graph, and one
    forward + backward launches each kernel 3 / 1 / 2 / 1 times."""
    _need_card()
    from esrganplus_tpu_torch.models.rrdb import draw_noise

    cfg = RRDBNetConfig(nb=1, noise_relative_detach=variant == "detach",
                        rrdb_noise=variant == "rrdb_noise")
    plain = dataclasses.replace(cfg, trunk_kernel="plain", tail_kernel="plain")
    params = params_to(init_rrdbnet(cfg, seed=0, init_scale=0.5), "cuda")

    def leaves(t):
        if isinstance(t, dict):
            return [l for k in sorted(t) for l in leaves(t[k])]
        return [l for v in t for l in leaves(v)] if isinstance(t, list) else [t]

    ls = leaves(params)
    for l in ls:
        l.requires_grad_()
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.rand((2, 16, 16, 3), generator=gen, device="cuda")
    noise = draw_noise(cfg, (2, 16, 16, 64), gen, torch.float32, "cuda")

    def run(c):
        with fp32_exact():  # cuDNN's backward too: it runs here, not in the forward
            y = rrdbnet_forward(params, x, c, train=True, noise=noise)
            loss = (y - 0.5).abs().mean()
            return loss.item(), torch.autograd.grad(loss, ls)

    counted = (K.rdb_ct, K.conv3x3_ct, T.upfold_ct, T.conv_hr_ct, K.rdb_ct_bwd,
               K.conv3x3_ct_bwd, T.upfold_ct_bwd, T.conv_hr_ct_bwd)
    for fn in counted:
        fn.launches = 0
    lk, gk = run(cfg)
    assert [fn.launches for fn in counted] == [3, 1, 2, 1, 3, 1, 2, 1]
    lp, gp = run(plain)
    assert abs(lk - lp) / abs(lp) <= 1e-5
    errs = [((a - b).abs().max() / b.abs().max()).item() for a, b in zip(gk, gp)]
    assert max(errs) <= 1e-3, errs


@pytest.mark.cuda
def test_trainer_steps_on_the_card_repeat_bit_for_bit():
    """Two SRTrainer runs from one seed (bf16, noise on, nb=2): the same
    l_pix at every step, finite, and fp32 masters throughout."""
    _need_card()
    from esrganplus_tpu_torch.train import SRTrainConfig, SRTrainer

    gen = torch.Generator(device="cuda").manual_seed(4)
    batch = (torch.rand((4, 16, 16, 3), generator=gen, device="cuda"),
             torch.rand((4, 64, 64, 3), generator=gen, device="cuda"))
    runs = []
    for _ in range(2):
        tr = SRTrainer(RRDBNetConfig(nb=2), SRTrainConfig(compute_dtype="bfloat16"))
        state = tr.init_state(0)
        runs.append([tr.train_step(state, batch, 1)[1]["l_pix"].item() for _ in range(4)])
    assert runs[0] == runs[1] and np.isfinite(runs[0]).all()
    assert tr.predict(state["params"], batch[0]).shape == (4, 64, 64, 3)


# ---------------------------------------------------------------------------
# the GAN slice: the stage kernels of the discriminator and the perceptual net
# ---------------------------------------------------------------------------

STAGE_CASES = {  # id: (kernel size, B, H, W, cin, cout, act)
    "s1-3to8-odd": (3, 2, 36, 52, 3, 8, "lrelu"),
    "s1-16to16-odd": (3, 2, 36, 52, 16, 16, "relu"),
    "s1-3to64": (3, 4, 128, 128, 3, 64, None),
    "s1-3to64-relu": (3, 4, 128, 128, 3, 64, "relu"),
    "s1-64to64": (3, 4, 128, 128, 64, 64, "relu"),
    "s1-64to128": (3, 4, 64, 64, 64, 128, "relu"),
    "s1-128to128": (3, 4, 64, 64, 128, 128, "relu"),
    "s2-3to8-odd": (4, 2, 36, 52, 3, 8, "lrelu"),
    "s2-16to16-odd": (4, 2, 36, 52, 16, 16, None),
    "s2-128to128-odd": (4, 2, 36, 52, 128, 128, "relu"),
    "s2-64to64": (4, 4, 128, 128, 64, 64, None),
    "s2-128to128": (4, 4, 64, 64, 128, 128, "lrelu"),
}


def _stage_case(case, dtype):
    from esrganplus_tpu_torch.kernels import stage_ct as S

    ks, B, H, W, cin, cout, act = STAGE_CASES[case]
    rs = np.random.RandomState(1)
    t = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32)).cuda()
    w, b = S.prepare_stage_ct(t(ks, ks, cin, cout) * float(np.sqrt(2.0 / (ks * ks * cin))),
                              t(cout) * 0.1, dtype)
    x = t(B, H, W, cin).to(dtype)
    fns = ((S.conv_s1_ct, S.conv_s1_ct_plain, S.conv_s1_ct_bwd, S.conv_s1_ct_bwd_plain)
           if ks == 3 else
           (S.conv_s2_ct, S.conv_s2_ct_plain, S.conv_s2_ct_bwd, S.conv_s2_ct_bwd_plain))
    return fns, x, w, b, act, t


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(STAGE_CASES))
def test_cuda_stage_kernel_matches_plain_twin_forward_and_backward(case, dtype):
    """Each stage kernel against its twin; bf16 launches the tensor-core
    design in both directions at both kernel sizes (the 4x4 adjoint: the
    phase-fold data gradient and the 16-tap weight gradient), fp32 the FMA
    design."""
    _need_card()
    from esrganplus_tpu_torch.kernels import stage_ct as S

    (fwd, fwd_p, bwd, bwd_p), x, w, b, act, t = _stage_case(case, dtype)
    S.reset_launch_counts()
    with fp32_exact():
        got, want = fwd(x, w, b, act=act), fwd_p(x, w, b, act=act)
        assert got.shape == want.shape and torch.isfinite(got.float()).all()
        assert (got.float() - want.float()).abs().max().item() \
            <= TOL[dtype] * max(1.0, want.float().abs().max().item())
        if dtype == torch.bfloat16:
            assert (got != want).float().mean().item() <= 0.01
        g = t(*got.shape).to(dtype)
        saved = None if act is None else got
        r, r_p = bwd(x, w, saved, g, act=act), bwd_p(x, w, saved, g, act=act)
        assert r["dx"].dtype == dtype and r["w"].dtype == r["b"].dtype == torch.float32
        for k in ("dx", "w", "b"):
            ref = r_p[k].float()
            assert (r[k].float() - ref).abs().max().item() <= TOL[dtype] * ref.abs().max().item(), k
        # the halves on their own, and a second launch, give the same bits
        assert torch.equal(bwd(x, w, saved, g, act=act, need_dw=False)["dx"], r["dx"])
        again = bwd(x, w, saved, g, act=act, need_dx=False)
        assert again["dx"] is None and torch.equal(again["w"], r["w"]) \
            and torch.equal(again["b"], r["b"])
    design = "mma" if dtype == torch.bfloat16 else "fma"
    assert fwd.launches_by_design == {"fma": 0, "mma": 0, design: 1}
    assert bwd.launches_by_design == {"fma": 0, "mma": 0, design: 3}


@pytest.mark.cuda
def test_cuda_stage_kernels_raise_for_what_they_do_not_take():
    _need_card()
    from esrganplus_tpu_torch.kernels import stage_ct as S

    x = torch.zeros(1, 8, 8, 8, device="cuda")
    w, b = torch.zeros(3, 3, 8, 24, device="cuda"), torch.zeros(24, device="cuda")
    with pytest.raises(ValueError, match="cout"):  # a width the kernel has no instance for
        S.conv_s1_ct(x, w, b)
    with pytest.raises(ValueError, match="input channels"):
        S.conv_s1_ct(torch.zeros(1, 8, 8, 256, device="cuda"),
                     torch.zeros(3, 3, 256, 64, device="cuda"), torch.zeros(64, device="cuda"))
    with pytest.raises(TypeError):
        S.conv_s1_ct(x.half(), w[..., :8].half(), b[:8])
    with pytest.raises(ValueError, match="cpu"):  # weights left on the CPU: no silent copy
        S.conv_s2_ct(x, torch.zeros(4, 4, 8, 8), b[:8])


@pytest.mark.cuda
def test_cuda_stage_entry_refuses_a_design_other_than_stage_design():
    """The C entries take one design per dtype, the one ``stage_ct.design``
    names: asked for mma in fp32 or for fma in bf16, at either kernel size
    and in every direction, they return an error code (``build.check``
    raises)."""
    _need_card()
    from esrganplus_tpu_torch.kernels import build
    from esrganplus_tpu_torch.kernels import stage_ct as S

    lib = build.load("stage_ct")
    stream = torch.cuda.current_stream().cuda_stream
    for dtype, ks, design in ((torch.float32, 3, "mma"), (torch.float32, 4, "mma"),
                              (torch.bfloat16, 4, "fma"), (torch.bfloat16, 3, "fma")):
        x = torch.zeros(1, 8, 8, 16, device="cuda", dtype=dtype)
        w = torch.zeros(ks, ks, 16, 16, device="cuda", dtype=dtype)
        b = torch.zeros(16, device="cuda")
        ho = 8 if ks == 3 else 4
        out = torch.empty(1, ho, ho, 16, device="cuda", dtype=dtype)
        code = lib.esr_stage_fwd(build.dtype_code(x), ks, S.DESIGNS[design], 16, x.data_ptr(),
                                 w.data_ptr(), b.data_ptr(), out.data_ptr(), 1, 8, 8, 16, 16, 0,
                                 0.2, stream)
        with pytest.raises(RuntimeError, match="cudaError"):
            build.check(code, "esr_stage_fwd")
    # the 4x4 adjoint's halves: the tensor cores in bf16, the FMA kernels in fp32
    for dtype, design in ((torch.bfloat16, "fma"), (torch.float32, "mma")):
        x = torch.zeros(1, 8, 8, 16, device="cuda", dtype=dtype)
        w = torch.zeros(4, 4, 16, 16, device="cuda", dtype=dtype)
        g = torch.zeros(1, 4, 4, 16, device="cuda", dtype=dtype)
        part = torch.empty(4 * 4 * 16 * 16 + 16, device="cuda")
        dwdb = torch.empty_like(part)
        codes = [
            lib.esr_stage_dgrad(build.dtype_code(x), 4, S.DESIGNS[design], 16, g.data_ptr(),
                                None, w.data_ptr(), torch.empty_like(x).data_ptr(), 1, 8, 8, 16,
                                16, 0, 0.2, stream),
            lib.esr_stage_wgrad(build.dtype_code(x), 4, S.DESIGNS[design], 16, x.data_ptr(),
                                g.data_ptr(), None, part.data_ptr(), 1, dwdb.data_ptr(), 1, 8,
                                8, 16, 16, 0, 0.2, stream)]
        for code in codes:
            with pytest.raises(RuntimeError, match="cudaError"):
                build.check(code, f"esr_stage 4x4 adjoint {dtype} {design}")


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,act", [(3, 8, "lrelu"), (16, 16, None), (128, 128, "relu"),
                                          (64, 64, None), (128, 64, "lrelu")])
@pytest.mark.parametrize("shape", [(2, 36, 52), (16, 64, 64)], ids=["odd", "flagship"])
def test_cuda_conv_s2_bwd_design_and_repeat(shape, cin, cout, act):
    """The bf16 4x4 adjoint on the tensor cores (phase-fold dx, 16-tap dW):
    within the bf16 bar of the twin, db 1e-4 of the twin's (the unrounded
    dz's sum), each half alone and a second call bit-equal, every launch
    counted as "mma"; at the odd stage shape (18x26 dz: neither a whole 8x16
    nor a whole 4x16 tile) and the width edges cin 3 and 16."""
    _need_card()
    from esrganplus_tpu_torch.kernels import stage_ct as S

    rs = np.random.RandomState(cin + cout)
    t = lambda *s_: torch.from_numpy(rs.randn(*s_).astype(np.float32)).cuda()
    B, H, W = shape
    w, b = S.prepare_stage_ct(t(4, 4, cin, cout) * float(np.sqrt(2.0 / (16 * cin))),
                              t(cout) * 0.1, torch.bfloat16)
    x = t(B, H, W, cin).to(torch.bfloat16)
    S.reset_launch_counts()
    out = S.conv_s2_ct(x, w, b, act=act)
    g = t(*out.shape).to(torch.bfloat16)
    saved = None if act is None else out
    with fp32_exact():
        got = S.conv_s2_ct_bwd(x, w, saved, g, act=act)
        want = S.conv_s2_ct_bwd_plain(x, w, saved, g, act=act)
    for k in ("dx", "w", "b"):
        a, r = got[k].float(), want[k].float()
        assert torch.isfinite(a).all(), k
        tol = 1e-4 if k == "b" else TOL[torch.bfloat16]
        assert (a - r).abs().max().item() <= tol * r.abs().max().item(), k
    dx_only = S.conv_s2_ct_bwd(x, w, saved, g, act=act, need_dw=False)
    dw_only = S.conv_s2_ct_bwd(x, w, saved, g, act=act, need_dx=False)
    again = S.conv_s2_ct_bwd(x, w, saved, g, act=act)
    assert torch.equal(dx_only["dx"], got["dx"])
    assert torch.equal(dw_only["w"], got["w"]) and torch.equal(dw_only["b"], got["b"])
    assert all(torch.equal(again[k], got[k]) for k in ("dx", "w", "b"))
    assert S.conv_s2_ct_bwd.launches_by_design == {"fma": 0, "mma": 4}
    assert S.conv_s2_ct.launches_by_design == {"fma": 0, "mma": 1}


@pytest.mark.cuda
def test_cuda_stage_mma_takes_tensors_off_16_byte_alignment():
    """The tensor-core kernels move 16-byte vectors; a view that starts two
    bytes into its storage gives the aligned copy's bits, forward and
    backward."""
    _need_card()
    from esrganplus_tpu_torch.kernels import stage_ct as S

    rs = np.random.RandomState(3)
    t = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32)).cuda()
    w, b = S.prepare_stage_ct(t(3, 3, 16, 32) * 0.1, t(32) * 0.1, torch.bfloat16)
    x = t(2, 12, 20, 16).to(torch.bfloat16)
    g = t(2, 12, 20, 32).to(torch.bfloat16)
    off = lambda a: torch.cat([a.new_zeros(1), a.flatten()])[1:].view(a.shape)
    assert off(x).data_ptr() % 16 and off(w).data_ptr() % 16
    y = S.conv_s1_ct(x, w, b, act="relu")
    assert torch.equal(S.conv_s1_ct(off(x), off(w), b, act="relu"), y)
    r = S.conv_s1_ct_bwd(x, w, y, g, act="relu")
    r_off = S.conv_s1_ct_bwd(off(x), off(w), off(y), off(g), act="relu")
    assert all(torch.equal(r[k], r_off[k]) for k in ("dx", "w", "b"))


def _grads_close_but_flips(got, want, tol=1e-4):
    """Gradients of the kernel route against the plain graph's: the median
    entry error within ``tol`` of its leaf's largest entry (or of 5 % of the
    largest gradient, for leaves whose true gradient is 0), 90 % of the
    entries within ``tol``, and the whole gradient's cosine at least 0.9999.
    Not every entry: a relu / lrelu gate that flips at a near-zero
    activation, where kernel and cuDNN sum in another order, moves the whole
    patch of entries behind it by as much as the cotangent there."""
    pairs = [(a.float(), b.float()) for a, b in zip(got, want) if b is not None]
    scale = max(b.abs().max().item() for _, b in pairs)
    errs = torch.cat([((a - b).abs() / max(b.abs().max().item(), 0.05 * scale)).flatten()
                      for a, b in pairs])
    assert torch.isfinite(errs).all()
    assert errs.median().item() <= tol and (errs <= tol).float().mean().item() >= 0.9
    flat = lambda i: torch.cat([p[i].flatten() for p in pairs])
    assert torch.nn.functional.cosine_similarity(flat(0), flat(1), dim=0).item() >= 0.9999


def _count_stage(fn):
    from esrganplus_tpu_torch.kernels import stage_ct as S

    counted = (S.conv_s1_ct, S.conv_s2_ct, S.conv_s1_ct_bwd, S.conv_s2_ct_bwd)
    for f in counted:
        f.launches = 0
    out = fn()
    return out, [f.launches for f in counted]


@pytest.mark.cuda
def test_auto_on_the_card_runs_d_and_f_through_the_stage_kernels():
    """``stage_kernel="auto"`` on a CUDA device: D's two early stages and F's
    four early convs launch the stage kernels (value and gradients within
    1e-4 of the plain graph's in fp32); a frozen net launches no weight
    half; ``"plain"`` launches nothing."""
    _need_card()
    from esrganplus_tpu_torch.models.discriminator import (DiscriminatorVGGConfig,
                                                           discriminator_forward,
                                                           init_discriminator)
    from esrganplus_tpu_torch.models.vgg import VGGFeatConfig, init_vgg_feat, vgg_feat_forward
    from esrganplus_tpu_torch.train.sr_model import tree_leaves

    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.rand(2, 128, 128, 3).astype(np.float32)).cuda().requires_grad_()
    dcfg = DiscriminatorVGGConfig(base_nf=16)
    dp = params_to(init_discriminator(0, dcfg), "cuda")
    leaves = [l.requires_grad_() for l in tree_leaves(dp)]

    def d_run(cfg):
        with fp32_exact():
            logits, st = discriminator_forward(dp, x, cfg, train=True)
            grads = torch.autograd.grad(torch.sin(logits).sum(), [x] + leaves, allow_unused=True)
        return logits, st, grads

    (logits, st, grads), launches = _count_stage(lambda: d_run(dcfg))
    assert launches == [2, 2, 2, 2]
    (logits_p, st_p, grads_p), launches_p = _count_stage(
        lambda: d_run(dataclasses.replace(dcfg, stage_kernel="plain")))
    assert launches_p == [0, 0, 0, 0]
    assert (logits - logits_p).abs().max().item() <= 1e-4 * max(1.0, logits_p.abs().max().item())
    _grads_close_but_flips(grads, grads_p)
    assert torch.allclose(st["bn"][1]["a"]["mean"], st_p["bn"][1]["a"]["mean"], atol=1e-5)

    vcfg = VGGFeatConfig(layout=(16, 16, "M", 32, 32, "M", 256, 256), feature_layer=13)
    vp = params_to(init_vgg_feat(0, vcfg), "cuda")

    def f_run(cfg):
        with fp32_exact():
            fea = vgg_feat_forward(vp, x, cfg)
            gx, = torch.autograd.grad(torch.sin(fea).sum(), x)
        return fea, gx

    (fea, gx), launches = _count_stage(lambda: f_run(vcfg))
    assert launches == [4, 0, 4, 0]  # frozen weights: four data-gradient launches
    (fea_p, gx_p), _ = _count_stage(lambda: f_run(dataclasses.replace(vcfg, stage_kernel="plain")))
    assert (fea - fea_p).abs().max().item() <= 1e-4 * max(1.0, fea_p.abs().max().item())
    _grads_close_but_flips([gx], [gx_p])
    # a width the kernels have no instance for raises under auto: no fallback
    bad = DiscriminatorVGGConfig(base_nf=24)
    with pytest.raises(ValueError, match="cout"):
        discriminator_forward(params_to(init_discriminator(0, bad), "cuda"), x.detach(), bad)


@pytest.mark.cuda
def test_gan_trainer_steps_on_the_card_repeat_bit_for_bit():
    _need_card()
    from esrganplus_tpu_torch.models.discriminator import DiscriminatorVGGConfig
    from esrganplus_tpu_torch.models.vgg import VGGFeatConfig
    from esrganplus_tpu_torch.train import GANTrainConfig, GANTrainer

    rs = np.random.RandomState(0)
    batch = (rs.rand(4, 24, 24, 3).astype(np.float32), rs.rand(4, 96, 96, 3).astype(np.float32))
    runs = []
    for _ in range(2):
        t = GANTrainer(RRDBNetConfig(nb=2), DiscriminatorVGGConfig(input_size=96, base_nf=16),
                       GANTrainConfig(compute_dtype="bfloat16"), device="cuda",
                       vgg_cfg=VGGFeatConfig(layout=(16, 16, "M", 32, 32, "M", 256, 256),
                                             feature_layer=13))
        state = t.init_state(0)
        (_, logs), launches = _count_stage(lambda: t.train_step(state, batch, 3))
        assert launches == [14, 6, 10, 6]
        runs.append([{k: float(v) for k, v in logs.items()}]
                    + [{k: float(v) for k, v in t.train_step(state, batch, 3)[1].items()}
                       for _ in range(2)])
    assert runs[0] == runs[1] and all(np.isfinite(v) for r in runs[0] for v in r.values())


# ---------------------------------------------------------------------------
# the nESRGAN+ slice: the fused noise mode and the 9-tap RDB (rdb_t)
# ---------------------------------------------------------------------------

SEED = (0x1234ABCD, 0x0BADF00D)


@pytest.mark.cuda
def test_cuda_dzsrc_layout_matches_the_ctypes_struct():
    """Every library whose kernels read a ``DzSrc`` reports the C size it was
    built with, and loading refuses a size that differs from the ctypes one."""
    _need_card()
    import ctypes

    from esrganplus_tpu_torch.kernels import build

    for name in ("dgrad_ct", "wgrad_ct", "rdb_t"):
        assert build.load(name).esr_dzsrc_size() == ctypes.sizeof(build.DzSrc), name
    with pytest.raises(RuntimeError, match="DzSrc"):
        build.check_dzsrc_layout(ctypes.sizeof(build.DzSrc) + 4, "dgrad_ct")


@pytest.mark.cuda
def test_cuda_philox_draw_matches_twin():
    """The device function's normals against the twin's (on the CPU and on the
    card): the same counter and key, Box-Muller in fp32 (logf / cosf against
    torch's log / cos: within 1e-5); the draw of an element does not depend
    on the shape around it."""
    _need_card()
    from esrganplus_tpu_torch.kernels.philox import (noise_factor_cuda, philox_normal,
                                                     philox_normal_cuda)

    shape = (3, 17, 23, 64)
    got = philox_normal_cuda(SEED, shape)
    assert got.dtype == torch.float32 and got.shape == shape
    for dev in ("cpu", "cuda"):
        want = philox_normal(SEED, shape, dev)
        assert (got.cpu() - want.cpu()).abs().max().item() <= 1e-5, dev
    assert torch.equal(philox_normal_cuda(SEED, (2, 9, 23, 64)), got[:2, :9])
    assert not torch.equal(philox_normal_cuda((SEED[0], SEED[1] + 1), shape), got)
    # the factor the backward fills is 1 + σn of the same draws, rounded as the twin
    assert torch.equal(noise_factor_cuda(SEED, 0.1, shape, "cuda"), 1.0 + 0.1 * got)


@pytest.mark.cuda
@pytest.mark.parametrize("b0", [0, 5])
def test_cuda_philox_batch_offset_draws_rows_of_the_global_draw(b0):
    """With the batch offset b0, the normals, the fused mode's factor and its
    forward in rdb_ct are rows b0.. of the larger batch's, bit for bit: a
    rank of a data-parallel run draws its rows of the global batch."""
    _need_card()
    from esrganplus_tpu_torch.kernels.philox import noise_factor_cuda, philox_normal_cuda

    shape = (3, 9, 23, 64)
    whole = philox_normal_cuda(SEED, (b0 + 3, 9, 23, 64))
    assert torch.equal(philox_normal_cuda(SEED, shape, b0=b0), whole[b0:])
    assert torch.equal(noise_factor_cuda(SEED, 0.1, shape, "cuda", b0=b0),
                       noise_factor_cuda(SEED, 0.1, whole.shape, "cuda")[b0:])
    rs = np.random.RandomState(3)
    p = {f"conv{k}": _conv(rs, 64 + (k - 1) * 32, 64 if k == 5 else 32) for k in range(1, 6)}
    w = K.prepare_rdb_ct_weights(p, torch.bfloat16)
    x = torch.from_numpy(rs.randn(b0 + 3, 8, 16, 64).astype(np.float32)).to("cuda",
                                                                         torch.bfloat16)
    full = K._rdb_ct_cuda(x, w, seed=SEED, sigma=0.1, save=True)
    part = K._rdb_ct_cuda(x[b0:].contiguous(), w, seed=SEED, b0=b0, sigma=0.1, save=True)
    assert all(torch.equal(a, b[b0:]) for a, b in zip(part, full))


@pytest.mark.cuda
def test_cuda_resident_step_under_gloo_raises():
    """A resident step on the card is a captured graph, and gloo's
    collectives cannot be captured: under a gloo group it raises; it does not
    fall back to eager steps."""
    _need_card()
    import socket

    from esrganplus_tpu_torch.parallel import mesh
    from esrganplus_tpu_torch.train import SRTrainConfig, SRTrainer

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    mesh.init_process_group(f"localhost:{port}", 1, 0, "cuda", backend="gloo")
    try:
        t = SRTrainer(RRDBNetConfig(nf=8, nb=1, gc=4), SRTrainConfig(), device="cuda")
        with pytest.raises(RuntimeError, match="gloo backend's collectives cannot be captured"):
            t.train_step_resident(t.init_state(0), None, 1, 2)
    finally:
        mesh.destroy_process_group()


def _rdb_ct_case(dtype, shape, rs):
    B, H, W = shape
    act = lambda: torch.from_numpy(rs.randn(B, H, W, 64).astype(np.float32)).to("cuda", dtype)
    p = {f"conv{k}": _conv(rs, 64 + (k - 1) * 32, 64 if k == 5 else 32) for k in range(1, 6)}
    p["conv1x1"] = {"w": torch.from_numpy((rs.randn(1, 1, 64, 32) / 8).astype(np.float32)).cuda()}
    return K.prepare_rdb_ct_weights(p, dtype), act(), act()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 37, 53), (16, 32, 32)], ids=["odd", "train"])
def test_cuda_rdb_ct_fused_forward_matches_plain_twin(shape, dtype):
    """rdb_ct's training forward drawing its noise in the kernel: output and
    saved buffers against the twin's (which draws with philox_normal), at the
    forward kernels' bars."""
    _need_card()
    w, x, _ = _rdb_ct_case(dtype, shape, np.random.RandomState(3))
    with fp32_exact():
        got = K._rdb_ct_cuda(x, w, seed=SEED, sigma=0.1, save=True)
        want = K._rdb_ct_train_plain(x, w, seed=SEED, sigma=0.1)
        clean = K._rdb_ct_cuda(x, w, save=True)[0]
    for name, a, b in zip(("out", "cat", "lsv"), got, want):
        a, b = a.float(), b.float()
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        assert (a - b).abs().max().item() <= TOL[dtype] * max(1.0, b.abs().max().item()), name
        if dtype == torch.bfloat16:
            assert (a != b).float().mean().item() <= 0.01, name
    assert not torch.equal(got[0], clean)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_cuda_rdb_ct_fused_backward_matches_plain_twin(dtype):
    """The backward kernels regenerate the forward's draws where they read the
    cotangent: every gradient against the twin's on the same saved buffers,
    and a second call gives the same bits."""
    _need_card()
    w, x, g = _rdb_ct_case(dtype, (2, 37, 53), np.random.RandomState(4))
    _, cat, lsv = K._rdb_ct_cuda(x, w, seed=SEED, sigma=0.1, save=True)
    before = K.rdb_ct_bwd.launches
    with fp32_exact():
        got = K.rdb_ct_bwd(x, w, cat, lsv, g, seed=SEED, sigma=0.1)
        want = K.rdb_ct_bwd_plain(x, w, cat, lsv, g, seed=SEED, sigma=0.1)
        again = K.rdb_ct_bwd(x, w, cat, lsv, g, seed=SEED, sigma=0.1)
    assert K.rdb_ct_bwd.launches == before + 2
    for k, ref in want.items():
        a, b = got[k].float(), ref.float()
        assert torch.isfinite(a).all(), k
        assert (a - b).abs().max().item() <= BWD_TOL[dtype] * b.abs().max().item(), k
        assert torch.equal(got[k], again[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("detach", [False, True], ids=["noise", "detach"])
def test_fused_train_kernel_path_grads_match_plain_graph(detach):
    """nb=1 at flagship widths, batch 2 of 16×16, fp32, ``noise_kernel="fused"``
    with one set of site seeds: the kernel path (noise drawn in the kernels)
    against autograd of the plain cuDNN graph (the same draws from
    philox_normal), loss ≤1e-5 relative and every leaf ≤1e-3 of max|ref|."""
    _need_card()
    from esrganplus_tpu_torch.train.rng import site_seeds

    cfg = RRDBNetConfig(nb=1, noise_kernel="fused", noise_relative_detach=detach)
    plain = dataclasses.replace(cfg, trunk_kernel="plain", tail_kernel="plain")
    params = params_to(init_rrdbnet(cfg, seed=0, init_scale=0.5), "cuda")

    def leaves(t):
        if isinstance(t, dict):
            return [l for k in sorted(t) for l in leaves(t[k])]
        return [l for v in t for l in leaves(v)] if isinstance(t, list) else [t]

    ls = [l.requires_grad_() for l in leaves(params)]
    x = torch.rand((2, 16, 16, 3), generator=torch.Generator(device="cuda").manual_seed(2),
                   device="cuda")
    seeds = site_seeds(3, 7, cfg.nb)

    def run(c):
        with fp32_exact():
            y = rrdbnet_forward(params, x, c, train=True, noise_seeds=seeds)
            loss = (y - 0.5).abs().mean()
            return loss.item(), torch.autograd.grad(loss, ls)

    K.rdb_ct.launches = K.rdb_ct_bwd.launches = 0
    lk, gk = run(cfg)
    assert (K.rdb_ct.launches, K.rdb_ct_bwd.launches) == (3, 3)
    lp, gp = run(plain)
    assert abs(lk - lp) / abs(lp) <= 1e-5
    errs = [((a - b).abs().max() / b.abs().max()).item() for a, b in zip(gk, gp)]
    assert max(errs) <= 1e-3, errs


def _rdb_t_case(dtype, shape=(2, 37, 53), seed=5):
    from esrganplus_tpu_torch.kernels import rdb_t as R

    rs = np.random.RandomState(seed)
    B, H, W = shape
    act = lambda: torch.from_numpy(rs.randn(B, H, W, 64).astype(np.float32)).to("cuda", dtype)
    p = {f"conv{k}": _conv(rs, 64 + (k - 1) * 32, 64 if k == 5 else 32) for k in range(1, 6)}
    p["conv1x1"] = {"w": torch.from_numpy((rs.randn(1, 1, 64, 32) / 8).astype(np.float32)).cuda()}
    return R, R.prepare_rdb_t_weights(p, 64, 32, True, dtype), act(), act()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("fold", [False, True], ids=["plain", "rrdb_fold"])
def test_cuda_rdb_t_matches_plain_twin(fold, dtype):
    _need_card()
    R, ws, x, res = _rdb_t_case(dtype)
    kw = dict(res=res, rrdb_scale=0.2) if fold else {}
    before = R.rdb_t.launches
    with fp32_exact():
        got, want = R.rdb_t(x, *ws, **kw).float(), R.rdb_t_plain(x, *ws, **kw).float()
    assert R.rdb_t.launches == before + 1
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL[dtype] * max(1.0, want.abs().max().item())
    if dtype == torch.bfloat16:
        assert (got != want).float().mean().item() <= 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_cuda_rdb_t_bwd_matches_plain_twin(dtype):
    """The adjoint recomputed from x: dx, fp32 dW in rdb_t's layout, dW11 and
    the packed db against the twin's; deterministic; its workspace is freed
    when it returns."""
    _need_card()
    R, ws, x, g = _rdb_t_case(dtype, seed=6)
    torch.cuda.synchronize()
    before_mem, before = torch.cuda.memory_allocated(), R.rdb_t_bwd.launches
    with fp32_exact():
        got = R.rdb_t_bwd(x, *ws, g)
        torch.cuda.synchronize()
        kept = torch.cuda.memory_allocated() - before_mem
        want = R.rdb_t_bwd_plain(x, *ws, g)
    assert R.rdb_t_bwd.launches == before + 1
    assert kept <= sum(t.numel() * t.element_size() for t in got) + (1 << 20)
    assert got[0].dtype == dtype and all(t.dtype == torch.float32 for t in got[1:])
    names = ("dx", "dw1", "dw2", "dw3", "dw4", "dw5", "dw11", "db")
    for name, a, b in zip(names, got, want):
        a, b = a.float(), b.float()
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        assert (a - b).abs().max().item() <= BWD_TOL[dtype] * b.abs().max().item(), name
    again = R.rdb_t_bwd(x, *ws, g)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_cuda_rdb_t_diff_launches_both_kernels_and_never_the_twins(monkeypatch):
    _need_card()
    R, ws, x, _ = _rdb_t_case(torch.bfloat16, shape=(2, 16, 16), seed=7)

    def refuse(*a, **kw):
        raise AssertionError("a twin ran on a CUDA tensor")

    for twin in ("rdb_t_plain", "rdb_t_bwd_plain"):
        monkeypatch.setattr(R, twin, refuse)
    masters = [w.float().requires_grad_() for w in ws]
    xr = x.float().requires_grad_()
    R.rdb_t.launches = R.rdb_t_bwd.launches = 0
    out = R.rdb_t_diff(xr.to(torch.bfloat16), *masters)
    grads = torch.autograd.grad(out.float().square().sum(), [xr, *masters])
    assert (R.rdb_t.launches, R.rdb_t_bwd.launches) == (1, 1)
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads)
    with pytest.raises(ValueError):  # weights in the wrong layout raise, no fallback
        R.rdb_t(x, ws[0].t().contiguous(), *ws[1:])


def _workbench_rdb_case(rs, nf, gc, conv1x1, xdt, wdt, shape):
    from esrganplus_tpu_torch.kernels.workbench import rdb as WR

    p = {f"conv{k}": _conv(rs, nf + (k - 1) * gc, nf if k == 5 else gc) for k in range(1, 6)}
    if conv1x1:
        p["conv1x1"] = {"w": torch.from_numpy(
            (rs.randn(1, 1, nf, gc) * np.sqrt(2.0 / nf)).astype(np.float32)).cuda()}
    x = torch.from_numpy(rs.randn(*shape, nf).astype(np.float32)).to("cuda", xdt)
    return WR, WR.prepare_rdb_weights(p, nf, gc, conv1x1, wdt), x


def _close_to_twin(got, want, dtype):
    got, want = got.float(), want.float()
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL[dtype] * max(1.0, want.abs().max().item())
    if dtype == torch.bfloat16:
        assert (got != want).float().mean().item() <= 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("cin,cout,slope", [(5, 7, None), (8, 24, 0.2), (64, 224, 0.0),
                                            (192, 64, 0.2), (320, 129, 0.2)])
def test_cuda_workbench_conv3x3_matches_plain_twin(cin, cout, slope, dtype):
    """Any Cin and Cout (the last Cout chunk ragged; above 192 input
    channels the tensor-core kernel stages them in two chunks), bias in x's
    dtype."""
    from esrganplus_tpu_torch.kernels.workbench import conv as WC

    _need_card()
    rs = np.random.RandomState(cin + cout)
    c = _conv(rs, cin, cout)
    x = torch.from_numpy(rs.randn(2, 16, 24, cin).astype(np.float32)).to("cuda", dtype)
    before = WC.conv3x3.launches
    by_design = dict(WC.conv3x3.launches_by_design)
    with fp32_exact():
        got = WC.conv3x3(x, c["w"], c["b"], act_slope=slope, tile=8)
        want = WC.conv3x3_plain(x, c["w"], c["b"], act_slope=slope, tile=8)
    assert WC.conv3x3.launches == before + 1 and got.dtype == dtype
    design = WC.conv_design(dtype)
    assert WC.conv3x3.launches_by_design[design] == by_design[design] + 1
    _close_to_twin(got, want, dtype)
    with fp32_exact():  # no bias
        _close_to_twin(WC.conv3x3(x, c["w"]), WC.conv3x3_plain(x, c["w"]), dtype)


@pytest.mark.cuda
def test_cuda_workbench_kernels_raise_for_a_non_dividing_tile():
    from esrganplus_tpu_torch.kernels.workbench import conv as WC

    _need_card()
    rs = np.random.RandomState(1)
    c = _conv(rs, 8, 8)
    x = torch.zeros((1, 20, 16, 8), device="cuda")
    before = WC.conv3x3.launches
    with pytest.raises(ValueError):
        WC.conv3x3(x, c["w"], c["b"], tile=8)
    with pytest.raises(ValueError):
        WC.conv3x3(x, c["w"], c["b"])
    WR, ws, x = _workbench_rdb_case(rs, 16, 8, True, torch.bfloat16, torch.bfloat16, (1, 24, 32))
    rbefore = WR.rdb_fused.launches
    with pytest.raises(ValueError):
        WR.rdb_fused(x, *ws, nf=16, gc=8, tile=16)
    assert WC.conv3x3.launches == before and WR.rdb_fused.launches == rbefore


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,wdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.bfloat16)],
                         ids=["fp32", "bf16", "fp32x_bf16w"])
@pytest.mark.parametrize("conv1x1", [True, False], ids=["1x1", "no1x1"])
def test_cuda_rdb_fused_matches_plain_twin_odd(conv1x1, xdt, wdt):
    """nf=16, gc=8 at B=2, 32×48 (tile 16): seams, borders, H ≠ W."""
    _need_card()
    WR, ws, x = _workbench_rdb_case(np.random.RandomState(2), 16, 8, conv1x1, xdt, wdt,
                                    (2, 32, 48))
    kw = dict(nf=16, gc=8, conv1x1=conv1x1, slope=0.1, res_scale=0.3, tile=16)
    before = WR.rdb_fused.launches
    design = WR.rdb_design(xdt, wdt)
    by_design = WR.rdb_fused.launches_by_design[design]
    with fp32_exact():
        got, want = WR.rdb_fused(x, *ws, **kw), WR.rdb_fused_plain(x, *ws, **kw)
    assert WR.rdb_fused.launches == before + 1 and got.dtype == xdt
    assert WR.rdb_fused.launches_by_design[design] == by_design + 1
    _close_to_twin(got, want, xdt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_cuda_rdb_fused_flagship_width_matches_plain_twin(dtype):
    """nf=64, gc=32 with the 1×1 (the tensor cores' 8×16 tile in bf16, the
    FMA kernel's 8×8 in fp32) at an image that is not a multiple of the
    kernel tile; never the twin."""
    _need_card()
    WR, ws, x = _workbench_rdb_case(np.random.RandomState(3), 64, 32, True, dtype, dtype,
                                    (2, 40, 24))
    kw = dict(nf=64, gc=32, tile=8)
    design = WR.rdb_design(dtype, dtype)
    by_design = WR.rdb_fused.launches_by_design[design]
    with fp32_exact():
        got, want = WR.rdb_fused(x, *ws, **kw), WR.rdb_fused_plain(x, *ws, **kw)
    assert WR.rdb_fused.launches_by_design[design] == by_design + 1
    _close_to_twin(got, want, dtype)
    with pytest.raises(RuntimeError, match="forward only"):
        WR.rdb_fused(x.float().requires_grad_().to(dtype), *ws, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_cuda_workbench_design_and_repeat(dtype):
    """bf16 runs both workbench kernels on the tensor cores within the
    twin's bar, bit-equal on a second call and (rdb_fused) at both of its
    tiles; fp32 runs the FMA kernels within 1e-4."""
    from esrganplus_tpu_torch.kernels.workbench import conv as WC

    _need_card()
    rs = np.random.RandomState(4)
    c = _conv(rs, 64, 224)
    x = torch.from_numpy(rs.randn(2, 16, 32, 64).astype(np.float32)).to("cuda", dtype)
    WR, ws, xr = _workbench_rdb_case(rs, 64, 32, True, dtype, dtype, (2, 24, 32))
    design = "mma" if dtype == torch.bfloat16 else "fma"
    assert WC.conv_design(dtype) == WR.rdb_design(dtype, dtype) == design
    WC.reset_launch_counts()
    WR.reset_launch_counts()
    kw = dict(nf=64, gc=32, tile=8)
    with fp32_exact():
        got_c, got_r = WC.conv3x3(x, c["w"], c["b"], act_slope=0.2), WR.rdb_fused(xr, *ws, **kw)
        _close_to_twin(got_c, WC.conv3x3_plain(x, c["w"], c["b"], act_slope=0.2), dtype)
        _close_to_twin(got_r, WR.rdb_fused_plain(xr, *ws, **kw), dtype)
        again_c, again_r = WC.conv3x3(x, c["w"], c["b"], act_slope=0.2), WR.rdb_fused(xr, *ws, **kw)
    assert torch.equal(got_c, again_c) and torch.equal(got_r, again_r)
    assert WC.conv3x3.launches_by_design == {"fma": 0, "mma": 0, design: 2}
    assert WR.rdb_fused.launches_by_design == {"fma": 0, "mma": 0, design: 2}
    if dtype == torch.bfloat16:
        for tile in WR.MMA_TILES:
            other = WR._rdb_fused_cuda(xr, ws[:5], ws[5], nf=64, gc=32, conv1x1=True, slope=0.2,
                                       res_scale=0.2, ktile=tile)
            assert torch.equal(other, got_r), tile


@pytest.mark.cuda
@pytest.mark.parametrize("nf,gc,tile", [(128, 64, (8, 8)), (72, 40, (8, 8)), (256, 32, (4, 8))],
                         ids=["128_64", "72_40", "256_32"])
def test_cuda_rdb_fused_wide_bf16_runs_the_tensor_cores(nf, gc, tile):
    """bf16 past nf 64, gc 32 (several passes of columns, several K chunks
    a tap) runs the tensor-core kernel at the largest tile that fits, within
    the twin's max-error bar, and every tile that fits gives the same bits.
    The twin's fp32 sums (K = 9·128 a source here) round apart from exact
    ones in up to 2.4 % of outputs, so the share of outputs is held against
    the fp64-summed reference: no more than the twin's own share + 1 %."""
    _need_card()
    WR, ws, x = _workbench_rdb_case(np.random.RandomState(nf + gc), nf, gc, True,
                                    torch.bfloat16, torch.bfloat16, (1, 24, 32))
    kw = dict(nf=nf, gc=gc, tile=8)
    assert WR.mma_tile(nf, gc) == tile
    by_design = dict(WR.rdb_fused.launches_by_design)
    with fp32_exact():
        got, want = WR.rdb_fused(x, *ws, **kw), WR.rdb_fused_plain(x, *ws, **kw)
    assert WR.rdb_fused.launches_by_design == {**by_design, "mma": by_design["mma"] + 1}
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    assert (g - w).abs().max().item() <= TOL[torch.bfloat16] * max(1.0, w.abs().max().item())
    exact = WR.rdb_fused_fp64(x, *ws, nf=nf, gc=gc)
    share = lambda a, b: (a != b).float().mean().item()
    assert share(got, exact) <= share(want, exact) + 0.01
    fits = WR.mma_tiles(nf, gc)
    assert fits[0] == tile
    for t in fits[1:]:
        other = WR._rdb_fused_cuda(x, ws[:5], ws[5], nf=nf, gc=gc, conv1x1=True, slope=0.2,
                                   res_scale=0.2, ktile=t)
        assert torch.equal(other, got), t


@pytest.mark.cuda
def test_cuda_workbench_entries_refuse_other_designs():
    """Each C entry runs one design per dtype pairing: asked for mma in fp32
    or for fma in bf16 it returns an error code (``build.check`` raises);
    the tensor-core RDB also refuses a tile it does not run, widths whose
    planes do not fit a block at the tile asked for, and widths past one
    pass at 8×16."""
    from esrganplus_tpu_torch.kernels import build
    from esrganplus_tpu_torch.kernels.stage_ct import DESIGNS

    _need_card()
    stream = torch.cuda.current_stream().cuda_stream
    conv = build.load("workbench_conv")
    for dtype, design in ((torch.float32, "mma"), (torch.bfloat16, "fma")):
        x = torch.zeros(1, 8, 16, 16, device="cuda", dtype=dtype)
        w = torch.zeros(3, 3, 16, 16, device="cuda", dtype=dtype)
        b, out = torch.zeros(16, device="cuda"), torch.empty_like(x)
        code = conv.esr_wb_conv3x3(DESIGNS[design], build.dtype_code(x), x.data_ptr(),
                                   w.data_ptr(), b.data_ptr(), out.data_ptr(), 1, 8, 16, 16, 16,
                                   0, 0.0, stream)
        with pytest.raises(RuntimeError, match="cudaError"):
            build.check(code, "esr_wb_conv3x3")
    rdb = build.load("workbench_rdb")
    bad = [(torch.float32, torch.float32, "mma", 16, 8, 8, 8),
           (torch.float32, torch.bfloat16, "mma", 16, 8, 8, 8),
           (torch.bfloat16, torch.bfloat16, "fma", 16, 8, 8, 8),
           (torch.bfloat16, torch.bfloat16, "mma", 16, 8, 16, 16),
           (torch.bfloat16, torch.bfloat16, "mma", 256, 64, 8, 16),
           (torch.bfloat16, torch.bfloat16, "mma", 72, 32, 8, 16),
           (torch.float32, torch.float32, "fma", 16, 8, 8, 16)]
    for xdt, wdt, design, nf, gc, th, tw in bad:
        x = torch.zeros(1, 16, 16, nf, device="cuda", dtype=xdt)
        w = torch.zeros(3 * 3 * (nf + 5 * gc) * (nf + 5 * gc), device="cuda", dtype=wdt)
        b = torch.zeros(nf + 4 * gc, device="cuda")
        code = rdb.esr_wb_rdb_fused(DESIGNS[design], build.dtype_code(x), build.dtype_code(w),
                                    x.data_ptr(), *(w.data_ptr(),) * 5, b.data_ptr(),
                                    torch.empty_like(x).data_ptr(), 1, 16, 16, nf, gc, 1, 0.2,
                                    0.2, th, tw, stream)
        with pytest.raises(RuntimeError, match="cudaError"):
            build.check(code, f"esr_wb_rdb_fused {xdt} {wdt} {design} {nf} {gc} {th}x{tw}")


# ---------------------------------------------------------------------------
# the dense-stage kernel's two designs (csrc/dense_conv.cuh): bf16 rdb_ct,
# conv3x3_ct and rdb_t on the tensor cores, fp32 on the CUDA cores
# ---------------------------------------------------------------------------

DENSE_ODD = (2, 37, 53)


def _dense_params(rs, nf, gc, conv1x1):
    p = {f"conv{k}": _conv(rs, nf + (k - 1) * gc, nf if k == 5 else gc) for k in range(1, 6)}
    if conv1x1:
        p["conv1x1"] = {"w": torch.from_numpy(
            (rs.randn(1, 1, nf, gc) * np.sqrt(2.0 / nf)).astype(np.float32)).cuda()}
    return p


def _held_bf16(got, want, name, max_differ=0.01):
    """The bf16 bar: within 2e-2 of max(1, max|ref|), at most 1 % off the
    reference (``max_differ``)."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all(), name
    assert (got - want).abs().max().item() <= TOL[torch.bfloat16] * max(
        1.0, want.abs().max().item()), name
    assert (got != want).float().mean().item() <= max_differ, name


def _differ(a, b) -> float:
    return (a != b).float().mean().item()


def _counted(fn, call, attr="launches_by_design"):
    """``call()`` and the design of every launch of ``fn`` it made."""
    before = dict(getattr(fn, attr))
    out = call()
    return out, {k: n - before[k] for k, n in getattr(fn, attr).items()}


@pytest.mark.cuda
@pytest.mark.parametrize("gc", [8, 16, 32, 64])
@pytest.mark.parametrize("nf", [8, 16, 32, 64])
def test_cuda_dense_mma_at_every_width(nf, gc):
    """bf16 on the tensor cores at an odd shape: rdb_ct's training forward
    (out, x1..x4, l2|l4) with and without the 1×1, with the RRDB fold and
    in both noise modes; conv3x3_ct at nf → nf; rdb_t with and without the
    fold. Every call counted as "mma", a second call bit-equal, every output
    at the bf16 bar with at most 1 % of it off the reference. The dense
    chains' reference is the twin's graph summed in float64
    (``rdb_ct_fp64``): the twin's fp32 sums are themselves 0.4–0.5 % of out
    off it at the flagship's widths and 0.8–1.5 % at gc = 64 (a flip early
    in the chain cascades), and the tensor cores are nearer to it than the
    twin (PERF.md, Findings). Past the flagship's gc = 32 the share is held as
    ``kernels-workbench-wide`` holds rdb_fused past its widths: no more than
    the twin's own share off the float64 graph plus 1 %. The share off the
    twin is bounded at 2 %. conv3x3_ct, one stage, is held against the
    twin."""
    _need_card()
    from esrganplus_tpu_torch.kernels import rdb_t as R

    rs = np.random.RandomState(100 * nf + gc)
    B, H, W = DENSE_ODD
    act = lambda: torch.from_numpy(rs.randn(B, H, W, nf).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    x, res, noise = act(), act(), act()
    for conv1x1 in (True, False):
        w = K.prepare_rdb_ct_weights(_dense_params(rs, nf, gc, conv1x1), torch.bfloat16)
        for tag, kw in (("plain", {}), ("fold", dict(res=res, rrdb_scale=0.2)),
                        ("noise", dict(noise=noise, sigma=0.1)),
                        ("seeded", dict(seed=(7, 9), sigma=0.1))):
            with fp32_exact():
                got, ran = _counted(K.rdb_ct, lambda: K._rdb_ct_cuda(x, w, save=True, **kw))
                again = K._rdb_ct_cuda(x, w, save=True, **kw)
                torch.cuda.synchronize()
                twin = K._rdb_ct_train_plain(x, w, **kw)
                ref = K.rdb_ct_fp64(x, w, **kw)
            assert ran == {"fma": 0, "mma": 1}, tag
            for name, a, b, c, d in zip(("out", "cat", "lsv"), got, again, twin, ref):
                assert torch.equal(a, b), (tag, name)
                wide = _differ(c, d) if gc > 32 else 0.0
                _held_bf16(a, d, (conv1x1, tag, name), 0.01 + wide)
                assert _differ(a, c) <= 0.02, (conv1x1, tag, name)
    c = _conv(rs, nf, nf)
    wc, bc = K.prepare_conv_ct_weights(c["w"], c["b"], torch.bfloat16)
    with fp32_exact():
        got, ran = _counted(K.conv3x3_ct, lambda: K.conv3x3_ct(x, wc, bc, res))
        again = K.conv3x3_ct(x, wc, bc, res)
        want = K.conv3x3_ct_plain(x, wc, bc, res)
    assert ran == {"fma": 0, "mma": 1} and torch.equal(got, again)
    _held_bf16(got, want, "conv3x3_ct")
    p = _dense_params(rs, nf, gc, True)
    ws = R.prepare_rdb_t_weights(p, nf, gc, True, torch.bfloat16)
    w = K.prepare_rdb_ct_weights(p, torch.bfloat16)  # the same bf16 weights, HWIO
    for fold in ({}, dict(rrdb_scale=0.2)):
        r = res if fold else None
        with fp32_exact():
            got, ran = _counted(R.rdb_t, lambda: R.rdb_t(x, *ws, r, **fold))
            again = R.rdb_t(x, *ws, r, **fold)
            twin = R.rdb_t_plain(x, *ws, r, **fold)
            ref = K.rdb_ct_fp64(x, w, r, **fold)[0]
        assert ran == {"fma": 0, "mma": 1} and torch.equal(got, again)
        wide = _differ(twin, ref) if gc > 32 else 0.0
        _held_bf16(got, ref, ("rdb_t", bool(fold)), 0.01 + wide)
        assert _differ(got, twin) <= 0.02


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(3, 64), (64, 64), (448, 64), (200, 16)])
def test_cuda_conv3x3_ct_mma_takes_any_cin(cin, cout):
    """bf16 conv3x3_ct on the tensor cores at any cin: 3 (staged a channel at
    a time), 64, and 448 at 64 outputs, whose haloed tile is staged in slices
    of 192 channels (launch.dense_kt); counted as "mma", bit-equal on a second
    call, at the bf16 bar."""
    _need_card()
    from esrganplus_tpu_torch.kernels import launch

    kp = launch.round16(cin)
    assert (launch.dense_kt(cout, kp, True) != kp) == (cin == 448)
    rs = np.random.RandomState(cin)
    B, H, W = DENSE_ODD
    x = torch.from_numpy(rs.randn(B, H, W, cin).astype(np.float32)).to("cuda", torch.bfloat16)
    res = torch.from_numpy(rs.randn(B, H, W, cout).astype(np.float32)).to("cuda", torch.bfloat16)
    c = _conv(rs, cin, cout)
    w, b = K.prepare_conv_ct_weights(c["w"], c["b"], torch.bfloat16)
    with fp32_exact():
        got, ran = _counted(K.conv3x3_ct, lambda: K.conv3x3_ct(x, w, b, res))
        again = K.conv3x3_ct(x, w, b, res)
        want = K.conv3x3_ct_plain(x, w, b, res)
    assert ran == {"fma": 0, "mma": 1} and torch.equal(got, again)
    _held_bf16(got, want, "conv3x3_ct")


@pytest.mark.cuda
def test_cuda_dense_fp32_stays_on_fma_and_recompute_moves():
    """fp32 rdb_ct, conv3x3_ct and rdb_t run the FMA kernel within the fp32
    bar; rdb_t_bwd's stage 1–4 recompute runs on the dtype's design."""
    _need_card()
    from esrganplus_tpu_torch.kernels import rdb_t as R

    rs = np.random.RandomState(11)
    B, H, W = DENSE_ODD
    for dtype, kind in ((torch.float32, "fma"), (torch.bfloat16, "mma")):
        x = torch.from_numpy(rs.randn(B, H, W, 16).astype(np.float32)).to("cuda", dtype)
        p = _dense_params(rs, 16, 8, True)
        w = K.prepare_rdb_ct_weights(p, dtype)
        ws = R.prepare_rdb_t_weights(p, 16, 8, True, dtype)
        wc, bc = K.prepare_conv_ct_weights(p["conv1"]["w"][..., :8], None, dtype)
        with fp32_exact():
            for fn, call, plain in (
                    (K.rdb_ct, lambda: K.rdb_ct(x, w), lambda: K.rdb_ct_plain(x, w)),
                    (K.conv3x3_ct, lambda: K.conv3x3_ct(x, wc, bc),
                     lambda: K.conv3x3_ct_plain(x, wc, bc)),
                    (R.rdb_t, lambda: R.rdb_t(x, *ws), lambda: R.rdb_t_plain(x, *ws))):
                got, ran = _counted(fn, call)
                assert ran == {"fma": 0, "mma": 0, kind: 1}, fn.__name__
                want = plain().float()
                if dtype == torch.float32:
                    assert (got - want).abs().max().item() <= 1e-4 * max(
                        1.0, want.abs().max().item()), fn.__name__
            g = torch.from_numpy(rs.randn(B, H, W, 16).astype(np.float32)).to("cuda", dtype)
            _, ran = _counted(R.rdb_t_bwd, lambda: R.rdb_t_bwd(x, *ws, g), "recompute_by_design")
        assert ran == {"fma": 0, "mma": 0, kind: 1}


@pytest.mark.cuda
def test_cuda_dense_entries_refuse_fp32_on_the_tensor_cores():
    """The dense entries run bf16 on either design when asked by name (the
    FMA one is the accuracy baseline) and refuse fp32 on the tensor cores."""
    _need_card()
    from esrganplus_tpu_torch.kernels import build
    from esrganplus_tpu_torch.kernels.launch import DESIGNS

    x = torch.zeros(1, 8, 16, 16, device="cuda")
    w = torch.zeros(3, 3, 16, 16, device="cuda")
    b, out = torch.zeros(16, device="cuda"), torch.empty_like(x)
    s = torch.cuda.current_stream().cuda_stream
    code = build.load("rdb_ct").esr_dense_conv3x3(
        build.dtype_code(x), DESIGNS["mma"], 16, 0, x.data_ptr(), 16, None, 0, 16, w.data_ptr(),
        b.data_ptr(), None, out.data_ptr(), 16, None, 0, None, 0, None, 0, None, 0.0, None,
        0, 1.0, 1.0, 0.2, 1, 8, 16, s)
    with pytest.raises(RuntimeError, match="cudaError"):
        build.check(code, "esr_dense_conv3x3")
    wt = torch.zeros(16, 9 * 16, device="cuda")
    code = build.load("rdb_t").esr_rdb_t_stage(
        build.dtype_code(x), DESIGNS["mma"], 16, 0, 16, 8, x.data_ptr(), None, 0, 16,
        wt.data_ptr(), b.data_ptr(), None, out.data_ptr(), 16, None, 0, None, 0, None, 0, 1.0,
        1.0, 0.2, 1, 8, 16, s)
    with pytest.raises(RuntimeError, match="cudaError"):
        build.check(code, "esr_rdb_t_stage")


# ---------------------------------------------------------------------------
# the RDB adjoints' two designs (csrc/dgrad.cuh, csrc/wgrad.cuh): bf16
# rdb_ct_bwd, conv3x3_ct_bwd and rdb_t_bwd on the tensor cores, fp32 on the
# CUDA cores
# ---------------------------------------------------------------------------

DENSE_TRAIN = (16, 32, 32)


# chip_smoke.py's: a twin that recomputes its own gates. By design, not a
# fault (ROADMAP.md §3, F3): the recompute's one-ulp input differences flip a
# few near-zero gates, and no float64 decision on either side's own inputs
# reconciles them; test_cuda_dense_bwd_mma_at_every_width holds the
# recompute itself against the twin's forward instead.
BWD_TOL_OWN_BUFFERS = 5e-2


def _held_bwd(fn, call, plain, kind, tol, name, twin=None):
    """``call()`` counted as one call on ``kind`` and bit-equal on a second
    call; every gradient within ``tol`` of max|ref| of ``plain()``'s and,
    where the twin recomputes the forward's gates itself (``twin``), within
    BWD_TOL_OWN_BUFFERS of its."""
    with fp32_exact():
        got, ran = _counted(fn, call)
        again = call()
        torch.cuda.synchronize()
        refs = [(plain(), tol)] + ([] if twin is None else [(twin(), BWD_TOL_OWN_BUFFERS)])
    assert ran == {"fma": 0, "mma": 0, kind: 1}, name
    for want, bar in refs:
        got_, again_ = got, again
        if isinstance(got, dict):
            got_, again_, want = ([d[k] for k in sorted(want)] for d in (got, again, want))
        for i, (a, b, c) in enumerate(zip(got_, again_, want)):
            if c is None:
                assert a is None and b is None, (name, i)
                continue
            assert torch.equal(a, b), (name, i)
            a, c = a.float(), c.float()
            assert a.shape == c.shape and torch.isfinite(a).all(), (name, i)
            err = (a - c).abs().max().item() / max(c.abs().max().item(), 1e-30)
            assert err <= bar, (name, i, err, bar)


def _rdb_t_bwd_on_own_buffers(x, p, g, nf, gc):
    """rdb_ct_bwd_plain on rdb_t's own recomputed buffers (x1..x4, l2|l4 from
    the kernel: the gates rdb_t_bwd's launches read), in rdb_t's layout: the
    twin of its data- and weight-gradient launches alone."""
    from esrganplus_tpu_torch.kernels import rdb_t as R

    ws = R.prepare_rdb_t_weights(p, nf, gc, True, x.dtype)
    _, cat, lsv = R._stages(x, ws, slope=0.2, last=False)
    r = K.rdb_ct_bwd_plain(x, K.prepare_rdb_ct_weights(p, x.dtype), cat, lsv, g)
    q = {f"conv{k}": {"w": r[f"w{k}"], "b": r[f"b{k}"]} for k in range(1, 6)}
    q["conv1x1"] = {"w": r["w11"][None, None]}
    return (r["dx"], *R.prepare_rdb_t_weights(q, nf, gc, True, torch.float32))


def _dense_bwd_cases(rs, nf, gc, shape, dtype):
    """(name, wrapper, call, reference call, twin call or None) of rdb_ct_bwd
    with and without the 1×1, with input and with fused noise, on the
    kernel's saved training buffers, its twin the reference; and of
    rdb_t_bwd, held to its adjoint's twin on its own recomputed buffers and
    to its twin (:func:`_held_bwd`)."""
    from esrganplus_tpu_torch.kernels import rdb_t as R

    B, H, W = shape
    act = lambda c=nf: torch.from_numpy(rs.randn(B, H, W, c).astype(np.float32)).to("cuda", dtype)
    x, noise, g = act(), act(), act()
    out = []
    for tag, conv1x1, kw in (("1x1", True, {}), ("no1x1", False, {}),
                             ("noise", True, dict(noise=noise, sigma=0.1)),
                             ("fused", True, dict(seed=(7, 9), sigma=0.1))):
        w = K.prepare_rdb_ct_weights(_dense_params(rs, nf, gc, conv1x1), dtype)
        noise_t = kw.pop("noise", None)
        _, cat, lsv = K._rdb_ct_cuda(x, w, None, noise_t, save=True, **kw)
        args = (x, w, cat, lsv, g, noise_t)
        out.append((f"rdb_ct_bwd_{tag}", K.rdb_ct_bwd,
                    lambda args=args, kw=kw: K.rdb_ct_bwd(*args, **kw),
                    lambda args=args, kw=kw: K.rdb_ct_bwd_plain(*args, **kw), None))
    p = _dense_params(rs, nf, gc, True)
    ws = R.prepare_rdb_t_weights(p, nf, gc, True, dtype)
    out.append(("rdb_t_bwd", R.rdb_t_bwd, lambda: R.rdb_t_bwd(x, *ws, g),
                lambda: _rdb_t_bwd_on_own_buffers(x, p, g, nf, gc),
                lambda: R.rdb_t_bwd_plain(x, *ws, g)))
    return out


def _rdb_t_recompute_held(rs, nf, gc):
    """bf16 rdb_t_bwd's recomputed buffers (``_stages(last=False)``: x1..x4
    and l2|l4, the gates its launches read) against the twin's forward
    (``_forward_plain``'s x1..x4 and lrelu(z2), lrelu(z4)) at the odd shape,
    at the forward card tests' bar: within 2e-2 of max(1, max|ref|), at most
    1 % of entries off the twin; past gc = 32 at most the twin's own share
    off the float64 graph (``rdb_ct_fp64``) plus 1 %."""
    from esrganplus_tpu_torch.kernels import rdb_t as R

    bf = torch.bfloat16
    x = torch.from_numpy(rs.randn(*DENSE_ODD, nf).astype(np.float32)).to("cuda", bf)
    p = _dense_params(rs, nf, gc, True)
    ws = R.prepare_rdb_t_weights(p, nf, gc, True, bf)
    lrelu = lambda z: torch.where(z >= 0, z, z * 0.2)
    with fp32_exact():
        _, cat, lsv = R._stages(x, ws, slope=0.2, last=False)
        torch.cuda.synchronize()
        im, zs, _ = R._forward_plain(x, ws, 0.2)
        exact = K.rdb_ct_fp64(x, K.prepare_rdb_ct_weights(p, bf))[1:]
    xk = lambda k: im[..., 9 * (nf + (k - 1) * gc) + 4 * gc:][..., :gc]  # source k's centre tap
    twin = (torch.cat([xk(k) for k in range(1, 5)], -1).to(bf),
            torch.cat([lrelu(zs[1]), lrelu(zs[3])], -1).to(bf))
    for name, got, want, ref in zip(("cat", "lsv"), (cat, lsv), twin, exact):
        wide = _differ(want, ref) if gc > 32 else 0.0
        _held_bf16(got, want, ("rdb_t_bwd recompute", nf, gc, name), 0.01 + wide)


@pytest.mark.cuda
@pytest.mark.parametrize("gc", [8, 16, 32, 64])
@pytest.mark.parametrize("nf", [8, 16, 32, 64])
def test_cuda_dense_bwd_mma_at_every_width(nf, gc):
    """bf16 rdb_ct_bwd (with and without the 1×1, input and fused noise) and
    rdb_t_bwd at the odd shape: every call on "mma", a second call
    bit-equal, every gradient within 2e-2 of the twin's max|ref| on the same
    gates (rdb_t_bwd's recompute, on the tensor cores since PR 11's, may flip
    a gate the twin's own recompute keeps: against that twin 5e-2). The two
    halves of rdb_t_bwd are pinned apart: its launches on its own recomputed
    buffers at 2e-2, and the recompute against the twin's forward
    (:func:`_rdb_t_recompute_held`)."""
    _need_card()
    rs = np.random.RandomState(10 * nf + gc)
    for name, fn, call, plain, twin in _dense_bwd_cases(rs, nf, gc, DENSE_ODD, torch.bfloat16):
        _held_bwd(fn, call, plain, "mma", BWD_TOL[torch.bfloat16], (nf, gc, name), twin)
    _rdb_t_recompute_held(rs, nf, gc)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_cuda_dense_bwd_designs_at_the_train_shape(dtype):
    """Flagship widths at the training shape (batch 16, 32²): bf16 on
    "mma", fp32 on "fma" at its 1e-4 bar, each bit-equal on a second call."""
    _need_card()
    rs = np.random.RandomState(21)
    kind = "mma" if dtype == torch.bfloat16 else "fma"
    for name, fn, call, plain, twin in _dense_bwd_cases(rs, 64, 32, DENSE_TRAIN, dtype):
        _held_bwd(fn, call, plain, kind, BWD_TOL[dtype], name, twin)


@pytest.mark.cuda
@pytest.mark.parametrize("nf,gc", [(8, 8), (64, 32)])
def test_cuda_dense_bwd_mma_at_batch_one(nf, gc):
    """bf16 at B = 1 with odd H and W (one partial pixel tile a row): the
    same holds as at the other shapes."""
    _need_card()
    rs = np.random.RandomState(nf + 3 * gc)
    for name, fn, call, plain, twin in _dense_bwd_cases(rs, nf, gc, (1, 13, 19), torch.bfloat16):
        _held_bwd(fn, call, plain, "mma", BWD_TOL[torch.bfloat16], (nf, gc, name), twin)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [DENSE_ODD, DENSE_TRAIN], ids=["odd", "train"])
@pytest.mark.parametrize("cin", [64, 200, 448])
def test_cuda_conv3x3_ct_bwd_designs_take_any_cin(cin, shape, dtype):
    """conv3x3_ct_bwd at cin 64, 200 and 448 (64 outputs): bf16 on "mma"
    (ragged channel chunks of the data gradient, two-chunk weight-gradient
    blocks), fp32 on "fma"; bit-equal repeats; the dtype's bar."""
    _need_card()
    rs = np.random.RandomState(cin)
    B, H, W = shape
    x = torch.from_numpy(rs.randn(B, H, W, cin).astype(np.float32)).to("cuda", dtype)
    g = torch.from_numpy(rs.randn(B, H, W, 64).astype(np.float32)).to("cuda", dtype)
    c = _conv(rs, cin, 64)
    w, _ = K.prepare_conv_ct_weights(c["w"], c["b"], dtype)
    kind = "mma" if dtype == torch.bfloat16 else "fma"
    _held_bwd(K.conv3x3_ct_bwd, lambda: K.conv3x3_ct_bwd(x, w, g),
              lambda: K.conv3x3_ct_bwd_plain(x, w, g), kind, BWD_TOL[dtype], cin)


@pytest.mark.cuda
def test_cuda_dense_bwd_fp32_stays_on_fma_at_every_width():
    """fp32 rdb_ct_bwd and rdb_t_bwd run the FMA kernels within 1e-4 at the
    width edges."""
    _need_card()
    for nf, gc in ((8, 8), (64, 64), (16, 32)):
        rs = np.random.RandomState(nf + gc)
        for name, fn, call, plain, twin in _dense_bwd_cases(rs, nf, gc, DENSE_ODD, torch.float32):
            _held_bwd(fn, call, plain, "fma", BWD_TOL[torch.float32], (nf, gc, name), twin)


@pytest.mark.cuda
def test_cuda_dense_bwd_entries_refuse_fp32_on_the_tensor_cores():
    """The four backward entries refuse fp32 on the tensor cores, in both
    layouts, and a design code they do not know: the launch raises, nothing
    falls back."""
    _need_card()
    import ctypes

    from esrganplus_tpu_torch.kernels import build
    from esrganplus_tpu_torch.kernels import launch as L

    x = torch.zeros(1, 8, 16, 16, device="cuda")
    dz = L.dz_src(8, 16, build.DZ_G, g=x, g_stride=16)
    hwio, byt = torch.zeros(3, 3, 16, 16, device="cuda"), torch.zeros(16, 9 * 16, device="cuda")
    for lay, w in ((None, hwio), ((8, 8), byt)):
        with pytest.raises(RuntimeError, match="cudaError"):
            L.dgrad(x, 1, dz, 16, w, 16, chunk=16, out=torch.empty_like(x), by_target=lay,
                    kind="mma")
        with pytest.raises(RuntimeError, match="cudaError"):
            L.wgrad(x, None, 16, dz, 16, by_target=lay, kind="mma")
    xb = x.to(torch.bfloat16)
    s = torch.cuda.current_stream().cuda_stream
    code = build.load("dgrad_ct").esr_dgrad(1, 7, 16, 9, ctypes.byref(dz), 16, hwio.data_ptr(), 16,
                                            None, 0, 0, xb.data_ptr(), 16, None, 1, s)
    with pytest.raises(RuntimeError, match="cudaError"):
        build.check(code, "esr_dgrad")
    out = torch.empty(9 * 16 * 16 + 16, device="cuda")
    code = build.load("wgrad_ct").esr_wgrad(1, 7, 9, xb.data_ptr(), 16, None, 0, 16,
                                            ctypes.byref(dz), 16, out.data_ptr(), 1,
                                            out.data_ptr(), 1, s)
    with pytest.raises(RuntimeError, match="cudaError"):
        build.check(code, "esr_wgrad")


# ---------------------------------------------------------------------------
# evaluation and serving on the card (infer.BatchedEvaluator, cli/serve.py)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_batched_evaluator_matches_sequential_upscale():
    """The flagship (nb 23, nf 64, gc 32, ×4) in bf16: four 32² images in
    one forward of BatchedEvaluator (``calls`` 1; rdb_ct launched 69 times,
    all on "mma"), each within 2e-2 of max(1, max|ref|) of SRInferencer's
    upscale of it alone. The kernels work image by image; only fea_conv's
    cuDNN call sees the batch, and its algorithm may depend on it."""
    _need_card()
    from esrganplus_tpu_torch.infer import BatchedEvaluator, SRInferencer

    cfg = RRDBNetConfig()
    params = init_rrdbnet(cfg, seed=0, init_scale=0.5)
    imgs = [np.random.RandomState(i).rand(32, 32, 3).astype(np.float32) for i in range(4)]
    ev = BatchedEvaluator(params, cfg, dtype=torch.bfloat16)
    outs, ran = _counted(K.rdb_ct, lambda: ev.upscale_batch(imgs))
    assert ev.calls == 1 and ran == {"fma": 0, "mma": 69}
    seq = SRInferencer(params, cfg, dtype=torch.bfloat16)
    for img, out in zip(imgs, outs):
        want = seq.upscale(img)
        assert out.dtype == np.float32 and out.shape == want.shape == (128, 128, 3)
        assert np.isfinite(out).all()
        assert np.abs(out - want).max() <= TOL[torch.bfloat16] * max(1.0, np.abs(want).max())


@pytest.mark.cuda
def test_cuda_serve_round_trip(tmp_path):
    """cli/serve.py on its default device, bf16, flagship widths at nb 1:
    /healthz after the warm-up, and one POST /upscale whose PNG is bit-equal
    to SRInferencer(pad_multiple=32).upscale through tensor2img, every rdb_ct
    call on "mma"."""
    _need_card()
    import argparse
    import http.client
    import json
    import threading

    from esrganplus_tpu_torch.cli.serve import make_server
    from esrganplus_tpu_torch.convert import rrdbnet_to_state_dict
    from esrganplus_tpu_torch.infer import SRInferencer
    from esrganplus_tpu_torch.ops.image_io import decode_img, encode_png, img2tensor, tensor2img

    cfg = RRDBNetConfig(nb=1)
    params = init_rrdbnet(cfg, seed=3, init_scale=0.5)
    pth = str(tmp_path / "nb1.pth")
    torch.save(rrdbnet_to_state_dict(params, cfg), pth)
    args = argparse.Namespace(model=pth, host="127.0.0.1", port=0, dtype="bf16",
                              pad_multiple=32, tile=0, x8=False, noise_seed=None,
                              device="cuda")
    srv, inf = make_server(args)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        c = http.client.HTTPConnection(*srv.server_address, timeout=60)
        c.request("GET", "/healthz")
        r = c.getresponse()
        assert r.status == 200 and json.loads(r.read())["device"].startswith("cuda")
        img = (np.random.RandomState(5).rand(37, 45, 3) * 255).astype(np.uint8)
        before = dict(K.rdb_ct.launches_by_design)
        c.request("POST", "/upscale", body=encode_png(img))
        r = c.getresponse()
        assert r.status == 200
        got = (decode_img(r.read()) * 255).round().astype(np.uint8)
        ran = {k: n - before[k] for k, n in K.rdb_ct.launches_by_design.items()}
        assert ran == {"fma": 0, "mma": 3}
    finally:
        srv.shutdown()
        srv.server_close()
    want = tensor2img(SRInferencer(params, cfg, dtype=torch.bfloat16, pad_multiple=32)
                      .upscale(img2tensor(img.astype(np.float32) / 255.0)))
    assert got.shape == want.shape == (148, 180, 3)
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# SFT-GAN and OutdoorSceneSeg (cuDNN models; VGG19's early stages of the
# SFT-GAN perceptual loss on the stage kernels)
# ---------------------------------------------------------------------------


def _sft_inputs(gen, b=2, h=12, w=16, device="cpu"):
    img = torch.rand((b, h, w, 3), generator=gen).to(device)
    seg = torch.softmax(3 * torch.randn((b, 4 * h, 4 * w, 8), generator=gen), -1).to(device)
    return img, seg


@pytest.mark.cuda
@pytest.mark.parametrize("legacy", [False, True])
def test_cuda_sft_forward_matches_cpu(legacy):
    """SFT_Net at the shipped widths (nf 64, cond_nf 32, nb 2, trunk init
    ×0.1) on the card against the CPU: fp32 within 1e-4 of max(1, max|ref|),
    bf16 on the card within 2e-2 of the fp32 CPU output."""
    _need_card()
    from esrganplus_tpu_torch.models.sft import SFTNetConfig, init_sftnet, sftnet_forward

    cfg = SFTNetConfig(nb=2, legacy=legacy)
    params = init_sftnet(cfg, seed=1)
    for name in ("blocks", "final_sft", "final_conv"):
        for _, leaf in _leaves_of(params[name]):
            leaf.mul_(0.1)
    img, seg = _sft_inputs(torch.Generator().manual_seed(2))
    with torch.inference_mode(), fp32_exact():
        ref = sftnet_forward(params, img, seg, cfg)
        dev = params_to(params, "cuda")
        got = sftnet_forward(dev, img.cuda(), seg.cuda(), cfg).cpu()
        bf = sftnet_forward(dev, img.cuda(), seg.cuda(), cfg, dtype=torch.bfloat16).cpu()
    assert got.shape == ref.shape == (2, 48, 64, 3)
    scale = max(1.0, ref.abs().max().item())
    assert (got - ref).abs().max().item() <= TOL[torch.float32] * scale
    assert (bf - ref).abs().max().item() <= TOL[torch.bfloat16] * scale


def _leaves_of(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _leaves_of(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _leaves_of(v, f"{prefix}/{i}")]
    return [] if tree is None else [(prefix, tree)]


@pytest.mark.cuda
def test_cuda_acd_forward_and_backward_match_cpu():
    """The ACD discriminator at 96², batch 4, train mode, fp32: both heads
    within 1e-4 of the CPU's, the BN updates within 1e-4, and the parameter
    and input gradients of BCE + CE with cosine ≥ 0.9999 against the CPU's
    (an lrelu gate behind a batch norm may flip at a near-zero activation,
    which moves single entries, so the cosine is held)."""
    _need_card()
    from esrganplus_tpu_torch.models.sft import acd_forward, init_acd
    from esrganplus_tpu_torch.train.sftgan_model import masked_cross_entropy

    params = init_acd(seed=3)
    gen = torch.Generator().manual_seed(4)
    x = torch.rand((4, 96, 96, 3), generator=gen)
    cat = torch.tensor([0, 2, 5, 7])

    def run(device):
        from esrganplus_tpu_torch.train.sr_model import tree_map

        p = tree_map(lambda t: t.detach().to(device).clone().requires_grad_(True), params)
        leaves = [t for _, t in _leaves_of(p)]
        xi = x.to(device).requires_grad_(True)
        with fp32_exact():
            gan, cls, upd = acd_forward(p, xi, train=True)
            loss = torch.nn.functional.softplus(-gan).mean() + masked_cross_entropy(
                cls, cat.to(device))
            grads = torch.autograd.grad(loss, leaves + [xi], allow_unused=True)
        flat = torch.cat([g.flatten().cpu() for g in grads if g is not None])
        return gan.detach().cpu(), cls.detach().cpu(), [
            {k: v.cpu() for k, v in u.items()} for u in upd if u is not None], flat

    g_ref, c_ref, u_ref, d_ref = run("cpu")
    g_got, c_got, u_got, d_got = run("cuda")
    for got, ref in ((g_got, g_ref), (c_got, c_ref)):
        assert (got - ref).abs().max().item() <= TOL[torch.float32] * max(1.0, ref.abs().max())
    for a, b in zip(u_got, u_ref):
        for k in ("mean", "var"):
            assert (a[k] - b[k]).abs().max().item() <= 1e-4 * max(1.0, b[k].abs().max())
    cos = torch.nn.functional.cosine_similarity(d_got.double(), d_ref.double(), dim=0)
    assert cos.item() >= 0.9999


@pytest.mark.cuda
def test_cuda_seg_forward_matches_cpu():
    """OutdoorSceneSeg (published widths and depth, seeded: near-identity
    batch norms, a random ×8 transposed conv) at 40×56 on the card against
    the CPU: probabilities within 1e-4, each pixel's summing to 1 within
    1e-5."""
    _need_card()
    from esrganplus_tpu_torch.models.seg import init_seg, seg_forward

    params = init_seg(seed=0)
    gen = torch.Generator().manual_seed(1)
    for layer in params["layers"]:
        for name, p in ((layer or {}).items() if "conv" not in (layer or {})
                        else [("c", layer)]):
            p["bn"]["scale"].copy_(0.5 + 0.5 * torch.rand(p["bn"]["scale"].shape, generator=gen))
            if name == "c2":
                p["bn"]["scale"].mul_(0.2)
    params["deconv_w"] = torch.randn(params["deconv_w"].shape, generator=gen) / 16
    x = 255 * torch.rand((1, 40, 56, 3), generator=gen) - 110
    with torch.inference_mode(), fp32_exact():
        ref = seg_forward(params, x)
        got = seg_forward(params_to(params, "cuda"), x.cuda()).cpu()
    assert got.shape == ref.shape == (1, 40, 56, 8)
    assert (got - ref).abs().max().item() <= 1e-4
    assert (got.sum(-1) - 1).abs().max().item() <= 1e-5
    assert 0.2 < ref.max(-1).values.mean().item() < 0.99


@pytest.mark.cuda
def test_sftgan_trainer_steps_on_the_card_repeat_bit_for_bit():
    """Two SFT-GAN steps (SFT nb 1, the ACD, VGG19 to features[34] seeded;
    batch 2, HR 96, fp32) twice from one state: bit-equal; each step
    launched conv_s1_ct 8 times and conv_s1_ct_bwd 4 times (VGG19's four
    ≤128-channel convs on the fake and the real, the fake's adjoint), all
    on the fp32 design."""
    _need_card()
    from esrganplus_tpu_torch.kernels import stage_ct as S
    from esrganplus_tpu_torch.models.sft import SFTNetConfig
    from esrganplus_tpu_torch.train import SFTGANTrainConfig, SFTGANTrainer

    gen = torch.Generator().manual_seed(5)
    img, seg = _sft_inputs(gen, b=2, h=24, w=24, device="cuda")
    batch = (img, seg, torch.rand((2, 96, 96, 3), generator=gen).cuda(),
             torch.tensor([0, 4]).cuda())
    runs = []
    for _ in range(2):
        t = SFTGANTrainer(SFTNetConfig(nb=1), SFTGANTrainConfig(other_start_iter=1),
                          device="cuda")
        state = t.init_state(0)
        before = {fn: dict(fn.launches_by_design) for fn in (S.conv_s1_ct, S.conv_s1_ct_bwd)}
        for _ in range(2):
            state, logs = t.train_step(state, batch, 0)
        ran = {fn.__name__: {k: n - before[fn][k] for k, n in fn.launches_by_design.items()}
               for fn in before}
        assert ran == {"conv_s1_ct": {"fma": 16, "mma": 0},
                       "conv_s1_ct_bwd": {"fma": 8, "mma": 0}}
        runs.append([t.detach().cpu() for _, t in _leaves_of(state)
                     if torch.is_tensor(t)] + [logs[k].cpu() for k in sorted(logs)])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# ---------------------------------------------------------------------------
# the resident step as a captured CUDA graph (train/resident_exec.py)
# ---------------------------------------------------------------------------


def _card_store(n=16, lr=32, scale=4, seed=0):
    """A resident crop store on the card holding seeded uint8 pools."""
    from esrganplus_tpu_torch.data.resident import ResidentCropStore

    rs = np.random.RandomState(seed)
    s = ResidentCropStore.__new__(ResidentCropStore)
    s.device, s.n_crops, s.use_flip, s.use_rot = torch.device("cuda"), n, True, True
    s.lr = torch.from_numpy(rs.randint(0, 256, (n, lr, lr, 3)).astype(np.uint8)).cuda()
    s.hr = torch.from_numpy(rs.randint(0, 256, (n, scale * lr, scale * lr, 3))
                            .astype(np.uint8)).cuda()
    return s


def _card_seg_store(n=8, seed=0):
    from esrganplus_tpu_torch.data.resident import ResidentSegStore

    rs = np.random.RandomState(seed)
    s = ResidentSegStore.__new__(ResidentSegStore)
    s.device, s.n_crops, s.use_flip, s.use_rot = torch.device("cuda"), n, True, False
    logits = rs.randn(n, 96, 96, 8)
    seg = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    s.lr = torch.from_numpy(rs.rand(n, 24, 24, 3).astype(np.float32)).cuda()
    s.seg = torch.from_numpy((seg * 255).round().astype(np.uint8)).cuda()
    s.hr = torch.from_numpy(rs.randint(0, 256, (n, 96, 96, 3)).astype(np.uint8)).cuda()
    s.cat = torch.from_numpy(rs.randint(0, 8, n)).cuda()
    return s


def _graph_vs_eager(make, store, batch_size, k=4, rng=3, between=None):
    """A burst of ``k`` graph replays against ``k`` eager steps on the
    batches the sampler draws, from one init: states and logs bit-equal, and
    the port's kernels by family the same in what the replays launch (read
    from the captured graphs), in what the card ran in them and in what it
    ran in the eager steps (by the profiler: no wrapper runs at a replay).
    The captures are made before the profiled bursts. ``between`` (a
    callable) runs after the first half of the steps of both. The eager
    steps' trace also holds, by family, what ``kernels/launch.py`` counted
    where the dense, data- and weight-gradient kernels launch. → (trainer a,
    [(replays' kernels, eager steps')], rdb_ct's seeded launches in the last
    eager half)."""
    import collections

    from esrganplus_tpu_torch.kernels import build, launch
    from esrganplus_tpu_torch.train.resident_exec import burst_gates, executor
    from esrganplus_tpu_torch.train.rng import sample_seed
    from esrganplus_tpu_torch.utils.trace import kernel_counts

    own = build.kernel_names()
    a, b = make(), make()
    sa, sb = a.init_state(0), b.init_state(0)
    halves = (k // 2, k - k // 2) if between else (k,)
    traces, logs = [], {}
    for i, n in enumerate(halves):
        executor(a).capture(sa, store, rng, batch_size, n)
        nodes = collections.Counter()
        for g in burst_gates(a, sa, n):
            nodes.update({f: c for f, c in a._resident.kernel_nodes(g).items() if f in own})
        graph = kernel_counts(lambda: logs.update(
            a=a.train_step_resident(sa, store, rng, batch_size, n_steps=n)[1]), own)
        assert graph == nodes

        def eager():
            for _ in range(n):
                logs["b"] = b.train_step(sb, store.make_sampler(batch_size)(
                    sample_seed(rng, sb["step"])), rng)[1]

        launch.device_launches.clear()
        K.rdb_ct.seeded_launches = 0
        traces.append((graph, kernel_counts(eager, own)))
        # (wgrad_finish_kernel also runs for the tail's weight gradients,
        # which launch.py does not count)
        assert all(traces[-1][1].get(f, 0) == launch.device_launches[f]
                   for f in launch._FAMILY.values())
        if between and i == 0:
            between()
    la, lb = logs["a"], logs["b"]
    assert sa["step"] == sb["step"] == k
    la_, lb_ = [t for _, t in _leaves_of(sa)], [t for _, t in _leaves_of(sb)]
    assert len(la_) == len(lb_)
    for x, y in zip(la_, lb_):
        assert torch.equal(x, y) if torch.is_tensor(x) else x == y
    assert set(la) == set(lb) and all(torch.equal(la[n], lb[n]) for n in la)
    assert all(torch.isfinite(v).all() for v in la.values())
    for graph, eager in traces:
        assert graph == eager and sum(graph.values()) > 0
    return a, traces, K.rdb_ct.seeded_launches


@pytest.mark.cuda
@pytest.mark.parametrize("net", ["rrdb-input", "rrdb-fused", "srresnet"])
def test_cuda_graph_burst_is_eager_steps_sr(net):
    """K = 4 replays of the captured PSNR step equal 4 eager steps bit for
    bit (RRDBNet bf16 with the input and the fused noise mode; SRResNet
    fp32), and the wrappers' counters advance by the same launches."""
    _need_card()
    from esrganplus_tpu_torch.models import SRResNetConfig
    from esrganplus_tpu_torch.train import SRTrainConfig, SRTrainer

    if net == "srresnet":
        make = lambda: SRTrainer(SRResNetConfig(nf=64, nb=2), SRTrainConfig(), device="cuda")
    else:
        cfg = RRDBNetConfig(nb=2, noise_kernel=net.split("-")[1])
        make = lambda: SRTrainer(cfg, SRTrainConfig(compute_dtype="bfloat16"), device="cuda")
    a, traces, seeded = _graph_vs_eager(make, _card_store(lr=16), 2)
    fams = traces[0][0]
    assert fams["philox_bits_kernel"] == 4  # the sampler's draw, once a step
    if net != "srresnet":
        assert fams["dense_mma_kernel"] > 0
    # every rdb_ct call of the eager steps drew its noise in the kernel (fused)
    assert seeded == (4 * 6 if net == "rrdb-fused" else 0)
    assert len(a._resident._graphs) == 1 and a._resident.captures == 1


@pytest.mark.cuda
def test_cuda_graph_burst_switches_gan_captures():
    """srragan with D_update_ratio 2: the gated and the open step are two
    captures, replayed in turn inside one burst, bit-equal to eager steps."""
    _need_card()
    from esrganplus_tpu_torch.models.discriminator import DiscriminatorVGGConfig
    from esrganplus_tpu_torch.train import GANTrainConfig, GANTrainer

    make = lambda: GANTrainer(RRDBNetConfig(nb=1), DiscriminatorVGGConfig(),
                              GANTrainConfig(compute_dtype="bfloat16", d_update_ratio=2),
                              device="cuda")
    a, _, _ = _graph_vs_eager(make, _card_store(lr=32), 2)
    assert set(a._resident._graphs) == {(False,), (True,)}


@pytest.mark.cuda
def test_cuda_graph_burst_sftgan_across_other_start_iter():
    """SFT-GAN (fp32) over a seg store: the step before and after
    ``other_start_iter`` are two captures, and the burst equals eager."""
    _need_card()
    from esrganplus_tpu_torch.models.sft import SFTNetConfig
    from esrganplus_tpu_torch.train import SFTGANTrainConfig, SFTGANTrainer

    make = lambda: SFTGANTrainer(SFTNetConfig(nb=1), SFTGANTrainConfig(other_start_iter=2),
                                 device="cuda")
    a, _, _ = _graph_vs_eager(make, _card_seg_store(), 2)
    assert set(a._resident._graphs) == {(True, False), (True, True)}


@pytest.mark.cuda
def test_cuda_refresh_lands_in_the_captured_step():
    """A pool refreshed between two bursts is what the captured step reads:
    the run stays bit-equal to eager steps on the new pool."""
    _need_card()
    from esrganplus_tpu_torch.models import SRResNetConfig
    from esrganplus_tpu_torch.train import SRTrainConfig, SRTrainer

    store = _card_store(lr=16)
    fresh = _card_store(lr=16, seed=1)
    ptrs = [t.data_ptr() for t in store.pools()]

    def refresh():
        store._upload((fresh.lr.cpu().numpy(), fresh.hr.cpu().numpy()), 1)
        assert [t.data_ptr() for t in store.pools()] == ptrs
        assert torch.equal(store.hr, fresh.hr)

    make = lambda: SRTrainer(SRResNetConfig(nf=64, nb=2), SRTrainConfig(), device="cuda")
    _graph_vs_eager(make, store, 2, k=4, between=refresh)


@pytest.mark.cuda
def test_cuda_broken_capture_raises():
    """A step that reads a value back to the host cannot be captured: the
    resident step raises, naming the trainer and the capture, and does not
    run eagerly instead."""
    _need_card()
    from esrganplus_tpu_torch.models import SRResNetConfig
    from esrganplus_tpu_torch.train import SRTrainConfig, SRTrainer

    class HostRead(SRTrainer):
        def _step(self, state, batch, sc, gates):
            logs = super()._step(state, batch, sc, gates)
            logs["l_pix"].item()  # a host synchronisation: illegal while capturing
            return logs

    t = HostRead(SRResNetConfig(nf=64, nb=1), SRTrainConfig(), device="cuda")
    state = t.init_state(0)
    with pytest.raises(RuntimeError, match="could not be captured as a CUDA graph"):
        t.train_step_resident(state, _card_store(lr=16), 0, 2, n_steps=2)


@pytest.mark.cuda
def test_cuda_capture_survives_a_dead_trainers_graphs():
    """A trainer dropped while still held by a reference cycle keeps its
    captured graphs until a cyclic collection. That collection must not run
    while another trainer's step is captured (a graph destroyed on the
    capturing thread invalidates the capture): the next capture collects
    first, and none runs during it."""
    _need_card()
    import gc
    import weakref

    from esrganplus_tpu_torch.models import SRResNetConfig
    from esrganplus_tpu_torch.train import SRTrainConfig, SRTrainer

    seen = []

    class Watched(SRTrainer):
        def _step(self, state, batch, sc, gates):
            if torch.cuda.is_current_stream_capturing():
                seen.append(gc.isenabled())
            return super()._step(state, batch, sc, gates)

    store = _card_store(lr=16)
    dead = Watched(SRResNetConfig(nf=64, nb=1), SRTrainConfig(), device="cuda")
    dead.cycle = dead  # only a cyclic collection frees it
    dead.train_step_resident(dead.init_state(0), store, 0, 2, n_steps=2)
    assert dead._resident._graphs
    gone = weakref.ref(dead)
    del dead
    t = Watched(SRResNetConfig(nf=64, nb=1), SRTrainConfig(), device="cuda")
    state, logs = t.train_step_resident(t.init_state(0), store, 0, 2, n_steps=2)
    assert gone() is None
    assert seen == [False, False] and gc.isenabled()
    assert state["step"] == 2 and bool(torch.isfinite(logs["l_pix"]))


# ---------------------------------------------------------------------------
# the captured step's phases (utils/trace.capture_marks, phase_times)
# ---------------------------------------------------------------------------


def _replay_rows(replays):
    """Run ``replays`` ((graph, its span's name)) under the profiler after
    LEAD_IN throwaway kernels → (kernel rows (family, start, end), host
    spans (name, start, end))."""
    from torch.profiler import ProfilerActivity, profile

    from esrganplus_tpu_torch.utils import trace as tr

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        lead = torch.zeros(1, device="cuda")
        for _ in range(tr.LEAD_IN):
            lead.add_(1)
        torch.cuda.synchronize()
        for graph, name in replays:
            tr.mark(name)
            graph.replay()
        torch.cuda.synchronize()
    rows, spans = [], []
    for e in prof.events():
        r = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.name.lower().startswith(("memcpy", "memset")):
                rows.append((tr.op_family(e.name),) + r[1:])
        else:
            spans.append(r)
    return rows, spans


@pytest.mark.cuda
def test_cuda_capture_marks_charge_each_node_to_its_phase():
    """A toy step of three phases, each launching kernels of families of
    its own (elementwise, reductions, a scan), captured with its marks:
    every kernel node carries its phase, a replay runs the nodes in the
    order the graph holds them (the profiler's rows, replay by replay), and
    ``phase_times`` charges every row of two replays to its phase and the
    lead-in to ``exec``."""
    _need_card()
    from esrganplus_tpu_torch.utils import trace as tr

    x = torch.rand(1 << 16, device="cuda")
    out = torch.empty_like(x)

    def body():
        tr.phase("g.fwd")
        x.add_(1.0)
        x.mul_(0.5)
        tr.phase("loss")
        s = x.sum() + x.amax()
        tr.phase("g.opt")
        out.copy_(torch.cumsum(x, 0) * 0 + s)

    body()  # the libraries set up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        with tr.capture_marks(torch.cuda.current_stream()) as marks:
            body()
    graph.instantiate()
    assert [m[0] for m in marks] == ["g.fwd", "loss", "g.opt"]
    nodes = tr.node_phases(tr.graph_node_families(graph), marks)
    assert sum(tr.graph_kernels(graph).values()) == len(nodes)
    by_phase = {}
    for ph, fam in nodes:
        by_phase.setdefault(ph, set()).add(fam)
    assert by_phase["g.fwd"] == {"vectorized_elementwise_kernel"}
    assert by_phase["loss"] >= {"reduce_kernel"}
    assert not by_phase["g.opt"] & {"reduce_kernel"}
    assert [p for p, _ in nodes] == sorted((p for p, _ in nodes),
                                           key=["g.fwd", "loss", "g.opt"].index)

    gid = "toy-capture"
    rows, spans = _replay_rows([(graph, tr.REPLAY + gid)] * 2)
    fams = [f for f, _, _ in sorted(rows, key=lambda r: r[1])]
    assert fams[-2 * len(nodes):] == [f for _, f in nodes] * 2
    got = tr.phase_times(rows, spans, {gid: nodes})
    assert got is not None
    for ph in ("g.fwd", "loss", "g.opt"):
        assert got[ph]["kernels"] == 2 * sum(1 for p, _ in nodes if p == ph)
    assert got[tr.EXEC]["kernels"] == len(rows) - 2 * len(nodes)
    assert abs(sum(t["ms"] for t in got.values())
               - sum(e - s for _, s, e in rows) / 1e3) < 1e-9


@pytest.mark.cuda
def test_cuda_gan_step_phase_nodes_sum_to_its_kernel_nodes():
    """The captured srragan step (bf16, D and VGG19 features on): its
    kernels by phase, summed by family, are the graph's kernel nodes; the
    backward phases open in the engine's order on the card (D's, then F's,
    then G's); and ``phase_times`` matches two replays of it row for row."""
    _need_card()
    import collections

    from esrganplus_tpu_torch.models.discriminator import DiscriminatorVGGConfig
    from esrganplus_tpu_torch.train import GANTrainConfig, GANTrainer
    from esrganplus_tpu_torch.train.resident_exec import executor
    from esrganplus_tpu_torch.utils import trace as tr

    t = GANTrainer(RRDBNetConfig(nb=1), DiscriminatorVGGConfig(),
                   GANTrainConfig(compute_dtype="bfloat16"), device="cuda")
    state, store = t.init_state(0), _card_store(lr=32)
    t.train_step_resident(state, store, 3, 2, n_steps=1)
    ex = executor(t)
    gates = t.gates(int(state["step"]) + 1)
    nodes = ex.phase_nodes(gates)
    summed = collections.Counter(f for _, f in nodes)
    assert summed == ex.kernel_nodes(gates)
    first = list(dict.fromkeys(p for p, _ in nodes))
    for ph in ("sample", "d.fwd", "g.fwd", "f.fwd", "loss", "d.bwd", "f.bwd", "g.bwd",
               "g.opt", "d.opt", "bn"):
        assert ph in first, ph
    assert first.index("d.bwd") < first.index("f.bwd") < first.index("g.bwd") \
        < first.index("g.opt") < first.index("d.opt")
    graph, _, name = ex._graphs[gates]
    ex._index.zero_()
    rows, spans = _replay_rows([(graph, name)] * 2)
    got = tr.phase_times(rows, spans)
    assert got is not None and sum(v["kernels"] for v in got.values()) == len(rows)
    for ph in first:
        if ph != tr.EXEC:
            assert got[ph]["kernels"] == 2 * sum(1 for p, _ in nodes if p == ph), ph
