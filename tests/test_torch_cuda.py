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
    "s1-64to128": (3, 4, 64, 64, 64, 128, "relu"),
    "s1-128to128": (3, 4, 64, 64, 128, 128, "relu"),
    "s2-3to8-odd": (4, 2, 36, 52, 3, 8, "lrelu"),
    "s2-16to16-odd": (4, 2, 36, 52, 16, 16, None),
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
    _need_card()
    (fwd, fwd_p, bwd, bwd_p), x, w, b, act, t = _stage_case(case, dtype)
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
