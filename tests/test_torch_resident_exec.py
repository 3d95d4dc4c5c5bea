"""The resident step burst (esrganplus_tpu_torch/train/resident_exec.py) and
what it needs off the host, on the CPU:

  (a) ``cli.train.compute_burst_len`` equal to the JAX package's on a grid of
      burst lengths, cadences (zeros among them), profile points and
      ``niter`` cuts;
  (b) each step's row of device scalars (``train/step_scalars.py``) against
      the host functions it replaces: lr per group against JAX's
      ``multistep_lr`` across a milestone, Adam's bias corrections against
      optax's ``scale_by_adam`` count (a gated group skips steps), the keys
      against ``sample_seed``, ``site_seeds`` and the per-RRDB sites;
  (c) the Philox-keyed sampler: a step's draw is a function of its key alone
      (a resumed run draws what an uninterrupted one does), indices lie in
      [0, n_crops), the coin and index rates within stated bounds, and the
      seg store's four pools stay aligned;
  (d) the plain twins keyed by a tensor give what they gave by value;
  (e) a burst of K steps equals K eager steps bit for bit for all three
      trainers (GAN gates and SFT-GAN's ``other_start_iter`` switching
      inside a burst);
  (f) ``cli.train --device cpu`` with ``steps_per_dispatch: 4``: the logged
      bursts are JAX's sequence, the run ends bit-equal to ``steps_per_dispatch:
      1`` and to its own resume from the step-6 checkpoint;
  (g) the gate patterns captured before a burst are the burst's, and the
      kernel names a profiler trace is filtered to are the sources'.
"""

import itertools
import json
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from esrganplus_tpu.cli.train import compute_burst_len as jax_burst_len
from esrganplus_tpu.train.schedule import multistep_lr as jax_multistep_lr
from esrganplus_tpu_torch.cli.train import compute_burst_len
from esrganplus_tpu_torch.data import datasets as pds
from esrganplus_tpu_torch.data import resident as pres
from esrganplus_tpu_torch.data.resident import ResidentCropStore, ResidentSegStore
from esrganplus_tpu_torch.kernels import rdb_ct as K
from esrganplus_tpu_torch.kernels.philox import key_words, philox_bits
from esrganplus_tpu_torch.models import RRDBNetConfig, SRResNetConfig
from esrganplus_tpu_torch.models.discriminator import DiscriminatorVGGConfig
from esrganplus_tpu_torch.models.sft import SFTNetConfig
from esrganplus_tpu_torch.ops.image_io import save_img
from esrganplus_tpu_torch.ops.resize import imresize_np
from esrganplus_tpu_torch.train import (GANTrainConfig, GANTrainer, SFTGANTrainConfig,
                                        SFTGANTrainer, SRTrainConfig, SRTrainer)
from esrganplus_tpu_torch.train.resident_exec import plan_burst
from esrganplus_tpu_torch.train.rng import (noise_site_words, sample_seed, site_seeds,
                                            split_words, step_seed)
from esrganplus_tpu_torch.train.sr_model import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# ---------------------------------------------------------------------------
# (a) compute_burst_len
# ---------------------------------------------------------------------------

BURST_GRID = list(itertools.product(
    (1, 3, 4),                                     # K
    ((2, 0, 0, 0), (5, 8, 0, 6), (3, 6, 6, None), (100, 7, 10, 12)),  # print/val/save/refresh
    ((None, None), (10, 13), (2, 5)),              # profile start, stop
    (10, 23)))                                     # niter


@pytest.mark.parametrize("burst,freqs,prof,niter", BURST_GRID)
def test_compute_burst_len_matches_jax(burst, freqs, prof, niter):
    got = [compute_burst_len(s, burst, niter, freqs, prof) for s in range(niter)]
    assert got == [jax_burst_len(s, burst, niter, freqs, prof) for s in range(niter)]
    assert set(got) <= {1, burst}


# ---------------------------------------------------------------------------
# (b) the step scalars
# ---------------------------------------------------------------------------

LR = 1e-3


def _gan(**cfg):
    return GANTrainer(RRDBNetConfig(nf=8, nb=2, gc=4, upscale=4),
                      DiscriminatorVGGConfig(input_size=96, base_nf=8),
                      GANTrainConfig(lr_g=LR, lr_d=2 * LR, milestones=(3,), feature_weight=0.0,
                                     **cfg), device="cpu")


def _host_state(trainer):
    """A state with only what ``plan`` reads: the step and the Adam counts."""
    if isinstance(trainer, SFTGANTrainer):
        return {"g_opt": {"other": {"count": 0}, "sft": {"count": 0}}, "d_opt": {"count": 0},
                "step": 0}
    return {"g_opt": {"count": 0}, "d_opt": {"count": 0}, "step": 0}


def _optax_bias(b, count):
    """``1 − b^count`` as optax's ``scale_by_adam`` forms it from its int32
    count: fp32 powers, which XLA's ``pow`` and the host's ``powf`` may round
    one ulp (2⁻²⁴ near 1) apart."""
    return np.float32(1 - b ** jnp.asarray(count, jnp.int32))


def test_rows_match_the_host_functions_across_a_milestone_and_gates():
    t = _gan(d_update_ratio=2, d_init_iters=1)
    state = _host_state(t)
    rows, gates = plan_burst(t, state, 11, 6)
    sched = {"g": jax_multistep_lr(LR, (3,), 0.5), "d": jax_multistep_lr(2 * LR, (3,), 0.5)}
    # optax's own counts: G's transform sees only its open steps
    tx = optax.scale_by_adam(0.9, 0.999)
    opt = {g: tx.init(jnp.zeros(1)) for g in ("g", "d")}
    assert [g[0] for g in gates] == [False, True, False, True, False, True]
    for s, (row, g) in enumerate(zip(rows, gates)):
        sc = t.scalars.view(torch.from_numpy(row))
        assert int(sc.step) == s
        for name in ("g", "d"):
            assert float(sc.lr(name)) == np.float32(sched[name](s + 1)), (s, name)
        for name in (("g", "d") if g[0] else ("d",)):
            _, opt[name] = tx.update(jnp.ones(1), opt[name])
            count = int(opt[name].count)
            c1, c2 = (float(c) for c in sc.bias(name))
            assert (c1, c2) == tuple(float(c) for c in t.tx_g.bias(count))
            assert abs(c1 - _optax_bias(0.9, count)) <= 2 ** -23
            assert abs(c2 - _optax_bias(0.999, count)) <= 2 ** -23
        key = sc.sample_key.to(torch.int64) & 0xFFFFFFFF
        assert tuple(key.tolist()) == split_words(sample_seed(11, s))
        sites = sc.site_keys.to(torch.int64) & 0xFFFFFFFF
        assert sites[:, :3].tolist() == [[list(p) for p in b] for b in site_seeds(11, s, 2)]
        assert sites.tolist() == [[list(p) for p in b] for b in noise_site_words(11, s, 2)]
    # the host mirror: 6 steps, G updated on the 1-based steps 2, 4, 6
    assert state["step"] == 6 and state["g_opt"]["count"] == 3 == int(opt["g"].count)
    assert state["d_opt"]["count"] == 6 == int(opt["d"].count)


def test_sftgan_rows_follow_both_gates():
    t = SFTGANTrainer(SFTNetConfig(nb=1, nf=16, cond_nf=8),
                      SFTGANTrainConfig(lr_g=LR, sft_lr_mult=5.0, milestones=(2,),
                                        other_start_iter=3, feature_weight=0.0), device="cpu")
    state = _host_state(t)
    rows, gates = plan_burst(t, state, 0, 5)
    assert gates == [(True, False)] * 3 + [(True, True)] * 2
    assert state["g_opt"]["sft"]["count"] == 5 and state["g_opt"]["other"]["count"] == 2
    sc = t.scalars.view(torch.from_numpy(rows[3]))
    assert float(sc.lr("sft")) == np.float32(5 * LR / 2) and float(sc.lr("other")) == np.float32(
        LR / 2)
    assert [float(c) for c in sc.bias("other")] == list(t.tx_g.bias(1))
    assert [float(c) for c in sc.bias("sft")] == list(t.tx_g.bias(4))
    assert t.scalars.n_blocks == 0  # SFT-GAN draws no noise


def test_step_keys_are_pure_functions_of_seed_and_step():
    assert noise_site_words(5, 12, 3) == noise_site_words(5, 12, 3) != noise_site_words(5, 13, 3)
    assert [b[:3] for b in noise_site_words(5, 12, 3)] == site_seeds(5, 12, 3)
    assert noise_site_words(5, 12, 4)[:3] == noise_site_words(5, 12, 3)  # deeper: same first
    words = [w for b in noise_site_words(5, 12, 3) for s in b for w in s]
    assert len(set(words)) == len(words)  # no two sites share a word
    assert split_words(step_seed(1, 2)) != split_words(sample_seed(1, 2))


# ---------------------------------------------------------------------------
# (c) the Philox-keyed sampler
# ---------------------------------------------------------------------------


def _write_pngs(root, n=4, hr=32):
    hr_dir, lr_dir = os.path.join(root, "HR"), os.path.join(root, "LR")
    rng = np.random.RandomState(7)
    for i in range(n):
        img = (rng.rand(hr, hr, 3) * 255).astype(np.uint8)
        save_img(img, os.path.join(hr_dir, f"img{i}.png"))
        lr = np.clip(imresize_np(img.astype(np.float32) / 255.0, 0.25), 0, 1)
        save_img((lr * 255).round().astype(np.uint8), os.path.join(lr_dir, f"img{i}.png"))
    return hr_dir, lr_dir


def _ds_opt(hr_dir, lr_dir, hr_size=16):
    return {"phase": "train", "dataroot_HR": hr_dir, "dataroot_LR": lr_dir, "scale": 4,
            "HR_size": hr_size, "use_flip": True, "use_rot": True}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return _write_pngs(str(tmp_path_factory.mktemp("burst")))


@pytest.fixture(scope="module")
def store(dirs):
    return ResidentCropStore(pds.LRHRDataset(_ds_opt(*dirs)), "cpu", n_crops=8, refresh_steps=0)


def test_a_steps_draw_depends_on_its_key_alone(store):
    sample = store.make_sampler(4)
    keys = [key_words(split_words(sample_seed(3, s))) for s in range(5)]
    uninterrupted = [sample(k) for k in keys]
    resumed = [sample(k) for k in keys[2:]]  # a run resumed at step 2
    for a, b in zip(uninterrupted[2:], resumed):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(uninterrupted[0][1], uninterrupted[1][1])
    # an int seed is its two words
    assert all(torch.equal(x, y) for x, y in zip(sample(sample_seed(3, 1)), uninterrupted[1]))


@pytest.mark.parametrize("n", [1, 7, 16, 4096])
def test_sampler_rates_within_bounds(n):
    """8192 draws: every index in [0, n), each coin at 1/2 within 0.02 (3.6
    binomial σ), each of n ≤ 16 indices at 1/n within 10 % of its count."""
    idx, coins = pres.draw(key_words((123, 456)), 8192, n, True, True)
    assert idx.dtype == torch.int64 and int(idx.min()) >= 0 and int(idx.max()) < n
    for c in coins:
        assert abs(float(c.float().mean()) - 0.5) <= 0.02
    if n <= 16:
        counts = torch.bincount(idx, minlength=n).float()
        assert (counts - 8192 / n).abs().max() <= 0.1 * 8192 / n
    off = pres.draw(key_words((123, 456)), 64, n, False, False)[1]
    assert not any(bool(c.any()) for c in off)
    # the words are Philox of counter (i, 0, 0, 0): index from the first
    bits = philox_bits((123, 456), 8192)
    assert torch.equal(idx, (bits[:, 0] * n) >> 32)


def test_seg_store_draws_keep_the_four_pools_aligned():
    """Each crop's LR, seg, HR hold its index everywhere and its category a
    function of it: a sample's four parts name one crop."""
    n = 12
    store = ResidentSegStore.__new__(ResidentSegStore)
    store.device, store.n_crops, store.use_flip, store.use_rot = torch.device("cpu"), n, True, True
    ar = torch.arange(n)
    store.lr = ar.float().view(n, 1, 1, 1).expand(n, 6, 6, 3).clone()
    store.seg = ar.to(torch.uint8).view(n, 1, 1, 1).expand(n, 24, 24, 8).clone()
    store.hr = (ar + 100).to(torch.uint8).view(n, 1, 1, 1).expand(n, 24, 24, 3).clone()
    store.cat = ar * 3
    lr, seg, hr, cat = store.make_sampler(64)(key_words((9, 9)))
    i = lr[:, 0, 0, 0].long()
    assert len(set(i.tolist())) > 4
    assert torch.equal((seg * 255).round().long(), i.view(-1, 1, 1, 1).expand_as(seg))
    assert torch.equal((hr * 255).round().long(), (i + 100).view(-1, 1, 1, 1).expand_as(hr))
    assert torch.equal(cat, i * 3)


def test_refresh_lands_in_the_same_buffers(dirs):
    s = ResidentCropStore(pds.LRHRDataset(_ds_opt(*dirs)), "cpu", n_crops=8, refresh_steps=2,
                          seed=3, async_refresh=False)
    ptrs, before = [t.data_ptr() for t in s.pools()], s.hr.clone()
    s.maybe_refresh(2)
    assert s.pool_index == 1 and [t.data_ptr() for t in s.pools()] == ptrs
    assert not torch.equal(s.hr, before)


# ---------------------------------------------------------------------------
# (d) the plain twins keyed by a tensor
# ---------------------------------------------------------------------------


def test_twins_take_the_seed_words_as_a_tensor():
    rs = np.random.RandomState(0)
    nf, gc = 8, 4
    x = torch.from_numpy(rs.randn(2, 5, 6, nf).astype(np.float32))
    w = {}
    for k in range(1, 6):
        cin, s = nf + (k - 1) * gc, nf if k == 5 else gc
        w[f"w{k}"] = torch.from_numpy(rs.randn(3, 3, cin, s).astype(np.float32) * 0.1)
        w[f"b{k}"] = torch.from_numpy(rs.randn(s).astype(np.float32) * 0.1)
    w["w11"] = torch.from_numpy(rs.randn(nf, gc).astype(np.float32) * 0.1)
    seed = (0xDEADBEEF, 7)
    by_value = K._rdb_ct_train_plain(x, w, seed=seed, sigma=0.1)
    by_tensor = K._rdb_ct_train_plain(x, w, seed=key_words(seed), sigma=0.1)
    assert all(torch.equal(a, b) for a, b in zip(by_value, by_tensor))
    out, cat, lsv = by_value
    g = torch.from_numpy(rs.randn(*out.shape).astype(np.float32))
    a = K.rdb_ct_bwd_plain(x, w, cat, lsv, g, seed=seed, sigma=0.1)
    b = K.rdb_ct_bwd_plain(x, w, cat, lsv, g, seed=key_words(seed), sigma=0.1)
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(by_value[0], K._rdb_ct_train_plain(x, w, seed=(1, 7), sigma=0.1)[0])


# ---------------------------------------------------------------------------
# (e) a burst of K steps is K eager steps, bit for bit
# ---------------------------------------------------------------------------


def _same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y) if torch.is_tensor(x) else x == y


def _burst_vs_eager(make, store, batch_size, k=4, rng=5):
    a, b = make(), make()
    sa, sb = a.init_state(0), b.init_state(0)
    sa, la = a.train_step_resident(sa, store, rng, batch_size, n_steps=k)
    for s in range(k):
        sb, lb = b.train_step(sb, store.make_sampler(batch_size)(sample_seed(rng, s)), rng)
    assert sa["step"] == sb["step"] == k
    _same(sa, sb)
    assert set(la) == set(lb) and all(torch.equal(la[n], lb[n]) for n in la)
    assert a._version == b._version
    return sa


@pytest.mark.parametrize("noise_kernel", ["input", "fused"])
def test_sr_burst_is_eager_steps(store, noise_kernel):
    make = lambda: SRTrainer(RRDBNetConfig(nf=8, nb=1, gc=4, upscale=4, rrdb_noise=True,
                                           noise_kernel=noise_kernel),
                             SRTrainConfig(lr=LR, milestones=(2,)), device="cpu")
    s = _burst_vs_eager(make, store, 2)
    assert s["opt_state"]["count"] == 4


def test_gan_burst_switches_gates_and_is_eager_steps(tmp_path):
    hr_dir, lr_dir = _write_pngs(str(tmp_path), n=2, hr=96)
    store96 = ResidentCropStore(pds.LRHRDataset(_ds_opt(hr_dir, lr_dir, hr_size=96)), "cpu",
                                n_crops=4, refresh_steps=0)
    make = lambda: GANTrainer(SRResNetConfig(nf=8, nb=1),
                              DiscriminatorVGGConfig(input_size=96, base_nf=8),
                              GANTrainConfig(variant="srragan", feature_weight=0.0,
                                             d_update_ratio=2, lr_g=LR, lr_d=LR), device="cpu")
    s = _burst_vs_eager(make, store96, 2)
    assert s["g_opt"]["count"] == 2 and s["d_opt"]["count"] == 4


def test_sftgan_burst_across_other_start_iter_is_eager_steps():
    n = 4
    rs = np.random.RandomState(0)
    store = ResidentSegStore.__new__(ResidentSegStore)
    store.device, store.n_crops, store.use_flip, store.use_rot = torch.device("cpu"), n, True, True
    store.lr = torch.from_numpy(rs.rand(n, 24, 24, 3).astype(np.float32))
    logits = rs.randn(n, 96, 96, 8)
    seg = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    store.seg = torch.from_numpy((seg * 255).round().astype(np.uint8))
    store.hr = torch.from_numpy((rs.rand(n, 96, 96, 3) * 255).astype(np.uint8))
    store.cat = torch.tensor([0, 3, 5, 1])
    make = lambda: SFTGANTrainer(SFTNetConfig(nb=1, nf=16, cond_nf=8),
                                 SFTGANTrainConfig(feature_weight=0.0, other_start_iter=2),
                                 device="cpu")
    s = _burst_vs_eager(make, store, 2, k=3)
    assert s["g_opt"]["sft"]["count"] == 3 and s["g_opt"]["other"]["count"] == 1


# ---------------------------------------------------------------------------
# (f) the train CLI
# ---------------------------------------------------------------------------


def _cli_options(root, hr_dir, lr_dir, *, dispatch, niter, print_freq):
    return {
        "name": "burst_cpu", "model": "sr", "scale": 4, "use_tb_logger": False,
        "datasets": {
            "train": {"name": "s", "mode": "LRHR", "dataroot_HR": hr_dir,
                      "dataroot_LR": lr_dir, "n_workers": 1, "batch_size": 2, "HR_size": 16,
                      "use_flip": True, "use_rot": True, "resident_crops": 8,
                      "resident_refresh": 1000, "resident_async_refresh": False},
            "val": {"name": "v", "mode": "LRHR", "dataroot_HR": hr_dir, "dataroot_LR": lr_dir},
        },
        "path": {"root": root},
        "network_G": {"which_model_G": "RRDB_net", "nf": 8, "nb": 1, "gc": 4,
                      "gaussian_noise": True},
        "train": {"lr_G": LR, "lr_scheme": "MultiStepLR", "lr_steps": [5],
                  "pixel_criterion": "l1", "manual_seed": 0, "niter": niter,
                  "steps_per_dispatch": dispatch, "val_freq": 1000,
                  "save_checkpoint_freq": 6},
        "logger": {"print_freq": print_freq},
    }


@pytest.mark.parametrize("print_freq", [3, 5])
def test_cli_bursts_are_jax_and_bit_equal_to_single_steps(tmp_path, dirs, print_freq):
    from esrganplus_tpu_torch.cli.train import main

    def run(tag, resume=None, **kw):
        root = str(tmp_path / tag)
        opt = _cli_options(root, *dirs, niter=10, print_freq=print_freq, **kw)
        if resume:
            opt["path"]["resume_state"] = resume
        os.makedirs(root, exist_ok=True)
        path = os.path.join(root, "opt.json")
        with open(path, "w") as f:
            json.dump(opt, f)
        main(["-opt", path, "--device", "cpu"])
        exp = os.path.join(root, "experiments", "burst_cpu")
        logs = [os.path.join(exp, f) for f in sorted(os.listdir(exp)) if f.endswith(".log")]
        text = open(logs[-1]).read()
        bursts = [int(n) for line in text.splitlines() if "bursts: " in line
                  for n in line.split("bursts: ")[1].split()]
        return exp, torch.load(os.path.join(exp, "models", "latest_G.pth")), bursts

    exp, burst4, seq = run("k4", dispatch=4)
    want, s = [], 0
    while s < 10:
        want.append(jax_burst_len(s, 4, 10, (print_freq, 1000, 6, 1000), (None, None)))
        s += want[-1]
    assert seq == want
    assert (4 in seq) == (print_freq == 5)
    _, single, _ = run("k1", dispatch=1)
    assert set(single) == set(burst4) and all(torch.equal(single[k], burst4[k]) for k in single)
    # resumed from the step-6 checkpoint into a fresh experiment tree
    ckpt = os.path.join(exp, "training_state", "6.state.npz")
    _, resumed, rseq = run("k4", resume=ckpt, dispatch=4)
    assert sum(rseq) == 4
    assert all(torch.equal(resumed[k], burst4[k]) for k in burst4)


# ---------------------------------------------------------------------------
# (g) what the card's path needs from the host: the captures a burst needs,
#     and the kernels a profiler trace is filtered to
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["gan-ratio-2-init-3", "gan-ratio-3", "sftgan-other-4"])
def test_burst_gates_are_the_planned_gates(case):
    """The gate patterns the executor captures before a burst are the ones
    the burst then replays, from any step, and nothing is advanced."""
    from esrganplus_tpu_torch.train.resident_exec import burst_gates

    if case.startswith("gan"):
        ratio, init = (2, 3) if case == "gan-ratio-2-init-3" else (3, 0)
        t = _gan(d_update_ratio=ratio, d_init_iters=init)
    else:
        t = SFTGANTrainer(SFTNetConfig(nb=1, nf=16, cond_nf=8),
                          SFTGANTrainConfig(other_start_iter=4, feature_weight=0.0),
                          device="cpu")
    state = _host_state(t)
    for n in (1, 4, 3, 5):
        before = json.dumps(state, sort_keys=True)
        want = burst_gates(t, state, n)
        assert json.dumps(state, sort_keys=True) == before
        assert plan_burst(t, state, 0, n)[1] == want
    assert len({g for s in range(13) for g in burst_gates(t, {**state, "step": s}, 1)}) == 2


def test_executor_holds_its_trainer_weakly():
    """A trainer and its executor form no reference cycle: a dropped trainer
    goes at once with its captures, never in a cyclic collection that could
    run while another trainer's step is captured."""
    import gc
    import weakref

    from esrganplus_tpu_torch.train.resident_exec import executor

    t = SRTrainer(SRResNetConfig(nf=8, nb=1), SRTrainConfig(), device="cpu")
    ex = executor(t)
    assert ex.trainer is t and executor(t) is ex
    alive = weakref.ref(t)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del t
        assert alive() is None and ex.trainer is None
    finally:
        if collecting:
            gc.enable()


def test_kernel_names_are_the_sources_kernels():
    """The profiler filter (``build.kernel_names``) holds every kernel the
    wrappers count by family and the Philox fills, and only names that a
    ``__global__`` definition in csrc/ gives."""
    import re

    from esrganplus_tpu_torch.kernels import build, launch

    names = build.kernel_names()
    assert set(launch._FAMILY.values()) | {"wgrad_finish_kernel", "philox_bits_kernel",
                                           "philox_fill_kernel"} <= names
    text = "".join(p.read_text() for p in build.CSRC.glob("*.cu*"))
    for n in names:
        assert re.search(r"__global__[^;{]*\b" + n + r"\s*\(", text), n
    assert "__launch_bounds__" not in names


@pytest.mark.parametrize("mangled,demangled", [
    ("_ZN12_GLOBAL__N_116dense_mma_kernelILi64ELi1ELi8ELi2EEEvNS_4ArgsE",
     "void (anonymous namespace)::dense_mma_kernel<64, 1, 8, 2>((anonymous namespace)::Args)"),
    ("_ZN41_GLOBAL__N__c152ddf4_9_philox_cu_aa12e7fa18philox_fill_kernelEPfPKjfiiii",
     "(anonymous namespace)::philox_fill_kernel(float*, unsigned int const*, float, int, int, "
     "int, int)"),
    ("_Z18philox_bits_kernelP5uint4PKjij",
     "philox_bits_kernel(uint4*, unsigned int const*, int, unsigned int)"),
    ("_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_11FillFunctorIfEESt5arrayIPcLm1EEEEv"
     "ifT0_T1_", "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor"
     "<float>, std::array<char*, 1ul> >(int, at::native::FillFunctor<float>, std::array<char*, "
     "1ul>)"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD (Pageable -> Device)"),
])
def test_graph_node_names_give_the_traces_families(mangled, demangled):
    """A captured graph's kernel nodes are named mangled, a profiler trace's
    kernels demangled: both give one family, so the two are compared."""
    from esrganplus_tpu_torch.utils.trace import mangled_family, op_family

    assert mangled_family(mangled) == op_family(demangled)
