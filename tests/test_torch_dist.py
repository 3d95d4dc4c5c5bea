"""Data-parallel training in the port (esrganplus_tpu_torch/parallel/mesh.py,
the trainers' global reductions, the loader's host interleave, Philox's
batch offset, ``cli.train --dist-*``) on the CPU, over real two-process gloo
groups (tests/torch_dist_worker.py):

  (a) every case of ``torch_dist_worker.CASES`` (sr with the input and the
      fused noise on both routes, srragan on the plain D and the stage
      kernels' twins, srgan with WGAN-GP, SFT-GAN with one rank keeping no
      label and the other one, resident bursts through ``run_eager``): every
      step's logs bit-equal on both ranks and both ranks' states bit-equal;
      the first step against the port's one-process step on the global
      batch: each logged term within 1e-6 (relative; of max(1, |ref|) for
      the mean logits) or within the larger of SUM_ORDER (a batch sum in
      another order: RaGAN's ``l_g_gan`` moved 1.1e-6) and 10× its noise;
      each state leaf
      within 1e-6 of max|leaf| or, where a leaf is more sensitive than that
      to rounding, by the rules of ``esrganplus_tpu_torch/parallel/held.py``
      (the biases whose gradient is rounding noise left out and printed; a
      parameter allowed what its gradient's difference moves Adam's first
      step; any other leaf held to 10× its own noise, capped, and a floor:
      SUM_ORDER, or FLOOR for SFT-GAN's ACD, where a 1e-7 perturbation of
      the input moves G's gradient by 1e-3, relative L2);
  (a') two planted faults fail those bars for ``srragan`` and ``sftgan``:
      an all-reduce whose backward keeps each rank's cotangent, and a batch
      norm that differentiates its global statistics as the rank's own;
  (b) noise off, fp32, a global batch of 8: the two-rank ``sr`` and
      ``srragan`` steps against the JAX package's trainer on the 8-device
      CPU mesh from the same state: every logged term within 1e-5, each
      leaf within 1e-5 of max|leaf| or, as in (a), by ``held.py``'s rules,
      a leaf's noise there the larger of its own and the one-process port
      step's distance to JAX's;
  (c) ``TrainLoader``'s host interleave as tests/test_multihost_loader.py
      checks JAX's, and a resume at batch N starting each host at its own
      N-th batch; Philox with a batch offset equals rows of the global draw;
  (d) ``cli.train --device cpu`` in two processes with ``--dist-*``: only
      the lead validates and saves, rank 1 logs to ``train_rank1``, and a
      two-rank resume ends bit-equal to the uninterrupted two-rank run.
"""

import functools
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from esrganplus_tpu_torch.parallel import held
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# seconds a two-process group may take before it is killed: a guard against
# a hang, far above the group's own time (about 15 s alone, several times
# that while the other test workers load the machine)
TIMEOUT = 300
JAX_CASES = ("sr_jax", "srragan_jax")
# (case, fault) of the planted faults that must fail the bars
FAULT_RUNS = [(c, f) for c in ("srragan", "sftgan") for f in W.FAULTS]
# relative L2 that a leaf summed over the batch in another order may move by:
# two ranks add their halves' sums, and the gradient of an L1 pixel loss is a
# sum of ±1/N terms that cancel (2.6e-6 of max|leaf| seen on hr_conv0's)
SUM_ORDER = 1e-5
# SFT-GAN's ACD at its init is chaotic in fp32: a 1e-7 relative perturbation
# of the HR batch moves D's gradient by 4.5e-4 (relative L2) in one process,
# and each rank runs D's convolutions at half the batch, whose rounding
# differs (seen: 1.6e-3); a missing global reduction moves it by percents
FLOOR = {"sftgan": 1e-2}
# JAX's (XLA's) convolutions and the port's (oneDNN's) sum in other orders;
# a bias's gradient sums 8·32·32 cancelling terms (seen: 3.2e-5)
JAX_FLOOR = 1e-4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    return dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
                OMP_NUM_THREADS="1")


def _start(cmd, logdir, cwd=None) -> list:
    """Start ``cmd(rank, port)`` as two processes of one group, each writing
    its output to ``logdir/rank{r}.log``."""
    port = _free_port()
    procs = []
    for r in range(2):
        with open(os.path.join(logdir, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen(cmd(r, port), env=_env(), cwd=cwd, stdout=log,
                                          stderr=subprocess.STDOUT))
    return procs


def _finish(procs, logdir, timeout=TIMEOUT) -> None:
    """Wait for a group's processes (both killed past ``timeout`` s); fail
    with both ranks' output unless both exit 0."""
    try:
        for p in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            p.kill()
            p.wait()
    if any(p.returncode for p in procs):
        tails = [open(os.path.join(logdir, f"rank{r}.log")).read()[-3000:] for r in range(2)]
        raise AssertionError(f"return codes {[p.returncode for p in procs]}: {tails}")


# ---------------------------------------------------------------------------
# JAX's steps on the 8-device mesh, from the port's seeded state
# ---------------------------------------------------------------------------


def _jax_trainer(case):
    from esrganplus_tpu.models import RRDBNetConfig as JGCfg
    from esrganplus_tpu.models.discriminator import DiscriminatorVGGConfig as JDCfg
    from esrganplus_tpu.models.vgg import VGGFeatConfig as JVCfg
    from esrganplus_tpu.parallel import make_mesh
    from esrganplus_tpu.train import SRTrainConfig, SRTrainer
    from esrganplus_tpu.train.gan_model import GANTrainConfig, GANTrainer

    net = JGCfg(**W.CASES[case][1]["net"])
    if case == "sr_jax":
        return SRTrainer(net, SRTrainConfig(lr=W.LR, milestones=(2,)), mesh=make_mesh())
    return GANTrainer(net, JDCfg(stage_kernel="xla", **W.D_NET),
                      GANTrainConfig(lr_g=W.LR, lr_d=W.LR, milestones=(2,), feature_weight=0.0),
                      mesh=make_mesh(), vgg_cfg=JVCfg(stage_kernel="xla", **W.VGG))


def _jax_step(case, jt):
    """The JAX trainer's first step from the port's seeded initial state (its
    parameters through the reference .pth layout) → (the state after it as
    the port's {leaf path: numpy}, its logs)."""
    from esrganplus_tpu.convert.pth import discriminator_from_state_dict, generator_from_state_dict
    from esrganplus_tpu.parallel import replicate_tree, shard_batch
    from esrganplus_tpu_torch.convert import (discriminator_to_state_dict,
                                              gan_trainer_state_from_jax,
                                              generator_to_state_dict, trainer_state_from_jax)

    pt = W.make_trainer(case)
    init = W._state(pt, None)
    sd = lambda t: {k: v.numpy() for k, v in t.items()}
    zero = jnp.zeros((), jnp.int32)
    if case == "sr_jax":
        g = generator_from_state_dict(sd(generator_to_state_dict(init["params"], pt.net_cfg)),
                                      jt.net_cfg)[0]
        jstate = {"params": g, "opt_state": jt.tx.init(g), "step": zero}
    else:
        g = generator_from_state_dict(sd(generator_to_state_dict(init["g_params"], pt.net_g)),
                                      jt.net_g)[0]
        d = discriminator_from_state_dict(
            sd(discriminator_to_state_dict(init["d_params"], pt.net_d)), jt.net_d)
        jstate = {"g_params": g, "d_params": d, "g_opt": jt.tx_g.init(g),
                  "d_opt": jt.tx_d.init(d), "step": zero}
    jstate = replicate_tree(jt.mesh, jstate)
    batch = shard_batch(jt.mesh, tuple(jnp.asarray(a) for a in W.global_batch(case)))
    jstate, logs = jt.train_step(jstate, batch, jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, jstate)
    out = (trainer_state_from_jax(host, pt.net_cfg) if case == "sr_jax"
           else gan_trainer_state_from_jax(host, pt.net_g, pt.net_d))
    out.pop("f_params", None)
    return ({n: t.detach().numpy() for n, t in W.named_leaves(out)},
            {k: float(v) for k, v in logs.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(case → [rank 0's, rank 1's] {"logs", "states"} from one two-process
    gloo group, case → JAX's first step). JAX steps while the group runs;
    every case starts from its trainer's seeded state."""
    tmp = tmp_path_factory.mktemp("dist")
    jts = {c: _jax_trainer(c) for c in JAX_CASES}
    torch.save(list(W.CASES) + [f"{c}+{f}" for c, f in FAULT_RUNS], tmp / "spec.pt")
    procs = _start(lambda r, port: [sys.executable, os.path.join(HERE, "torch_dist_worker.py"),
                                    str(tmp / "spec.pt"), str(r), "2", str(port),
                                    str(tmp / f"out{r}.pt")], tmp)
    try:
        jax_steps = {c: _jax_step(c, jt) for c, jt in jts.items()}
    finally:
        _finish(procs, tmp)
    outs = [torch.load(tmp / f"out{r}.pt", weights_only=False) for r in range(2)]
    return {c: [o[c] for o in outs] for c in outs[0]}, jax_steps


# ---------------------------------------------------------------------------
# (a) two ranks against one process
# ---------------------------------------------------------------------------


def _perturbed(batch):
    """``batch`` with every float entry moved by 1e-7 relative."""
    rs = np.random.RandomState(11)
    return tuple(a * (1 + 1e-7 * rs.randn(*a.shape)).astype(np.float32)
                 if a.dtype == np.float32 else a for a in batch)


@functools.cache
def _ref(case):
    """The port's one-process first step of ``case`` on the global batch."""
    return W.run_case(case, calls=1)


@functools.cache
def _noise(case):
    """The rounding noise of the one-process first step ``_ref(case)``: how
    far it moves (``held.noise_of`` per leaf, relative per logged term) when
    its initial parameters and its batch are perturbed by 1e-7 relative."""
    from esrganplus_tpu_torch.train.sr_model import tree_leaves

    init = W._state(W.make_trainer(case), None)
    rs = np.random.RandomState(5)
    with torch.no_grad():
        for t in tree_leaves(init):
            if torch.is_tensor(t) and t.is_floating_point():
                t.mul_(1 + 1e-7 * torch.from_numpy(rs.randn(*t.shape).astype(np.float32)))
    orig = W.global_batch
    W.global_batch = lambda c: _perturbed(orig(c)) if c == case else orig(c)
    try:
        pert = W.run_case(case, init, calls=1)
    finally:
        W.global_batch = orig
    ref = _ref(case)
    logs, states = ref["logs"][0], ref["states"][0]
    return (held.noise_of(pert["states"][0], states),
            {k: abs(pert["logs"][0][k] - v) / max(abs(v), 1e-30) for k, v in logs.items()})


def _held(got: dict, want: dict, tol: float, noise, floor: float) -> dict:
    """The leaves of ``got`` off ``want`` (the first step's state) beyond the
    bars of ``parallel/held.py`` → {path: (relative L2, bar)}; the leaves it
    left out are printed with the reason."""
    res = held.held_state(got, want, tol, W.LR, lambda: noise()[0], floor)
    for n, why in res["left_out"].items():
        print(f"left out {n}: {why}")
    print(f"worst held leaf: {res['worst']:.3g} of its bar")
    return res["bad"]


def _terms_close(got: dict, want: dict, tol: float, noise, floor: float = 0.0):
    """Every logged term within ``tol`` (relative; of max(1, |ref|) for the
    mean logits), or within ``floor`` and 10× its noise (relative)."""
    assert set(got) == set(want)
    for k, b in want.items():
        denom = max(1.0, abs(b)) if k.startswith("D_") else max(abs(b), 1e-12)
        if abs(got[k] - b) <= tol * denom:
            continue
        assert abs(got[k] - b) <= max(floor, 10 * noise()[1][k]) * abs(b), (k, got[k], b)


@pytest.mark.parametrize("case", list(W.CASES))
def test_two_ranks_agree_with_each_other(case, runs):
    r0, r1 = runs[0][case]
    assert r0["logs"] == r1["logs"]
    for s0, s1 in zip(r0["states"], r1["states"]):
        assert s0.keys() == s1.keys()
        for n in s0:
            assert np.array_equal(s0[n], s1[n]), n


@pytest.mark.parametrize("case", [c for c in W.CASES if c not in JAX_CASES])
def test_two_ranks_match_one_process(case, runs):
    ranks, _ = runs
    got = ranks[case][0]
    ref = _ref(case)
    noise = functools.partial(_noise, case)
    floor = FLOOR.get(case, SUM_ORDER)
    _terms_close(got["logs"][0], ref["logs"][0], 1e-6, noise, FLOOR.get(case, SUM_ORDER))
    bad = _held(got["states"][0], ref["states"][0], 1e-6, noise, floor)
    assert not bad, bad


@pytest.mark.parametrize("case,fault", FAULT_RUNS)
def test_planted_fault_fails_the_bars(case, fault, runs):
    """A fault in the backward of a global reduction leaves the first step's
    logs as they were and moves its state past the bars."""
    ranks, _ = runs
    got = ranks[f"{case}+{fault}"][0]
    ref = _ref(case)
    noise = functools.partial(_noise, case)
    _terms_close(got["logs"][0], ref["logs"][0], 1e-6, noise, FLOOR.get(case, SUM_ORDER))
    bad = _held(got["states"][0], ref["states"][0], 1e-6, noise, FLOOR.get(case, SUM_ORDER))
    print(f"{case}+{fault}: {len(bad)} leaves past their bars, the worst",
          max(bad.items(), key=lambda kv: kv[1][0] / kv[1][1], default=None))
    assert bad


# ---------------------------------------------------------------------------
# (b) two ranks against JAX's 8-device mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", JAX_CASES)
def test_two_ranks_match_jax_mesh(case, runs):
    ranks, jax_steps = runs
    got = ranks[case][0]
    want, jlogs = jax_steps[case]
    ref = _ref(case)

    @functools.cache
    def noise():
        # a leaf's noise here also counts the one-process port's own distance
        # to JAX: the two-rank step may be no further from it than 10× that
        leaves, terms = _noise(case)
        own = ref["states"][0]
        return {n: max(v, held.rel_l2(own[n], want[n])) for n, v in leaves.items()}, terms

    _terms_close(got["logs"][0], jlogs, 1e-5, noise)
    bad = _held(got["states"][0], want, 1e-5, noise, JAX_FLOOR)
    assert not bad, bad


# ---------------------------------------------------------------------------
# (c) the loader's host interleave and Philox's batch offset
# ---------------------------------------------------------------------------


class _IdxDataset:
    def __len__(self):
        return 32

    def sample(self, i, rng):
        return {"LR": np.full((2, 2, 3), i, np.float32)}


def _stream(host_index, host_count, steps, start=0, batch=4):
    from esrganplus_tpu_torch.data.loader import TrainLoader

    loader = TrainLoader(_IdxDataset(), batch_size=batch, num_workers=2, seed=7,
                         start_batch=start, host_index=host_index, host_count=host_count)
    try:
        it = iter(loader)
        return [list(next(it)["LR"][:, 0, 0, 0].astype(int)) for _ in range(steps)]
    finally:
        loader.stop()


def test_loader_hosts_interleave_one_stream():
    g = _stream(0, 1, 8)
    h0, h1 = _stream(0, 2, 4), _stream(1, 2, 4)
    assert h0 == g[0::2] and h1 == g[1::2]
    for b0, b1 in zip(h0, h1):
        assert not set(b0) & set(b1)
    # an epoch of 8 batches: the two hosts' 4 each cover every sample once
    assert sorted(i for b in h0 + h1 for i in b) == list(range(32))
    # a resume at step 2 starts each host at its own 2nd batch
    assert _stream(1, 2, 2, start=2) == h1[2:]


def test_loader_hosts_as_jax_loader():
    """The interleave rule of the JAX loader: host i of n takes the global
    batches k ≡ i (mod n) of the single-host stream."""
    from esrganplus_tpu_torch.data.loader import TrainLoader

    for i in range(3):
        assert TrainLoader(_IdxDataset(), 4, host_index=i, host_count=3)._k0 == i
    with pytest.raises(ValueError):
        TrainLoader(_IdxDataset(), 4, host_index=2, host_count=2)


@pytest.mark.parametrize("b0", [0, 3, 8])
def test_philox_offset_is_rows_of_the_global_draw(b0):
    from esrganplus_tpu_torch.kernels.philox import philox_normal
    from esrganplus_tpu_torch.kernels.rdb_ct import _noise_factor

    key = (0x12345678, 0x9ABCDEF0)
    whole = philox_normal(key, (16, 5, 6, 4))
    assert torch.equal(philox_normal(key, (4, 5, 6, 4), b0=b0), whole[b0:b0 + 4])
    assert torch.equal(_noise_factor(key, 0.1, (4, 5, 6, 4), None, b0),
                       _noise_factor(key, 0.1, (16, 5, 6, 4), None)[b0:b0 + 4])


def test_mesh_helpers_are_the_identity_without_a_group():
    from esrganplus_tpu_torch.parallel import mesh

    t = torch.arange(6.0, requires_grad=True)
    assert not mesh.is_initialized() and mesh.world_size() == 1 and mesh.rank() == 0
    assert mesh.all_reduce(t) is t and mesh.local_rows(t) is t
    g = [torch.ones(2)]
    assert mesh.all_reduce_grads(g) is g
    logs = {"a": torch.tensor(1.0)}
    assert mesh.reduce_logs(logs) is logs
    assert mesh.row_offset(5) == 0 and mesh.global_rows(5) == 5
    assert mesh.local_batch_size(7) == 7


# ---------------------------------------------------------------------------
# (d) the train CLI over two processes
# ---------------------------------------------------------------------------


def _cli_pair(root, opt):
    import json

    path = os.path.join(root, "opt.json")
    with open(path, "w") as f:
        json.dump(opt, f)
    _finish(_start(lambda r, port: [
        sys.executable, "-m", "esrganplus_tpu_torch.cli.train", "-opt", path, "--device",
        "cpu", "--dist-coordinator", f"localhost:{port}", "--dist-num-processes", "2",
        "--dist-process-id", str(r)], root, cwd=ROOT), root)
    return os.path.join(root, "experiments", "debug_e2e")


def test_cli_two_processes_lead_owns_outputs_and_resume_is_bit_equal(tmp_path):
    from test_torch_train_cli import _make_dataset, _options

    from esrganplus_tpu_torch.train.checkpoint import STATE_SUFFIX

    root = str(tmp_path)
    hr_dir, lr_dir = _make_dataset(root)
    opt = _options(root, hr_dir, lr_dir, niter=12)
    opt["datasets"]["train"]["batch_size"] = 4  # per process: a global batch of 8
    full = _cli_pair(root, opt)
    logs = sorted(os.listdir(full))
    lead = [f for f in logs if f.startswith("train_") and not f.startswith("train_rank")]
    rank1 = [f for f in logs if f.startswith("train_rank1")]
    assert len(lead) == 1 and len(rank1) == 1, logs
    lead_text = open(os.path.join(full, lead[0])).read()
    rank1_text = open(os.path.join(full, rank1[0])).read()
    assert "Validation # PSNR" in lead_text and "Saving models" in lead_text
    assert "Validation" not in rank1_text and "Saving" not in rank1_text
    assert "process 1 of 2 (gloo); batch 4 per process" in rank1_text
    # the logged terms are the global batch's on both ranks
    step_line = lambda text: [l.split("> ", 1)[1] for l in text.splitlines()
                              if "<step:      12," in l]
    assert step_line(lead_text) == step_line(rank1_text) and step_line(lead_text)
    assert sorted(os.listdir(os.path.join(full, "models"))) == ["8_G.pth", "latest_G.pth"]
    assert os.listdir(os.path.join(full, "training_state")) == ["8" + STATE_SUFFIX]
    assert len(os.listdir(os.path.join(full, "val_images"))) == 4
    want = torch.load(os.path.join(full, "models", "latest_G.pth"))

    # both ranks resume from the step-8 state and end as the run did
    opt["path"]["resume_state"] = os.path.join(full, "training_state", "8" + STATE_SUFFIX)
    _cli_pair(root, opt)
    got = torch.load(os.path.join(full, "models", "latest_G.pth"))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
