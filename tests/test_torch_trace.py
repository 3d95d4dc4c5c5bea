"""The port's profiler-trace summary (esrganplus_tpu_torch/utils/trace.py,
cli/profile_summary.py) and the train CLI's ``--profile``:

  (a) exclusive aggregation over a synthetic ``torch.profiler`` trace: GPU
      kernel rows when there are any (each event once), else nested CPU op
      rows; per-step division; ``op_family`` on the port's kernel names;
  (b) ``cli.profile_summary`` on a ``.pt.trace.json`` and a gzipped trace;
  (c) ``cli.train --device cpu --profile DIR --profile-steps 2`` writes a
      trace that ``profile_summary`` reads, also when the run ends inside
      the window;
  (d) the spans and phase marks: one check a span while no profiler
      records, a host row under a CPU profile; each trainer's eager step
      marks its phases in order; ``SRInferencer.upscale`` and
      ``BatchedEvaluator`` their front-end spans; ``node_phases`` and
      ``phase_times`` on synthetic rows; ``profile_summary`` by phase with a
      ``phases.json``.
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from esrganplus_tpu_torch.utils import trace as T
from esrganplus_tpu_torch.utils.trace import (aggregate_exclusive, device_rows, find_trace_file,
                                              op_family)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _ev(name, ts, dur, cat="kernel", pid=0, tid=7):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur}


DENSE = "void (anonymous namespace)::dense_mma_kernel<64, 1, 8, 2>(DenseArgs)"
WGRAD = "void wgrad_mma_kernel<16, 9, 2>(WgradArgs, float*)"


def test_op_family_strips_templates_and_namespaces():
    assert op_family(DENSE) == "dense_mma_kernel"
    assert op_family(WGRAD) == "wgrad_mma_kernel"
    assert op_family("void at::native::vectorized_elementwise_kernel<4, float>(int)") == \
        "vectorized_elementwise_kernel"
    assert op_family("aten::conv2d") == "conv2d"
    assert op_family("stage_fwd_s2_mma_kernel") == "stage_fwd_s2_mma_kernel"
    assert op_family("ampere_bf16_s16816gemm_bf16_128x64") == "ampere_bf16_s16816gemm_bf16_128x64"


def test_kernel_rows_win_and_count_once():
    events = [
        _ev("ProfilerStep#10", 0, 1000, cat="user_annotation", tid=1),
        _ev("aten::conv2d", 0, 900, cat="cpu_op", tid=1),
        _ev(DENSE, 10, 30), _ev(DENSE, 10, 30),  # the same event twice in the file
        _ev(DENSE, 50, 20), _ev(WGRAD, 80, 50),
        _ev(WGRAD, 40, 10, tid=8),  # another stream
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7, "args": {"name": "stream 7"}},
    ]
    assert device_rows(events)[0] == "kernel"
    total, agg = aggregate_exclusive(events)
    assert abs(total - 0.110) < 1e-9  # 30 + 20 + 50 + 10 µs
    assert agg["dense_mma_kernel"] == pytest.approx((0.050, 2))
    assert agg["wgrad_mma_kernel"] == pytest.approx((0.060, 2))
    assert "conv2d" not in agg


def test_cpu_rows_nest_exclusively_and_divide_by_steps():
    events = []
    for step in range(2):
        t = 1000 * step
        events += [_ev("aten::conv2d", t, 100, cat="cpu_op"),
                   _ev("aten::convolution", t + 10, 80, cat="cpu_op"),
                   _ev("aten::add", t + 120, 10, cat="cpu_op"),
                   _ev("aten::add", t + 5, 10, cat="cpu_op", tid=9)]
    assert device_rows(events)[0] == "cpu_op"
    total, agg = aggregate_exclusive(events, steps=2)
    assert abs(total - 0.120) < 1e-9  # (100 + 10 + 10) µs a step
    assert agg["conv2d"] == pytest.approx((0.020, 1))
    assert agg["convolution"] == pytest.approx((0.080, 1))
    assert agg["add"] == pytest.approx((0.020, 2))


@pytest.mark.parametrize("gz", [False, True])
def test_profile_summary_cli(tmp_path, capsys, gz):
    from esrganplus_tpu_torch.cli.profile_summary import main

    d = tmp_path / "run"
    os.makedirs(d)
    data = {"traceEvents": [_ev(DENSE, 0, 750), _ev(WGRAD, 800, 250)]}
    if gz:
        with gzip.open(d / "host_1.123.pt.trace.json.gz", "wt") as f:
            json.dump(data, f)
    else:
        (d / "host_1.123.pt.trace.json").write_text(json.dumps(data))
    main([str(tmp_path), "--steps", "1"])
    out = capsys.readouterr().out
    assert "device total: 1.000 ms/step" in out
    rows = out.splitlines()
    assert "dense_mma_kernel" in rows[2] and "wgrad_mma_kernel" in rows[3]


@pytest.mark.parametrize("niter", [12, 11])
def test_cli_train_profile_writes_a_readable_trace(tmp_path, capsys, niter):
    from esrganplus_tpu_torch.cli.profile_summary import main as summary
    from esrganplus_tpu_torch.cli.train import main as train
    from esrganplus_tpu_torch.ops.image_io import save_img

    root = str(tmp_path)
    hr_dir = os.path.join(root, "HR")
    rng = np.random.RandomState(0)
    for i in range(2):
        save_img((rng.rand(32, 32, 3) * 255).astype(np.uint8), os.path.join(hr_dir, f"{i}.png"))
    opt = {"name": "debug_profile", "model": "sr", "scale": 4, "use_tb_logger": False,
           "datasets": {"train": {"name": "s", "mode": "LRHR", "dataroot_HR": hr_dir,
                                  "n_workers": 1, "batch_size": 2, "HR_size": 16,
                                  "resident_crops": 8}},
           "path": {"root": root},
           "network_G": {"which_model_G": "sr_resnet", "nf": 8, "nb": 1},
           "train": {"lr_G": 1e-3, "lr_steps": [100], "pixel_criterion": "l2",
                     "manual_seed": 0, "niter": niter},
           "logger": {"print_freq": 2}}
    path = os.path.join(root, "opt.json")
    with open(path, "w") as f:
        json.dump(opt, f)
    trace_dir = os.path.join(root, "trace")
    train(["-opt", path, "--device", "cpu", "--profile", trace_dir, "--profile-steps", "2"])
    trace = find_trace_file(trace_dir)
    assert trace.endswith(".pt.trace.json")
    capsys.readouterr()
    summary([trace_dir, "--steps", str(niter - 10)])
    out = capsys.readouterr().out
    assert "device total:" in out and ("conv2d" in out or "convolution" in out)
    exp = os.path.join(root, "experiments", "debug_profile")
    log = open(os.path.join(exp, sorted(f for f in os.listdir(exp) if f.endswith(".log"))[-1])).read()
    assert "profiler trace written" in log
    assert ("ended inside the profile window" in log) == (niter == 11)


# ---------------------------------------------------------------------------
# (d) spans and phases
# ---------------------------------------------------------------------------


def test_span_is_one_check_without_a_profiler(monkeypatch):
    checks = []
    monkeypatch.setattr(T, "recording", lambda: checks.append(1) or False)
    monkeypatch.setattr(T, "record", lambda name: pytest.fail(f"record({name!r}) called"))
    with T.span("sr.forward"):
        pass
    assert checks == [1]
    T.mark(T.REPLAY + "0")
    T.phase("g.fwd")
    T.end_phase()
    assert checks == [1, 1, 1] and T._open == []
    x = torch.ones(2, requires_grad=True)
    assert T.phase_at_grad(x, "g.bwd") is x and not x._backward_hooks


def _host_rows(fn, names):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.name in names)


def test_span_is_a_host_row_under_the_profiler():
    def fn():
        with T.span("sr.forward"):
            torch.ones(4).mul(2)
        T.mark(T.REPLAY + "3")

    rows = _host_rows(fn, {"sr.forward", "aten::mul", T.REPLAY + "3"})
    assert [n for _, _, n in rows] == ["sr.forward", "aten::mul", T.REPLAY + "3"]
    (ss, se, _), = [r for r in rows if r[2] == "sr.forward"]
    (ms, me, _), = [r for r in rows if r[2] == "aten::mul"]
    assert ss <= ms <= me <= se
    assert T.is_span("sr.forward") and T.is_span("g.opt") and not T.is_span("aten::mul")


SMALL_VGG = (8, 8, "M", 16, 16, "M", 32, 32, 32, 32, "M", 32, 32, 32, 32, "M", 32, 32, 32, 32,
             "M")
GAN_ORDER = ["d.fwd", "g.fwd", "loss", "f.fwd", "loss", "d.fwd", "loss", "d.bwd", "f.bwd",
             "g.bwd", "g.opt", "d.fwd", "loss", "d.bwd", "d.opt", "bn", "logs"]
ORDER = {"sr": ["sample", "g.fwd", "loss", "g.bwd", "g.opt", "logs"],
         "srragan": ["sample"] + GAN_ORDER,
         "sftgan": ["sample"] + GAN_ORDER[1:]}


def _cpu_store(cls, n, hr, seg=False):
    rs = np.random.RandomState(0)
    s = cls.__new__(cls)
    s.device, s.n_crops, s.use_flip, s.use_rot = torch.device("cpu"), n, True, True
    lr = hr // 4
    if seg:
        s.lr = torch.from_numpy(rs.rand(n, lr, lr, 3).astype(np.float32))
        s.seg = torch.from_numpy((rs.rand(n, hr, hr, 8) * 255).astype(np.uint8))
        s.cat = torch.arange(n) % 8
    else:
        s.lr = torch.from_numpy((rs.rand(n, lr, lr, 3) * 255).astype(np.uint8))
    s.hr = torch.from_numpy((rs.rand(n, hr, hr, 3) * 255).astype(np.uint8))
    return s


def _trainer_and_store(kind):
    from esrganplus_tpu_torch.data.resident import ResidentCropStore, ResidentSegStore
    from esrganplus_tpu_torch.models import RRDBNetConfig, SRResNetConfig
    from esrganplus_tpu_torch.models.discriminator import DiscriminatorVGGConfig
    from esrganplus_tpu_torch.models.sft import SFTNetConfig
    from esrganplus_tpu_torch.models.vgg import VGGFeatConfig
    from esrganplus_tpu_torch.train import (GANTrainConfig, GANTrainer, SFTGANTrainConfig,
                                            SFTGANTrainer, SRTrainConfig, SRTrainer)

    vgg = VGGFeatConfig(layout=SMALL_VGG)
    if kind == "sr":
        return (SRTrainer(RRDBNetConfig(nf=8, nb=1, gc=4, upscale=4), SRTrainConfig(),
                          device="cpu"), _cpu_store(ResidentCropStore, 4, 32))
    if kind == "srragan":
        return (GANTrainer(SRResNetConfig(nf=8, nb=1),
                           DiscriminatorVGGConfig(input_size=96, base_nf=8),
                           GANTrainConfig(variant="srragan", feature_weight=1.0),
                           device="cpu", vgg_cfg=vgg), _cpu_store(ResidentCropStore, 4, 96))
    return (SFTGANTrainer(SFTNetConfig(nb=1, nf=16, cond_nf=8),
                          SFTGANTrainConfig(feature_weight=1.0), device="cpu", vgg_cfg=vgg),
            _cpu_store(ResidentSegStore, 4, 96, seg=True))


@pytest.mark.parametrize("kind", ["sr", "srragan", "sftgan"])
def test_eager_step_marks_its_phases_in_order(kind):
    """A CPU profile of a resident step (``run_eager``): the phases follow
    the body, and the backward phases open in the autograd engine's order
    (D's, then F's, then G's), each span closed before the next opens."""
    from esrganplus_tpu_torch.train.resident_exec import run_eager

    trainer, store = _trainer_and_store(kind)
    state = trainer.init_state(0)
    rows = _host_rows(lambda: run_eager(trainer, state, store, 3, 2, 1), set(T.PHASES))
    assert [n for _, _, n in rows] == ORDER[kind]
    assert all(a[1] <= b[0] for a, b in zip(rows, rows[1:]))
    assert T._open == []


@pytest.mark.parametrize("batched", [False, True])
def test_upscale_marks_its_front_end_spans(batched):
    from esrganplus_tpu_torch.infer import BatchedEvaluator, SRInferencer
    from esrganplus_tpu_torch.models import RRDBNetConfig, generator_init

    cfg = RRDBNetConfig(nf=8, nb=1, gc=4, upscale=4)
    params = generator_init(0, cfg)
    img = np.random.RandomState(0).rand(9, 11, 3).astype(np.float32)
    if batched:
        ev = BatchedEvaluator(params, cfg, device="cpu", batch=2)
        fn = lambda: ev.upscale_batch([img, img[:7]])
        want = ["sr.prepare", "sr.prepare", "sr.copy_in", "sr.forward", "sr.copy_out",
                "sr.copy_out"]
    else:
        inf = SRInferencer(params, cfg, device="cpu", pad_multiple=4)
        fn = lambda: inf.upscale(img)
        want = ["sr.prepare", "sr.copy_in", "sr.forward", "sr.copy_out"]
    names = {"sr.prepare", "sr.copy_in", "sr.forward", "sr.copy_out"}
    assert [n for _, _, n in _host_rows(fn, names)] == want


def test_node_phases_follow_the_marks():
    fams = [None, "a", "b", None, "c", "d", "e"]
    marks = [("sample", 2), ("g.fwd", 4), ("loss", 4), ("g.opt", 6)]
    assert T.node_phases(fams, marks) == [(T.EXEC, "a"), ("sample", "b"), ("loss", "c"),
                                          ("loss", "d"), ("g.opt", "e")]
    assert T.node_phases(fams, []) == [(T.EXEC, f) for f in fams if f is not None]


OWN = frozenset({"philox_bits_kernel", "dense_mma_kernel"})
LISTS = {"7": [("sample", "philox_bits_kernel"), ("g.fwd", "dense_mma_kernel"),
               ("g.fwd", "kernel"), ("g.opt", "vectorized_elementwise_kernel")]}


def _bursts(replays_per_burst=(2, 1), drop=None, rename=None):
    """Kernel rows and spans of bursts of replays of graph 7 (10 µs a row,
    2 µs apart; 5 µs before a replay's first row), an executor row (a fill)
    before each burst."""
    rows, spans, t = [], [], 0.0
    for n in replays_per_burst:
        rows.append(("vectorized_elementwise_kernel", t, t + 10))
        t += 12
        for _ in range(n):
            spans.append((T.REPLAY + "7", t - 3, t + 1))
            t += 5
            for _, fam in LISTS["7"]:
                rows.append((fam, t, t + 10))
                t += 12
    if rename:
        i, fam = rename
        rows[i] = (fam,) + rows[i][1:]
    if drop is not None:
        del rows[drop]
    return rows, spans


def test_phase_times_charges_each_replay_row_to_its_phase():
    rows, spans = _bursts()
    got = T.phase_times(rows, spans, LISTS, OWN)
    assert {k: v["kernels"] for k, v in got.items()} == {
        T.EXEC: 2, "sample": 3, "g.fwd": 6, "g.opt": 3}
    assert all(abs(v["ms"] - v["kernels"] * 0.01) < 1e-12 for v in got.values())
    # 2 µs before every row, 5 µs more before a replay's first (the sampler's)
    assert abs(got["sample"]["idle_ms"] - 3 * 0.007) < 1e-12
    assert abs(got["g.fwd"]["idle_ms"] - 6 * 0.002) < 1e-12
    assert abs(got[T.EXEC]["idle_ms"] - 0.002) < 1e-12  # the first row has no gap before it
    # rows of the executor between bursts are exec's, and a library kernel
    # named otherwise in the trace than in the graph node still matches
    rows, spans = _bursts(rename=(3, "enable_if"))
    assert T.phase_times(rows, spans, LISTS, OWN)["g.fwd"]["kernels"] == 6


@pytest.mark.parametrize("fault", ["missing_row", "own_renamed", "unknown_graph"])
def test_phase_times_is_none_where_a_replay_does_not_match(fault):
    if fault == "missing_row":
        rows, spans = _bursts(drop=6)
    elif fault == "own_renamed":
        rows, spans = _bursts(rename=(2, "dgrad_mma_kernel"))
    else:
        rows, spans = _bursts()
        spans[1] = (T.REPLAY + "8",) + spans[1][1:]
    assert T.phase_times(rows, spans, LISTS, OWN) is None


def test_profile_summary_prints_phases_and_spans(tmp_path, capsys):
    from esrganplus_tpu_torch.cli.profile_summary import main

    rows, spans = _bursts()
    fam_name = {"philox_bits_kernel": "void philox_bits_kernel(unsigned*)",
                "dense_mma_kernel": DENSE, "kernel": "void gemvx::kernel<int>(float)",
                "vectorized_elementwise_kernel":
                    "void at::native::vectorized_elementwise_kernel<4>(int)"}
    events = [_ev(fam_name[f], s, e - s) for f, s, e in rows]
    # a graph's copy node, run as a kernel of CUDA's own
    events.append(_ev("memcpy32_post", rows[2][1] + 10.5, 1))
    events += [_ev(n, s, e - s, cat="cpu_op", tid=1) for n, s, e in spans]
    (tmp_path / "h_1.2.pt.trace.json").write_text(json.dumps({"traceEvents": events}))
    (tmp_path / "phases.json").write_text(json.dumps(LISTS))
    main([str(tmp_path), "--steps", "3"])
    out = capsys.readouterr().out
    assert "host ms/step by span:" in out and "exec.replay" in out
    table = out.split("by phase")[1].splitlines()
    assert any(line.split()[:2] == ["0.020", "ms"] and line.endswith("g.fwd") for line in table)
    (tmp_path / "phases.json").write_text(json.dumps({"8": LISTS["7"]}))
    main([str(tmp_path), "--steps", "3"])
    assert "do not match phases.json" in capsys.readouterr().out
