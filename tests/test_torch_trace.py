"""The port's profiler-trace summary (esrganplus_tpu_torch/utils/trace.py,
cli/profile_summary.py) and the train CLI's ``--profile``:

  (a) exclusive aggregation over a synthetic ``torch.profiler`` trace: GPU
      kernel rows when there are any (each event once), else nested CPU op
      rows; per-step division; ``op_family`` on the port's kernel names;
  (b) ``cli.profile_summary`` on a ``.pt.trace.json`` and a gzipped trace;
  (c) ``cli.train --device cpu --profile DIR --profile-steps 2`` writes a
      trace that ``profile_summary`` reads, also when the run ends inside
      the window.
"""

import gzip
import json
import os

import numpy as np
import pytest

from esrganplus_tpu_torch.utils.trace import (aggregate_exclusive, device_rows, find_trace_file,
                                              op_family)


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
