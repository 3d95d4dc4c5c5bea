"""The benchmark's readers of the program's spans (``benchmark/metrics``:
``optimizer_ms.train``, ``feature_ms.train``, ``disc_ms.train``,
``step_kernels.train``, ``frontend_idle_ms.infer``) on synthetic traced
slices: what each reads, and None where the slice is incomplete, the rows
do not match, or the program has no such spans or record (as a program
without them, an older one, gives)."""

import os
import sys

import pytest

from esrganplus_tpu_torch.utils import trace as T

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
sys.path.insert(0, BENCH)

from core import harness, spans  # noqa: E402
from core import trace as btrace  # noqa: E402


def _reader(name):
    return harness.load_module(os.path.join(BENCH, "metrics", f"{name}.py"),
                               "metric_" + name.replace(".", "_"))


GID = "phase-metrics-test"
NODES = [("sample", "philox_bits_kernel"), ("d.fwd", "stage_fwd_mma_kernel"),
         ("g.fwd", "dense_mma_kernel"), ("f.fwd", "cudnn_conv"), ("d.bwd", "stage_dgrad"),
         ("f.bwd", "cudnn_dgrad"), ("g.bwd", "dgrad_mma_kernel"), ("g.opt", "adam_a"),
         ("g.opt", "adam_b"), ("d.opt", "adam_c"), ("bn", "bn_merge")]
OWN = frozenset({"philox_bits_kernel", "stage_fwd_mma_kernel", "dense_mma_kernel",
                 "stage_dgrad", "dgrad_mma_kernel"})
MS = {"sample": 1, "d.fwd": 4, "g.fwd": 8, "f.fwd": 3, "d.bwd": 5, "f.bwd": 2, "g.bwd": 16,
      "g.opt": 0.5, "d.opt": 0.75, "bn": 0.25}  # µs a row


def _train_slice(steps=2, drop=None, complete=True, replay_spans=True):
    T.register_phases(GID, NODES)
    device, host, t = [], [], 0.0
    device.append(btrace.DeviceEvent("void at::native::vectorized_elementwise_kernel<4>(int)",
                                     t, t + 1))
    t += 2
    for _ in range(steps):
        if replay_spans:
            host.append((T.REPLAY + GID, t - 1, t))
        for ph, fam in NODES:
            device.append(btrace.DeviceEvent(f"void {fam}<1>(Args)", t, t + MS[ph]))
            t += MS[ph] + 1
    if drop is not None:
        del device[drop]
    return btrace.Slice(wall_s=t / 1e6, lo=0.0, hi=t, device=device, host=host,
                        work=[{}] * steps, complete=complete, context={"port_kernels": OWN})


@pytest.mark.parametrize("name,phases", [("optimizer_ms.train", ("g.opt", "d.opt")),
                                         ("feature_ms.train", ("f.fwd", "f.bwd")),
                                         ("disc_ms.train", ("d.fwd", "d.bwd"))])
def test_phase_readers_read_device_ms_a_step_of_their_phases(name, phases):
    want = sum(MS[p] * sum(1 for q, _ in NODES if q == p) for p in phases) / 1e3
    assert _reader(name).read(_train_slice()) == pytest.approx(want)


def test_step_kernels_is_the_replays_kernel_nodes():
    assert _reader("step_kernels.train").read(_train_slice(steps=3)) == len(NODES)


@pytest.mark.parametrize("name", ["optimizer_ms.train", "feature_ms.train", "disc_ms.train",
                                  "step_kernels.train"])
@pytest.mark.parametrize("case", ["incomplete", "no_replay_span", "unmatched", "older_program"])
def test_training_readers_give_none(name, case, monkeypatch):
    sl = _train_slice(complete=case != "incomplete", replay_spans=case != "no_replay_span",
                      drop=5 if case == "unmatched" else None)
    if case == "older_program":
        monkeypatch.delattr(T, "phase_times")
        monkeypatch.delattr(T, "phase_lists")
    if case == "unmatched" and name == "step_kernels.train":
        assert _reader(name).read(sl) == len(NODES)  # it reads the graphs, not the rows
        return
    assert _reader(name).read(sl) is None


def _infer_slice(images=2, complete=True, with_spans=True):
    """Per image: prepare 0–10, copy in 10–14 (an H2D copy 12–13), forward
    14–20 (kernels 16–40), copy out 20–50 (D2H 42–48); then 5 µs outside."""
    device, host = [], []
    for i in range(images):
        o = 55.0 * i
        device += [btrace.DeviceEvent("Memcpy HtoD (Pageable -> Device)", o + 12, o + 13),
                   btrace.DeviceEvent("void dense_mma_kernel<1>(Args)", o + 16, o + 40),
                   btrace.DeviceEvent("Memcpy DtoH (Device -> Pageable)", o + 42, o + 48)]
        if with_spans:
            host += [("sr.prepare", o, o + 10), ("sr.copy_in", o + 10, o + 14),
                     ("sr.forward", o + 14, o + 20), ("sr.copy_out", o + 20, o + 50),
                     ("aten::to", o + 10, o + 14)]
    return btrace.Slice(wall_s=1e-4, lo=0.0, hi=55.0 * images, device=device, host=host,
                        work=[{}] * images, complete=complete)


def test_frontend_idle_is_the_idle_under_the_front_ends_host_spans():
    sl = _infer_slice()
    # prepare 10 + copy in 3 (10–12, 13–14) + copy out (40–42, 48–50) 4 = 17 µs an
    # image; forward 14–16 = 2; outside 50–55 = 5
    assert _reader("frontend_idle_ms.infer").read(sl) == pytest.approx(17e-3)
    idle = spans.idle_by_span(sl, "sr.")
    assert idle["sr.forward"] == pytest.approx(4) and idle[spans.OUTSIDE] == pytest.approx(10)
    total = (sl.hi - sl.lo) - sl.busy_us()
    assert sum(idle.values()) == pytest.approx(total)


@pytest.mark.parametrize("case", ["incomplete", "no_spans"])
def test_frontend_idle_gives_none(case):
    sl = _infer_slice(complete=case != "incomplete", with_spans=case != "no_spans")
    assert _reader("frontend_idle_ms.infer").read(sl) is None


def test_innermost_span_takes_the_idle():
    dev = [btrace.DeviceEvent("void k<1>(A)", 0, 10)]
    host = [("sr.copy_out", 10, 40), ("sr.prepare", 20, 30)]
    sl = btrace.Slice(wall_s=1e-4, lo=0.0, hi=50.0, device=dev, host=host, work=[{}])
    idle = spans.idle_by_span(sl, "sr.")
    assert idle == {"sr.copy_out": 20, "sr.prepare": 10, spans.OUTSIDE: 10}
