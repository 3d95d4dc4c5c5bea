"""The traced slice's reduction: the device's busy time is the union of its
intervals, not their sum over streams; idle gaps and the breakdown."""

from __future__ import annotations

import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE]

from core import trace  # noqa: E402


def _two_streams():
    # stream A busy [0, 40) and [60, 100); stream B busy [20, 50) (overlaps A)
    dev = [trace.DeviceEvent("void ns::dense_mma_kernel<64, 1>(Args)", 0, 40),
           trace.DeviceEvent("void ns::dense_mma_kernel<64, 1>(Args)", 60, 100),
           trace.DeviceEvent("Memcpy DtoH (Device -> Pageable)", 20, 50)]
    host = [("cudaGraphLaunch", 48, 62), ("aten::copy_", 10, 30)]
    return trace.Slice(wall_s=1e-4, lo=0, hi=100, device=dev, host=host, work=[{}])


def test_idle_share_is_the_union_not_the_summed_streams():
    s = _two_streams()
    summed = sum(e.end - e.start for e in s.device)
    assert summed == 110  # more than the slice: a per-stream sum reads a negative idle share
    assert s.busy_us() == 90
    assert 100 * (1 - s.busy_us() / (s.hi - s.lo)) == pytest.approx(10)


def test_gaps_and_breakdown():
    s = _two_streams()
    assert trace.gaps([(e.start, e.end) for e in s.device], 0, 100) == [(50, 60)]
    b = s.breakdown()
    assert b["device_ops"][0] == ["dense_mma_kernel", pytest.approx(8e-5)]  # seconds
    assert b["idle_gaps"] == [["cudaGraphLaunch", 1e-05]]
    assert [e.kind for e in s.device] == ["kernel", "kernel", "copy"]


def test_families_agree_between_trace_rows_and_graph_nodes():
    assert trace.op_family("void (anonymous namespace)::dense_mma_kernel<64, 1, 8, 2>(Args)") \
        == trace.mangled_family("_ZN12_GLOBAL__N_116dense_mma_kernelILi64ELi1ELi8ELi2EEEv4Args") \
        == "dense_mma_kernel"
    assert trace.op_family("sm90_xmma_fprop_f32") == trace.mangled_family("sm90_xmma_fprop_f32")


def test_other_rows_cannot_stand_in_for_the_programs_own():
    own = frozenset({"dense_mma_kernel", "wgrad_mma_kernel"})
    want = {"dense_mma_kernel": 4, "wgrad_mma_kernel": 2, "sm90_xmma_fprop": 3}
    # two dense rows dropped, two more fills than the graph holds: the total
    # is the graph's, and the slice still lacks the program's kernels
    got = {"dense_mma_kernel": 2, "wgrad_mma_kernel": 2, "sm90_xmma_fprop": 3,
           "FillFunctor": 2}
    assert sum(got.values()) == sum(want.values())
    assert trace.shortfall(want, got, own) == {"own_short": {"dense_mma_kernel": 2}}
    # a library kernel named otherwise in the trace counts by number
    got = {"dense_mma_kernel": 4, "wgrad_mma_kernel": 2, "xmma_fprop_renamed": 3}
    assert trace.shortfall(want, got, own) == {}
    got["xmma_fprop_renamed"] = 2
    assert trace.shortfall(want, got, own) == {"library": {"rows": 2, "graph_nodes": 3}}
    missing = trace.shortfall(want, got, own)
    s = trace.Slice(0.01, 0, 100, [], [], [{}], not missing, missing)
    assert s.own_complete and not s.complete  # a kernel roofline reads, an idle share not
