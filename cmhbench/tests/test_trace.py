"""The reduction of a traced window: busy and idle time, kernels by the
span that launched them, the breakdown, and a roofline share from it."""

import pytest

from cmhbench import flops, layer
from cmhbench.common import Outcome
from cmhbench.trace import Trace


def ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


EVENTS = [
    ev("user_annotation", "cmhbench.window", 0, 100),
    ev("user_annotation", "cmhbench.k1_fwd [1000, 768, 2]", 10, 10, **{"External id": 3}),
    ev("user_annotation", "cmhbench.k4 [1, 4096, 2, 1]", 86, 4, tid=2, **{"External id": 9}),
    ev("cpu_op", "aten::copy_", 40, 30),
    ev("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=5),
    ev("cuda_runtime", "cudaLaunchKernel", 50, 1, correlation=6),
    ev("kernel", "layernorm_fwd_kernel", 30, 10, tid=7, correlation=5),
    ev("kernel", "gemm", 60, 20, tid=7, correlation=6),
    ev("gpu_memcpy", "Memcpy DtoH", 75, 10, tid=7, correlation=7),
    # launched from a thread whose launch the trace lost, linked by External id
    ev("kernel", "hamming_kernel", 90, 5, tid=7, correlation=8, **{"External id": 9}),
    {"ph": "i", "name": "marker", "ts": 5},
]


def test_busy_idle_and_kernels_by_span():
    t = Trace(EVENTS)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s() == pytest.approx(40e-6)          # 30-40, 60-85 and 90-95
    assert t.kernels() == 3
    assert t.span_count("k1_fwd") == 1
    assert t.span_calls("k1_fwd") == [([1000, 768, 2], pytest.approx(10e-6))]
    assert t.span_calls("k4") == [([1, 4096, 2, 1], pytest.approx(5e-6))]
    ops = dict(t.device_ops())
    assert ops["gemm"] == pytest.approx(20e-6) and len(ops) == 4
    gaps = dict(t.idle_gaps())
    assert gaps["idle while aten::copy_"] == pytest.approx(20e-6)   # 40-60
    assert gaps["idle while cmhbench.k4"] == pytest.approx(5e-6)     # 85-90
    assert sum(gaps.values()) == pytest.approx(60e-6)


def test_roofline_and_idle_from_a_trace():
    t = Trace(EVENTS)
    o = Outcome(e2e={}, attempted=1, failed=0, memory_peak_bytes=0, checks=[], trace=t)
    bound = flops.bound_s(*flops.k1_fwd(1000, 768, 2))
    assert layer.roofline_pct(o, (("k1_fwd", flops.k1_fwd),)) == pytest.approx(
        100 * bound / 10e-6)
    assert layer.idle_pct(o) == pytest.approx(60.0)
    assert layer.roofline_pct(o, (("k2_fwd", flops.k2_fwd),)) is None


def test_a_trace_without_the_window_span_is_refused():
    with pytest.raises(ValueError):
        Trace(EVENTS[1:])
