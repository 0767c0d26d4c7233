"""The program's ``cmh.*`` spans read from a traced window: intervals,
device time launched inside them on any thread, idle time inside them, and
the nine per-layer readers that use them."""

import pytest

from cmhbench import program_spans, spec
from cmhbench.common import Outcome
from cmhbench.tests.test_trace import ev
from cmhbench.trace import Trace

MAIN, AUTOGRAD, DEVICE = 1, 2, 7


def kernel(corr, launch_ts, start, dur, tid=MAIN):
    """A launch on host thread ``tid`` and the kernel it put on the card."""
    return [ev("cuda_runtime", "cudaLaunchKernel", launch_ts, 1, tid=tid, correlation=corr),
            ev("kernel", f"k{corr}", start, dur, tid=DEVICE, correlation=corr)]


TRAIN = [
    ev("user_annotation", "cmhbench.window", 0, 200),
    ev("user_annotation", "cmh.train_step", 0, 180),
    ev("user_annotation", "cmh.forward", 10, 50),
    ev("user_annotation", "cmh.k1_fwd [100, 768, 2]", 19, 3),
    ev("user_annotation", "cmh.backward", 70, 70),
    ev("user_annotation", "cmh.k2_bwd [100, 16, 257, 64, 2, false, false]", 79, 3, tid=AUTOGRAD),
    ev("user_annotation", "cmh.optimizer", 150, 25),
    ev("user_annotation", "cmh.wait.epoch_loss", 185, 10),
    ev("cpu_op", "aten::mm", 40, 5),
    *kernel(1, 20, 25, 20),               # forward: 25-45
    *kernel(4, 48, 50, 30),               # launched in the forward, runs past its end: 50-80
    *kernel(2, 80, 90, 30, tid=AUTOGRAD),  # the autograd engine's, inside cmh.backward: 90-120
    *kernel(3, 160, 160, 10),             # optimizer: 160-170
]


def outcome(events):
    return Outcome(e2e={}, attempted=1, failed=0, memory_peak_bytes=0, checks=[],
                   trace=Trace(events))


def test_intervals_device_and_idle_time_of_program_spans():
    t = Trace(TRAIN)
    assert program_spans.intervals(t, "forward") == [(pytest.approx(10e-6), pytest.approx(60e-6))]
    assert program_spans.count(t, "k1_fwd") == 1      # the shapes after the space are not the name
    assert program_spans.count(t, "wait.*") == 1 and program_spans.count(t, "wait") == 0
    # by launch time, on any thread: the kernel that runs past the forward stays the forward's
    assert program_spans.device_s(t, "forward") == pytest.approx(50e-6)
    assert program_spans.device_s(t, "backward") == pytest.approx(30e-6)
    assert program_spans.device_s(t, "train_step") == pytest.approx(90e-6)
    # idle split at the span edges: 10-25, 45-50 in the forward; 80-90, 120-140 in the backward
    assert program_spans.idle_s(t, "forward") == pytest.approx(20e-6)
    assert program_spans.idle_s(t, "backward") == pytest.approx(30e-6)
    assert program_spans.idle_s(t, "optimizer") == pytest.approx(15e-6)


def test_overlapping_spans_of_one_name_count_once():
    t = Trace(TRAIN + [ev("user_annotation", "cmh.forward", 30, 40, tid=AUTOGRAD)])
    assert program_spans.intervals(t, "forward") == [(pytest.approx(10e-6), pytest.approx(70e-6))]
    assert program_spans.device_s(t, "forward") == pytest.approx(50e-6)
    assert program_spans.idle_s(t, "forward") == pytest.approx(20e-6)   # 10-25, 45-50


def test_the_training_readers():
    o = outcome(TRAIN + [ev("user_annotation", "cmh.train_step", 181, 1)])   # two steps
    read = {n: spec.reader(n)(o) for n in (
        "forward_ms.train", "backward_ms.train", "forward_idle_ms.train",
        "backward_idle_ms.train", "host_waits_per_step.train")}
    assert read == {"forward_ms.train": pytest.approx(0.025),
                    "backward_ms.train": pytest.approx(0.015),
                    "forward_idle_ms.train": pytest.approx(0.010),
                    "backward_idle_ms.train": pytest.approx(0.015),
                    "host_waits_per_step.train": 0.5}


VALID = [
    ev("user_annotation", "cmhbench.window", 0, 120),
    ev("user_annotation", "cmh.valid", 0, 110),
    ev("user_annotation", "cmh.get_code", 5, 55),
    ev("user_annotation", "cmh.wait.get_code_index", 6, 3),
    ev("user_annotation", "cmh.encode_image", 10, 20),
    ev("user_annotation", "cmh.encode_text", 30, 20),
    ev("user_annotation", "cmh.make_code", 51, 8),
    ev("user_annotation", "cmh.wait.get_code_rows", 52, 6),
    ev("user_annotation", "cmh.wait.code_sync", 60, 2),
    ev("user_annotation", "cmh.map_4dir", 62, 40),
    ev("user_annotation", "cmh.wait.map_read", 95, 5),
    *kernel(1, 12, 15, 20),    # image tower: 15-35
    *kernel(2, 32, 35, 20),    # text tower: 35-55
    *kernel(3, 64, 70, 20),    # K3
]


def test_the_valid_readers():
    o = outcome(VALID)
    assert spec.reader("image_tower_ms.valid")(o) == pytest.approx(0.020)
    assert spec.reader("text_tower_ms.valid")(o) == pytest.approx(0.020)
    assert spec.reader("code_idle_ms.valid")(o) == pytest.approx(0.015)   # 5-15, 55-60
    assert spec.reader("host_waits_per_valid.valid")(o) == 4


NINE = ("forward_ms.train", "backward_ms.train", "forward_idle_ms.train",
        "backward_idle_ms.train", "host_waits_per_step.train", "image_tower_ms.valid",
        "text_tower_ms.valid", "code_idle_ms.valid", "host_waits_per_valid.valid")


@pytest.mark.parametrize("events", [None, TRAIN[:1] + TRAIN[8:]], ids=["untraced", "no-spans"])
def test_a_program_without_spans_reads_nothing(events):
    """A run without a trace, or a program without the spans (an earlier
    commit), gives no value and raises nothing."""
    o = outcome(events) if events else Outcome(e2e={}, attempted=1, failed=0,
                                               memory_peak_bytes=0, checks=[])
    assert {n: spec.reader(n)(o) for n in NINE} == dict.fromkeys(NINE)


def test_the_nine_are_declared():
    bench = spec.load()
    declared = {m["name"]: m for m in bench["per_layer"]}
    for n in NINE:
        cell = "dcmht-vitl14-train" if n.endswith(".train") else "dcmht-vitb32-valid"
        assert declared[n]["workloads"] == [cell]
        assert declared[n]["source"] in ("device_trace", "program_counter")
