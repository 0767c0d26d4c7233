"""The result line: its keys in the contract's order, the numbers compared
last, the breakdown of a traced run, and correct false on a failed check."""

import json

import pytest
import torch

from cmhbench import run, spec
from cmhbench.common import Check, Outcome
from cmhbench.tests.test_trace import EVENTS
from cmhbench.trace import Trace


@pytest.fixture
def named_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")


def outcome(checks, trace=None):
    return Outcome(e2e={"train_pairs_per_s": 2512.25, "setup_s": 21.5}, attempted=90, failed=0,
                   memory_peak_bytes=41 << 30, checks=checks,
                   host={"steps": 90, "window_s": 9.2, "flops_per_step": 8.7e12,
                         "traced_steps": 2}, trace=trace)


def test_untraced_line(named_card):
    bench = spec.load()
    cell = spec.cell(bench, "dcmht-vitl14-train")
    line = run.result_line(outcome([Check("loss_gap", 1e-3, 4e-3)]),
                           spec.metrics(bench, cell["name"], "end_to_end"), False, cell)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    assert line["metrics"] == {"train_pairs_per_s": {"value": 2512.25, "unit": "pairs/s"},
                               "setup_s": {"value": 21.5, "unit": "s"}}
    assert line["device"] == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                              "memory_peak_bytes": 41 << 30}
    assert line["checks"] == {"loss_gap": {"value": 1e-3, "limit": 4e-3}}
    json.dumps(line)


def test_traced_line_and_a_failed_check(named_card):
    bench = spec.load()
    cell = spec.cell(bench, "dcmht-vitl14-train")
    line = run.result_line(outcome([Check("loss_gap", 1e-3, 4e-3), Check("grad_gap", 1.0, 0.1)],
                                   Trace(EVENTS)),
                           spec.metrics(bench, cell["name"], "per_layer"), True, cell)
    assert line["correct"] is False and list(line)[-1] == "checks"
    assert line["device"]["busy_s"] == pytest.approx(40e-6)
    assert line["device"]["window_s"] == pytest.approx(100e-6)
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in line["breakdown"].values())
    m = line["metrics"]
    assert m["launches_per_step.train"]["value"] == 1.5
    assert m["train_mfu"]["unit"] == "%" and 0 < m["train_mfu"]["value"] < 100
    assert "k2_roofline.train" not in m          # no K2 call in this trace
    json.dumps(line)
