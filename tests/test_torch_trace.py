"""The program's spans (``cmh_torch/utils/trace.py``) on the CPU at the tiny
CLIP: off without a profiler, the phases of ``train_step`` and of
``valid_codes_and_maps`` nested and in order under one, the host waits
counted, the kernel entries' shapes as JSON, and the exported Chrome trace
readable."""

import json

import pytest
import torch_threads  # noqa: F401  (before any torch work)
import torch
from torch.profiler import ProfilerActivity, profile

from cmh_torch.tools.profile_train import device_batches, synthetic_trainer
from cmh_torch.utils import trace

CPU = torch.device("cpu")
PHASES = ["to_device", "forward", "loss", "zero_grad", "backward", "optimizer"]


@pytest.fixture(scope="module")
def trainer():
    tr = synthetic_trainer("DCMHT", 8, 16, True, 8, CPU)
    tr.batches = device_batches(tr.train_loader, CPU)
    tr.history.append({"epoch": 0})
    return tr


def traced(tmp_path, fn):
    """Run ``fn`` under the profiler (host activity), export its Chrome
    trace, load it with ``json.load`` and return its ``cmh.*`` spans as
    (start, end, name, shapes or None), by start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.recording()
        fn()
    path = tmp_path / "window.pt.trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("name", "").startswith(trace.PREFIX):
            name, _, shapes = e["name"].partition(" ")
            out.append((e["ts"], e["ts"] + e["dur"], name[len(trace.PREFIX):],
                        json.loads(shapes) if shapes else None))
    return sorted(out)


def test_the_flag_spans_read_follows_the_profiler():
    """Spans read ``torch.autograd.profiler._is_profiler_enabled``: a
    PyTorch that drops or renames it fails here instead of losing spans."""
    assert isinstance(torch.autograd.profiler._is_profiler_enabled, bool)
    assert not trace.recording()
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.recording() and torch.autograd.profiler._is_profiler_enabled
    assert not trace.recording()


def test_spans_cost_nothing_without_a_profiler(trainer, monkeypatch):
    """Off, a train step and a valid enter no ``record_function`` and build
    no span name."""
    class NoJson:
        @staticmethod
        def dumps(*a, **k):
            raise AssertionError("a span name was built with no profiler recording")

    def refused(*a, **k):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(trace, "record_function", refused)
    monkeypatch.setattr(trace, "json", NoJson)
    trainer.train_step(trainer.batches[0])
    trainer.valid_codes_and_maps(0)
    assert trace.span("x", (1, 2)) is trace.wait("y")      # one shared no-op


def test_train_step_phases_nest_in_order(trainer, tmp_path):
    spans = traced(tmp_path, lambda: trainer.train_step(trainer.batches[1]))
    (a, b, _, _), = [s for s in spans if s[2] == "train_step"]
    phases = [s for s in spans if s[2] in PHASES]
    assert [s[2] for s in phases] == PHASES                 # one each, in order
    assert all(a <= s[0] and s[1] <= b for s in phases)
    assert all(x[1] <= y[0] for x, y in zip(phases, phases[1:]))
    # one wait a step: the text tower's host scalar, inside the forward
    (w0, w1, _, _), = [s for s in spans if s[2].startswith("wait.")]
    assert [s[2] for s in spans if s[2].startswith("wait.")] == ["wait.eos_attn_zero"]
    assert phases[1][0] <= w0 and w1 <= phases[1][1]
    inside = {p: [s for s in spans if s[0] >= ph[0] and s[1] <= ph[1] and s[2] != p]
              for p, ph in ((s[2], s) for s in phases)}
    assert {s[2] for s in inside["forward"]} == {"k1_fwd", "k2_fwd", "wait.eos_attn_zero"}
    assert {s[2] for s in inside["backward"]} == {"k1_bwd", "k2_bwd"}


def test_launch_site_spans_carry_their_shapes(trainer, tmp_path):
    spans = traced(tmp_path, lambda: trainer.train_step(trainer.batches[2]))
    k1 = [s[3] for s in spans if s[2] in ("k1_fwd", "k1_bwd")]
    k2 = [s[3] for s in spans if s[2] in ("k2_fwd", "k2_bwd")]
    assert k1 and all(len(x) == 3 and x[2] == 4 and x[1] == 64 for x in k1)   # rows, d, fp32
    assert k2 and all(len(x) == 7 and x[4] == 4 for x in k2)    # b, h, s, hd, size, mask, bias
    assert {tuple(x[5:]) for x in k2} == {(False, False), (True, True)}   # image; causal text
    assert all(type(v) in (int, bool) for x in k1 + k2 for v in x)


def test_valid_spans_and_host_waits(trainer, tmp_path):
    spans = traced(tmp_path, lambda: trainer.valid_codes_and_maps(0))
    names = [s[2] for s in spans]
    batches = len(trainer.query_loader) + len(trainer.retrieval_loader)
    assert names.count("valid") == 1 and names.count("get_code") == 2
    assert names.count("encode_image") == names.count("encode_text") == batches
    assert names.count("make_code") == 2 * batches and names.count("map_4dir") == 1
    waits = [n for n in names if n.startswith("wait.")]
    # three boolean indexings and the text tower's host scalar a batch, then the
    # mAP's read (no synchronize on the CPU)
    assert sorted(set(waits)) == ["wait.eos_attn_zero", "wait.get_code_index",
                                  "wait.get_code_rows", "wait.map_read"]
    assert len(waits) == 4 * batches + 1
    (m0, m1, _, _), = [s for s in spans if s[2] == "map_4dir"]
    k3 = [s for s in spans if s[2] in ("k3_hist", "k3_ap")]
    assert k3 and all(m0 <= s[0] and s[1] <= m1 and len(s[3]) == 5 for s in k3)
    assert trainer.history[-1]["map_s"] > 0 and trainer.history[-1]["code_s"] > 0


def test_remat_recomputes_the_forward_inside_the_backward(tmp_path):
    tr = synthetic_trainer("Baseline", 4, 16, True, 4, CPU)
    tr.remat = True
    batch = device_batches(tr.train_loader, CPU)[0]
    spans = traced(tmp_path, lambda: tr.train_step(batch))
    forwards = [s for s in spans if s[2] == "forward"]
    (b0, b1, _, _), = [s for s in spans if s[2] == "backward"]
    assert len(forwards) == 2 and b0 <= forwards[1][0] and forwards[1][1] <= b1


def test_search_and_random_entries_carry_their_shapes(tmp_path):
    from cmh_torch.ops import hamming, random
    from cmh_torch.utils import prng

    q = torch.zeros((3, 2), dtype=torch.int32)
    g = torch.zeros((5, 2), dtype=torch.int32)
    x = torch.ones((4, 8))
    key = prng.PRNGKey(0)
    spans = traced(tmp_path, lambda: (hamming.hamming_packed(q, g, 64),
                                      random.random_bits(key, (6,), CPU),
                                      random.dropout(x, key, 0.1)))
    assert [(s[2], s[3]) for s in spans] == [("k4", [3, 5, 2, 1]), ("t", [6, 4, False]),
                                             ("t", [32, 4, True])]
