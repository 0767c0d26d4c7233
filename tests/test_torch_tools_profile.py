"""``cmh_torch.tools.profile_train`` and ``profile_encode`` on the CPU at the
tiny CLIP: the dicts ``main`` returns (the step and encode times are the
CPU's, the op list its host operators, the phases their host time), and the
chip microbenchmark's plumbing."""

import os

import torch_threads  # noqa: F401  (before any torch work)
from cmh_torch.tools import chip_microbench, profile_encode, profile_train


def _check_ops(out):
    assert out["kind"] == "host operators" and out["total_ms"] > 0
    ops = out["ops"]
    assert ops and all(set(op) == {"name", "ms", "share", "calls"} for op in ops)
    assert [op["ms"] for op in ops] == sorted((op["ms"] for op in ops), reverse=True)
    assert abs(sum(op["share"] for op in ops) - 1.0) < 1e-6


def test_profile_train_returns_its_numbers(tmp_path, capsys):
    out = profile_train.main(["--tiny", "--device", "cpu", "--batch", "8", "--steps", "2",
                              "--outdir", str(tmp_path)])
    assert out["step_ms"] > 0 and out["pairs_per_s"] > 0 and out["device"] == "cpu"
    assert (out["method"], out["batch"], out["steps"]) == ("DCMHT", 8, 2)
    # the wrappers count launches of the kernels only: none on the CPU
    assert out["launches_per_step"] == {"layernorm": 0, "layernorm_bwd": 0, "attention": 0,
                                        "attention_bwd": 0}
    _check_ops(out)
    assert any("mm" in op["name"] for op in out["ops"])
    assert os.path.getsize(out["trace"]) > 0 and out["trace"].startswith(str(tmp_path))
    # the step by the program's phases, from its spans: on the CPU their host time
    phases = out["phases"]
    assert phases["kind"] == "host ms" and phases["step_ms"] > 0
    assert [p["name"] for p in phases["phases"]] == ["to_device", "forward", "loss",
                                                      "zero_grad", "backward", "optimizer"]
    assert all(p["ms"] > 0 for p in phases["phases"])
    assert 0.9 < sum(p["share"] for p in phases["phases"]) <= 1.0
    printed = capsys.readouterr().out
    assert "train step: " in printed and "pairs/s" in printed and "ms/step" in printed
    assert "train_step by phase (host ms)" in printed


def test_profile_encode_returns_its_numbers(capsys):
    out = profile_encode.main(["--tiny", "--device", "cpu", "--batch", "8", "--nbatches", "2",
                               "--runs", "1", "--trace"])
    for key in ("product_ms", "encode_only_ms", "encode_map_ms"):
        assert out[key] > 0, key
    assert out["product_items_per_sec"] == 16 / (out["product_ms"] / 1e3)
    _check_ops(out)
    assert os.path.getsize(out["trace"]) > 0
    assert "A product get_code" in capsys.readouterr().out


def test_chip_microbench_reads_the_card_first(monkeypatch):
    """The card's line comes from nvidia-smi's query of name and power limit."""
    seen = {}

    def fake_run(cmd, **kw):
        seen["cmd"] = cmd

        class Done:
            stdout = "NVIDIA H100 80GB HBM3, 700.00 W\n"
        return Done()

    monkeypatch.setattr(chip_microbench.subprocess, "run", fake_run)
    assert chip_microbench.card_line() == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert seen["cmd"] == ["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]


def test_chip_microbench_rate_on_the_host():
    import torch

    out = chip_microbench.mm_rate(64, 32, 48, 2, torch.device("cpu"), torch.Generator())
    assert out["shape"] == [64, 32, 48] and out["ms"] > 0
    assert out["tflops"] == 2 * 64 * 32 * 48 / (out["ms"] * 1e-3) / 1e12


def test_profile_train_phases_on_the_card_count_launches_on_any_thread(tmp_path):
    """On the card a phase holds the device time of what was launched inside
    it, the autograd engine's launches inside ``cmh.backward`` included."""
    import json

    import torch

    def x(cat, name, ts, dur, tid=1, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
                "args": args}

    events = [x("user_annotation", "cmh.train_step", 0, 100),
              x("user_annotation", "cmh.forward", 0, 40),
              x("user_annotation", "cmh.k1_fwd [10, 64, 2]", 5, 2),
              x("user_annotation", "cmh.backward", 50, 40),
              x("cuda_runtime", "cudaLaunchKernel", 5, 1, correlation=1),
              x("cuda_runtime", "cudaLaunchKernel", 60, 1, tid=2, correlation=2),
              x("kernel", "a", 10, 30, tid=7, correlation=1),
              x("kernel", "b", 70, 20, tid=7, correlation=2),
              x("gpu_memcpy", "Memcpy DtoH", 95, 4, tid=7, correlation=3)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    out = profile_train.phase_table(str(path), torch.device("cuda"), 2)
    assert out == {"kind": "device ms", "step_ms": 0.025,
                   "phases": [{"name": "forward", "ms": 0.015, "share": 0.6},
                              {"name": "backward", "ms": 0.01, "share": 0.4}]}
