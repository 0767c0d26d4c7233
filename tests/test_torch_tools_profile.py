"""``cmh_torch.tools.profile_train`` and ``profile_encode`` on the CPU at the
tiny CLIP: the dicts ``main`` returns (the step and encode times are the
CPU's, the op list its host operators), and the chip microbenchmark's
plumbing."""

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
    printed = capsys.readouterr().out
    assert "train step: " in printed and "pairs/s" in printed and "ms/step" in printed


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
