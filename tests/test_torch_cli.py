"""``python -m cmh_torch.main`` on the CPU: the training CLI of the port.

A tiny synthetic DCMHT config (``CLIPConfig.tiny()``) runs two epochs end to
end and writes the model file and the three ``.mat`` files in the
reference schema. Without ``--device cpu`` (and no card) it raises; run keys
the port does not carry yet raise instead of being ignored, and each ported
run key does its work in a tiny run.
"""

import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.io as scio
import torch_threads  # noqa: F401  (before any torch work)
import torch

from cmh_torch.main import main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = """\
model: {arch: DCMHT, clip_path: /nonexistent.pt, clip_variant: tiny, hash_func: softmax}
optimizer: {arch: BertAdam, lr: 0.002}
dataset: {arch: synthetic_dataset, name: synthetic, num_classes: 4, image_resolution: 32, max_word: 12}
run: {arch: DCMHTTrainer, output_dim: 8, batch_size: 16,
      train_num: 32, query_num: 16, display_step: 2%s}
"""


def _cfg(tmp_path, extra=", epochs: 2"):
    path = tmp_path / "tiny.yaml"
    path.write_text(TINY % extra)
    return str(path)


def test_cli_trains_two_epochs_on_the_cpu(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "cmh_torch.main", "--config-file", _cfg(tmp_path),
         "--save-dir", str(tmp_path / "out"), "--device", "cpu", "--seed", "3"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    (run_dir,) = os.listdir(tmp_path / "out")          # the timestamped save dir
    run_dir = tmp_path / "out" / run_dir
    log = (run_dir / "log" / "synthetic-cpu.txt").read_text()
    assert log.count("], MAP(i->t)") == 2 and "pairs/s" in log and "FINISHED" in log
    models = sorted(p for p in os.listdir(run_dir) if p.startswith("model-"))
    assert models and all(p.endswith(".pt") for p in models)
    state = torch.load(run_dir / models[0], weights_only=True)
    assert "hash.img_hash.norm.running_var" in state
    for name in ("i2t-best", "t2i-best", "last"):
        mat = scio.loadmat(run_dir / "mat_files" / f"{name}.mat")
        assert {"q_img", "q_txt", "r_img", "r_txt", "q_l", "r_l"} <= set(mat)
        assert mat["q_img"].shape == (16, 8) and mat["r_txt"].shape == (64, 8)
        for key in ("q_img", "q_txt", "r_img", "r_txt"):
            assert set(np.unique(mat[key])) == {-1.0, 1.0}


def test_cli_refuses_the_cpu_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config-file", _cfg(tmp_path), "--save-dir", str(tmp_path / "o")])
    # one process a card: the CPU has none to spread over
    with pytest.raises(AssertionError, match="more than one device"):
        main(["--config-file", _cfg(tmp_path), "--save-dir", str(tmp_path / "o"),
              "--device", "cpu", "--distribute"])


@pytest.mark.parametrize("extra,error,match", [
    (", tp: 2", ValueError, "1 devices not divisible by tp=2"),
    (", distribute: True, tp: 2", ValueError, "1 devices not divisible by tp=2"),
    (", multi_host: True", ValueError,
     "run.multi_host needs run.num_processes and run.process_id")])
def test_unported_run_keys_raise(tmp_path, extra, error, match):
    """``run.tp`` needs a process group that it divides (cmh_tpu's error; a
    run without a group, or ``run.distribute``'s group of one, is one
    process; ``tests/test_torch_tp.py`` runs it); ``run.multi_host`` needs
    cmh_tpu's keys of the group (``tests/test_torch_dp.py`` runs it)."""
    with pytest.raises(error, match=match):
        main(["--config-file", _cfg(tmp_path, extra), "--save-dir", str(tmp_path / "o"),
              "--device", "cpu"])


@pytest.fixture
def trainer_log():
    """The messages the runner logs (its logger does not propagate)."""
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logger = logging.getLogger("synthetic-cpu")
    logger.addHandler(handler)
    yield records
    logger.removeHandler(handler)


def _train(tmp_path, extra, out="o"):
    return main(["--config-file", _cfg(tmp_path, ", epochs: 1" + extra),
                 "--save-dir", str(tmp_path / out), "--device", "cpu"])


@pytest.mark.parametrize("key", ["checkpoint_every", "auto_resume", "resume_checkpoint",
                                 "profile_dir", "remat"])
def test_ported_run_keys_run(tmp_path, trainer_log, key):
    if key == "checkpoint_every":
        tr = _train(tmp_path, ", checkpoint_every: 1")
        path = os.path.join(tr.save_dir, "checkpoint-last.pt")
        with open(path + ".meta.json") as f:
            assert json.load(f) == {"epoch": 1, "fingerprint": tr._config_fingerprint()}
        assert torch.load(path, weights_only=True)["meta"]["global_step"] == 2
    elif key == "auto_resume":
        first = _train(tmp_path, ", checkpoint_every: 1, auto_resume: True")
        again = _train(tmp_path, ", checkpoint_every: 1, auto_resume: True")
        assert any("resuming at epoch 1" in m for m in trainer_log)
        assert again.global_step == first.global_step == 2 and again.history == []
    elif key == "resume_checkpoint":
        first = _train(tmp_path, ", checkpoint_every: 1", out="first")
        path = os.path.join(first.save_dir, "checkpoint-last.pt")
        again = _train(tmp_path, f", resume_checkpoint: {path}")
        assert f"checkpoint restored from {path} (resuming at epoch 1)" in trainer_log
        assert again.optimizer.step_count == first.optimizer.step_count == 2
    elif key == "profile_dir":
        prof = tmp_path / "prof"
        _train(tmp_path, f", profile_dir: {prof}, profile_steps: 1")
        with open(prof / "train-steps-2-2.pt.trace.json") as f:
            assert json.load(f)["traceEvents"]
    else:
        tr = _train(tmp_path, ", remat: True")
        assert any(m.startswith("run.remat ignored") and "hash.img_hash.norm" in m
                   for m in trainer_log)
        assert tr.history and np.isfinite(tr.history[0]["loss"])


def test_unknown_arch_names_the_ported_ones(tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text((TINY % "").replace("arch: DCMHT,", "arch: NoSuchMethod,"))
    with pytest.raises(KeyError, match="DCMHT.*DIMCH.*UMoED"):
        main(["--config-file", str(path), "--save-dir", str(tmp_path / "o"),
              "--device", "cpu"])


def test_test_mode_reproduces_the_valid_maps(tmp_path):
    """``run.is_train: False`` with ``run.resume_model`` reloads a
    ``model-<epoch>.pt`` and scores the same four mAPs as that epoch's
    ``valid`` (the weights and the BatchNorm running statistics round-trip)."""
    trainer = main(["--config-file", _cfg(tmp_path, ", epochs: 1, is_train: True"),
                    "--save-dir", str(tmp_path / "train"), "--device", "cpu"])
    model = os.path.join(trainer.save_dir, "model-0.pt")
    assert os.path.isfile(model)
    tester = main(["--config-file", _cfg(tmp_path, f", is_train: False, resume_model: {model}"),
                   "--save-dir", str(tmp_path / "test"), "--device", "cpu"])
    np.testing.assert_allclose(tester.test(), trainer.history[0]["maps"], rtol=0, atol=1e-12)
    with pytest.raises(FileNotFoundError, match="resume_model"):
        main(["--config-file", _cfg(tmp_path, ", is_train: False, resume_model: nope.pt"),
              "--save-dir", str(tmp_path / "t2"), "--device", "cpu"])
