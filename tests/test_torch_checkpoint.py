"""Full-state checkpoints, auto-resume and the SIGTERM save of cmh_torch's
runner, after cmh_tpu's runner tests (``tests/test_runner_paths.py``).

Tiny DCMHT trainers (``CLIPConfig.tiny()``, 2 steps an epoch) on the CPU:
the checkpoint's meta round-trips; the run fingerprint and the sidecar equal
cmh_tpu's for one config; auto-resume skips foreign and fingerprint-less
checkpoints, falls back past a truncated one and rolls back a partial load;
a checkpoint of another structure fails with a clear error; a run resumed
at an epoch boundary is bit-equal to the uninterrupted run (shuffle off);
and an emergency save, from the SIGTERM flag, a crash or a real signal to a
CLI process, resumes.
"""

import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch_threads  # noqa: F401  (before any torch work)
import torch

from cmh_torch.config import config_from_dict
from cmh_torch.optim.bert_adam import _FlatSpec
from cmh_torch.runners.base import BaseTrainer
from cmh_torch.runners.dcmht import DCMHTTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(save_dir, run_extra=None, optimizer_extra=None, model_extra=None):
    """``tests/util_methods.tiny_trainer``'s config."""
    return {
        "model": {"arch": "DCMHT", "clip_path": "/nonexistent.pt", "clip_variant": "tiny",
                  "hash_func": "softmax", **(model_extra or {})},
        "optimizer": {"arch": "BertAdam", "lr": 0.002, "clip_lr": 0.0005,
                      "warmup_proportion": 0.1, "schedule": "warmup_cosine",
                      **(optimizer_extra or {})},
        "dataset": {"arch": "synthetic_dataset", "name": "synthetic", "num_classes": 4,
                    "image_resolution": 32, "max_word": 12},
        "run": {"arch": "DCMHTTrainer", "save_dir": str(save_dir),
                "log_dir": str(save_dir / "log"), "output_dim": 8, "batch_size": 16,
                "is_train": True, "train_num": 32, "query_num": 16, "epochs": 1,
                "display_step": 1000, "seed": 5, **(run_extra or {})},
    }


def trainer(save_dir, **kw):
    return DCMHTTrainer.from_config(cfg=config_from_dict(_cfg(save_dir, **kw)), device="cpu",
                                    auto_run=False)


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


def assert_same_state(a, b):
    """Model state (parameters and BatchNorm statistics), optimizer moments
    and step count bit-equal."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["step_count"] == ob["step_count"]
    for ga, gb in zip(oa["groups"], ob["groups"]):
        assert torch.equal(ga["m"], gb["m"]) and torch.equal(ga["v"], gb["v"])


def _sidecar(path):
    with open(str(path) + ".meta.json") as f:
        return json.load(f)


@pytest.mark.parametrize("flat_saved,flat_loaded", [(True, True), (True, False),
                                                    (False, True)])
def test_checkpoint_meta_roundtrips(tmp_path, trainer_log, flat_saved, flat_loaded):
    """save_checkpoint carries the state and the bookkeeping (next epoch,
    step, best trackers); load restores them and returns the resume epoch,
    converting the optimizer state between the flat and the tree path."""
    tr = trainer(tmp_path / "a", optimizer_extra={"flat": flat_saved})
    tr.train_epoch(0)
    tr.max_mapi2t, tr.best_epoch_i = 0.75, 3
    ckpt = str(tmp_path / "full.pt")
    tr.save_checkpoint(ckpt, epoch=4)
    assert _sidecar(ckpt) == {"epoch": 4, "fingerprint": tr._config_fingerprint()}

    tr2 = trainer(tmp_path / "b", optimizer_extra={"flat": flat_loaded})
    assert tr2.load_checkpoint(ckpt) == 4
    assert (tr2.max_mapi2t, tr2.best_epoch_i) == (0.75, 3)
    assert tr2.global_step == tr.global_step == 2
    assert ("optimizer state format converted (flat↔tree) on restore" in trainer_log) == (
        flat_saved != flat_loaded)
    if flat_saved == flat_loaded:
        assert_same_state(tr, tr2)
        return
    # the moments convert exactly; the flat key changes the fingerprint
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, tr2.model.state_dict()[k]), k
    assert tr2.optimizer.step_count == tr.optimizer.step_count
    for a, b in zip(_moments(tr.optimizer), _moments(tr2.optimizer)):
        assert torch.equal(a, b)
    assert any("fingerprint differs from this run on ['optimizer_hash']" in m
               for m in trainer_log)


def _moments(opt):
    """Each group's m and v, every parameter's unpadded, in one vector."""
    out = []
    for group, saved in zip(opt.param_groups, opt.state_dict()["groups"]):
        for key in ("m", "v"):
            ts = saved[key]
            if torch.is_tensor(ts):
                ts = _FlatSpec(group["params"]).views(ts)
            out.append(torch.cat([t.reshape(-1) for t in ts]))
    return out


def test_fingerprint_and_sidecar_equal_cmh_tpus(tmp_path, monkeypatch):
    """For one config the two packages name a run alike: the same
    fingerprint, and the port's one epoch with ``checkpoint_every: 1``
    writes the sidecar that cmh_tpu's ``train`` writes after epoch 0 (the
    next epoch, 1, and the fingerprint). cmh_tpu's save is called as its
    ``train`` calls it (``cmh_tpu/runners/base.py:650-652``): training it
    on the CPU would add some 13 s."""
    from tests.util_methods import tiny_trainer

    monkeypatch.setenv("CMH_TPU_FUSED", "0")       # interpret mode is slow
    extra = {"checkpoint_every": 1}
    jtr = tiny_trainer(tmp_path / "jax", "DCMHT", "DCMHTTrainer",
                       model_extra={"hash_func": "softmax"}, run_extra=extra)
    ptr = trainer(tmp_path / "port", run_extra=extra)
    assert ptr._config_fingerprint() == jtr._config_fingerprint()
    jtr.save_checkpoint(str(tmp_path / "jax" / "checkpoint-last.msgpack"), epoch=1)
    ptr.train()
    want = _sidecar(tmp_path / "jax" / "checkpoint-last.msgpack")
    assert _sidecar(tmp_path / "port" / "checkpoint-last.pt") == want
    assert want["epoch"] == 1


def test_auto_resume_skips_foreign_config_checkpoints(tmp_path, trainer_log):
    """The newest checkpoint under the save root wins only if its
    fingerprint matches; a foreign one (same structure, other lr) and one
    without a fingerprint are skipped with the reason logged."""
    tr_match = trainer(tmp_path / "x")
    ck_match = str(tmp_path / "x" / "checkpoint-last.pt")
    tr_match.save_checkpoint(ck_match, epoch=1)
    tr_foreign = trainer(tmp_path / "y", optimizer_extra={"lr": 0.05})
    ck_foreign = str(tmp_path / "y" / "checkpoint-last.pt")
    tr_foreign.save_checkpoint(ck_foreign, epoch=7)
    os.makedirs(tmp_path / "z")
    ck_bare = str(tmp_path / "z" / "emergency.ckpt.pt")
    torch.save({"model": tr_match.model.state_dict()}, ck_bare)   # no meta, no sidecar
    now = os.path.getmtime(ck_match)
    for i, p in enumerate((ck_match, ck_foreign, ck_bare)):   # matching oldest
        os.utime(p, (now + 10 * i, now + 10 * i))

    tr_new = trainer(tmp_path / "w")
    assert next(tr_new._resume_candidates(), None) == ck_match
    assert any(f"skipping {ck_bare} (no config fingerprint" in m for m in trainer_log)
    assert any(f"skipping {ck_foreign} (config fingerprint mismatch on ['optimizer_hash'])"
               in m for m in trainer_log)
    assert tr_new.load_checkpoint(ck_match) == 1
    os.remove(ck_match + ".meta.json")          # the fingerprint read from the file itself
    assert next(tr_new._resume_candidates(), None) == ck_match
    os.remove(ck_match)                         # nothing matches: a fresh start
    assert next(tr_new._resume_candidates(), None) is None
    foreign2 = trainer(tmp_path / "v", optimizer_extra={"lr": 0.05})
    assert next(foreign2._resume_candidates(), None) == ck_foreign


def test_auto_resume_survives_truncated_checkpoint(tmp_path, trainer_log):
    """A truncated file under a valid sidecar does not stop auto_resume: the
    next candidate is loaded, or training starts fresh."""
    tr_a = trainer(tmp_path / "a")
    tr_a.train_epoch(0)
    ck_good = str(tmp_path / "a" / "checkpoint-last.pt")
    tr_a.save_checkpoint(ck_good, epoch=1)
    tr_b = trainer(tmp_path / "b")
    ck_bad = str(tmp_path / "b" / "checkpoint-last.pt")
    tr_b.save_checkpoint(ck_bad, epoch=1)
    with open(ck_bad, "r+b") as f:             # a kill in the middle of a write
        f.truncate(100)
    now = os.path.getmtime(ck_good)
    os.utime(ck_bad, (now + 10, now + 10))     # the corrupt one is newest

    tr_new = trainer(tmp_path / "c", run_extra={"auto_resume": True})
    assert list(tr_new._resume_candidates()) == [ck_bad, ck_good]
    tr_new.train()                             # epoch 1 of 1: nothing left to run
    assert any(m.startswith(f"auto_resume: {ck_bad} unreadable") for m in trainer_log)
    assert_same_state(tr_new, tr_a)

    os.remove(ck_good)
    tr_fresh = trainer(tmp_path / "d", run_extra={"auto_resume": True})
    tr_fresh.train()
    assert tr_fresh.optimizer.step_count == tr_fresh.global_step == 2


def test_auto_resume_rolls_back_after_partial_load(tmp_path, monkeypatch):
    """A candidate that changes the trainer and then fails leaves nothing
    behind: the fresh start runs from the pristine init."""
    tr_a = trainer(tmp_path / "a")
    tr_a.train_epoch(0)
    tr_a.save_checkpoint(str(tmp_path / "a" / "checkpoint-last.pt"), epoch=1)
    # no shuffle: the two runs below draw from numpy's one global generator
    tr_b = trainer(tmp_path / "b", run_extra={"auto_resume": True, "shuffle": False})
    pristine = trainer(tmp_path / "p", run_extra={"shuffle": False})

    orig = BaseTrainer._load_checkpoint       # what auto_resume loads each candidate with

    def poisoned(self, path):
        orig(self, path)                       # changes the state and trackers
        self.global_step = 777
        raise KeyError("simulated older meta schema")

    monkeypatch.setattr(BaseTrainer, "_load_checkpoint", poisoned)
    tr_b.train()
    assert tr_b.global_step == 2 and tr_b.optimizer.step_count == 2
    pristine.train()
    assert_same_state(tr_b, pristine)


def test_load_checkpoint_structure_mismatch_clear_error(tmp_path):
    tr = trainer(tmp_path / "a")
    ckpt = str(tmp_path / "a.pt")
    tr.save_checkpoint(ckpt, epoch=1)
    other = trainer(tmp_path / "b", run_extra={"output_dim": 16})
    with pytest.raises(ValueError, match="does not match this trainer's state structure"):
        other.load_checkpoint(ckpt)


class _Killed(BaseException):
    """A kill that leaves no emergency save (not an ``Exception``)."""


def test_resume_at_epoch_boundary_is_bit_equal(tmp_path, monkeypatch):
    """With shuffle off, 1 epoch + checkpoint + auto-resume of epoch 2 ends
    with the state, the trackers and the mAPs of 2 uninterrupted epochs."""
    run = {"epochs": 2, "shuffle": False}
    whole = trainer(tmp_path / "whole" / "run", run_extra=run)
    whole.train()

    run.update(checkpoint_every=1, auto_resume=True)
    first = trainer(tmp_path / "root" / "first", run_extra=run)
    orig = BaseTrainer.train_epoch

    def killed_in_epoch_1(self, epoch):
        if epoch == 1:
            raise _Killed()
        return orig(self, epoch)

    monkeypatch.setattr(BaseTrainer, "train_epoch", killed_in_epoch_1)
    with pytest.raises(_Killed):
        first.train()
    monkeypatch.setattr(BaseTrainer, "train_epoch", orig)
    assert not (tmp_path / "root" / "first" / "emergency.ckpt.pt").exists()

    resumed = trainer(tmp_path / "root" / "second", run_extra=run)
    resumed.train()
    assert [h["epoch"] for h in resumed.history] == [1]
    assert resumed.history[0]["loss"] == whole.history[1]["loss"]
    assert resumed.history[0]["maps"] == whole.history[1]["maps"]
    assert_same_state(resumed, whole)
    assert (resumed.global_step, resumed.max_mapi2t, resumed.max_mapt2i, resumed.best_epoch_i,
            resumed.best_epoch_t) == (whole.global_step, whole.max_mapi2t, whole.max_mapt2i,
                                      whole.best_epoch_i, whole.best_epoch_t)


@pytest.mark.parametrize("how", ["sigterm_flag", "crash"])
def test_emergency_save_resumes(tmp_path, monkeypatch, trainer_log, how):
    """The SIGTERM flag, set from a wrapped ``train_step`` in epoch 1, makes
    ``train`` save ``emergency.ckpt.pt`` and return; a crash saves and
    re-raises. Either way the restart resumes at the interrupted epoch."""
    run = {"epochs": 3, "auto_resume": True, "checkpoint_every": 1}
    first = trainer(tmp_path / "first", run_extra=run)
    orig = BaseTrainer.train_step

    def interrupted(self, batch):
        out = orig(self, batch)
        if self.global_step == 3:              # the first step of epoch 1
            if how == "crash":
                raise RuntimeError("injected crash")
            self._preempt_signal = signal.SIGTERM
        return out

    monkeypatch.setattr(BaseTrainer, "train_step", interrupted)
    if how == "crash":
        with pytest.raises(RuntimeError, match="injected crash"):
            first.train()
    else:
        first.train()
        assert any(m.startswith("preempted (SIGTERM)") for m in trainer_log)
    monkeypatch.setattr(BaseTrainer, "train_step", orig)
    emergency = tmp_path / "first" / "emergency.ckpt.pt"
    assert _sidecar(emergency)["epoch"] == 1
    assert torch.load(emergency, weights_only=True)["meta"]["global_step"] == 3

    again = trainer(tmp_path / "second", run_extra=run)
    again.train()
    assert f"checkpoint restored from {emergency} (resuming at epoch 1)" in trainer_log
    assert [h["epoch"] for h in again.history] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in again.history)
    assert again.global_step == again.optimizer.step_count == 3 + 4


TINY_FOREVER = """\
model: {arch: DCMHT, clip_path: /nonexistent.pt, clip_variant: tiny, hash_func: softmax}
optimizer: {arch: BertAdam, lr: 0.002}
dataset: {arch: synthetic_dataset, name: synthetic, num_classes: 4, image_resolution: 32, max_word: 12}
run: {arch: DCMHTTrainer, output_dim: 8, batch_size: 16, train_num: 32, query_num: 16,
      epochs: 200, display_step: 1000, auto_resume: True, checkpoint_every: 1}
"""


def test_sigterm_to_a_cli_run_saves_and_the_restart_resumes(tmp_path):
    """A real SIGTERM to ``python -m cmh_torch.main``: the emergency save is
    written and the process exits 0; the same command again resumes and
    goes past it. The signal is sent only once this process has written a
    checkpoint, which proves its handler is installed."""
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(TINY_FOREVER)
    out_root = tmp_path / "out"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}

    def max_meta_epoch():
        best = -1
        for meta in out_root.glob("*/*.pt.meta.json"):
            try:
                best = max(best, json.loads(meta.read_text())["epoch"])
            except (OSError, ValueError):
                pass                            # being replaced right now
        return best

    def run_and_preempt():
        baseline = max_meta_epoch()
        proc = subprocess.Popen(
            [sys.executable, "-m", "cmh_torch.main", "--config-file", str(cfg),
             "--save-dir", str(out_root), "--device", "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
        chunks = []
        drainer = threading.Thread(target=lambda: chunks.append(proc.stdout.read()),
                                   daemon=True)
        drainer.start()
        try:
            deadline = time.monotonic() + 120
            while max_meta_epoch() <= baseline:
                assert proc.poll() is None, "exited before the signal: " + "".join(chunks)
                assert time.monotonic() < deadline, f"no checkpoint past epoch {baseline}"
                time.sleep(0.2)
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=120)
            drainer.join(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
        return proc.returncode, "".join(chunks)

    rc, out = run_and_preempt()
    assert rc == 0, out[-3000:]
    assert "preempted (SIGTERM)" in out, out[-3000:]
    assert list(out_root.glob("*/emergency.ckpt.pt")), out[-3000:]
    after_first = max_meta_epoch()
    assert after_first >= 1

    rc, out = run_and_preempt()
    assert rc == 0, out[-3000:]
    assert "checkpoint restored from" in out and "preempted (SIGTERM)" in out, out[-3000:]
    assert max_meta_epoch() > after_first
