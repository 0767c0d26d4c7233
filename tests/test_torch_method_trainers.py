"""The Baseline, DSPH and DNPH trainers of cmh_torch on the CPU at tiny
shapes (``CLIPConfig.tiny()``, 2 steps an epoch, dropout on).

Each trains two epochs through ``python -m cmh_torch.main`` with finite
losses and four mAPs an epoch. DSPH and DNPH resume at an epoch boundary
bit-equal to the uninterrupted run: the model, BertAdam's moments, the SGD
state of the proxies, dropout masks and DNPH's noise (functions of the run
seed and the step). ``run.remat`` recomputes the forward in the backward
with the same masks: the gradients equal those without it (1e-6 relative,
the same ops), and the forward ops run twice. On DCMHT it still warns.
"""

import logging

import numpy as np
import pytest
import torch_threads  # noqa: F401  (before any torch work)
import torch
import yaml

import cmh_torch.ops.attention as attention_ops
import cmh_torch.ops.layernorm as layernorm_ops
from cmh_torch.config import config_from_dict
from cmh_torch.main import main
from cmh_torch.registry import load_components
from cmh_torch.runners.base import BaseTrainer

METHODS = ("Baseline", "DSPH", "DNPH")


def _cfg(save_dir, arch, run_extra=None, model_extra=None):
    return {
        "model": {"arch": arch, "clip_path": "/nonexistent.pt", "clip_variant": "tiny",
                  "hash_func": "softmax" if arch == "DCMHT" else "tanh", "numclass": 4,
                  "noise_alpha": 0.1, **(model_extra or {})},
        "optimizer": {"arch": "BertAdam", "lr": 0.002, "clip_lr": 0.0005,
                      "warmup_proportion": 0.1, "schedule": "warmup_cosine",
                      "hyp": {"lr": 0.02, "momentum": 0.9, "weight_decay": 0.0005},
                      "loss": {"lr": 0.01}},
        "dataset": {"arch": "synthetic_dataset", "name": "synthetic", "num_classes": 4,
                    "image_resolution": 32, "max_word": 12},
        "run": {"arch": arch + "Trainer", "save_dir": str(save_dir),
                "log_dir": str(save_dir / "log"), "output_dim": 8, "batch_size": 16,
                "is_train": True, "train_num": 32, "query_num": 16, "epochs": 1,
                "display_step": 1000, "seed": 5, **(run_extra or {})},
    }


def trainer(save_dir, arch, **kw):
    cls = load_components().require_runner_class(arch + "Trainer")
    return cls.from_config(cfg=config_from_dict(_cfg(save_dir, arch, **kw)), device="cpu",
                           auto_run=False)


@pytest.mark.parametrize("arch", METHODS)
def test_cli_trains_two_epochs(arch, tmp_path):
    cfg = _cfg(tmp_path / "unused", arch, run_extra={"epochs": 2})
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    tr = main(["--config-file", str(path), "--save-dir", str(tmp_path / "out"),
               "--device", "cpu"])
    assert [h["epoch"] for h in tr.history] == [0, 1]
    for h in tr.history:
        assert np.isfinite(h["loss"]) and len(h["maps"]) == 4
        assert all(0.0 < m <= 1.0 for m in h["maps"])
    assert tr.optimizer.step_count == tr.global_step == 4
    want = {"Baseline": [], "DSPH": ["proxies"], "DNPH": ["proxies"]}[arch]
    assert sorted(tr.extra_optimizers) == want
    bert_adam = {id(p) for g in tr.optimizer.param_groups for p in g["params"]}
    for opt in tr.extra_optimizers.values():
        (p,) = opt.param_groups[0]["params"]
        assert id(p) not in bert_adam and opt.state[p] is not None


def assert_same_state(a, b):
    """Model, BertAdam and the extra optimizers bit-equal."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["step_count"] == ob["step_count"]
    for ga, gb in zip(oa["groups"], ob["groups"]):
        assert torch.equal(ga["m"], gb["m"]) and torch.equal(ga["v"], gb["v"])
    assert a.extra_optimizers.keys() == b.extra_optimizers.keys()
    for name in a.extra_optimizers:
        xa = a.extra_optimizers[name].state_dict()
        xb = b.extra_optimizers[name].state_dict()
        assert xa["param_groups"] == xb["param_groups"]
        assert xa["state"].keys() == xb["state"].keys()
        for i in xa["state"]:
            for k, v in xa["state"][i].items():
                w = xb["state"][i][k]
                assert (v is None and w is None) or torch.equal(v, w), (name, k)


class _Killed(BaseException):
    """A kill that leaves no emergency save."""


@pytest.mark.parametrize("arch", ["DSPH", "DNPH"])
def test_resume_at_epoch_boundary_is_bit_equal(arch, tmp_path, monkeypatch):
    """Dropout on (0.2), shuffle off: 1 epoch + checkpoint + auto-resume of
    epoch 2 ends with the state, trackers and mAPs of 2 uninterrupted
    epochs, the proxies' SGD state included (and DNPH's noise)."""
    run = {"epochs": 2, "shuffle": False}
    whole = trainer(tmp_path / "whole" / "run", arch, run_extra=run)
    whole.train()
    if arch == "DSPH":          # momentum: the buffer must travel in the checkpoint
        (state,) = whole.extra_optimizers["proxies"].state.values()
        assert state["momentum_buffer"].abs().max() > 0

    run.update(checkpoint_every=1, auto_resume=True)
    first = trainer(tmp_path / "root" / "first", arch, run_extra=run)
    orig = BaseTrainer.train_epoch

    def killed_in_epoch_1(self, epoch):
        if epoch == 1:
            raise _Killed()
        return orig(self, epoch)

    monkeypatch.setattr(BaseTrainer, "train_epoch", killed_in_epoch_1)
    with pytest.raises(_Killed):
        first.train()
    monkeypatch.setattr(BaseTrainer, "train_epoch", orig)

    resumed = trainer(tmp_path / "root" / "second", arch, run_extra=run)
    resumed.train()
    assert [h["epoch"] for h in resumed.history] == [1]
    assert resumed.history[0]["loss"] == whole.history[1]["loss"]
    assert resumed.history[0]["maps"] == whole.history[1]["maps"]
    assert_same_state(resumed, whole)
    assert resumed.global_step == whole.global_step


def _counting(monkeypatch):
    counts = {"layernorm": 0, "attention": 0}

    def wrap(module, key):
        orig = module._forward

        def counted(*args):
            counts[key] += 1
            return orig(*args)

        monkeypatch.setattr(module, "_forward", counted)

    wrap(layernorm_ops, "layernorm")
    wrap(attention_ops, "attention")
    return counts


def test_remat_gradients_equal_and_forward_runs_twice(tmp_path, monkeypatch):
    counts = _counting(monkeypatch)
    grads, ops = {}, {}
    for remat in (False, True):
        tr = trainer(tmp_path / str(remat), "DSPH", run_extra={"remat": remat})
        assert tr.remat is remat
        batch = next(iter(tr.train_loader))
        for k in counts:
            counts[k] = 0
        tr.train_step(batch)
        ops[remat] = dict(counts)
        grads[remat] = {n: p.grad.clone() for n, p in tr.model.named_parameters()
                        if p.grad is not None}
    assert grads[True].keys() == grads[False].keys()
    for n, g in grads[False].items():
        diff = (grads[True][n] - g).abs().max() / g.abs().max().clamp(min=1e-30)
        assert diff <= 1e-6, n
    # tiny towers: 2 + 2 blocks, 2·2 + 2 + 2·2 + 1 LayerNorms, 1 + 1 K2 blocks
    assert ops[False] == {"layernorm": 11, "attention": 2}
    assert ops[True] == {"layernorm": 22, "attention": 4}


def test_remat_on_dcmht_still_warns(tmp_path):
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logger = logging.getLogger("synthetic-cpu")
    logger.addHandler(handler)
    try:
        tr = trainer(tmp_path, "DCMHT", run_extra={"remat": True})
    finally:
        logger.removeHandler(handler)
    assert tr.remat is False
    assert any(m.startswith("run.remat ignored: the model carries running statistics")
               for m in records)
