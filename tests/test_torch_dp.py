"""Data parallelism of the port (``cmh_torch/parallel/dp.py``) on the CPU:
two gloo ranks, each a process started through ``run.multi_host``
(``process_id`` 0 and 1) with ``python -m cmh_torch.main``, at tiny shapes.

- DCMHT (the image head's BatchNorm), DNPH (dropout 0.2 in its heads, its
  proxies on SGD, the global batch's noise assignment) and MITH (its memory
  banks, written at the global batch's indices), 1 epoch of 2 steps
  at a global batch of 16 and its ``valid``: the epoch loss and the
  parameters equal the single process's at the same global batch (loss
  1e-6 relative; parameters within 1e-5: the towers' gradients are summed
  over two shards instead of one batch, and the flat BertAdam of the single
  process adds its clip norms in another order than the ranks' tree one),
  and are bit-equal across the ranks, BatchNorm statistics and MITH's banks
  included (the banks within 1e-5 of the single process's); the
  dropout masks are drawn at the global shape (the elements drawn equal the
  single process's); the four mAPs are equal on both ranks and to the single
  process's (1e-12); only rank 0 wrote files. BertAdam's ε is 1e-3 and the
  schedule constant: at ε 1e-6 an element whose gradient is fp32 noise
  (the attention key biases' true gradient is 0) steps by up to the whole
  lr on either side.
- The first step's loss of the two ranks from cmh_tpu's initial weights is
  cmh_tpu's 2-device mesh step's on the same batch (rtol 1e-4, as
  ``tests/test_parallel.py:62-82``).
- A SIGTERM that reaches rank 1 alone stops both ranks at the same step,
  and rank 0 writes the emergency checkpoint. Restarted with
  ``run.auto_resume``, where only rank 0's save root holds that file, both
  ranks resume from it: they run the same epochs, hold bit-equal
  parameters, step counts and best tracking, and match a single process
  resumed from the same file (loss 1e-6 relative, parameters 1e-5, mAPs
  1e-12).
- A batch that two ranks do not divide raises cmh_tpu's named
  ``ValueError``; ``--distribute`` without two cards, ``run.distribute``
  in a trainer built outside the CLI's group, and ``run.tp`` outside a group
  that it divides raise.

Each subprocess has its own timeout, so a hang fails the test. Run as
``python -m tests.test_torch_dp <mode> ...``, this file is the worker.
"""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest
from tests import torch_threads  # noqa: F401  (before any torch work)
import torch
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240


def _cfg(arch, **run):
    return {
        "model": {"arch": arch, "clip_path": "/nonexistent.pt", "clip_variant": "tiny",
                  "hash_func": "softmax" if arch == "DCMHT" else "tanh", "numclass": 4,
                  "noise_alpha": 0.1, "top_k_label": 4},
        "optimizer": {"arch": "BertAdam", "lr": 0.002, "clip_lr": 0.0005,
                      "warmup_proportion": 0.0, "schedule": "warmup_constant", "e": 1e-3,
                      "loss": {"lr": 0.01}},
        "dataset": {"arch": "synthetic_dataset", "name": "synthetic", "num_classes": 4,
                    "image_resolution": 32, "max_word": 12},
        "run": {"arch": arch + "Trainer", "output_dim": 8, "batch_size": 16,
                "is_train": True, "train_num": 32, "query_num": 16, "epochs": 1,
                "display_step": 1000, "seed": 5, **run},
    }


def _free_port():
    from cmh_torch.parallel.dp import free_port

    return free_port()


def _spawn(tmp_path, name, mode, cfg, *extra):
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    out = tmp_path / f"{name}.pt"
    cmd = [sys.executable, "-m", "tests.test_torch_dp", mode, str(path), str(out), *extra]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            env=dict(os.environ, OMP_NUM_THREADS="2"))
    return proc, out


def _wait(jobs):
    """Each job's result, or the test fails with its output."""
    results = []
    for proc, out in jobs:
        try:
            log, _ = proc.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for p, _ in jobs:
                p.kill()
            pytest.fail(f"a worker hung past {TIMEOUT} s")
        assert proc.returncode == 0, log.decode()[-4000:]
        results.append(torch.load(out, weights_only=False))
    return results


def _dp(port, rank):
    return {"multi_host": True, "distributed_port": port, "num_processes": 2,
            "process_id": rank}


@pytest.fixture(scope="module", params=["DCMHT", "DNPH", "MITH"])
def runs(request, tmp_path_factory):
    """The single process and the two ranks of one method through the CLI,
    all three at once."""
    arch = request.param
    tmp = tmp_path_factory.mktemp(arch)
    port = _free_port()
    jobs = [_spawn(tmp, "single", "cli", _cfg(arch), str(tmp / "out_single"))]
    jobs += [_spawn(tmp, f"rank{r}", "cli", _cfg(arch, **_dp(port, r)), str(tmp / f"out_rank{r}"))
             for r in (0, 1)]
    single, r0, r1 = _wait(jobs)
    return arch, tmp, single, r0, r1


def test_two_ranks_are_the_single_process_at_the_global_batch(runs):
    arch, _, single, r0, r1 = runs
    assert r0["world"] == r1["world"] == 2 and single["world"] is None
    assert not r0["flat"] and single["flat"]     # tree BertAdam on the group, as on a mesh
    loss = single["history"][0]["loss"]
    for r in (r0, r1):
        assert len(r["step_losses"]) == 2
        assert abs(r["history"][0]["loss"] - loss) <= 1e-6 * abs(loss)
        worst = max(float((r["model"][k] - single["model"][k]).abs().max())
                    for k in single["model"])
        assert worst <= 1e-5, worst
    for k in r0["model"]:
        assert torch.equal(r0["model"][k], r1["model"][k]), k
    for a, b in zip(r0["optimizer"]["groups"], r1["optimizer"]["groups"]):
        for x, y in zip(a["m"] + a["v"], b["m"] + b["v"]):
            assert torch.equal(x, y)
    assert r0["step_losses"] == r1["step_losses"]
    # the masks are drawn at the global shape on every rank
    assert r0["mask_elements"] == r1["mask_elements"] == single["mask_elements"]
    if arch == "DNPH":
        assert single["mask_elements"] > 0
        for r in (r0, r1):   # the proxies, outside BertAdam, stay equal too
            assert r["extra"] == r0["extra"]
    elif arch == "MITH":
        # the banks are written from the global batch's indices on every rank
        for name, bank in single["method_state"].items():
            assert torch.equal(r0["method_state"][name], r1["method_state"][name]), name
            assert float((r0["method_state"][name] - bank).abs().max()) <= 1e-5, name
    else:
        stats = [k for k in single["model"] if "running_" in k]
        assert stats
        for k in stats:
            assert float((r0["model"][k] - single["model"][k]).abs().max()) <= 1e-5, k


def test_maps_are_equal_and_only_rank_0_writes(runs):
    arch, tmp, single, r0, r1 = runs
    assert r0["history"][0]["maps"] == r1["history"][0]["maps"]
    np.testing.assert_allclose(r0["history"][0]["maps"], single["history"][0]["maps"],
                               rtol=0, atol=1e-12)
    assert (r0["best"] == r1["best"]) and r0["best"][0] > 0
    assert not os.path.exists(tmp / "out_rank1")
    (stamp,) = os.listdir(tmp / "out_rank0")
    wrote = sorted(os.listdir(tmp / "out_rank0" / stamp))
    assert "mat_files" in wrote and "log" in wrote and any(w.startswith("model-") for w in wrote)
    assert sorted(os.listdir(tmp / "out_rank0" / stamp / "mat_files")) == [
        "i2t-best.mat", "last.mat", "t2i-best.mat"]


@pytest.mark.parametrize("runs", ["DCMHT"], indirect=True)
def test_distribute_alone_runs_a_group_of_one(runs, tmp_path):
    """``run.distribute: true`` without a group starts one of one process
    (gloo here), trains on the data-parallel path and leaves the group at
    the end; its collectives are identities, so its epoch loss and mAPs are
    the single process's (the loss within 1e-6 relative: its BertAdam is the
    tree path)."""
    from cmh_torch.main import main
    from cmh_torch.parallel import dp

    arch, _, single, _, _ = runs
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(_cfg(arch, distribute=True)))
    tr = main(["--config-file", str(path), "--save-dir", str(tmp_path / "o"), "--device", "cpu"])
    assert tr.dp.world == 1 and not tr.optimizer.flat and dp.current() is None
    loss = single["history"][0]["loss"]
    assert abs(tr.history[0]["loss"] - loss) <= 1e-6 * abs(loss)
    np.testing.assert_allclose(tr.history[0]["maps"], single["history"][0]["maps"],
                               rtol=0, atol=1e-12)


def test_a_resume_that_rank_0_alone_sees_reaches_every_rank(tmp_path):
    port = _free_port()
    # epoch 1, step 1: rank 1 alone is sent SIGTERM
    jobs = [_spawn(tmp_path, f"first{r}", "preempt", _cfg("DCMHT", epochs=2, **_dp(port, r)),
                   str(tmp_path / f"root{r}")) for r in (0, 1)]
    first = _wait(jobs)
    for r in first:
        assert [h["epoch"] for h in r["history"]] == [0] and len(r["step_losses"]) == 3
    assert not os.path.exists(tmp_path / "root1")
    (stamp,) = os.listdir(tmp_path / "root0")
    emergency = tmp_path / "root0" / stamp / "emergency.ckpt.pt"
    assert emergency.exists()
    port = _free_port()
    jobs = [_spawn(tmp_path, f"again{r}", "cli",
                   _cfg("DCMHT", epochs=2, auto_resume=True, **_dp(port, r)),
                   str(tmp_path / f"root{r}")) for r in (0, 1)]
    jobs.append(_spawn(tmp_path, "single", "cli",
                       _cfg("DCMHT", epochs=2, resume_checkpoint=str(emergency)),
                       str(tmp_path / "single")))
    r0, r1, single = _wait(jobs)
    for r in (r0, r1, single):
        assert [h["epoch"] for h in r["history"]] == [1] and len(r["step_losses"]) == 2
        assert r["global_step"] == 5
    for k in r0["model"]:
        assert torch.equal(r0["model"][k], r1["model"][k]), k
    assert r0["step_losses"] == r1["step_losses"] and r0["best"] == r1["best"]
    assert r0["best"][2:] == single["best"][2:]
    np.testing.assert_allclose(r0["best"][:2], single["best"][:2], rtol=0, atol=1e-12)
    loss = single["history"][0]["loss"]
    assert abs(r0["history"][0]["loss"] - loss) <= 1e-6 * abs(loss)
    worst = max(float((r0["model"][k] - single["model"][k]).abs().max()) for k in single["model"])
    assert worst <= 1e-5, worst
    np.testing.assert_allclose(r0["history"][0]["maps"], single["history"][0]["maps"],
                               rtol=0, atol=1e-12)


def test_first_step_is_cmh_tpus_two_device_mesh_step(tmp_path):
    """From cmh_tpu's initial weights and on its batch, the two ranks' first
    loss is the loss of cmh_tpu's step on a 2-device mesh."""
    import jax
    import jax.numpy as jnp

    from cmh_torch.models import convert
    from cmh_tpu.config import config_from_dict
    from cmh_tpu.parallel.mesh import shard_batch
    from cmh_tpu.registry import registry

    cfg = _cfg("DCMHT", save_dir=str(tmp_path / "jax"), log_dir=str(tmp_path / "jax_log"),
               distribute=True)
    tr = registry.get_runner_class("DCMHTTrainer").from_config(
        cfg=config_from_dict(cfg), world_size=2, distributed=True, auto_run=False)
    assert tr.mesh.shape["dp"] == 2
    batch = next(iter(tr.train_loader))
    weights = convert.dcmht_state_from_jax(
        *jax.tree_util.tree_map(np.asarray, (tr.state.params,
                                             tr.state.model_state["batch_stats"])))
    torch.save(weights, tmp_path / "weights.pt")
    np.savez(tmp_path / "batch.npz", **batch)
    _, want, _ = tr._train_step(tr.state, shard_batch(batch, tr.mesh))
    port = _free_port()
    run = {k: v for k, v in cfg["run"].items()
           if k not in ("arch", "save_dir", "log_dir", "distribute")}
    jobs = [_spawn(tmp_path, f"rank{r}", "step", _cfg("DCMHT", **run, **_dp(port, r)),
                   str(tmp_path / "weights.pt"),
                   str(tmp_path / "batch.npz")) for r in (0, 1)]
    r0, r1 = _wait(jobs)
    assert r0["step_losses"] == r1["step_losses"]
    np.testing.assert_allclose(r0["step_losses"][0], float(jnp.asarray(want)), rtol=1e-4)


def test_a_batch_the_ranks_do_not_divide_raises(monkeypatch, tmp_path):
    from cmh_torch.config import config_from_dict
    from cmh_torch.parallel import dp
    from cmh_torch.registry import load_components

    monkeypatch.setattr(dp, "current", lambda: dp.Group(0, 2, torch.device("cpu")))
    cfg = _cfg("DCMHT", batch_size=15, save_dir=str(tmp_path / "a"),
               log_dir=str(tmp_path / "log"))
    with pytest.raises(ValueError, match=r"run.batch_size=15 is not divisible by the "
                                         r"data-parallel world \(2 processes\)"):
        load_components().require_runner_class("DCMHTTrainer").from_config(
            cfg=config_from_dict(cfg), device="cpu", auto_run=False)
    with pytest.raises(ValueError, match="e.g. 16"):
        dp.check_batch_divisible(15, 2)


def test_distribute_needs_two_cards_and_tp_still_raises(tmp_path):
    from cmh_torch.config import config_from_dict
    from cmh_torch.main import main
    from cmh_torch.registry import load_components

    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(_cfg("DCMHT")))
    with pytest.raises(AssertionError, match="more than one device"):
        main(["--config-file", str(path), "--save-dir", str(tmp_path / "o"), "--device", "cpu",
              "--distribute"])
    # tensor parallelism needs a group that it divides: a trainer outside one
    # is one process (tests/test_torch_tp.py runs it)
    cfg = _cfg("DCMHT", tp=2, save_dir=str(tmp_path / "b"), log_dir=str(tmp_path / "log"))
    with pytest.raises(ValueError, match="1 devices not divisible by tp=2"):
        load_components().require_runner_class("DCMHTTrainer").from_config(
            cfg=config_from_dict(cfg), device="cpu", auto_run=False)
    # the CLI's run_config alone opens groups; a trainer only reads one
    cfg = _cfg("DCMHT", distribute=True, save_dir=str(tmp_path / "c"),
               log_dir=str(tmp_path / "log"))
    with pytest.raises(ValueError, match="run.distribute needs a data-parallel group"):
        load_components().require_runner_class("DCMHTTrainer").from_config(
            cfg=config_from_dict(cfg), device="cpu", auto_run=False)


# ------------------------------------------------------------------ worker
def _worker(mode, cfg_path, out, *extra):
    import cmh_torch.main as cli
    from cmh_torch.models.common import Dropout
    from cmh_torch.parallel import dp
    from cmh_torch.runners.base import BaseTrainer

    losses = []
    step = BaseTrainer.train_step

    def recorded(self, batch):
        loss, loss_dict = step(self, batch)
        losses.append(float(loss))
        return loss, loss_dict

    if mode == "preempt":
        def recorded(self, batch):   # noqa: F811  (SIGTERM to rank 1 after its third step)
            loss, loss_dict = step(self, batch)
            losses.append(float(loss))
            if self.dp.rank == 1 and self.global_step == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            return loss, loss_dict

    BaseTrainer.train_step = recorded
    if mode in ("cli", "preempt"):
        (save_dir,) = extra
        tr = cli.main(["--config-file", cfg_path, "--save-dir", save_dir, "--device", "cpu"])
        group = tr.dp
    else:
        from cmh_torch.config import load_config
        from cmh_torch.registry import load_components

        weights, batch_file = extra
        cfg = load_config(cfg_path)
        cfg.run.update({"save_dir": os.path.dirname(out), "log_dir": None})
        cli.maybe_init_distributed(cfg, "cpu")
        tr = load_components().require_runner_class(cfg.run.arch).from_config(
            cfg=cfg, device="cpu", auto_run=False)
        tr.model.load_state_dict(torch.load(weights, weights_only=True))
        tr.train_step(dict(np.load(batch_file)))
        group = tr.dp
        dp.shutdown()
    world = group.world if group is not None else None
    torch.save({"world": world, "flat": tr.optimizer.flat, "step_losses": losses,
                "global_step": tr.global_step,
                "history": tr.history, "model": tr.model.state_dict(),
                "optimizer": tr.optimizer.state_dict(),
                "extra": {k: o.state_dict()["state"] for k, o in tr.extra_optimizers.items()},
                "mask_elements": Dropout.mask_elements, "method_state": tr.method_state,
                "best": (tr.max_mapi2t, tr.max_mapt2i, tr.best_epoch_i, tr.best_epoch_t)}, out)


if __name__ == "__main__":
    _worker(*sys.argv[1:])
