"""Runs from a seed, port against cmh_tpu and parts against one process, on
the CPU.

- A tiny DCMHT YAML (the tiny CLIP, 32 synthetic pairs at batch 16)
  through both trainers from ``run.seed``: the same batches, and the losses
  of its first epoch's two steps within 1e-5 relative (each trainer's own
  init; the normal leaves start a few ulps apart).
- Two gloo ranks: each draws its part of a dropout site's mask, rank r's
  heads (tensor parallelism, ``Dropout.shard``) or its rows (a row offset,
  as a data-parallel part would), and the parts put together are one
  process's mask, bit for bit, forward and backward.
"""

import socket

import jax.numpy as jnp
import numpy as np
import torch_threads  # noqa: F401  (before any torch work)
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import cmh_tpu.runners.dcmht  # noqa: F401  (registers cmh_tpu's trainer)
from cmh_torch.config import config_from_dict as port_config
from cmh_torch.models.common import Dropout, dropout_rng
from cmh_torch.ops import random as port_random
from cmh_torch.registry import load_components
from cmh_torch.utils import prng
from cmh_tpu.config import config_from_dict
from cmh_tpu.registry import registry as jax_registry

port_registry = load_components()

TINY = {
    "model": {"arch": "DCMHT", "clip_path": "/nonexistent.pt", "clip_variant": "tiny",
              "hash_func": "softmax"},
    "optimizer": {"arch": "BertAdam", "lr": 0.002},
    "dataset": {"arch": "synthetic_dataset", "name": "synthetic", "num_classes": 4,
                "image_resolution": 32, "max_word": 12},
    "run": {"arch": "DCMHTTrainer", "output_dim": 8, "batch_size": 16, "is_train": True,
            "train_num": 32, "query_num": 16, "epochs": 2, "display_step": 2},
}


def test_tiny_dcmht_two_steps_from_the_seed(tmp_path):
    cfg = {k: dict(v) for k, v in TINY.items()}
    cfg["run"].update(save_dir=str(tmp_path / "jax"), log_dir=str(tmp_path / "jax_log"))
    # each trainer seeds the host generators, then its epoch draws the order
    jtr = jax_registry.get_runner_class("DCMHTTrainer").from_config(
        cfg=config_from_dict(cfg), auto_run=False)
    jbatches = list(jtr.train_loader)
    cfg["run"].update(save_dir=str(tmp_path / "port"), log_dir=str(tmp_path / "port_log"))
    ptr = port_registry.require_runner_class("DCMHTTrainer").from_config(
        cfg=port_config(cfg), device="cpu", auto_run=False)
    losses = []
    for jb, pb in zip(jbatches, ptr.train_loader):
        for k in jb:
            np.testing.assert_array_equal(np.asarray(pb[k]), np.asarray(jb[k]), err_msg=k)
        jtr.state, jloss, _ = jtr._train_step(jtr.state, {k: jnp.asarray(v) for k, v in jb.items()})
        ploss, _ = ptr.train_step(pb)
        losses.append((float(ploss), float(jloss)))
    assert len(losses) == 2 and ptr.optimizer.step_count == int(jtr.state.step) == 2
    for got, want in losses:
        assert abs(got - want) <= 1e-5 * abs(want), losses


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(rank: int, port: int, x: torch.Tensor, key, out: dict) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    try:
        drop = Dropout(0.3).train()
        drop.path, drop.shard = ("hash_module", "layer_0", "self_attn", "attn_drop"), (1, rank, 2)
        heads = x.chunk(2, 1)[rank].clone().requires_grad_(True)
        with dropout_rng(key):
            y = drop(heads)
        y.backward(torch.ones_like(y))
        rows = x.chunk(2, 0)[rank].contiguous()
        part = port_random.dropout(rows, prng.flax_key(key, 7), 0.3,
                                   (0, rank * rows.shape[0], x.shape[0]))
        gathered = {}
        for name, t in (("heads", y.detach()), ("grad", heads.grad), ("rows", part)):
            parts = [torch.empty_like(t) for _ in range(2)]
            dist.all_gather(parts, t.contiguous())
            gathered[name] = parts
        if rank == 0:
            out.update(heads=torch.cat(gathered["heads"], 1), grad=torch.cat(gathered["grad"], 1),
                       rows=torch.cat(gathered["rows"], 0))
    finally:
        dist.destroy_process_group()


def test_two_gloo_ranks_draw_one_process_masks():
    x = torch.from_numpy(np.random.RandomState(3).randn(6, 4, 5, 5).astype(np.float32))
    key = prng.fold_in(prng.PRNGKey(1814), 3)
    with mp.Manager() as manager:
        out = manager.dict()
        mp.spawn(_rank, args=(_free_port(), x, key, out), nprocs=2, join=True)
        got = dict(out)
    drop = Dropout(0.3).train()
    drop.path = ("hash_module", "layer_0", "self_attn", "attn_drop")
    whole = x.clone().requires_grad_(True)
    with dropout_rng(key):
        y = drop(whole)
    y.backward(torch.ones_like(y))
    torch.testing.assert_close(got["heads"], y.detach(), rtol=0, atol=0)
    torch.testing.assert_close(got["grad"], whole.grad, rtol=0, atol=0)
    torch.testing.assert_close(got["rows"], port_random.dropout(x, prng.flax_key(key, 7), 0.3),
                               rtol=0, atol=0)
