"""The port as the kinds build it: a trainer whose weights come from the
benchmark's seed through the port's own load paths, and the wrappers of the
traced window."""

from __future__ import annotations

import logging
import math

import torch

from .. import spec, weights
from ..common import mark


def logger() -> logging.Logger:
    """The port's log, warnings and errors only, on standard error."""
    log = logging.getLogger("cmhbench.program")
    if not log.handlers:
        log.addHandler(logging.StreamHandler())
        log.setLevel(logging.WARNING)
        log.propagate = False
    return log


def t_total(cfg: dict, batch: int) -> int:
    """BertAdam's schedule length: the reference's train set in batches of
    ``batch``, over its epochs."""
    return math.ceil(cfg["run"]["train_num"] / batch) * cfg["run"]["epochs"]


def trainer(ctx, batch: int):
    """The trainer of the configuration's method (``methods/<method>.py``):
    the CLIP tensors written as an fp16 state dict at ``model.clip_path``
    (its geometry and its towers), the heads loaded into its model; the
    configuration's ``run`` keys over the run's own. Returns (trainer, the
    weights' fp16 buffer, the CLIP tensors, the head tensors) with the
    tensors on the card."""
    from cmh_torch.config import config_from_dict
    from cmh_torch.registry import load_components

    cfg = ctx.cfg
    method = spec.method(cfg)
    half, clip, heads = weights.make(cfg, ctx.seed, ctx.device)
    mark(ctx, "weights made")
    archive = ctx.tmp / "clip.pt"
    host = half.cpu()
    start = 0
    state = {}
    for name, t in clip.items():
        state[name] = host[start:start + t.numel()].view(t.shape)
        start += t.numel()
    torch.save(state, archive)
    del host, state
    mark(ctx, "archive written")
    run = cfg["run"]
    conf = config_from_dict({
        "model": dict(cfg["model"], arch=method.ARCH, clip_path=str(archive),
                      clip_dtype=cfg["dtype"]),
        "optimizer": cfg["optimizer"],
        "dataset": {"arch": "synthetic_dataset", "name": "cmhbench",
                    "num_classes": cfg["num_classes"], "max_word": cfg["max_word"],
                    "image_resolution": cfg["clip"]["image_resolution"],
                    "num_items": run["train_num"] + 1},
        "run": dict({"arch": method.RUNNER, "output_dim": cfg["output_dim"],
                     "batch_size": batch, "query_num": 1, "is_train": True, "shuffle": False,
                     "save_dir": str(ctx.tmp / "run"), "seed": ctx.seed % (1 << 31)}, **run),
    })
    runner = load_components().require_runner_class(method.RUNNER)
    tr = runner.from_config(cfg=conf, device=str(ctx.device), logger=logger(), auto_run=False)
    archive.unlink()
    mark(ctx, "trainer built")
    method.load_heads(tr.model, heads)
    return tr, half, clip, heads


def kernel_spans(spans, optimizer=None) -> None:
    """Spans around K1's and K2's launches, forward and backward, keeping
    each call's shapes, and around ``step`` of the ``optimizer`` class, if
    given."""
    from cmh_torch.ops import attention, layernorm

    def ln(ctx, x2d, *rest):
        return (int(x2d.shape[0]), int(x2d.shape[1]), x2d.element_size())

    def att(ctx, q, k, v, scale, mask, bias, *rest):
        b, h, s, hd = (int(n) for n in q.shape)
        lengths = ctx.get("lengths") if bias is not None else None
        return (b, h, s, hd, q.element_size(), mask is not None, bias is not None, lengths)

    spans.add(layernorm, "_launch", "k1_fwd", ln)
    spans.add(layernorm, "_launch_bwd", "k1_bwd", ln)
    spans.add(attention, "_launch", "k2_fwd", att)
    spans.add(attention, "_launch_bwd", "k2_bwd", att)
    if optimizer is not None:
        spans.add(optimizer, "step", "optimizer")
