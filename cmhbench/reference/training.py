"""Training steps of a CLIP-tower hashing method in plain PyTorch:
BertAdam, and the step that runs the towers in blocks of rows.

A method's reference (``reference/<method>.py``) hands ``train_steps`` its
``head_loss``: the loss of a batch from the towers' outputs. The towers'
parameters are under ``backbone.``, the heads' under their own names.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .clip import Matmul, Params, encode_image, encode_text, exact_fp32, fp32_matmul

# (bare parameters, image embeddings, text embeddings, labels) -> loss
HeadLoss = Callable[[Params, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def bare(P: Params) -> Params:
    """The parameters with the towers' ``backbone.`` prefix taken off, as
    the towers read them."""
    return {k[len("backbone."):] if k.startswith("backbone.") else k: v for k, v in P.items()}


def lr_factor(step: int, opt: dict, t_total: int) -> float:
    """warmup_cosine over t_total steps, at the steps taken before this one."""
    x = step / t_total
    w = opt["warmup_proportion"]
    return x / w if x < w else 0.5 * (1.0 + math.cos(math.pi * x))


class BertAdam:
    """BertAdam on a dict of parameters: each gradient clipped by its own
    norm, Adam moments without bias correction, weight decay added to the
    update; the towers at ``clip_lr``, the heads at ``lr``. A parameter no
    loss term reaches is updated with a zero gradient."""

    def __init__(self, P: Params, opt: dict, t_total: int):
        self.P, self.opt, self.t_total, self.step_count = P, opt, t_total, 0
        self.m = {k: torch.zeros_like(v) for k, v in P.items()}
        self.v = {k: torch.zeros_like(v) for k, v in P.items()}
        self.clipped = {}            # name -> the gradient the moments took, last step

    @torch.no_grad()
    def step(self, grads: Dict[str, Optional[torch.Tensor]]):
        o = self.opt
        factor = lr_factor(self.step_count, o, self.t_total)
        for name, p in self.P.items():
            g = grads.get(name)
            g = torch.zeros_like(p) if g is None else g
            g = g * min(1.0, o["max_grad_norm"] / (float(g.norm()) + 1e-6))
            self.clipped[name] = g
            self.m[name].mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
            self.v[name].mul_(o["b2"]).addcmul_(g, g, value=1 - o["b2"])
            upd = self.m[name] / (self.v[name].sqrt() + o["e"]) + o["weight_decay"] * p
            lr = o["clip_lr"] if name.startswith("backbone.") else o["lr"]
            p.sub_(lr * factor * upd)
        self.step_count += 1


BUFFERS = ("running_mean", "running_var")


def _step_grads(params: Params, plain: Params, batch: dict, head_loss: HeadLoss, mm: Matmul,
                rows: Optional[int], chunk: int):
    """The loss of one training batch and every parameter's gradient. The
    towers run in blocks of ``chunk`` rows: their outputs first without a
    graph, then the heads and the loss over the whole batch give the
    outputs' gradients, and each block's tower runs again to take its
    part of the towers' gradients; the same arithmetic as one pass, in a
    fraction of the memory."""
    image, text, labels = batch["image"], batch["text"], batch["label"]
    if rows is not None:
        image, text, labels = image[:rows], text[:rows], labels[:rows]
    blocks = [slice(i, i + chunk) for i in range(0, image.shape[0], chunk)]
    with torch.no_grad():
        emb_i = torch.cat([encode_image(plain, image[b], mm) for b in blocks])
        emb_t = torch.cat([encode_text(plain, text[b], mm) for b in blocks])
    emb_i.requires_grad_(True)
    emb_t.requires_grad_(True)
    loss = head_loss(plain, emb_i, emb_t, labels)
    names = list(params)
    got = torch.autograd.grad(loss, [params[n] for n in names] + [emb_i, emb_t],
                              allow_unused=True)
    grads = dict(zip(names, got[:-2]))
    g_i, g_t = got[-2:]
    for p in params.values():
        p.grad = None
    for b in blocks:
        encode_image(plain, image[b], mm).backward(g_i[b])
        encode_text(plain, text[b], mm).backward(g_t[b])
    for n, p in params.items():
        if p.grad is not None:
            grads[n] = p.grad if grads[n] is None else grads[n] + p.grad
            p.grad = None
    return loss.detach(), grads


def train_steps(P: Params, batches: List[dict], head_loss: HeadLoss, opt: dict, t_total: int,
                mm: Matmul = fp32_matmul, rows: Optional[int] = None, chunk: int = 32
                ) -> Tuple[List[float], Dict[str, float], Dict[str, float]]:
    """Train ``P`` (the towers under ``backbone.``, in place) through
    ``batches``: (each step's loss, the first step's clipped gradient norm
    of each parameter, each parameter's norm of change over the steps).
    ``rows``, if given, keeps only the first rows of each batch."""
    params = {k: v for k, v in P.items() if not k.endswith(BUFFERS)}
    start = {k: v.detach().clone() for k, v in params.items()}
    for v in params.values():
        v.requires_grad_(True)
    plain = bare(P)
    opt_state = BertAdam(params, opt, t_total)
    losses, first = [], {}
    with exact_fp32():
        for i, batch in enumerate(batches):
            loss, grads = _step_grads(params, plain, batch, head_loss, mm, rows, chunk)
            losses.append(float(loss))
            opt_state.step(grads)
            if i == 0:
                first = {k: float(g.norm()) for k, g in opt_state.clipped.items()}
            del grads
    change = {k: float((params[k].detach() - start[k]).norm()) for k in params}
    return losses, first, change
