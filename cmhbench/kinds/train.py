"""Steady training through the method's trainer's ``train_step``.

Set-up makes the weights and a pool of distinct batches on the card from
the seed, builds one trainer, and drives it through its first three steps
on pool batches 0, 1 and 2 (the checked steps) and ``warm_steps`` more;
the window then cycles through the pool, one ``train_step`` a batch,
until ``--seconds`` have passed, and ends in a synchronize. With
``--trace 1`` a second window of ``trace_seconds`` runs under the
profiler with spans around K1, K2 and BertAdam's step.

``correct``: once the windows have closed and the trainer is freed, the
reference trains the same weights through the same three batches in
float32. Compared: the first step's gradient of each leaf as BertAdam took it, from its first moment after one
step, and each leaf's change over the three steps, both by the worst leaf:
the gap between the two norms over the reference's norm of that leaf or of
the median leaf, whichever is larger. Leaves whose reference gradient is
under a thousandth of the median leaf's move by round-off alone and are
left out of the change. Each step's loss gap is printed, not compared.
"""

from __future__ import annotations

import statistics
import sys
import time
from typing import Dict, List

import torch

from .. import flops, inputs, spec, weights
from ..common import INPUTS, Check, Outcome, generator, mark, pace
from ..trace import Spans, trace_window
from . import program


def gaps(prog: Dict[str, float], ref: Dict[str, float], names) -> float:
    """The worst leaf's |‖prog‖ − ‖ref‖| over max(‖ref‖ of the leaf, the
    median leaf's ‖ref‖)."""
    names = list(names)
    median = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30) for n in names)


def loss_gap(prog_losses: List[float], ref_losses: List[float]) -> float:
    """The worst step's |loss - reference loss| over the reference loss."""
    return max(abs(p - r) / abs(r) for p, r in zip(prog_losses, ref_losses))


def compare(prog_losses: List[float], prog_grad: Dict[str, float], prog_change: Dict[str, float],
            ref_losses: List[float], ref_grad: Dict[str, float], ref_change: Dict[str, float],
            limits: Dict[str, float]) -> List[Check]:
    """The numbers compared. The loss gap is not among them: no control or
    fault reads it three times what sound runs read (PERF.md, limits)."""
    median = statistics.median(ref_grad.values())
    moving = [n for n in ref_grad if ref_grad[n] >= 1e-3 * median]
    return [Check("grad_gap", gaps(prog_grad, ref_grad, ref_grad), limits["grad_gap"]),
            Check("change_gap", gaps(prog_change, ref_change, moving), limits["change_gap"])]


def first_moment_norms(trainer) -> Dict[str, float]:
    """Each parameter's gradient as BertAdam took it in its one step so
    far: its first moment over (1 - b1)."""
    from cmh_torch.optim.bert_adam import moment_list

    names = {id(p): n for n, p in trainer.model.named_parameters()}
    state = trainer.optimizer.state_dict()
    out = {}
    for group, saved in zip(trainer.optimizer.param_groups, state["groups"]):
        for p, m in zip(group["params"], moment_list(saved["m"], group["params"])):
            out[names[id(p)]] = float(m.norm()) / (1.0 - group["b1"])
    return out


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(ctx) -> Outcome:
    cfg, tr = ctx.cfg, ctx.traffic
    dev, batch = ctx.device, tr["batch"]
    g = generator(ctx.seed, INPUTS, dev)
    pool = [inputs.batch(g, batch, cfg, tr, dev) for _ in range(tr["pool"])]
    lengths = [(b["text"] != 0).sum(1).tolist() for b in pool]
    mark(ctx, "batches made")
    trainer, _, clip, heads = program.trainer(ctx, batch)
    start = {"backbone." + k: v for k, v in clip.items()}
    start.update(heads)

    # the checked steps, then the warm-up
    losses, grad = [], {}
    for s in range(3):
        loss, _ = trainer.train_step(pool[s])
        losses.append(float(loss))
        if s == 0:
            grad = first_moment_norms(trainer)
    change = {n: float((p.detach() - start[n].float()).norm())
              for n, p in trainer.model.named_parameters()}
    del start, clip, heads
    mark(ctx, "checked steps taken")
    for s in range(tr["warm_steps"]):
        trainer.train_step(pool[(3 + s) % len(pool)])
    sync(dev)

    t0 = time.perf_counter()
    setup_s = time.time() - ctx.started
    steps, ends = 0, []
    while True:
        trainer.train_step(pool[steps % len(pool)])
        steps += 1
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= ctx.seconds:
            break
    sync(dev)
    window_s = time.perf_counter() - t0
    mark(ctx, "window closed")
    pace("steps", ends, t0)
    heads = spec.method(cfg).head_flops(cfg)
    host = {"steps": steps, "window_s": window_s, "batch": batch,
            "flops_per_step": batch * flops.pair_train(cfg["clip"], cfg["max_word"], heads)}

    result, spans = {}, Spans()
    if ctx.trace:
        program.kernel_spans(spans, type(trainer.optimizer))
        traced = 0
        try:
            with trace_window(ctx.tmp, result):
                t1 = time.perf_counter()
                while time.perf_counter() - t1 < tr["trace_seconds"]:
                    spans.context["lengths"] = lengths[traced % len(pool)]
                    trainer.train_step(pool[traced % len(pool)])
                    traced += 1
        finally:
            spans.remove()
        host["traced_steps"] = traced
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    del trainer
    checked = pool[:3]
    del pool
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    P = weights.reference_params(cfg, ctx.seed, dev)
    ref = spec.reference(cfg).train_steps(P, checked, cfg["model"], cfg["optimizer"],
                                          program.t_total(cfg, batch),
                                          chunk=tr["reference_chunk"])
    mark(ctx, "reference trained")
    print(f"cmhbench: loss gap {loss_gap(losses, ref[0])!r} (not compared)", file=sys.stderr)
    checks = compare(losses, grad, change, *ref, ctx.limits)
    return Outcome(e2e={"train_pairs_per_s": steps * batch / window_s, "setup_s": setup_s},
                   attempted=steps, failed=0, memory_peak_bytes=int(peak), checks=checks,
                   host=host, trace=result.get("trace"))
