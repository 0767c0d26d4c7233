"""The readings that set each cell's limits from above: the control and
the faults, at the cell's own sizes, on the card.

    python -m cmhbench.control --workload <cell> --seeds <n> [<n> ...]

The control is the reference put in the port's place and computed in the
precision below the configuration's: every product of the towers in fp8
(``reference.clip.fp8_matmul``) below their bf16, and a ``valid``'s mAP
in bf16 below its float32. Its numbers are read against the
float32 reference exactly as a run reads the port's. A training cell also
reads the fault "half of the batch left out, the mean taken over the
rest" (the reference trained on each batch's first half); the fault "a
step that returns its state unchanged" reads 1 on ``change_gap`` and
needs no run. Prints one JSON line a seed. The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import torch

from . import inputs, spec, weights
from .common import INPUTS, SAMPLE, code_margin, generator
from .reference import retrieval, tokenizer
from .reference.clip import exact_fp32, fp8_matmul
from .reference.training import bare
from .run import context


def train_readings(ctx) -> dict:
    from .kinds import program, train

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    g = generator(ctx.seed, INPUTS, dev)
    batches = [inputs.batch(g, tr["batch"], cfg, tr, dev) for _ in range(3)]
    steps = program.t_total(cfg, tr["batch"])
    reference = spec.reference(cfg)

    def steps_of(**kw):
        P = weights.reference_params(cfg, ctx.seed, dev)
        out = reference.train_steps(P, batches, cfg["model"], cfg["optimizer"], steps,
                                    chunk=tr["reference_chunk"], **kw)
        del P
        return out

    ref = steps_of()
    out = {}
    for name, kw in (("control", {"mm": fp8_matmul}),
                     ("half_batch", {"rows": tr["batch"] // 2})):
        got = steps_of(**kw)
        out[name] = {c.name: c.value for c in train.compare(*got, *ref, ctx.limits)}
        out[name]["loss_gap"] = train.loss_gap(got[0], ref[0])
    return out


def search_readings(ctx) -> dict:
    from .kinds import search

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    plan = search.schedule(ctx, ctx.seconds, 0)
    pick = torch.randperm(len(plan), generator=generator(ctx.seed, SAMPLE, "cpu"))
    sample = set(pick[:tr["check_requests"]].tolist())
    sample.add(max(range(len(plan)), key=lambda i: len(plan[i][1].split())))
    ids = torch.tensor([tokenizer.encode(plan[i][1], cfg["max_word"]) for i in sorted(sample)],
                       device=dev)
    reference = spec.reference(cfg)
    P = bare(weights.reference_params(cfg, ctx.seed, dev))
    with exact_fp32(), torch.no_grad():
        ref = reference.bits(reference.text_codes(P, ids))
        ctl = reference.bits(reference.text_codes(P, ids, mm=fp8_matmul))
    return {"control": {"code_margin": code_margin(ctl[0], ref)}}


def valid_readings(ctx) -> dict:
    from .kinds.valid import evaluation_set, reference_codes

    nq = ctx.traffic["query"]
    data = evaluation_set(ctx)
    margin, img, txt = 0.0, [], []
    for (s, e, ri, rt), (_, _, ci, ct) in zip(reference_codes(ctx, data),
                                              reference_codes(ctx, data, fp8_matmul)):
        margin = max(margin, code_margin(ci[0], ri), code_margin(ct[0], rt))
        img.append(ri[0])
        txt.append(rt[0])
    img, txt, lab = torch.cat(img), torch.cat(txt), data["label"]
    args = (img[:nq], txt[:nq], img[nq:], txt[nq:], lab[:nq], lab[nq:])
    # the mAP stage in the precision below float32: the same codes, bf16
    gap = max(abs(a - b) for a, b in zip(retrieval.maps_4dir(*args, dtype=torch.bfloat16),
                                         retrieval.maps_4dir(*args)))
    return {"control": {"code_margin": margin, "map_gap": gap}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=None,
                    help="the window whose requests a search cell samples (run_seconds)")
    args = ap.parse_args(argv)
    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    seconds = args.seconds or bench["run_seconds"]
    for seed in args.seeds:
        t0 = time.time()
        with tempfile.TemporaryDirectory(prefix="cmhbench-") as tmp:
            ctx = context(bench, cell, seed, seconds, False, t0, tmp)
            kind = ctx.traffic["kind"]
            readings = {"train": train_readings, "search": search_readings,
                        "valid": valid_readings}[kind](ctx)
        print(json.dumps({"workload": args.workload, "seed": seed, "readings": readings,
                          "seconds": time.time() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
