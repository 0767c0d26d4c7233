"""Whole ``valid``s back to back through ``valid_codes_and_maps``.

Set-up makes the weights and the evaluation set on the card from the
seed: ``query`` + ``retrieval`` items of 224-px images, token captions and
multi-hot labels, cut into the port's loader batches of ``batch`` rows (the
last one of each set padded with its first items and marked in ``valid``),
and builds a DCMHT trainer whose query and retrieval loaders, counts and
labels are those batches. One whole ``valid`` warms every shape; the window
then runs ``valid``s until ``--seconds`` have passed, each the ±1 codes of
both sets (eval towers and heads) and the 4-direction mAP (K3). With
``--trace 1`` one more ``valid`` runs under the profiler with spans around
K3's two passes.

``correct``: once the windows have closed and the trainer is freed, the
reference encodes every item in float32 (``code_margin``: the widest
reference margin of a bit that the last ``valid``'s codes set the other
way) and computes the four mAPs of the port's codes in float64
(``map_gap``: the largest gap to the port's mAPs). Printed beside them,
not compared: the bits the port set the other way, the share of the
reference's bits whose margin is under the ``code_margin`` limit, and the
largest gap between the port's mAPs and those of the reference's own codes.
"""

from __future__ import annotations

import sys
import time

import torch

from .. import flops, inputs, spec, weights
from ..common import INPUTS, Check, Outcome, code_margin, generator, mark, pace
from ..reference import retrieval
from ..reference.clip import exact_fp32, fp32_matmul
from ..reference.training import bare
from ..trace import Spans, trace_window
from . import program
from .train import sync


def loader(data: dict, first: int, count: int, batch: int):
    """The port's loader batches over items ``first .. first + count`` of
    ``data``: full batches, the last padded with the set's first items."""
    out = []
    for start in range(0, count, batch):
        size = min(batch, count - start)
        rows = torch.arange(start, start + batch, device=data["label"].device) % count
        if size == batch:
            take = {k: v[first + start:first + start + batch] for k, v in data.items()}
        else:
            take = {k: v[first + rows] for k, v in data.items()}
        take["index"] = rows.to(torch.int32)
        take["valid"] = torch.arange(batch, device=rows.device) < size
        out.append(take)
    return out


def evaluation_set(ctx) -> dict:
    """Every item of the query and then the retrieval set: image, text,
    key_padding_mask, label."""
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    n, res = tr["query"] + tr["retrieval"], cfg["clip"]["image_resolution"]
    g = generator(ctx.seed, INPUTS, dev)
    image = torch.empty((n, res, res, 3), device=dev)
    for s in range(0, n, tr["make_chunk"]):
        inputs.images(g, min(tr["make_chunk"], n - s), res, dev, out=image[s:s + tr["make_chunk"]])
    text, kpm = inputs.token_captions(g, n, cfg["max_word"], tr["min_tokens"],
                                      tr["max_tokens"], dev)
    label = inputs.labels(g, n, cfg["num_classes"], cfg["label_p"], dev)
    return {"image": image, "text": text, "key_padding_mask": kpm, "label": label}


def reference_codes(ctx, data: dict, mm=fp32_matmul):
    """The reference's bits (±1 codes, margins) of every item, in blocks,
    as a generator of (start, end, image bits, text bits)."""
    ref = spec.reference(ctx.cfg)
    P = bare(weights.reference_params(ctx.cfg, ctx.seed, ctx.device))
    n, chunk = data["label"].shape[0], ctx.traffic["reference_chunk"]
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        with exact_fp32(), torch.no_grad():
            block = (s, e, ref.bits(ref.image_codes(P, data["image"][s:e], mm=mm)),
                     ref.bits(ref.text_codes(P, data["text"][s:e], mm=mm)))
        yield block


def run(ctx) -> Outcome:
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    nq, nr, batch = tr["query"], tr["retrieval"], tr["batch"]
    data = evaluation_set(ctx)
    label = data["label"]
    mark(ctx, "evaluation set made")

    trainer, _, _, _ = program.trainer(ctx, batch)
    trainer.query_loader = loader(data, 0, nq, batch)
    trainer.retrieval_loader = loader(data, nq, nr, batch)
    trainer.query_num, trainer.retrieval_num = nq, nr
    trainer.query_labels, trainer.retrieval_labels = label[:nq], label[nq:]

    def one_valid(i):
        trainer.history.append({"epoch": i})
        return trainer.valid_codes_and_maps(i)

    one_valid(-1)
    sync(dev)
    mark(ctx, "first valid done")
    t0 = time.perf_counter()
    setup_s = time.time() - ctx.started
    done, map_s, ends = 0, [], []
    while True:
        codes, maps = one_valid(done)
        map_s.append(trainer.history[-1]["map_s"])
        done += 1
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= ctx.seconds:
            break
    sync(dev)
    window_s = time.perf_counter() - t0
    mark(ctx, "window closed")
    pace("valids", ends, t0)
    heads = spec.method(cfg).head_flops(cfg)
    host = {"valids": done, "window_s": window_s, "map_s": map_s,
            "flops_per_valid": (nq + nr) * flops.pair_forward(cfg["clip"], cfg["max_word"],
                                                              heads)}

    result, spans = {}, Spans()
    if ctx.trace:
        from cmh_torch.ops import map_kernel

        spans.add(map_kernel, "map_hist", "k3_hist",
                  lambda c, w, bits, seg_len=None: (
                      *(int(x) for x in w.shape), w.element_size(), bits + 1,
                      -(-int(w.shape[1]) // (seg_len or map_kernel.segment_len(bits)))))
        spans.add(map_kernel, "map_ap", "k3_ap",
                  lambda c, w, start, *rest: (*(int(x) for x in w.shape), w.element_size(),
                                              int(start.shape[2]), int(start.shape[1])))
        try:
            with trace_window(ctx.tmp, result):
                one_valid(done)
        finally:
            spans.remove()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    prog_img = torch.cat([codes[0], codes[2]])
    prog_txt = torch.cat([codes[1], codes[3]])
    del trainer, codes
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    margin, flipped, narrow, own_img, own_txt = 0.0, 0, 0, [], []
    for s, e, b_img, b_txt in reference_codes(ctx, data):
        margin = max(margin, code_margin(prog_img[s:e], b_img), code_margin(prog_txt[s:e], b_txt))
        for prog, (ref, gaps) in ((prog_img[s:e], b_img), (prog_txt[s:e], b_txt)):
            flipped += int((ref != prog.to(ref.device, ref.dtype)).sum())
            narrow += int((gaps < ctx.limits["code_margin"]).sum())
        own_img.append(b_img[0])
        own_txt.append(b_txt[0])
    ref_maps = retrieval.maps_4dir(prog_img[:nq], prog_txt[:nq], prog_img[nq:], prog_txt[nq:],
                                   label[:nq], label[nq:])
    gap = max(abs(a - b) for a, b in zip(maps, ref_maps))
    own_img, own_txt = torch.cat(own_img), torch.cat(own_txt)
    own_maps = retrieval.maps_4dir(own_img[:nq], own_txt[:nq], own_img[nq:], own_txt[nq:],
                                   label[:nq], label[nq:])
    bits_all = 2 * own_img.numel()
    print(f"cmhbench: not compared: {flipped} of {bits_all} bits set the other way; "
          f"{narrow / bits_all!r} of the reference's bits under a margin of "
          f"{ctx.limits['code_margin']!r}; mAP gap to the reference's own codes "
          f"{max(abs(a - b) for a, b in zip(maps, own_maps))!r}", file=sys.stderr)
    mark(ctx, "reference done")
    checks = [Check("code_margin", margin, ctx.limits["code_margin"]),
              Check("map_gap", gap, ctx.limits["map_gap"])]
    return Outcome(e2e={"valid_s": window_s / done, "setup_s": setup_s}, attempted=done,
                   failed=0, memory_peak_bytes=int(peak), checks=checks,
                   host=host, trace=result.get("trace"))
