"""Open-loop text search through the port's HTTP server.

Set-up makes the weights, builds the method's eval encoders (the CLIP
tensors through ``load_pretrained_backbone``, the heads into the model), fills a
``RetrievalIndex`` with ``gallery`` random codes from the seed in chunks,
and serves it with ``make_server`` on 127.0.0.1 at a port the system
picks, in this process; ``warm_requests`` requests then warm every shape.
The window is a child process (``loadgen.py``, no torch) sending
``POST /search_text`` with one caption each at Poisson arrivals of
``rate`` a second for ``--seconds``: one fixed set of gaps and caption
lengths (``arrival_seed``), in an order and with words drawn from the
seed. Each request is timed from when it was due. With ``--trace 1`` a second window of ``trace_seconds`` runs under
the profiler with spans around the app's ``handle_post``, the encoders'
``encode_text``, the index's ``search`` and K4.

``correct``: every request of the window is answered; then, for a sample
drawn from the seed (and the longest caption), the same app and encoders
tokenize and encode the caption again once the window has closed, and the
reference tokenizes it (``tokens_differ``: the port's ids differ), runs
the text tower and head in float32 (``code_margin``: the widest reference
margin of a bit the port's code set the other way), and ranks the whole
gallery, made again from the seed, for the port's code (``topk_mismatch``:
answers whose distances or indices differ from the exact top-k).
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import threading

import numpy as np
import torch

from .. import flops, inputs, spec, weights
from ..common import GALLERY, INPUTS, SAMPLE, Check, Outcome, code_margin, generator, mark
from ..loadgen import TIMEOUT_S, drive
from ..reference import retrieval, tokenizer
from ..reference.clip import exact_fp32
from ..reference.training import bare
from ..trace import Spans, trace_window

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def encoders(ctx):
    """The port's eval encoders of the configuration, on the card."""
    from cmh_torch.export import LoadedEncoders
    from cmh_torch.models.clip.loader import infer_config
    from cmh_torch.registry import load_components

    cfg = ctx.cfg
    glue = spec.method(cfg)
    _, clip, heads = weights.make(cfg, ctx.seed, ctx.device)
    sd = {k: v.float() for k, v in clip.items()}
    method = load_components().require_model_class(glue.ARCH).from_config(
        dict(cfg["model"]), output_dim=cfg["output_dim"],
        clip_cfg=infer_config(sd, dtype=DTYPES[cfg["dtype"]]))
    method.load_pretrained_backbone(sd)
    glue.load_heads(method.model, heads)
    method.model.to(ctx.device)
    return LoadedEncoders(method, ctx.device)


def gallery(ctx, sink) -> None:
    """The gallery's ±1 codes from the seed, chunk by chunk, into ``sink``."""
    tr = ctx.traffic
    g = generator(ctx.seed, GALLERY, ctx.device)
    for _ in range(tr["gallery"] // tr["gallery_chunk"]):
        sink(inputs.gallery_chunk(g, tr["gallery_chunk"], ctx.cfg["output_dim"], ctx.device))


def schedule(ctx, seconds: float, stream: int):
    """(due_s, caption) pairs: ``rate x seconds`` Poisson gaps and caption
    lengths, one fixed set of the traffic (``arrival_seed``), in an order
    and with words drawn from the seed, so that every seed offers the same
    work."""
    tr = ctx.traffic
    n = max(1, round(tr["rate"] * seconds))
    fixed = torch.Generator().manual_seed(tr["arrival_seed"] + stream)
    gaps = -torch.log1p(-torch.rand(n, generator=fixed, dtype=torch.float64))
    words = torch.randint(tr["min_words"], tr["max_words"] + 1, (n,), generator=fixed)
    g = generator(ctx.seed, INPUTS + 8 * stream, "cpu")
    gaps = gaps[torch.randperm(n, generator=g)] * (seconds / float(gaps.sum()))
    words = words[torch.randperm(n, generator=g)]
    due = torch.cumsum(gaps, 0) - gaps[0]
    captions = [inputs.text_captions(g, 1, int(w), int(w))[0] for w in words]
    return list(zip(due.tolist(), captions))


def window(ctx, port: int, plan, tag: str) -> dict:
    """Send ``plan`` from the load generator's own process; its results."""
    path = ctx.tmp / f"{tag}-schedule.json"
    out = ctx.tmp / f"{tag}-results.json"
    with open(path, "w") as f:
        json.dump([[due, "/search_text", {"text": [c], "topk": ctx.traffic["topk"]}]
                   for due, c in plan], f)
    subprocess.run([sys.executable, "-m", "cmhbench.loadgen", str(path), str(port), str(out)],
                   cwd=spec.ROOT, check=True, timeout=plan[-1][0] + 2 * TIMEOUT_S + 60)
    with open(out) as f:
        return json.load(f)


def latencies_ms(results):
    """Each request's latency in ms; one that failed or timed out counts
    as the generator's timeout, past every limit."""
    return [r["latency_s"] * 1e3 if r.get("status") == 200 and r.get("latency_s") is not None
            else TIMEOUT_S * 1e3 for r in results]


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]


@contextlib.contextmanager
def served(ctx):
    """The port's encoders and index of the cell behind ``make_server`` on
    127.0.0.1, warmed by ``warm_requests`` requests; yields (port, app)."""
    from cmh_torch.models.clip.tokenizer import SimpleTokenizer
    from cmh_torch.server import RetrievalApp, make_server
    from cmh_torch.serving import RetrievalIndex

    cfg, tr = ctx.cfg, ctx.traffic
    enc = encoders(ctx)
    mark(ctx, "encoders built")
    index = RetrievalIndex(cfg["output_dim"], device=ctx.device)
    gallery(ctx, index.add)
    mark(ctx, "gallery made")
    app = RetrievalApp(index, enc, SimpleTokenizer(), backend="device",
                       max_words=cfg["max_word"], default_topk=tr["topk"])
    server = make_server(app, "127.0.0.1", 0)
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    try:
        port = server.server_address[1]
        for _, c in schedule(ctx, tr["warm_requests"] / tr["rate"], 2):
            drive([[0.0, "/search_text", {"text": [c], "topk": tr["topk"]}]], port)
        mark(ctx, "warm requests answered")
        yield port, app
    finally:
        server.shutdown()
        server.server_close()
        serving.join(timeout=60)


def run(ctx) -> Outcome:
    from cmh_torch.export import LoadedEncoders
    from cmh_torch.ops import hamming
    from cmh_torch.server import RetrievalApp
    from cmh_torch.serving import RetrievalIndex

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    result, spans = {}, Spans()
    with served(ctx) as (port, app):
        plan = schedule(ctx, ctx.seconds, 0)
        timed = window(ctx, port, plan, "window")
        mark(ctx, "window closed")
        setup_s = timed["start_wall"] - ctx.started
        lat = latencies_ms(timed["results"])
        host = {"latency_ms": lat, "late_ms": [r["late_s"] * 1e3 for r in timed["results"]],
                "bound_s_per_request": flops.text_forward(cfg["clip"], cfg["max_word"])
                / flops.PEAK["bf16"] + tr["gallery"] * cfg["output_dim"] / 8
                / flops.HBM_BYTES_PER_S}
        if ctx.trace:
            spans.add(RetrievalApp, "handle_post", "handle_post")
            spans.add(LoadedEncoders, "encode_text", "encode_text")
            spans.add(RetrievalIndex, "search", "index_search")
            spans.add(hamming, "_launch", "k4",
                      lambda c, q, g, bits: (int(q.shape[0]), int(g.shape[0]), int(q.shape[1]),
                                             hamming.out_dtype(bits, int(q.shape[1])).itemsize))
            try:
                with trace_window(ctx.tmp, result):
                    traced = window(ctx, port, schedule(ctx, tr["trace_seconds"], 1), "traced")
            finally:
                spans.remove()
            host["trace_latency_ms"] = latencies_ms(traced["results"])
            host["span_ms"] = {k: [s * 1e3 for s in v] for k, v in spans.host_s.items()}
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        sample = sampled(ctx, plan, timed["results"])
        encoded = {i: port_code(app, plan[i][1]) for i in sample}
        del app
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    checks = check(ctx, plan, timed["results"], encoded)
    mark(ctx, "reference done")
    failed = sum(1 for r in timed["results"] if r.get("status") != 200)
    return Outcome(e2e={"search_p95_ms": percentile(lat, 95), "setup_s": setup_s},
                   attempted=len(plan), failed=failed, memory_peak_bytes=int(peak),
                   checks=checks, host=host, trace=result.get("trace"))


def sampled(ctx, plan, results):
    """The answered requests to check: a sample drawn from the seed and the
    longest caption."""
    answered = [i for i, r in enumerate(results) if r.get("status") == 200]
    g = generator(ctx.seed, SAMPLE, "cpu")
    pick = torch.randperm(len(answered), generator=g)[:ctx.traffic["check_requests"]].tolist()
    sample = {answered[i] for i in pick}
    if answered:
        sample.add(max(answered, key=lambda i: len(plan[i][1].split())))
    return sorted(sample)


def port_code(app, caption: str):
    """(the port's token ids, its code) of ``caption`` by the app's own
    tokenizer and encoders, as ``/search_text`` makes them, one a call."""
    from cmh_torch.models.clip import tokenizer as port_tokenizer

    ids, mask = port_tokenizer.tokenize_caption(app.tokenizer, caption, app.max_words)
    return ids.tolist(), app.encoders.encode_text(ids[None], mask[None])[0]


def check(ctx, plan, results, encoded):
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    failed = sum(1 for r in results if r.get("status") != 200)
    ids, codes, replies, tokens_differ = [], [], [], 0
    for i, (port_ids, code) in sorted(encoded.items()):
        t = tokenizer.encode(plan[i][1], cfg["max_word"])
        if list(t) != port_ids:
            tokens_differ += 1
            continue
        ids.append(t)
        codes.append(torch.as_tensor(np.asarray(code), dtype=torch.float32))
        replies.append(results[i]["reply"])
    margin, mismatch = 0.0, 0
    if ids:
        ref = spec.reference(cfg)
        P = bare(weights.reference_params(cfg, ctx.seed, dev))
        codes = torch.stack(codes).to(dev)
        with exact_fp32(), torch.no_grad():
            out = ref.text_codes(P, torch.tensor(ids, device=dev))
        margin = code_margin(codes, ref.bits(out))
        del P
        packed = []
        gallery(ctx, lambda chunk: packed.append(retrieval.pack_bytes(chunk)))
        packed = torch.cat(packed)
        for code, reply in zip(codes, replies):
            dist, idx = retrieval.topk(retrieval.pack_bytes(code[None])[0], packed, tr["topk"])
            if (dist.tolist() != reply["dist"][0]) or (idx.tolist() != reply["idx"][0]):
                mismatch += 1
    lim = ctx.limits
    return [Check("requests_failed", failed, lim["requests_failed"]),
            Check("tokens_differ", tokens_differ, lim["tokens_differ"]),
            Check("code_margin", margin, lim["code_margin"]),
            Check("topk_mismatch", mismatch, lim["topk_mismatch"])]
