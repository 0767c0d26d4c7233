#!/usr/bin/env python3
"""Smoke test of the cmh_torch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no ``ok`` line):

1. device and environment: card name and power limit, torch and CUDA
   versions, which optional packages (PIL, yaml, regex) are present;
2. build the six CUDA sources from ``cmh_torch/csrc`` (``ops/_build.py``),
   one ``nvcc`` each, all at once;
3. each kernel against its plain PyTorch version, with its time beside the
   plain version's, one PyTorch library call's and the card's bound (the
   attention kernels also once on the head views of a packed projection,
   which they read in place; K1, K3 and K4 also with a cold L2,
   ``cold_ms``; K3-ap also run twice for the same bits; K4 also beside its
   popcount floor): the forward kernels at the serving path's shapes
   (batch 256), K1-fwd also at the training step's, the backward kernels
   at the training step's (batch 100), K4 at 64 queries against 2^20 + 777
   items (16 and 64 bits), a request's 4 queries against 2^20 (16 bits)
   and 64 against 2^18 at 1,024 and 512 bits (int32), and the mAP
   kernels at coco scale (4 directions of query chunks against 110,000
   items, 80 classes, 16, 64 and 512 bits (int16 words), and 1,024 bits at
   20,000); K1 and K2 also in fp32 at MITH's concept transformer's shapes
   (100 × 16 tokens of width 512; (100, 8, 16, 64)), with the largest
   concept count the fp32 attention kernels hold in shared memory;
4. the full-width ViT-B/32 DCMHT model in fp32 on the card (kernels) and on
   the CPU (plain versions) from one seed: head outputs and codes must agree;
5. one full-width fp32 train step's gradients on 8 pairs, card against CPU;
6. the full-width bf16 model's device time on inputs made on the card: the
   image and the text tower forward at batch 256, and one image + text
   forward and backward at batch 100;
7. serving at full width in bf16: encode a gallery of synthetic images, fill
   a 16-bit index past 2^20 items, start ``cmh_torch.server`` on a local
   port and answer requests over HTTP; every answer must equal the top-k
   of the same query from a CPU copy of the index (plain Hamming), and the
   kernels' launch counters must show the path went through them; then one
   line splits a 4-query search's device time into K4 and the rest;
8. training through the CLI entry point (``cmh_torch.main``) at full width
   in bf16, in a fresh save root made with ``tempfile.mkdtemp`` and removed
   at the end (each checkpoint holds about 1.85 GB):
   a. ``configs/DCMHT/synthetic_tpu.yaml`` as it stands (3 epochs, 18 steps
      and 3 ``valid``s, a full-state checkpoint after each epoch,
      ``auto_resume``): finite losses, the model, checkpoint and ``.mat``
      files, the last mAPs equal to the plain counting rank and the numpy
      oracle on ``last.mat``, and the launch counts worked out from the code;
   b. the same command again: it resumes at epoch 3, trains nothing
      (launches no kernel), and its parameters, BatchNorm statistics,
      optimizer vectors, step counts and best-mAP tracking equal run a's
      bit for bit;
   c. a preemption: SIGTERM from a wrapped ``train_step`` in epoch 1 of a
      run cut to 200 train and 100 query items; the run writes
      ``emergency.ckpt.pt`` and returns, and the same command resumes at
      epoch 1 and finishes with finite losses;
   d. the flat BertAdam over the full-width parameter list with seeded
      gradients, two steps: the card against the CPU's flat path and the
      card's tree path (1e-6), and a second run on the card bit-equal;
   e. ``torch.profiler`` over one more train step of run a's trainer: the
      launches, and the ten kernels with the most device time;
9. pretrained CLIP at full width: a seeded ViT-B/32 in OpenAI's layout (fp16
   tensors and the three integer entries), written as a plain state dict and
   as a TorchScript archive; the DCMHT trainer built with ``clip_path`` at
   each must infer ViT-B/32 and hold every backbone tensor of the file, and
   the eval codes of 256 pairs on the card (K1-fwd, K2-fwd) must agree with
   the CPU model read from the same file (at most 1% of the bits, each near
   the boundary); the files' bytes and the load seconds are printed;
10. Baseline, DSPH and DNPH through the CLI at full width in bf16:
   ``configs/{DSPH,DNPH}/config.yaml`` (Baseline's YAML made here) with the
   synthetic dataset of ``configs/DCMHT/synthetic_tpu.yaml`` and 8 classes,
   2 epochs of 2 steps at batch 100, a checkpoint after each epoch,
   ``auto_resume``, DSPH with ``run.remat``: the launch counts (K1-fwd and
   K2-fwd twice a step under ``remat``), finite losses, the mAPs against the
   recomputation, and a rerun that resumes at epoch 2, trains nothing and
   holds the model, BertAdam and the proxies' SGD state bit for bit. Printed:
   each method's step time (host clock), DSPH's peak memory of a step with
   and without ``remat``, DNPH's host milliseconds a step in the Hungarian
   solve. After DSPH, phase 7's search once more on its exported encoders:
   256 images encoded (codes equal the trainer's) into an index past 2^20
   items, one search through K4 equal to a CPU copy's;
11. MITH and TwDH through the CLI at full width in bf16, as phase 10 runs
   its methods (``configs/{MITH,TwDH}/config.yaml``, TwDH's ``numclass`` 8):
   the launch counts (MITH's fp32 K1 and K2 apart: 8 and 2 a forward and a
   backward), finite losses, every code width's mAPs against the
   recomputation (TwDH: the 512-bit long code and the 16-bit short one), a
   rerun that resumes at epoch 2, trains nothing and holds the model,
   BertAdam, MITH's banks and TwDH's per-width best tracking bit for bit;
   each method's steady step time (host clock) and the fp32 kernels' share
   of a MITH step (torch.profiler);
12. a full-width TwDH ``model-3.msgpack`` in cmh_tpu's layout, written
   from seeded weights by the port's encoder half (the card's machine has
   no flax), read through ``run.resume_model`` in test mode: the eval codes
   of 256 pairs equal those of the model it was written from, the file's
   bytes and the load seconds printed; then ``search_cpu`` for 4 queries on
   phase 7's 16-bit index and on a 512-bit TwDH index of 2^18 items, equal
   to ``search`` through K4, with its host ms and thread count;
13. DIMCH and UMoED through the CLI at full width in bf16, as phase 10 runs
   its methods (``configs/{DIMCH,UMoED}/config.yaml``): the launch counts
   (UMoED's fp32 K1 apart: 3 a decoder layer in each of the two head calls
   a pair, 36 a forward and a backward), finite losses, the mAPs against the
   recomputation, a rerun that resumes at epoch 2, trains nothing and holds
   the model, BertAdam and UMoED's i→i and t→t best tracking bit for bit;
   each method's steady step time (host clock) and its dropout masks drawn
   on the host (masks, elements and host ms a step); UMoED's decoder device
   time against a whole step's; then UMoED's exported encoders over a
   64-bit index of 2^20 items, and phase 12's TwDH encoders (whose code
   tree ``/search_text`` searches by its long code) over its 512-bit index,
   each asked over HTTP with ``--backend device`` and ``--backend cpu``,
   whose answers must be equal.

14. the row-tiled K2 (every S past the one-block kernels' limits) on its
   main path, and the ResNet tower and ``api.py``, at full width:
   a. DCMHT through the CLI with a seeded ViT-L/14 archive in OpenAI's
      layout (fp16, about 0.86 GB) at ``model.clip_path`` of
      ``configs/DCMHT/synthetic_tpu.yaml``'s dataset, 2 epochs of 2 steps at
      batch 100 with their ``valid``s, no full-state checkpoint: the
      inferred geometry, the launch counts (a forward 75 K1 and 34 K2, 23
      of them row-tiled at S = 257; a backward the same), finite losses,
      the mAPs against the recomputation, the steady step time;
   b. ``api.load("ViT-B/16")`` encodes 256 images (K2 at S = 197 through
      the row tiles) and 256 captions from ``api.tokenize``;
   c. phases 4 and 5 for ViT-L/14 in fp32 at batch 4 (head outputs, loss
      and gradients, card against CPU, TF32 off): its vision K2 (S = 257)
      on the fp32 row tiles (3xTF32 on the tensor cores) both ways, 46
      forward and 23 backward;
   d. MITH at 128 bits, one epoch of 2 steps through the CLI (its fp32
      backward at S = 128 on the row tiles);
   e. an RN50 tower at its published geometry from a seeded archive in
      OpenAI's layout: 256 images in bf16 on the card, and 8 in fp32 held
      against the CPU.

15. ``cmh_tpu``'s full-state checkpoint and data parallelism, on the one card:
   a. a full-width DCMHT trainer (``configs/DCMHT/synthetic_tpu.yaml`` cut to
      one epoch of 2 steps) one step past init writes ``checkpoint-last.msgpack``
      in ``cmh_tpu``'s layout, flat and tree; fresh trainers resume each
      through ``run.resume_checkpoint``: the state and the meta bit-equal the
      source's, and one more step on the same batch gives bit-equal
      parameters in all three (the files' bytes and the load seconds printed);
   b. the same YAML through ``cmh_torch.main`` with ``run.distribute`` in an
      NCCL group of one (``run.multi_host``, rank 0 of 1), against the run
      without it: the first step's loss bit-equal, the second, the parameters,
      BatchNorm statistics, moments (tree against flat) and mAPs at stated
      tolerances; both runs' step times;
   c. the query-sharded mAP at coco scale (16 and 512 bits), shards 0 and 1
      of 2 in turn, against the unsharded (1e-12), and the gallery-sharded
      search over ``[cuda:0, cuda:0]`` on phase 7's index against the
      unsharded, bit for bit; their times.

16. tensor parallelism (``run.tp``) on the one card: each run is a set of
   worker processes (``python3 chip_smoke.py --tp-worker <plan>``) in a gloo
   group on cuda:0 (NCCL refuses two ranks on one device), each with a
   timeout; first one process's first steps of the runs below are timed
   here, and the fp32 products of tensor parallelism against the bf16 ones:
   a. the full-width fp32 DCMHT model at tp=2 on grad_parity's 8 pairs, TF32
      off, against one process on the card: loss within 1e-5 relative, the
      gathered gradients within 2e-4 of their largest;
   b. DCMHT in bf16 at dp=2 × tp=2 (phase 15's YAML with ``run.tp: 2``): 2
      steps and the ``valid`` codes and mAPs, the checkpoint gathered and
      written; a fresh tp=2 group resumes it (state bit-equal to the file)
      and takes a step and a ``valid``; the first loss within 1e-3 of one
      process's;
   c. ViT-L/14 (phase 14's archive) at tp=2, batch 20: a step and a
      ``valid``, the row-tiled K2 at 8 heads a rank, the loss within 1e-3 of
      one process's;
   d. UMoED (phase 13's YAML) at tp=2, batch 50: a step and a ``valid``, its
      experts sharded, the loss within 1e-3 of one process's.
   Every rank's K1 and K2 each way, and K3 on the trainers' paths, must
   launch; the all-reduces a step and their bytes are printed.

17. the tools (``cmh_torch/tools``) on the card, each path's launches
   counted apart:
   a. ``build_index`` on phase 8's DCMHT model file (its best i→t epoch) at
      full width, writing an index and encoders: the index's packed words
      equal that epoch's retrieval codes in ``i2t-best.mat``, packed; 4
      queries searched through K4 equal the plain top-k; the encoders
      answer one caption over HTTP (``/search_text``) as the plain top-k of
      its code;
   b. ``all_methods_smoke.run_method`` for all eight methods in process:
      a train step and a ``valid`` each, K1, K2 each way and K3 launched
      each time;
   c. ``profile_train`` at its defaults (ViT-B/32, batch 256, 6 steps): the
      port's K1 and K2 kernels each way among its profiled kernels (their
      ranks printed), and its launches a step those of a DCMHT step
      (``pair_launches``); ``profile_encode`` at its defaults;
   d. ``twdh_matrix`` at its default widths (512 → 16 bits, 80 classes), 40
      epochs: lossless or the epochs it ran, and its saved matrix checked
      again;
   e. ``epoch_ab --scale full`` with ``tools/artifacts/ref_epoch_full.json``:
      1,000 train items at 224 px, batch 100, 2 timed epochs after the warm
      one, read from JPEG files through the native transforms;
   f. one 500×375 → 224 image through the native eval and train transforms
      against their PIL versions on the host: bit-equal, and both times;
   g. ``chip_microbench --quick``.

18. the random streams (``csrc/threefry.cu``): ``threefry_bits`` bit-equal
   to the plain threefry at three keys, 1 to 2^28 words and offsets
   across the counters' hi word; ``dropout_fwd`` and ``dropout_bwd``
   bit-equal to the plain dropout in fp32 and bf16, whole, as a tp shard,
   at a data-parallel row offset, at n = 1, 2, 3 modulo the vector and on
   a view off a 16-byte boundary; the reciprocal quotient against IEEE
   division at every float32 and bfloat16 input for each rate the configs
   use; their times (hot and cold L2) at UMoED's largest mask and a hash
   head's beside the plain version's, ``F.dropout``'s and the bound (32-bit
   integer work at the issue rate, 128 thread-instructions a clock an SM at
   ``clocks.max.sm``); UMoED's dropout launches of a step by size, each
   timed; their launches on phase 13's main paths (the init drawn on the
   card, the masks of every step); UMoED's steady step. No dropout mask is
   drawn on the host in any phase (``Dropout.host_seconds`` stays 0, in
   phase 16's workers too).

Phase 3 holds K1 in fp32 at UMoED's decoder rows (6400, 512) too, and K2 on
the text tower with the causal mask alone (DIMCH's and UMoED's text tower
runs without the key-padding mask), forward and backward; the bf16 K2 rows
carry their cold-L2 time; the row-tiled K2 kernels, each row named after the
kernel it launches: with bf16 operands (``tiled_fwd_mma``, ``tiled_bwd_mma``)
ViT-B/16's (256, 12, 197, 64) and ViT-L/14's (100, 16, 257, 64) forward and
ViT-L/14's backward, and the forward one past the logit rows' shared-memory
limit at (4, 16, 3153, 64), its rows in device memory; in 3xTF32
(``tiled_fwd_tf32``, ``tiled_bwd_tf32``) ViT-L/14's (4, 16, 257, 64) both
ways and MITH's 128-bit (100, 8, 128, 64) backward in fp32.

The last lines are the script's seconds, the card's name and power limit,
one JSON object with a ``kernels`` list, and ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import base64
import copy
import http.client
import importlib.util
import io
import itertools
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
PEAK_OPS = {"bf16": 989e12,      # dense tensor-core bf16
            "tf32": 495e12,      # dense tensor-core TF32
            "fp32": 67e12}       # fp32 FLOPs outside the tensor cores, an FMA counted as two
# 32-bit integer work: an SM sub-partition issues one warp instruction a clock,
# 4 x 32 thread-instructions a clock an SM, at the card's clocks.max.sm
# (int32_ops_per_s); an integer add, rotate or xor is one instruction
INT32_OPS_PER_CLOCK_PER_SM = 128
B = 256                          # serving batch
TRAIN_B = 100                    # configs/DCMHT/synthetic_tpu.yaml batch
MAX_WORDS, CODE_BITS = 32, 16    # configs/DCMHT/config.yaml
COCO_N, COCO_Q, COCO_CLASSES = 110_000, 5_000, 80   # bench.py's coco-scale eval
GALLERY_IMAGES = 2048
MITH_K = 16                      # configs/MITH/config.yaml: 16 concept tokens a pair
UMOED_SLOTS = 64                 # configs/UMoED/config.yaml: setDim, the decoder's rows a pair
FP32_LN_ROWS = ((TRAIN_B * MITH_K, 512, "MITH"), (TRAIN_B * UMOED_SLOTS, 512, "UMoED decoder"))
# (tower, heads, S, masks): the vision tower; the text tower with the key-padding
# mask (six methods) and with the causal mask alone (DIMCH, UMoED)
ATTENTION_CASES = (("vision", 12, 50, None), ("text", 8, MAX_WORDS, "causal+kpm"),
                   ("text", 8, MAX_WORDS, "causal"))
# the row-tiled K2 (S past the one-block limits): (what, batch, heads, S,
# dtype, route); bf16 runs on mma with bf16 operands, fp32 on mma in 3xTF32;
# the bf16 forward past 3152 (hd 64), whose logit rows live in device memory,
# is no model's
TILED_FWD_CASES = (("ViT-B/16 vision", B, 12, 197, "bf16", "tiled"),
                   ("ViT-L/14 vision", TRAIN_B, 16, 257, "bf16", "tiled"),
                   ("ViT-L/14 vision", 4, 16, 257, "fp32", "tiled"),
                   ("past the logit rows", 4, 16, 3153, "bf16", "tiled"))
TILED_BWD_CASES = (("ViT-L/14 vision", TRAIN_B, 16, 257, "bf16", "tiled"),
                   ("ViT-L/14 vision", 4, 16, 257, "fp32", "tiled"),
                   ("MITH 128-bit concepts", TRAIN_B, 8, 128, "fp32", "tiled"))
# numbers the script works out rather than measures: printed on the [kernel]
# lines, kept out of the kernels line
FLOORS = ("popc_floor_ms", "fma_floor_ms")
INDEX_ITEMS = (1 << 20) + 4096   # two gallery blocks of the blocked search
# phase 18: 32-bit integer operations an element of threefry2x32 (20 rounds
# of add, rotate, xor; 5 injections of 2 adds; 2 initial adds; the output
# xor) and of a dropout element (those, the counter, the uniform, the compare)
THREEFRY_OPS, DROPOUT_OPS = 73, 78
# (what, shape): UMoED's largest mask (its decoder's FFN at batch 100, 64
# slots) and the hash heads' (Linear 512 → 256 at batch 100: Baseline's;
# DCMHT has no dropout site)
DROPOUT_CASES = (("UMoED drop_ff", (TRAIN_B, UMOED_SLOTS, 2048)), ("hash head", (TRAIN_B, 256)))
# measured by the training phases, printed by phase 18
RANDOM_STATS = {}
# OpenAI's ViT-L/14 (cmh_tpu/models/clip/api.py:27-31) and RN50 geometries, and
# the integer entries of OpenAI's CLIP files
VIT_L14 = dict(embed_dim=768, vision_layers=24, vision_width=1024, vision_patch_size=14,
               transformer_width=768, transformer_heads=12, transformer_layers=12)
RN50 = dict(layers=(3, 4, 6, 3), width=64, output_dim=1024, heads=32, input_resolution=224)
OPENAI_INTS = {"input_resolution": 224, "context_length": 77, "vocab_size": 49408}
ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
TRAIN_CONFIG = os.path.join(ROOT, "configs", "DCMHT", "synthetic_tpu.yaml")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def seed_key(seed: int):
    """cmh_tpu's ``PRNGKey(seed)`` (``utils/prng.py``): a model built here
    draws cmh_tpu's init from it, on the card."""
    from cmh_torch.utils import prng

    return prng.PRNGKey(seed)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events around the run, after ``warmup`` calls).

    A spin kernel queued first holds the card until the host has queued
    every call, so the events time the card's work and not the host's
    launch rate (tens of microseconds a call through Python)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # the spin's length comes from a second, warm pass: the first calls pay
    # one-time set-up (library handles, kernel selection) that would inflate it
    t = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t) / warmup * iters
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(2 * host_s * 2e9) + 1_000_000)   # ~2 GHz SM clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


COLD_BYTES = 200e6               # 4 times the H100's 50 MB L2


def cold_ms(fn, args, iters: int = 50) -> float:
    """``cuda_ms`` of ``fn(*args)`` with its inputs out of the L2: the calls
    rotate over copies of the tensors ``args``, so many that at least
    ``COLD_BYTES`` of other copies are read between two reads of one."""
    nbytes = sum(a.numel() * a.element_size() for a in args)
    copies = [[a.clone() for a in args] for _ in range(max(2, -(-int(COLD_BYTES) // nbytes) + 1))]
    pick = itertools.cycle(copies)
    return cuda_ms(lambda: fn(*next(pick)), iters=iters)


def bf16_steps_checked(got, want, what: str) -> str:
    """Hold a bf16 kernel result to its plain version: at most 1% of the
    elements (at least one) may differ, each by one bf16 step or by 1e-6.
    Two fp32 results a last bit apart round to neighbouring bf16 values, and
    near 0, where bf16 steps are tiny, fp32 summation noise spans several. A
    kernel that rounds W to bf16 before dV moves about 40% of dV."""
    import torch

    if got.dtype != torch.bfloat16 or want.dtype != torch.bfloat16:
        raise AssertionError(f"{what}: expected bf16, got {got.dtype} and {want.dtype}")

    def ordinal(t):   # bf16 bit patterns in value order, +0 and -0 alike
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -32768 - i, i)

    steps = (ordinal(got) - ordinal(want)).abs()
    far = int(((steps > 1) & ((got.float() - want.float()).abs() > 1e-6)).sum())
    differ = int((steps > 0).sum())
    if far or differ > max(1, steps.numel() // 100):
        raise AssertionError(f"{what}: {differ} of {steps.numel()} bf16 elements differ "
                             f"from plain, {far} by more than one step and 1e-6")
    return f"{differ} of {steps.numel()} bf16 elements differ from plain"


def int32_ops_per_s() -> float:
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_OPS_PER_CLOCK_PER_SM * sm_clock_hz()


def bound(nbytes: float, ops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (int32_ops_per_s() if kind == "int32" else PEAK_OPS[kind]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def entry(name, source, replaces, shape, err, ms, plain_ms, lib_ms, nbytes, ops, kind):
    b_ms, by = bound(nbytes, ops, kind)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "shape": shape, "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": lib_ms}


def reset_counts(counters):
    for c in counters.values():
        c.launches = 0
        for part in ("launches_fp32", "launches_tiled", "launches_tiled_tf32"):
            if hasattr(c, part):
                setattr(c, part, 0)


def read_counts(counters):
    return {k: c.launches for k, c in counters.items()}


def read_fp32(counters):
    """Of the launches, those of the fp32 K1 and K2 kernels."""
    return {k: c.launches_fp32 for k, c in counters.items() if hasattr(c, "launches_fp32")}


def read_tiled(counters):
    """Of the K2 launches, those of the row-tiled kernels (S past the
    one-block limits), and under ``<name>_tf32`` those of them in fp32
    (3xTF32)."""
    out = {}
    for k, c in counters.items():
        if hasattr(c, "launches_tiled"):
            out[k], out[f"{k}_tf32"] = c.launches_tiled, c.launches_tiled_tf32
    return out


def tiled_kernel(which: str, dt: str) -> str:
    """The name of the row-tiled kernel the "tiled" route launches
    (``which`` is "fwd" or "bwd"): bf16 on mma with bf16 operands
    (tiled_*_mma), fp32 in 3xTF32 (tiled_*_tf32)."""
    return f"tiled_{which}_{'mma' if dt == 'bf16' else 'tf32'}"


def tiled_launches(tiled: dict, name: str) -> int:
    """The launches of the row-tiled kernel ``name`` in a ``read_tiled``
    count."""
    k = "attention" if "_fwd_" in name else "attention_bwd"
    tf32 = tiled[f"{k}_tf32"]
    return tiled[k] - tf32 if name.endswith("_mma") else tf32


def check_layernorm(torch, gen):
    import torch.nn.functional as F

    from cmh_torch.ops.layernorm import fused_layernorm, layernorm_plain

    rows = []
    # the towers at the serving batch, then at the training batch, where
    # most of its launches run
    for n, d in ((B * 50, 768), (B * MAX_WORDS, 512), (TRAIN_B * 50, 768),
                 (TRAIN_B * MAX_WORDS, 512)):
        x = torch.randn(n, d, generator=gen, device="cuda").mul_(3).add_(1).bfloat16()
        g = torch.randn(d, generator=gen, device="cuda")
        b = torch.randn(d, generator=gen, device="cuda")
        out, ref = fused_layernorm(x, g, b), layernorm_plain(x, g, b)
        torch.cuda.synchronize()
        # fp32 in both, rounded once to bf16
        steps = bf16_steps_checked(out, ref, f"layernorm_fwd ({n},{d})")
        print(f"[kernel] layernorm_fwd ({n},{d}): {steps}", flush=True)
        err = (out.float() - ref.float()).abs().max().item()
        gb, bb = g.bfloat16(), b.bfloat16()
        rows.append(entry(
            "layernorm_fwd", "cmh_torch/csrc/layernorm.cu",
            "cmh_tpu/ops/layernorm_pallas.py:30", f"({n},{d}) bf16", err,
            cuda_ms(lambda: fused_layernorm(x, g, b)),
            cuda_ms(lambda: layernorm_plain(x, g, b)),
            cuda_ms(lambda: F.layer_norm(x, (d,), gb, bb, 1e-5)),
            2 * n * d * 2 + 2 * d * 4, 8 * n * d, "fp32"))
        rows[-1]["cold_ms"] = cold_ms(fused_layernorm, (x, g, b))
    # fp32: MITH's concept transformer (K = 16 concept tokens a pair) and
    # UMoED's decoder (64 slots a pair), width 512
    for n, d, who in FP32_LN_ROWS:
        x = torch.randn(n, d, generator=gen, device="cuda").mul_(3).add_(1)
        g, b = (torch.randn(d, generator=gen, device="cuda") for _ in range(2))
        out, ref = fused_layernorm(x, g, b), layernorm_plain(x, g, b)
        torch.cuda.synchronize()
        # fp32 in both: only the order of the sums differs
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        rows.append(entry(
            "layernorm_fwd", "cmh_torch/csrc/layernorm.cu", "cmh_tpu/ops/layernorm_pallas.py:30",
            f"({n},{d}) fp32 ({who})", (out - ref).abs().max().item(),
            cuda_ms(lambda: fused_layernorm(x, g, b)), cuda_ms(lambda: layernorm_plain(x, g, b)),
            cuda_ms(lambda: F.layer_norm(x, (d,), g, b, 1e-5)),
            2 * n * d * 4 + 2 * d * 4, 8 * n * d, "fp32"))
        rows[-1]["cold_ms"] = cold_ms(fused_layernorm, (x, g, b))
    return rows


def text_masks(torch, gen, n, s, masks="causal+kpm"):
    """The text tower's masks at batch n: (the causal (S, S) mask, a random
    key-padding mask (lengths 2..S), its fp32 bias, the bool mask SDPA takes
    for both); ``masks`` "causal" (DIMCH's and UMoED's text tower) leaves
    the key-padding mask out, None (the vision tower) both."""
    from cmh_torch.ops.attention import kpm_bias

    if masks is None:
        return None, None, None, None
    mask = torch.full((s, s), float("-inf"), device="cuda").triu(1)
    causal = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()[None, None]
    if masks == "causal":
        return mask, None, None, causal
    lengths = torch.randint(2, s + 1, (n,), generator=gen, device="cuda")
    kpm = torch.arange(s, device="cuda")[None, :] >= lengths[:, None]
    return mask, kpm, kpm_bias(kpm), causal & ~kpm[:, None, None, :]


def head_views(torch, gen, n, h, s, parts):
    """``parts`` (B, H, S, 64) bf16 head views of one packed (B, S, parts·H·64)
    tensor, as MultiHeadAttention hands q, k, v to the kernels (and autograd
    dout, parts = 1)."""
    packed = torch.randn(n, s, parts * h * 64, generator=gen, device="cuda").bfloat16()
    return [t.reshape(n, s, h, 64).transpose(1, 2) for t in packed.split(h * 64, -1)]


def check_attention(torch, gen):
    import torch.nn.functional as F

    from cmh_torch.ops.attention import attention_plain, fused_attention

    rows = []
    for tower, h, s, masks in ATTENTION_CASES:
        q, k, v = (torch.randn(B, h, s, 64, generator=gen, device="cuda").bfloat16()
                   for _ in range(3))
        mask, kpm, bias, sdpa_mask = text_masks(torch, gen, B, s, masks)
        tower = tower + (f" {masks}" if masks else "")
        scale = 64**-0.5
        out = fused_attention(q, k, v, scale, mask, kpm)
        ref = attention_plain(q, k, v, scale, mask, bias)
        torch.cuda.synchronize()
        # P and the output round to bf16 in both; a last-bit logit
        # difference can move a rounding step
        steps = bf16_steps_checked(out, ref, f"attention_fwd {tower}")
        print(f"[kernel] attention_fwd {tower}: {steps}", flush=True)
        err = (out.float() - ref.float()).abs().max().item()
        # once more on the head views of a packed projection, read in place
        qp, kp, vp = head_views(torch, gen, B, h, s, 3)
        steps = bf16_steps_checked(fused_attention(qp, kp, vp, scale, mask, kpm),
                                   attention_plain(qp, kp, vp, scale, mask, bias),
                                   f"attention_fwd {tower} head views")
        print(f"[kernel] attention_fwd {tower} head views: {steps}", flush=True)
        nbytes = (4 * B * h * s * 64 * 2 + (s * s * 4 if mask is not None else 0)
                  + (B * s * 4 if kpm is not None else 0))
        rows.append(entry(
            "attention_fwd", "cmh_torch/csrc/attention.cu",
            "cmh_tpu/ops/attention_pallas.py:60",
            f"{tower} ({B},{h},{s},64) bf16", err,
            cuda_ms(lambda: fused_attention(q, k, v, scale, mask, kpm)),
            cuda_ms(lambda: attention_plain(q, k, v, scale, mask, bias)),
            cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=sdpa_mask, scale=scale)),
            nbytes, 4 * B * h * s * s * 64, "bf16"))
        rows[-1]["head_views_ms"] = cuda_ms(lambda: fused_attention(qp, kp, vp, scale, mask, kpm))
        rows[-1]["cold_ms"] = cold_ms(lambda a, b, c: fused_attention(a, b, c, scale, mask, kpm),
                                      (q, k, v))
    # MITH's fp32 concept transformer, block 0: (B, 8, K, 64), no mask
    q, k, v = (torch.randn(TRAIN_B, 8, MITH_K, 64, generator=gen, device="cuda")
               for _ in range(3))
    scale = 64**-0.5
    out, ref = fused_attention(q, k, v, scale), attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    rows.append(entry(
        "attention_fwd", "cmh_torch/csrc/attention.cu", "cmh_tpu/ops/attention_pallas.py:60",
        f"MITH concepts ({TRAIN_B},8,{MITH_K},64) fp32", (out - ref).abs().max().item(),
        cuda_ms(lambda: fused_attention(q, k, v, scale)),
        cuda_ms(lambda: attention_plain(q, k, v, scale)),
        cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)),
        4 * TRAIN_B * 8 * MITH_K * 64 * 4, 4 * TRAIN_B * 8 * MITH_K * MITH_K * 64, "fp32"))
    rows[-1]["cold_ms"] = cold_ms(lambda a, b, c: fused_attention(a, b, c, scale), (q, k, v))
    return rows


def sm_clock_hz() -> float:
    """The card's highest SM clock, from nvidia-smi (MHz)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


POPC_PER_CLOCK_PER_SM = 16       # __popc on compute capability 9.0, a quarter of XOR's rate


def check_hamming(torch, gen):
    from cmh_torch.ops.hamming import hamming_packed, hamming_plain
    from cmh_torch.ops.hashing import pack_bits

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    popc_per_s = sms * POPC_PER_CLOCK_PER_SM * sm_clock_hz()
    rows = []
    # chip_smoke's two K4 shapes first, then a serving request's (4 queries
    # against a 2^20 block) and the int32 path at 1,024 bits
    for nq, ng, bits in ((64, (1 << 20) + 777, 16), (64, (1 << 20) + 777, 64),
                         (4, 1 << 20, 16), (64, 1 << 18, 1024), (64, 1 << 18, 512)):
        def codes(n):
            return torch.randint(0, 2, (n, bits), generator=gen, device="cuda").float() * 2 - 1
        qf, gf = codes(nq), codes(ng)
        q, g = pack_bits(qf), pack_bits(gf)
        w = q.shape[1]
        out, ref = hamming_packed(q, g, bits=bits), hamming_plain(q, g, bits=bits)
        torch.cuda.synchronize()
        if out.dtype != ref.dtype or not torch.equal(out, ref):
            raise AssertionError(f"hamming kernel differs from plain at Q={nq} N={ng} {bits} bits")
        rows.append(entry(
            "hamming", "cmh_torch/csrc/hamming.cu",
            "cmh_tpu/ops/hamming_pallas.py:42",
            f"Q={nq} N={ng} {bits}-bit -> {str(out.dtype).split('.')[-1]}", 0.0,
            cuda_ms(lambda: hamming_packed(q, g, bits=bits)),
            cuda_ms(lambda: hamming_plain(q, g, bits=bits), iters=3, warmup=1),
            # the same distances from the unpacked ±1 codes
            cuda_ms(lambda: torch.cdist(qf, gf, p=0), iters=5, warmup=1),
            (nq + ng) * w * 4 + nq * ng * out.element_size(), 3 * nq * ng * w, "fp32"))
        rows[-1]["cold_ms"] = cold_ms(lambda a, b: hamming_packed(a, b, bits=bits), (q, g))
        rows[-1]["popc_floor_ms"] = nq * ng * w / popc_per_s * 1e3
        del qf, gf, q, g, out, ref
    return rows


def check_layernorm_bwd(torch, gen):
    import torch.nn.functional as F

    from cmh_torch.ops.layernorm import layernorm_bwd, layernorm_bwd_plain

    rows = []
    for n, d in ((TRAIN_B * 50, 768), (TRAIN_B * MAX_WORDS, 512)):
        x = torch.randn(n, d, generator=gen, device="cuda").mul_(3).add_(1).bfloat16()
        do = torch.randn(n, d, generator=gen, device="cuda").bfloat16()
        g = torch.randn(d, generator=gen, device="cuda")
        got, want = layernorm_bwd(x, g, do), layernorm_bwd_plain(x, g, do)
        torch.cuda.synchronize()
        # dx: fp32 in both, rounded once to bf16; dγ/dβ: fp32 sums over n
        # rows in another order
        steps = bf16_steps_checked(got[0], want[0], "layernorm_bwd dx")
        print(f"[kernel] layernorm_bwd ({n},{d}) dx: {steps}", flush=True)
        for a, b in zip(got[1:], want[1:]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)
        err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
        xl = x.clone().requires_grad_()
        gl = g.bfloat16().requires_grad_()
        bl = torch.zeros_like(gl).requires_grad_()
        y = F.layer_norm(xl, (d,), gl, bl, 1e-5)
        rows.append(entry(
            "layernorm_bwd", "cmh_torch/csrc/layernorm.cu",
            "cmh_tpu/ops/layernorm_pallas.py:44", f"({n},{d}) bf16", err,
            cuda_ms(lambda: layernorm_bwd(x, g, do)),
            cuda_ms(lambda: layernorm_bwd_plain(x, g, do)),
            cuda_ms(lambda: torch.autograd.grad(y, (xl, gl, bl), do, retain_graph=True)),
            3 * n * d * 2 + 3 * d * 4, 12 * n * d, "fp32"))
        rows[-1]["cold_ms"] = cold_ms(layernorm_bwd, (x, g, do))
    for n, d, who in FP32_LN_ROWS:          # MITH's concepts, UMoED's decoder
        x = torch.randn(n, d, generator=gen, device="cuda").mul_(3).add_(1)
        do = torch.randn(n, d, generator=gen, device="cuda")
        g = torch.randn(d, generator=gen, device="cuda")
        got, want = layernorm_bwd(x, g, do), layernorm_bwd_plain(x, g, do)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
        for a, b in zip(got[1:], want[1:]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)
        xl, gl, bl = (t.clone().requires_grad_() for t in (x, g, torch.zeros_like(g)))
        y = F.layer_norm(xl, (d,), gl, bl, 1e-5)
        rows.append(entry(
            "layernorm_bwd", "cmh_torch/csrc/layernorm.cu", "cmh_tpu/ops/layernorm_pallas.py:44",
            f"({n},{d}) fp32 ({who})",
            max((a - b).abs().max().item() for a, b in zip(got, want)),
            cuda_ms(lambda: layernorm_bwd(x, g, do)),
            cuda_ms(lambda: layernorm_bwd_plain(x, g, do)),
            cuda_ms(lambda: torch.autograd.grad(y, (xl, gl, bl), do, retain_graph=True)),
            3 * n * d * 4 + 3 * d * 4, 12 * n * d, "fp32"))
        rows[-1]["cold_ms"] = cold_ms(layernorm_bwd, (x, g, do))
    return rows


def check_attention_bwd(torch, gen):
    import torch.nn.functional as F

    from cmh_torch.ops.attention import _MAX_SMEM as ATTN_MAX_SMEM
    from cmh_torch.ops.attention import _lib as attention_lib
    from cmh_torch.ops.attention import attention_bwd, attention_bwd_plain

    rows = []
    for tower, h, s, masks in ATTENTION_CASES:
        q, k, v, do = (torch.randn(TRAIN_B, h, s, 64, generator=gen, device="cuda").bfloat16()
                       for _ in range(4))
        mask, _, bias, sdpa_mask = text_masks(torch, gen, TRAIN_B, s, masks)
        tower = tower + (f" {masks}" if masks else "")
        scale = 64**-0.5
        got = attention_bwd(q, k, v, scale, mask, bias, do)
        want = attention_bwd_plain(q, k, v, scale, mask, bias, do)
        torch.cuda.synchronize()
        # fp32 arithmetic on the same bf16 inputs (W never rounded), then one
        # bf16 rounding
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            steps = bf16_steps_checked(a, b, f"attention_bwd {name}")
            print(f"[kernel] attention_bwd {tower} {name}: {steps}", flush=True)
        err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
        # once more on head views, as autograd hands them over
        qp, kp, vp = head_views(torch, gen, TRAIN_B, h, s, 3)
        (dop,) = head_views(torch, gen, TRAIN_B, h, s, 1)
        for name, a, b in zip(("dq", "dk", "dv"),
                              attention_bwd(qp, kp, vp, scale, mask, bias, dop),
                              attention_bwd_plain(qp, kp, vp, scale, mask, bias, dop)):
            steps = bf16_steps_checked(a, b, f"attention_bwd {name} head views")
            print(f"[kernel] attention_bwd {tower} {name} head views: {steps}", flush=True)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=sdpa_mask, scale=scale)
        nbytes = (7 * TRAIN_B * h * s * 64 * 2 + (s * s * 4 if mask is not None else 0)
                  + (TRAIN_B * s * 4 if bias is not None else 0))
        rows.append(entry(
            "attention_bwd", "cmh_torch/csrc/attention.cu",
            "cmh_tpu/ops/attention_pallas.py:84",
            f"{tower} ({TRAIN_B},{h},{s},64) bf16",
            err,
            cuda_ms(lambda: attention_bwd(q, k, v, scale, mask, bias, do)),
            cuda_ms(lambda: attention_bwd_plain(q, k, v, scale, mask, bias, do)),
            cuda_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)),
            nbytes, 10 * TRAIN_B * h * s * s * 64, "bf16"))
        rows[-1]["head_views_ms"] = cuda_ms(
            lambda: attention_bwd(qp, kp, vp, scale, mask, bias, dop))
        rows[-1]["cold_ms"] = cold_ms(
            lambda a, b, c, e: attention_bwd(a, b, c, scale, mask, bias, e), (q, k, v, do))
    q, k, v, do = (torch.randn(TRAIN_B, 8, MITH_K, 64, generator=gen, device="cuda")
                   for _ in range(4))
    scale = 64**-0.5
    got = attention_bwd(q, k, v, scale, None, None, do)
    want = attention_bwd_plain(q, k, v, scale, None, None, do)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, scale=scale)
    rows.append(entry(
        "attention_bwd", "cmh_torch/csrc/attention.cu", "cmh_tpu/ops/attention_pallas.py:84",
        f"MITH concepts ({TRAIN_B},8,{MITH_K},64) fp32",
        max((a - b).abs().max().item() for a, b in zip(got, want)),
        cuda_ms(lambda: attention_bwd(q, k, v, scale, None, None, do)),
        cuda_ms(lambda: attention_bwd_plain(q, k, v, scale, None, None, do)),
        cuda_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)),
        7 * TRAIN_B * 8 * MITH_K * 64 * 4, 10 * TRAIN_B * 8 * MITH_K * MITH_K * 64, "fp32"))
    rows[-1]["cold_ms"] = cold_ms(
        lambda a, b, c, e: attention_bwd(a, b, c, scale, None, None, e), (q, k, v, do))
    # the largest K each fp32 kernel holds in shared memory at head dim 64
    lib = attention_lib()
    limit = {w: max(s for s in range(1, 257) if getattr(lib, f)(s, 64) <= ATTN_MAX_SMEM)
             for w, f in (("fwd", "cmh_attention_smem_bytes"),
                          ("bwd", "cmh_attention_bwd_smem_bytes"))}
    print(f"[kernel] fp32 attention at head dim 64 holds S <= {limit['fwd']} forward and "
          f"S <= {limit['bwd']} backward (MITH's K concept tokens)", flush=True)
    return rows


def check_attention_tiled(torch, gen):
    """The row-tiled K2 pair at the lengths past the one-block kernels, each
    row named after the kernel it launches: tiled_*_mma, ViT-B/16's and
    ViT-L/14's vision forward and ViT-L/14's backward in bf16, and the bf16
    forward one past the logit rows' shared-memory limit (its rows in device
    memory); tiled_*_tf32, ViT-L/14's vision both ways in fp32 (phase 14c's
    shapes) and MITH's 128 concept tokens backward in fp32. bf16 is held to
    the one-bf16-step check, fp32 within 1e-5; each row has its cold-L2
    time, the plain version's and SDPA's; the bf16 forward rows also the
    floor of their fp32 FMA logit walk. The fp32 rows' bound counts the
    three TF32 products of each fp32 one at the TF32 peak."""
    import torch.nn.functional as F

    from cmh_torch.ops.attention import (attention_bwd, attention_bwd_plain, attention_plain,
                                         fused_attention, route)

    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    rows, scale = [], 64**-0.5
    for which, cases in (("fwd", TILED_FWD_CASES), ("bwd", TILED_BWD_CASES)):
        for what, n, h, s, dt, way in cases:
            if route(dtypes[dt], which, s, 64) != way:
                raise AssertionError(f"{what} S={s} {dt} {which} does not take the {way} route")
            name = tiled_kernel(which, dt)
            tf32 = name.endswith("_tf32")
            args = [torch.randn(n, h, s, 64, generator=gen, device="cuda").to(dtypes[dt])
                    for _ in range(3 if which == "fwd" else 4)]
            shape = f"{what} ({n},{h},{s},64) {dt}"
            counts = lambda: (fused_attention.launches_tiled, attention_bwd.launches_tiled,
                              fused_attention.launches_tiled_tf32,
                              attention_bwd.launches_tiled_tf32)
            before = counts()
            if which == "fwd":
                got = (fused_attention(*args, scale),)
                want = (attention_plain(*args, scale),)
            else:
                got = attention_bwd(*args[:3], scale, None, None, args[3])
                want = attention_bwd_plain(*args[:3], scale, None, None, args[3])
            torch.cuda.synchronize()
            one = (1, 0) if which == "fwd" else (0, 1)
            if tuple(a - b for a, b in zip(counts(), before)) != \
                    one + (one if tf32 else (0, 0)):
                raise AssertionError(f"{shape}: the kernel {name} was not launched")
            for part, a, b in zip(("out",) if which == "fwd" else ("dq", "dk", "dv"), got, want):
                if dt == "bf16":
                    steps = bf16_steps_checked(a, b, f"{name} {shape} {part}")
                    print(f"[kernel] {name} {shape} {part}: {steps}", flush=True)
                else:
                    # fp32 in both: only the order of the sums differs
                    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
            err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
            size = 2 if dt == "bf16" else 4
            if which == "fwd":
                leaves = None
                kernel = lambda: fused_attention(*args, scale)
                plain = lambda: attention_plain(*args, scale)
                library = lambda: F.scaled_dot_product_attention(*args, scale=scale)
                cold = cold_ms(lambda a, b, c: fused_attention(a, b, c, scale), args)
                nbytes, ops = 4 * n * h * s * 64 * size, 4 * n * h * s * s * 64
            else:
                leaves = [t.clone().requires_grad_() for t in args[:3]]
                out = F.scaled_dot_product_attention(*leaves, scale=scale)
                kernel = lambda: attention_bwd(*args[:3], scale, None, None, args[3])
                plain = lambda: attention_bwd_plain(*args[:3], scale, None, None, args[3])
                library = lambda: torch.autograd.grad(out, leaves, args[3], retain_graph=True)
                cold = cold_ms(lambda a, b, c, e: attention_bwd(a, b, c, scale, None, None, e),
                               args)
                nbytes, ops = 7 * n * h * s * 64 * size, 10 * n * h * s * s * 64
            rows.append(entry(
                name, "cmh_torch/csrc/attention_tiled.cu",
                "cmh_tpu/ops/attention_pallas.py:" + ("60" if which == "fwd" else "84"),
                shape, err, cuda_ms(kernel, iters=20, warmup=3),
                cuda_ms(plain, iters=10, warmup=2), cuda_ms(library, iters=20, warmup=3),
                nbytes, 3 * ops if tf32 else ops, "tf32" if tf32 else dt))
            rows[-1]["cold_ms"] = cold
            if name == "tiled_fwd_mma":
                # the check keeps the logits off the tensor cores: one walk of
                # fp32 FMA chains (2 n h S^2 hd flops) at the CUDA cores' peak
                rows[-1]["fma_floor_ms"] = 2 * n * h * s * s * 64 / PEAK_OPS["fp32"] * 1e3
            del args, got, want, leaves
    return rows


def coco_codes(torch, gen, nq, n, bits):
    """Random ±1 codes for queries and gallery of both modalities and
    multi-hot labels over 80 classes (about 3 a item, at least one)."""
    def codes(m):
        return torch.randint(0, 2, (m, bits), generator=gen, device="cuda").float() * 2 - 1

    def labels(m):
        lab = (torch.rand(m, COCO_CLASSES, generator=gen, device="cuda") < 2.0 / COCO_CLASSES)
        lab[torch.arange(m, device="cuda"),
            torch.randint(0, COCO_CLASSES, (m,), generator=gen, device="cuda")] = True
        return lab.float()

    return codes(nq), codes(nq), codes(n), codes(n), labels(nq), labels(n)


def check_map(torch, gen):
    from cmh_torch.ops.map_bucketed import calc_map_k_4dir
    from cmh_torch.ops.map_kernel import (map_ap, map_ap_plain, map_hist, map_hist_plain,
                                          pack_words, query_chunk, rank_counts, segment_len)
    from cmh_torch.ops.metrics import calc_label_sim

    rows, runs = [], []
    for bits, n in ((16, COCO_N), (64, COCO_N), (1024, 20_000), (512, COCO_N)):
        chunk, seg = query_chunk(bits), segment_len(bits)
        qi, qt, ri, rt, ql, rl = coco_codes(torch, gen, chunk, n, bits)
        gnd = calc_label_sim(ql, rl)
        words = torch.cat([pack_words(a, b, gnd, bits)
                           for a, b in ((qi, rt), (qt, ri), (qi, ri), (qt, rt))])
        sl = words[:1024].contiguous()          # the comparison slice, Q = 1,024
        q, wsize, v = sl.shape[0], sl.element_size(), bits + 1
        hist, rhist = map_hist(sl, bits, seg)
        ph, prh = map_hist_plain(sl, bits, seg)
        torch.cuda.synchronize()
        if not (torch.equal(hist, ph) and torch.equal(rhist, prh)):
            raise AssertionError(f"K3-hist histograms differ from plain at {bits} bits")
        start, start_r, total = rank_counts(hist, rhist, None)
        ap = map_ap(sl, start, start_r, total, seg)
        pap = map_ap_plain(sl, start, start_r, total, seg)
        again = map_ap(sl, start, start_r, total, seg)
        torch.cuda.synchronize()
        t = torch.clamp(total.double(), min=1.0)
        err = ((ap - pap) / t).abs().max().item()
        # identical fp32 quotients, fp64 sums in another order
        if not err <= 1e-12:
            raise AssertionError(f"K3-ap per-query AP differs by {err} at {bits} bits")
        if not torch.equal(ap, again):
            raise AssertionError(f"K3-ap gave other bits on a rerun at {bits} bits")
        shape = (f"Q={q} N={n} {bits}-bit " + ("uint8" if wsize == 1 else "int16")
                 + f", {hist.shape[1]} segments of {seg}")
        rows.append(entry(
            "map_hist", "cmh_torch/csrc/map.cu", "cmh_tpu/ops/map_pallas.py:110", shape,
            0.0, cuda_ms(lambda: map_hist(sl, bits, seg), iters=10, warmup=2),
            cuda_ms(lambda: map_hist_plain(sl, bits, seg), iters=3, warmup=1),
            None,   # no single PyTorch call computes it
            q * n * wsize + 2 * q * v * 4, 2 * q * n, "fp32"))
        rows[-1]["cold_ms"] = cold_ms(lambda w: map_hist(w, bits, seg), (sl,), iters=10)
        rows.append(entry(
            "map_ap", "cmh_torch/csrc/map.cu", "cmh_tpu/ops/map_pallas.py:129", shape,
            err, cuda_ms(lambda: map_ap(sl, start, start_r, total, seg), iters=10, warmup=2),
            cuda_ms(lambda: map_ap_plain(sl, start, start_r, total, seg), iters=2, warmup=1),
            None, q * n * wsize + 2 * q * v * 4 + q * 12, 4 * q * n, "fp32"))
        rows[-1]["cold_ms"] = cold_ms(lambda w, a, b, c: map_ap(w, a, b, c, seg),
                                      (sl, start, start_r, total), iters=10)
        counts = rank_counts(*map_hist(words, bits, seg), None)
        full = (cuda_ms(lambda: map_hist(words, bits, seg), iters=5, warmup=1),
                cuda_ms(lambda: rank_counts(*map_hist(words, bits, seg), None), iters=5,
                        warmup=1),
                cuda_ms(lambda: map_ap(words, *counts, seg), iters=5, warmup=1))
        del words, sl, gnd, counts
        # the whole 4-direction eval of 5,000 queries (host clock, packing included)
        nq = COCO_Q if n == COCO_N else 1_000
        data = coco_codes(torch, gen, nq, n, bits)
        calc_map_k_4dir(*data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        maps = calc_map_k_4dir(*data)
        torch.cuda.synchronize()
        runs.append({"bits": bits, "queries": nq, "items": n,
                     "chunk_words": [4 * chunk, n], "segment_len": seg,
                     "chunk_hist_ms": full[0], "chunk_hist_and_counts_ms": full[1],
                     "chunk_ap_ms": full[2],
                     "eval_4dir_s": time.perf_counter() - t0,
                     "maps": [round(m, 6) for m in maps]})
        print(f"[map] {runs[-1]}", flush=True)
        del data
    return rows, runs


def grad_parity(torch, geometry=None, n=8, tag="[grad]", grad_tol=1e-4):
    """One fp32 train step's loss and gradients at full width on ``n`` pairs
    (ViT-B/32, or the CLIP ``geometry``): the card (kernels) against the CPU
    (plain versions), TF32 off; each gradient tensor within ``grad_tol`` of
    its largest CPU value."""
    import numpy as np

    from cmh_torch.models.clip.model import CLIPConfig
    from cmh_torch.models.clip.tokenizer import SimpleTokenizer, tokenize_caption
    from cmh_torch.models.dcmht import DCMHTModel, dcmht_loss_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = DCMHTModel(CLIPConfig(**(geometry or {}), dtype=torch.float32), CODE_BITS)
    model.init_weights(seed_key(0), "cuda").train()
    cpu_model = copy.deepcopy(model)
    gpu_model = model.to("cuda")
    rng = np.random.RandomState(2)
    img = torch.from_numpy(rng.randn(n, 224, 224, 3).astype(np.float32))
    tok = SimpleTokenizer()
    ids, kpm = (torch.from_numpy(np.stack(a)) for a in
                zip(*(tokenize_caption(tok, c, MAX_WORDS) for c in CAPTIONS[:n])))
    labels = torch.from_numpy(np.eye(4, dtype=np.float32)[[0, 1, 2, 3, 0, 1, 2, 3][:n]])
    loss_fn = dcmht_loss_fn(output_dim=CODE_BITS)
    losses = {}
    for name, m, dev in (("cuda", gpu_model, "cuda"), ("cpu", cpu_model, "cpu")):
        loss, _, _ = loss_fn(m(img.to(dev), ids.to(dev), kpm.to(dev)),
                             {"label": labels.to(dev)}, {}, 0)
        loss.backward()
        losses[name] = float(loss.detach())
    loss_rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    # biases that only shift the image BatchNorm's input: true gradient 0,
    # both sides see rounding noise (tests/test_torch_train_fused.py)
    absorbed = {"backbone.visual.ln_post.bias", "hash.img_hash.atten.in_proj_bias",
                "hash.img_hash.atten.out_proj.bias"}
    worst, noise = (0.0, ""), {}
    for (name, pg), pc in zip(gpu_model.named_parameters(), cpu_model.parameters()):
        if pc.grad is None:
            if pg.grad is not None:
                raise AssertionError(f"{name}: gradient on the card only")
            continue
        g = pg.grad.cpu()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: non-finite gradient on the card")
        rel = ((g - pc.grad).abs().max() / pc.grad.abs().max()).item()
        if name in absorbed:
            noise[name] = pc.grad.abs().max().item()
        elif rel > worst[0]:
            worst = (rel, name)
    print(f"{tag} loss card {losses['cuda']:.7f} cpu {losses['cpu']:.7f} rel diff "
          f"{loss_rel:.3e}; largest per-tensor relative gradient difference "
          f"{worst[0]:.3e} ({worst[1]}); BatchNorm-absorbed gradients (noise) "
          f"{ {k: f'{v:.1e}' for k, v in noise.items()} }", flush=True)
    # fp32 on both sides, TF32 off: only summation order differs, through 12
    # layers forward and backward
    if not loss_rel <= 1e-6:
        raise AssertionError(f"loss differs card/CPU: {loss_rel}")
    if not worst[0] <= grad_tol:
        raise AssertionError(f"gradient of {worst[1]} differs card/CPU: {worst[0]}")
    if max(noise.values()) > 1e-4:
        raise AssertionError(f"BatchNorm-absorbed gradients are not noise: {noise}")
    return {"loss_rel_diff": loss_rel, "max_grad_rel_diff": worst[0]}


def device_batch(torch, gen, n):
    """A training batch made on the card (no loader): 224 px NHWC images,
    token ids laid out as the tokenizer's ([SOT] … [EOT], zero-padded to
    32, lengths 2..32) with their key-padding mask, and multi-hot labels
    over the synthetic config's 8 classes, and item indices 0..n-1 (MITH's
    banks)."""
    pos = torch.arange(MAX_WORDS, device="cuda")
    lengths = torch.randint(2, MAX_WORDS + 1, (n,), generator=gen, device="cuda")
    ids = torch.randint(1, 49406, (n, MAX_WORDS), generator=gen, device="cuda")
    ids = torch.where(pos[None] < lengths[:, None], ids, 0)
    ids[:, 0] = 49406
    ids[torch.arange(n, device="cuda"), lengths - 1] = 49407
    label = torch.rand(n, 8, generator=gen, device="cuda") < 0.25
    label[torch.arange(n, device="cuda"), torch.randint(0, 8, (n,), generator=gen, device="cuda")] = True
    return {"image": torch.randn(n, 224, 224, 3, generator=gen, device="cuda"),
            "text": ids.int(), "key_padding_mask": pos[None] >= lengths[:, None],
            "label": label.float(), "index": torch.arange(n, device="cuda")}


def tower_times(torch):
    """Device time (cuda_ms) of the full-width bf16 model on inputs made on
    the card: the image and the text tower forward at the serving batch,
    and one image + text forward and backward (loss included, no optimizer)
    at the training batch."""
    from cmh_torch.models.clip.model import CLIPConfig
    from cmh_torch.models.dcmht import DCMHTModel, dcmht_loss_fn

    model = DCMHTModel(CLIPConfig(), CODE_BITS)
    model.init_weights(seed_key(0), "cuda").to("cuda").eval()
    gen = torch.Generator(device="cuda").manual_seed(5)
    x_txt = device_batch(torch, gen, B)
    x_img = x_txt.pop("image")
    with torch.no_grad():
        image_ms = cuda_ms(lambda: model.encode_image(x_img), iters=10, warmup=2)
        text_ms = cuda_ms(lambda: model.encode_text(x_txt["text"], x_txt["key_padding_mask"]),
                          iters=10, warmup=2)
    x = device_batch(torch, gen, TRAIN_B)
    loss_fn = dcmht_loss_fn(output_dim=CODE_BITS)
    model.train()

    def step():
        model.zero_grad(set_to_none=True)
        loss, _, _ = loss_fn(model(x["image"], x["text"], x["key_padding_mask"]), x, {}, 0)
        loss.backward()

    train_ms = cuda_ms(step, iters=5, warmup=2)
    with torch.no_grad():
        model.eval()
        busy = {"image_fwd_b256": kernel_busy_ms(torch, lambda: model.encode_image(x_img)),
                "text_fwd_b256": kernel_busy_ms(
                    torch, lambda: model.encode_text(x_txt["text"], x_txt["key_padding_mask"]))}
    model.train()
    busy["fwd_bwd_b100"] = kernel_busy_ms(torch, step)
    out = {"image_fwd_b256_ms": image_ms, "text_fwd_b256_ms": text_ms,
           "fwd_bwd_b100_ms": train_ms}
    print(f"[towers] device ms (CUDA events around back-to-back calls, idle gaps "
          f"included), full-width bf16: {out}", flush=True)
    print(f"[towers] kernel busy ms (torch.profiler, one call): {busy}", flush=True)
    return out


def _device_us(e):
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def kernel_events(torch, prof):
    """The device kernels of a torch.profiler run, summed by name: device
    events whose name is no host event's (annotations such as
    ``Optimizer.step#…`` carry a device span of the same name as their host
    span, and no kernel is named like a host op)."""
    events = prof.key_averages()
    host = {e.key for e in events if e.device_type != torch.autograd.DeviceType.CUDA}
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key not in host and _device_us(e) > 0]


def kernel_busy_ms(torch, fn):
    """Device time spent in kernels during one call of ``fn`` (after one
    warm call), from torch.profiler: no idle gaps, unlike ``cuda_ms``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(_device_us(e) for e in kernel_events(torch, prof)) / 1e3


def profile_train_step(torch, trainer):
    """torch.profiler over one train step of the CLI's trainer on a batch
    made on the card: the ten kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    batch = device_batch(torch, torch.Generator(device="cuda").manual_seed(6), TRAIN_B)
    trainer.train_step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = kernel_events(torch, prof)
    total = sum(_device_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=_device_us, reverse=True)[:10]
    print(f"[profile] one train step (batch {TRAIN_B}): {len(kernels)} kernel names, "
          f"{sum(e.count for e in kernels)} launches, {total:.3f} ms of kernel time in "
          f"{wall_ms:.3f} ms of host wall clock (device busy {total / wall_ms:.1%})",
          flush=True)
    for e in top:
        print(f"[profile] {_device_us(e) / 1e3:9.3f} ms {e.count:5d}x  {e.key[:110]}", flush=True)
    return {"kernel_ms": total, "wall_ms": wall_ms,
            "top": [(e.key[:110], _device_us(e) / 1e3, e.count) for e in top]}


def train_cli(cfg_path, save_dir):
    """``python -m cmh_torch.main`` in-process, on the card, seed 0."""
    from cmh_torch.main import main as cli_main

    return cli_main(["--config-file", cfg_path, "--save-dir", save_dir, "--device", "cuda",
                     "--seed", "0"])


def read_sidecar(path):
    with open(path + ".meta.json") as f:
        return json.load(f)


def training(torch, counters, keep):
    """Phase 8a, b and e in a fresh save root outside the repository; the
    model file of run a's best i→t epoch and that epoch's ``i2t-best.mat``
    are copied under ``keep`` (phase 17 builds an index from them)."""
    root = tempfile.mkdtemp(prefix="cmh_smoke_train_")
    try:
        launches, stats, trainer = train_main_path(torch, counters, root)
        shutil.copy(os.path.join(trainer.save_dir, f"model-{trainer.best_epoch_i}.pt"),
                    os.path.join(keep, "dcmht-model.pt"))
        shutil.copy(os.path.join(trainer.save_dir, "mat_files", "i2t-best.mat"),
                    os.path.join(keep, "dcmht-i2t-best.mat"))
        check_resume(torch, counters, trainer, root)
        profile_train_step(torch, trainer)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches, stats


def pair_launches(layers=(12, 12), fp32=(0, 0)):
    """(K1, K2) launches of one image + text forward (and as many in the
    backward) through towers of ``layers`` (vision, text) blocks: 2 K1 a
    block, 3 more for ln_pre, ln_post and ln_final, a K2 a block but the last
    of each tower, and ``fp32`` more (K1, K2) in fp32."""
    lv, lt = layers
    return 2 * lv + 2 + 2 * lt + 1 + fp32[0], (lv - 1) + (lt - 1) + fp32[1]


def expected_launches(cfg, remat=False, fp32=(0, 0), widths=None, layers=(12, 12),
                      tiled=None, tiled_tf32=(0, 0)):
    """(train steps, kernel launches) of a training run of the config
    ``cfg`` (a dict) through the CLI, worked out from the code: per image +
    text pair of full-width towers of ``layers`` (vision, text) blocks, 2 K1
    a block, 3 more for ln_pre, ln_post and ln_final, and a K2 a block but
    the last of each tower (which takes the explicit path): 51 K1 and 22 K2
    at ViT-B/32's 12 and 12, forward and backward, the forward twice under
    ``remat``, and ``fp32`` (K1, K2) more in fp32 (MITH's concept
    transformers: 2 blocks of 2 LayerNorms and one K2 block a modality);
    one K3 pass each per query chunk of a ``valid`` for each code width
    (``widths``, default ``run.output_dim``). With ``fp32`` a third dict
    gives the fp32 launches alone; with ``tiled`` (row-tiled K2 launches a
    forward, a backward, and ``tiled_tf32`` of them in fp32) a last dict
    gives the row-tiled K2 launches as ``read_tiled`` counts them."""
    import math

    from cmh_torch.ops.map_kernel import query_chunk

    run = cfg["run"]
    steps = math.ceil(run["train_num"] / run["batch_size"]) * run["epochs"]
    retrieval = cfg["dataset"].get("num_items", run["query_num"] + 2 * run["train_num"]) \
        - run["query_num"]
    eval_b = run.get("eval_batch_size", run["batch_size"])
    eval_batches = (math.ceil(run["query_num"] / eval_b) + math.ceil(retrieval / eval_b)) \
        * run["epochs"]
    chunks = sum(math.ceil(run["query_num"] / query_chunk(w))
                 for w in (widths or [run["output_dim"]])) * run["epochs"]
    ln, attn = pair_launches(layers, fp32)
    fwd = steps * (2 if remat else 1) + eval_batches
    expect = {"layernorm": ln * fwd, "layernorm_bwd": ln * steps,
              "attention": attn * fwd, "attention_bwd": attn * steps,
              "hamming": 0, "map_hist": chunks, "map_ap": chunks}
    out = [steps, expect]
    if fp32 != (0, 0):
        out.append({"layernorm": fp32[0] * fwd, "layernorm_bwd": fp32[0] * steps,
                    "attention": fp32[1] * fwd, "attention_bwd": fp32[1] * steps})
    if tiled is not None:
        out.append({"attention": tiled[0] * fwd, "attention_bwd": tiled[1] * steps,
                    "attention_tf32": tiled_tf32[0] * fwd,
                    "attention_bwd_tf32": tiled_tf32[1] * steps})
    return tuple(out)


def train_main_path(torch, counters, root):
    """8a: configs/DCMHT/synthetic_tpu.yaml as it stands, through the CLI."""
    import numpy as np
    import scipy.io as scio
    import yaml

    with open(TRAIN_CONFIG) as f:
        cfg = yaml.safe_load(f)
    run = cfg["run"]
    steps, expect = expected_launches(cfg)

    reset_counts(counters)
    # ---- the main path: python -m cmh_torch.main, in-process
    t0 = time.perf_counter()
    trainer = train_cli(TRAIN_CONFIG, os.path.join(root, "main"))
    torch.cuda.synchronize()
    launches = read_counts(counters)
    t_main = time.perf_counter() - t0
    # ---- end of the main path
    hist = trainer.history
    train_s = sum(h["seconds"] for h in hist)
    pairs = sum(h["pairs"] for h in hist)
    print(f"[train] {steps} steps in {train_s:.2f} s of training ({steps / train_s:.3f} "
          f"steps/s, {pairs / train_s:.1f} pairs/s, host clock), of which "
          f"{sum(h['data_wait_s'] for h in hist):.2f} s waiting for data; code generation "
          f"{[round(h['code_s'], 2) for h in hist]} s, of which "
          f"{[round(h['code_data_wait_s'], 2) for h in hist]} s waiting for data; 4-direction "
          f"mAP {[round(h['map_s'], 4) for h in hist]} s; main path {t_main:.1f} s; "
          f"epoch losses {[h['loss'] for h in hist]}; mAPs {[h['maps'] for h in hist]}",
          flush=True)
    print(f"[train] launches {launches} expected {expect}", flush=True)
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
    if not all(np.isfinite(h["loss"]) for h in hist) or len(hist) != run["epochs"]:
        raise AssertionError(f"non-finite or missing epoch losses: {hist}")
    save = trainer.save_dir
    if not [p for p in os.listdir(save) if p.startswith("model-") and p.endswith(".pt")]:
        raise AssertionError("no model-*.pt written")
    ckpt = os.path.join(save, "checkpoint-last.pt")
    meta = read_sidecar(ckpt)
    if meta != {"epoch": run["epochs"], "fingerprint": trainer._config_fingerprint()}:
        raise AssertionError(f"checkpoint sidecar {meta}")
    print(f"[train] checkpoint-last.pt {os.path.getsize(ckpt) / 1e9:.3f} GB, sidecar "
          f"epoch {meta['epoch']}", flush=True)
    for name in ("i2t-best", "t2i-best", "last"):
        mat = scio.loadmat(os.path.join(save, "mat_files", f"{name}.mat"))
        if not {"q_img", "q_txt", "r_img", "r_txt", "q_l", "r_l"} <= set(mat):
            raise AssertionError(f"{name}.mat lacks the reference keys")
        for key in ("q_img", "q_txt", "r_img", "r_txt"):
            if not set(np.unique(mat[key])) <= {-1.0, 1.0}:
                raise AssertionError(f"{name}.mat {key} is not ±1")
    check_last_maps(torch, trainer, "[train]")
    stats = {"steps": steps, "train_s": train_s, "pairs": pairs, "main_s": t_main}
    return launches, stats, trainer


def check_last_maps(torch, trainer, tag):
    """The last ``valid``'s four mAPs against the plain counting rank and the
    numpy oracle on ``last.mat``."""
    import numpy as np
    import scipy.io as scio

    from cmh_torch.ops.map_bucketed import calc_map_k_4dir
    from cmh_torch.ops.metrics import calc_map_k_numpy

    mat = scio.loadmat(os.path.join(trainer.save_dir, "mat_files", "last.mat"))
    args = [mat[k].astype(np.float32) for k in ("q_img", "q_txt", "r_img", "r_txt", "q_l", "r_l")]
    plain = calc_map_k_4dir(*(torch.from_numpy(a) for a in args))
    oracle = [calc_map_k_numpy(a, b, args[4], args[5])
              for a, b in ((args[0], args[3]), (args[1], args[2]),
                           (args[0], args[2]), (args[1], args[3]))]
    got = trainer.history[-1]["maps"]
    print(f"{tag} last valid mAPs {got}; plain {plain}; numpy {oracle}", flush=True)
    # K3 and the plain version add the same fp32 quotients in fp64; numpy
    # divides in fp64 (one fp32 rounding a term)
    if not (np.allclose(got, plain, rtol=0, atol=1e-12)
            and np.allclose(got, oracle, rtol=0, atol=1e-7)):
        raise AssertionError(f"{tag} the last valid's mAPs differ from the recomputation")


def trackers(tr):
    return (tr.global_step, tr.optimizer.step_count, tr.max_mapi2t, tr.max_mapt2i,
            tr.best_epoch_i, tr.best_epoch_t)


def same_state(torch, a, b):
    """Names of the model tensors, optimizer vectors and other optimizers'
    state tensors (SGD momentum buffers) that differ."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    bad = [k for k in sa if not torch.equal(sa[k], sb[k])]
    for i, (ga, gb) in enumerate(zip(a.optimizer.state_dict()["groups"],
                                     b.optimizer.state_dict()["groups"])):
        bad += [f"group {i} {k}" for k in ("m", "v") if not torch.equal(ga[k], gb[k])]
    if a.extra_optimizers.keys() != b.extra_optimizers.keys():
        return bad + ["extra optimizers"]
    for name in a.extra_optimizers:
        xa = a.extra_optimizers[name].state_dict()
        xb = b.extra_optimizers[name].state_dict()
        if xa["param_groups"] != xb["param_groups"] or xa["state"].keys() != xb["state"].keys():
            bad.append(f"{name} groups")
            continue
        for i, st in xa["state"].items():
            bad += [f"{name} {k}" for k, v in st.items()
                    if not ((v is None and xb["state"][i][k] is None)
                            or torch.equal(v, xb["state"][i][k]))]
    return bad


def check_resume(torch, counters, trainer, root):
    """8b: the same command again resumes at epoch 3 and trains nothing."""
    reset_counts(counters)
    t0 = time.perf_counter()
    again = train_cli(TRAIN_CONFIG, os.path.join(root, "main"))
    torch.cuda.synchronize()
    launches = read_counts(counters)
    bad = same_state(torch, trainer, again)
    print(f"[resume] {time.perf_counter() - t0:.1f} s; epochs trained {len(again.history)}; "
          f"launches {sum(launches.values())}; step, step_count and best tracking "
          f"{trackers(again)} (run a {trackers(trainer)}); "
          f"{len(again.model.state_dict())} model tensors and "
          f"{2 * len(again.optimizer.param_groups)} optimizer vectors, "
          f"{len(bad)} differ", flush=True)
    if again.history or any(launches.values()):
        raise AssertionError(f"the resumed run trained: {again.history}, {launches}")
    if trackers(again) != trackers(trainer) or bad:
        raise AssertionError(f"the resumed state differs from run a's: {bad[:8]}")


def preemption(torch):
    """8c: SIGTERM in epoch 1; the emergency save; the same command resumes."""
    import numpy as np
    import yaml

    from cmh_torch.runners.base import BaseTrainer

    root = tempfile.mkdtemp(prefix="cmh_smoke_preempt_")
    try:
        with open(TRAIN_CONFIG) as f:
            cfg = yaml.safe_load(f)
        cfg["run"].update(train_num=200, query_num=100)     # 2 steps an epoch
        cfg_path = os.path.join(root, "preempt.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f)
        steps_per_epoch = -(-cfg["run"]["train_num"] // cfg["run"]["batch_size"])
        orig = BaseTrainer.train_step

        def sigterm_in_epoch_1(self, batch):
            out = orig(self, batch)
            if self.global_step == steps_per_epoch + 1:
                signal.raise_signal(signal.SIGTERM)
            return out

        BaseTrainer.train_step = sigterm_in_epoch_1
        try:
            first = train_cli(cfg_path, os.path.join(root, "run"))
        finally:
            BaseTrainer.train_step = orig
        emergency = os.path.join(first.save_dir, "emergency.ckpt.pt")
        meta = read_sidecar(emergency)
        if meta["epoch"] != 1 or len(first.history) != 1:
            raise AssertionError(f"preempted run: sidecar {meta}, {len(first.history)} epochs")
        second = train_cli(cfg_path, os.path.join(root, "run"))
        losses = [h["loss"] for h in second.history]
        print(f"[preempt] SIGTERM at step {steps_per_epoch + 1}: emergency.ckpt.pt epoch "
              f"{meta['epoch']}, step {first.global_step}; the restart trained epochs "
              f"{[h['epoch'] for h in second.history]} to step {second.global_step}, losses "
              f"{losses}", flush=True)
        if [h["epoch"] for h in second.history] != [1, 2] or not np.all(np.isfinite(losses)):
            raise AssertionError("the preempted run did not resume and finish")
        if second.global_step != first.global_step + 2 * steps_per_epoch:
            raise AssertionError(f"resumed at step {second.global_step - 2 * steps_per_epoch}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def flat_optimizer(torch):
    """8d: BertAdam's flat path over the full-width parameter list, two steps
    of seeded gradients (logit_scale gets none, as in training): the card
    against the CPU and against the card's tree path, and rerun bit-equal."""
    from cmh_torch.models.clip.model import CLIPConfig
    from cmh_torch.models.dcmht import DCMHTModel
    from cmh_torch.optim.bert_adam import BertAdam, _FlatSpec
    from cmh_torch.optim.partition import param_groups

    base = DCMHTModel(CLIPConfig(), CODE_BITS)
    base.init_weights(seed_key(0), "cuda")
    gen = torch.Generator().manual_seed(9)
    # 1e-3 an element: the clip takes every tensor of more than 1e6 elements
    grads = [[None if n.endswith("logit_scale") else torch.randn(p.shape, generator=gen) * 1e-3
              for n, p in base.named_parameters()] for _ in range(2)]
    clipped = sum(1 for g in grads[0] if g is not None and float(g.norm()) > 1.0)
    # configs/DCMHT/synthetic_tpu.yaml's settings, 18 steps
    common = dict(warmup=0.1, t_total=18, schedule="warmup_cosine", b1=0.9, b2=0.98, e=1e-6,
                  weight_decay=0.2, max_grad_norm=1.0)

    def run(device, flat):
        model = copy.deepcopy(base).to(device)
        opt = BertAdam(param_groups(model, 0.001, 0.00001), lr=0.001, flat=flat, **common)
        for step in grads:
            for p, g in zip(model.parameters(), step):
                p.grad = None if g is None else g.to(device)
            opt.step()
        if device == "cuda":
            torch.cuda.synchronize()
        return model, opt

    def moments(opt):   # each group's m and v, unpadded, on the host
        out = []
        for group, saved in zip(opt.param_groups, opt.state_dict()["groups"]):
            for k in ("m", "v"):
                ts = saved[k]
                if torch.is_tensor(ts):
                    ts = _FlatSpec(group["params"]).views(ts)
                out.append(torch.cat([t.reshape(-1).cpu() for t in ts]))
        return out

    def diff(a, b):     # largest parameter difference, largest moment one relative
        (ma, oa), (mb, ob) = a, b
        dp = max((x.detach().cpu() - y.detach().cpu()).abs().max().item()
                 for x, y in zip(ma.parameters(), mb.parameters()))
        dm = max(((x - y).abs().max() / y.abs().max()).item()
                 for x, y in zip(moments(oa), moments(ob)) if x.numel())
        return dp, dm

    card = run("cuda", True)
    cpu = run("cpu", True)
    d_cpu = diff(card, cpu)
    del cpu
    again = run("cuda", True)
    rerun_equal = (all(torch.equal(x, y) for x, y in zip(card[0].parameters(),
                                                            again[0].parameters()))
                   and all(torch.equal(x, y) for x, y in zip(moments(card[1]),
                                                               moments(again[1]))))
    del again
    tree = run("cuda", False)
    d_tree = diff(card, tree)
    times = {}
    for name, (model, opt) in (("flat", card), ("tree", tree)):
        # host clock of one step, enqueue to finish, then its device time
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        times[name] = {"wall_ms": (time.perf_counter() - t0) * 1e3,
                       "device_ms": cuda_ms(opt.step, iters=5, warmup=1)}
    n = sum(1 for _ in base.parameters())
    print(f"[optim] flat BertAdam, {n} tensors, {sum(p.numel() for p in base.parameters())} "
          f"parameters, {clipped} clipped: card vs CPU flat max |dparam| {d_cpu[0]:.3e}, moments "
          f"{d_cpu[1]:.3e} relative; card flat vs card tree {d_tree[0]:.3e}, {d_tree[1]:.3e}; "
          f"rerun bit-equal {rerun_equal}; one step {times}", flush=True)
    if not (d_cpu[0] <= 1e-6 and d_cpu[1] <= 1e-6 and d_tree[0] <= 1e-6 and d_tree[1] <= 1e-6):
        raise AssertionError(f"flat BertAdam differs: vs CPU {d_cpu}, vs tree {d_tree}")
    if not rerun_equal:
        raise AssertionError("flat BertAdam on the card gave other bits on a rerun")


def model_parity(torch, geometry=None, n=8, tag="[parity]"):
    """Full-width fp32 DCMHT (ViT-B/32, or the CLIP ``geometry``) on ``n``
    pairs: card (kernels) against CPU (plain versions)."""
    import numpy as np

    from cmh_torch.models.clip.model import CLIPConfig
    from cmh_torch.models.clip.tokenizer import SimpleTokenizer, tokenize_caption
    from cmh_torch.models.dcmht import DCMHTModel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = DCMHTModel(CLIPConfig(**(geometry or {}), dtype=torch.float32), CODE_BITS)
    model.init_weights(seed_key(0), "cuda").eval()
    cpu_model = copy.deepcopy(model)
    gpu_model = model.to("cuda")
    rng = np.random.RandomState(1)
    img = torch.from_numpy(rng.randn(n, 224, 224, 3).astype(np.float32))
    tok = SimpleTokenizer()
    caps = CAPTIONS[:n]
    ids, kpm = (torch.from_numpy(np.stack(a)) for a in
                zip(*(tokenize_caption(tok, c, MAX_WORDS) for c in caps)))
    out = {}
    with torch.no_grad():
        for name, run in (("image", lambda m, d: m.encode_image(img.to(d))),
                          ("text", lambda m, d: m.encode_text(ids.to(d), kpm.to(d)))):
            h_gpu = run(gpu_model, "cuda").cpu()
            h_cpu = run(cpu_model, "cpu")
            rel = ((h_gpu - h_cpu).abs().max() / h_cpu.abs().max()).item()
            pairs_cpu = h_cpu.reshape(n, -1, 2)
            margin = (pairs_cpu[..., 1] - pairs_cpu[..., 0]).abs()
            agree = cpu_model.make_hash_code(h_cpu) == gpu_model.make_hash_code(h_gpu)
            decided = margin >= 1e-3
            out[name] = {"max_rel_diff": rel, "code_agreement": agree.float().mean().item(),
                         "undecided_pairs": int((~decided).sum())}
            print(f"{tag} {name}: max rel diff {rel:.3e}, codes agree "
                  f"{out[name]['code_agreement']:.4f} "
                  f"({out[name]['undecided_pairs']} pairs with margin < 1e-3)", flush=True)
            # fp32 with TF32 off on both: only summation order differs
            if not (np.isfinite(rel) and rel <= 1e-5):
                raise AssertionError(f"{name} head outputs differ: {rel}")
            if not bool(agree[decided].all()):
                raise AssertionError(f"{name} codes differ at a pair with margin >= 1e-3")
    return out


CAPTIONS = [
    "a dog running on the grass", "two people riding bikes down a hill",
    "A red car parked next to 3 trees.", "café terrace at night, Paris",
    "a plate of sushi and chopsticks", "children playing football at 5pm",
    "an old man reading the newspaper", "snow-covered mountains under a blue sky",
]


def request(port, method, path, payload=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        body = json.dumps(payload) if payload is not None else None
        conn.request(method, path, body=body, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def serving(torch, counters):
    import numpy as np

    from cmh_torch.config import config_from_dict
    from cmh_torch.export import load_encoders, save_encoders
    from cmh_torch.models.clip.tokenizer import SimpleTokenizer, tokenize_caption
    from cmh_torch.models.dcmht import DCMHTModel
    from cmh_torch.ops.hashing import unpack_bits
    from cmh_torch.server import RetrievalApp, make_server
    from cmh_torch.serving import _DEVICE_BLOCK, RetrievalIndex

    os.makedirs(WORK, exist_ok=True)
    cfg = config_from_dict({"model": {"arch": "DCMHT", "hash_func": "softmax"},
                            "run": {"output_dim": CODE_BITS},
                            "dataset": {"max_word": MAX_WORDS}})
    model = DCMHTModel.from_config(cfg)
    model.init_weights(seed_key(0), "cuda")
    enc_path = os.path.join(WORK, "enc.pt")
    save_encoders(model, cfg, enc_path)
    enc = load_encoders(enc_path, device="cuda")
    tok = SimpleTokenizer()
    has_pil = importlib.util.find_spec("PIL") is not None
    rng = np.random.RandomState(7)
    nblocks = -(-INDEX_ITEMS // _DEVICE_BLOCK)

    reset_counts(counters)
    # ---- the main path: gallery encode, index, HTTP requests
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(3)
    index = RetrievalIndex(CODE_BITS, device="cuda")
    for _ in range(GALLERY_IMAGES // B):
        imgs = torch.randn((B, 224, 224, 3), generator=gen, device="cuda")
        index.add(enc.encode_image(imgs))
    torch.cuda.synchronize()
    t_gallery = time.perf_counter() - t0
    fill = INDEX_ITEMS - len(index)
    index.add(torch.randint(0, 2, (fill, CODE_BITS), generator=gen, device="cuda").float() * 2 - 1)
    idx_path = os.path.join(WORK, "index.npz")
    index.save(idx_path)

    app = RetrievalApp(index, enc, tok, max_words=MAX_WORDS, image_size=224)
    server = make_server(app, "127.0.0.1", 0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    asked, lat = [], []
    expect = {"layernorm": 26 * (GALLERY_IMAGES // B), "attention": 11 * (GALLERY_IMAGES // B),
              "hamming": 0, "layernorm_bwd": 0, "attention_bwd": 0, "map_hist": 0,
              "map_ap": 0}
    try:
        status, health = request(port, "GET", "/healthz")
        assert status == 200 and health["count"] == INDEX_ITEMS, health
        for i in range(4):
            caps = CAPTIONS[2 * i: 2 * i + 2]
            asked.append(("/search_text", {"text": caps, "topk": 10}))
            expect["layernorm"] += 25
            expect["attention"] += 11
            expect["hamming"] += nblocks
        gallery_codes = index._gallery()[:4]
        for i in range(2):
            codes = rng.choice([-1.0, 1.0], (4, CODE_BITS)).astype(np.float32)
            if i == 0:   # one query equal to a gallery item: distance 0 must come back
                codes[0] = unpack_bits(gallery_codes[:1].cpu(), CODE_BITS)[0].numpy()
                self_query = len(asked)
            asked.append(("/search", {"codes": codes.tolist(), "topk": 10}))
            expect["hamming"] += nblocks
        images = []
        if has_pil:
            from PIL import Image

            for i in range(2):
                im = Image.fromarray(rng.randint(0, 255, (240, 320, 3), dtype=np.uint8))
                buf = io.BytesIO()
                im.save(buf, format="PNG")
                images.append(im)
                asked.append(("/search_image",
                              {"image_b64": [base64.b64encode(buf.getvalue()).decode()],
                               "topk": 10}))
                expect["layernorm"] += 26
                expect["attention"] += 11
                expect["hamming"] += nblocks
        print(f"[serving] /search_image {'on' if has_pil else 'skipped: PIL not installed'}",
              flush=True)
        answers = []
        for path, payload in asked:
            t = time.perf_counter()
            status, out = request(port, "POST", path, payload)
            lat.append((time.perf_counter() - t) * 1e3)
            if status != 200:
                raise AssertionError(f"{path} -> {status}: {out}")
            answers.append(out)
        torch.cuda.synchronize()
        launches = read_counts(counters)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    t_main = time.perf_counter() - t0
    # ---- end of the main path
    print(f"[serving] {len(asked)} requests over HTTP, index {INDEX_ITEMS} items; "
          f"gallery encode {t_gallery:.3f} s for {GALLERY_IMAGES} images; "
          f"main path {t_main:.3f} s; request ms {[round(x, 3) for x in lat]}", flush=True)
    print(f"[serving] launches {launches} expected {expect}", flush=True)
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect}")

    # every answer against the plain path: a CPU copy of the index
    cpu_index = RetrievalIndex.load(idx_path, device="cpu")
    from cmh_torch.data.transforms import eval_transform

    img_iter = iter(images)
    for (path, payload), out in zip(asked, answers):
        if path == "/search_text":
            ids, masks = zip(*(tokenize_caption(tok, c, MAX_WORDS) for c in payload["text"]))
            codes = enc.encode_text(np.stack(ids), np.stack(masks))
        elif path == "/search":
            codes = np.asarray(payload["codes"], np.float32)
        else:
            codes = enc.encode_image(eval_transform(next(img_iter), 224)[None])
        want_d, want_i = cpu_index.search(codes, topk=payload["topk"])
        if out["dist"] != want_d.tolist() or out["idx"] != want_i.tolist():
            raise AssertionError(f"{path} answer differs from the plain top-k")
    if answers[self_query]["dist"][0][0] != 0:
        raise AssertionError("a gallery item's own code did not come back at distance 0")
    print(f"[serving] all {len(asked)} answers equal the plain top-k", flush=True)
    search_split(torch, index._gallery(), rng)
    return launches


def search_split(torch, gallery, rng):
    """Device time of one 4-query search over the whole index: K4 on both
    gallery blocks, against ``topk_blocked`` whole (K4, the int64 keys and
    the ``torch.topk`` merge). Printed, not a metric."""
    import numpy as np

    from cmh_torch.ops.hamming import hamming_packed
    from cmh_torch.ops.hashing import pack_bits
    from cmh_torch.serving import _DEVICE_BLOCK, topk_blocked

    q = pack_bits(torch.from_numpy(
        rng.choice([-1.0, 1.0], (4, CODE_BITS)).astype(np.float32)).to("cuda"))
    n = gallery.shape[0]
    blocks = [gallery[s:s + _DEVICE_BLOCK] for s in range(0, n, _DEVICE_BLOCK)]
    k4 = cuda_ms(lambda: [hamming_packed(q, b, bits=CODE_BITS) for b in blocks])
    whole = cuda_ms(lambda: topk_blocked(q, gallery, 10, _DEVICE_BLOCK, CODE_BITS))
    print(f"[serving] one search of 4 queries over {n} items, device ms: K4 on the "
          f"{len(blocks)} blocks {k4:.5f}; topk_blocked whole {whole:.5f}; keys and "
          f"merge {whole - k4:.5f}", flush=True)


def code_bits_agree(torch, card, cpu, what):
    """The bf16-step rule applied to ±1 codes: at most 1% of the code bits
    (at least one) may differ between the card and the CPU, each where the
    CPU's continuous output is within 0.05 of the decision boundary (the
    pair's probability gap for pair-argmax codes, |h| for sign codes).
    ``card`` and ``cpu`` are (codes, continuous outputs)."""
    (codes_g, h_g), (codes_c, h_c) = ((c.float().cpu(), h.float().cpu()) for c, h in (card, cpu))
    pairs = h_c.reshape(*codes_c.shape, -1)
    margin = (pairs[..., 1] - pairs[..., 0]).abs() if pairs.shape[-1] == 2 else pairs[..., 0].abs()
    differ = codes_g != codes_c
    n, far = int(differ.sum()), int((differ & (margin >= 0.05)).sum())
    print(f"[pretrained] {what}: {n} of {differ.numel()} code bits differ card/CPU "
          f"({far} with a CPU margin >= 0.05); head outputs max abs diff "
          f"{(h_g - h_c).abs().max().item():.3e}", flush=True)
    if far or n > max(1, differ.numel() // 100):
        raise AssertionError(f"{what}: {n} code bits differ card/CPU, {far} decided ones")


def pretrained_load(torch, counters):
    """Phase 9: a seeded ViT-B/32 CLIP in OpenAI's layout (fp16 tensors and
    the three integer entries), written as a plain state dict and as a
    TorchScript archive, read by the DCMHT trainer through ``model.clip_path``."""
    import yaml

    from cmh_torch.config import config_from_dict
    from cmh_torch.models.clip.loader import save_torchscript_archive
    from cmh_torch.models.clip.model import CLIP, CLIPConfig
    from cmh_torch.runners.dcmht import DCMHTTrainer

    root = tempfile.mkdtemp(prefix="cmh_smoke_clip_")
    launches = {}
    try:
        clip = CLIP(CLIPConfig())
        clip.init_weights(seed_key(9), "cuda")
        half = {k: v.detach().half() for k, v in clip.state_dict().items()}
        del clip
        ints = {k: torch.tensor(v) for k, v in OPENAI_INTS.items()}
        files = {"fp16 state dict": os.path.join(root, "ViT-B-32-sd.pt"),
                 "TorchScript archive": os.path.join(root, "ViT-B-32.pt")}
        torch.save({**half, **ints}, files["fp16 state dict"])
        save_torchscript_archive({**half, **ints}, files["TorchScript archive"])
        with open(TRAIN_CONFIG) as f:
            cfg = yaml.safe_load(f)
        batch = device_batch(torch, torch.Generator(device="cuda").manual_seed(8), B)
        first = None
        for what, path in files.items():
            cfg["model"]["clip_path"] = path
            cfg["run"].update(save_dir=os.path.join(root, "run"), log_dir=os.path.join(root, "log"))
            t0 = time.perf_counter()
            tr = DCMHTTrainer.from_config(cfg=config_from_dict(cfg), device="cuda", auto_run=False)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            if tr.model.backbone.cfg != CLIPConfig():
                raise AssertionError(f"{what}: inferred {tr.model.backbone.cfg}, not ViT-B/32")
            sd = tr.model.state_dict()
            bad = [k for k, v in half.items() if not torch.equal(sd["backbone." + k].cpu(), v.float())]
            n_backbone = sum(1 for k in sd if k.startswith("backbone."))
            if bad or n_backbone != len(half):
                raise AssertionError(f"{what}: backbone tensors differ from the file: {bad[:5]}")
            reset_counts(counters)
            tr.model.eval()
            with torch.no_grad():
                h_img = tr.model.encode_image(batch["image"])
                h_txt = tr.model.encode_text(batch["text"], batch["key_padding_mask"])
                card = [(tr.method.make_hash_code(h), h) for h in (h_img, h_txt)]
            torch.cuda.synchronize()
            launches[what] = read_counts(counters)
            print(f"[pretrained] {what}: {os.path.getsize(path)} bytes, trainer built and "
                  f"backbone loaded in {load_s:.2f} s; config ViT-B/32 bf16; {len(half)} "
                  f"backbone tensors equal the file's; eval of {B} pairs launches "
                  f"{launches[what]}", flush=True)
            if first is None:
                first = card
                # the CPU model read from the same file, in the same dtype
                cpu_tr = DCMHTTrainer.from_config(cfg=config_from_dict(cfg), device="cpu",
                                                  auto_run=False)
                cpu_tr.model.eval()
                t0 = time.perf_counter()
                with torch.no_grad():
                    hc_img = cpu_tr.model.encode_image(batch["image"].cpu())
                    hc_txt = cpu_tr.model.encode_text(batch["text"].cpu(),
                                                      batch["key_padding_mask"].cpu())
                print(f"[pretrained] CPU reference forward {time.perf_counter() - t0:.1f} s",
                      flush=True)
                for name, got, h in (("image", card[0], hc_img), ("text", card[1], hc_txt)):
                    code_bits_agree(torch, got, (cpu_tr.method.make_hash_code(h), h), name)
                del cpu_tr
            elif not all(torch.equal(a[0], b[0]) for a, b in zip(card, first)):
                raise AssertionError(f"{what}: codes differ from the first file's")
            del tr
    finally:
        shutil.rmtree(root, ignore_errors=True)
    total = {k: sum(l[k] for l in launches.values()) for k in counters}
    expect = {k: 0 for k in counters}
    expect.update(layernorm=2 * 51, attention=2 * 22)
    if total != expect:
        raise AssertionError(f"pretrained eval launches {total} != {expect}")
    return total


METHOD_CONFIGS = {arch: os.path.join(ROOT, "configs", arch, "config.yaml")
                  for arch in ("DSPH", "DNPH", "MITH", "TwDH", "DIMCH", "UMoED")}


def method_config(arch):
    """Phase 10's and 11's YAML: ``configs/{arch}/config.yaml`` (Baseline
    has none: DSPH's optimizer and run sections, with Baseline's model) with
    the dataset of ``configs/DCMHT/synthetic_tpu.yaml`` and 8 classes (a
    method's ``numclass``); 2 epochs of 2 steps at batch 100, a checkpoint
    after each, auto-resume; DSPH with ``run.remat``."""
    import yaml

    with open(TRAIN_CONFIG) as f:
        synthetic = yaml.safe_load(f)
    with open(METHOD_CONFIGS.get(arch, METHOD_CONFIGS["DSPH"])) as f:
        cfg = yaml.safe_load(f)
    if arch == "Baseline":
        cfg["model"] = {"arch": "Baseline", "clip_path": "./ViT-B-32.pt", "hash_func": "tanh",
                        "quan_alpha": 0.001}
        cfg["optimizer"].pop("hyp")
        cfg["run"]["arch"] = "BaselineTrainer"
    cfg["model"]["numclass"] = synthetic["dataset"]["num_classes"]
    cfg["dataset"] = synthetic["dataset"]
    cfg["run"].update(epochs=2, train_num=200, query_num=100, batch_size=100, display_step=1,
                      checkpoint_every=1, auto_resume=True, remat=arch == "DSPH")
    return cfg


def train_methods(torch, counters):
    """Phase 10: Baseline, DSPH and DNPH through the CLI at full width, each
    run twice on one save root (the rerun resumes at epoch 2 and trains
    nothing); after DSPH, phase 7's search on its exported encoders."""
    import numpy as np
    import yaml

    from cmh_torch.ops.hungarian import assign_noise

    by_path = {}
    for arch in ("Baseline", "DSPH", "DNPH"):
        root = tempfile.mkdtemp(prefix=f"cmh_smoke_{arch.lower()}_")
        try:
            cfg = method_config(arch)
            cfg_path = os.path.join(root, "config.yaml")
            with open(cfg_path, "w") as f:
                yaml.safe_dump(cfg, f)
            steps, expect = expected_launches(cfg, remat=cfg["run"]["remat"])
            reset_counts(counters)
            calls0, host0, solve0 = (assign_noise.calls, assign_noise.host_seconds,
                                     assign_noise.solve_seconds)
            # ---- the main path: python -m cmh_torch.main, in-process
            t0 = time.perf_counter()
            tr = train_cli(cfg_path, os.path.join(root, "run"))
            torch.cuda.synchronize()
            launches = read_counts(counters)
            t_main = time.perf_counter() - t0
            # ---- end of the main path
            by_path[arch] = launches
            hist = tr.history
            train_s = sum(h["seconds"] for h in hist)
            wait_s = sum(h["data_wait_s"] for h in hist)
            print(f"[{arch}] {steps} steps: {train_s / steps * 1e3:.1f} ms a step on the host "
                  f"clock, {(train_s - wait_s) / steps * 1e3:.1f} ms without the data waits; "
                  f"main path {t_main:.1f} s; epoch losses {[h['loss'] for h in hist]}; "
                  f"mAPs {[h['maps'] for h in hist]}", flush=True)
            print(f"[{arch}] launches {launches} expected {expect}", flush=True)
            if launches != expect:
                raise AssertionError(f"{arch}: launch counts {launches} != expected {expect}")
            if len(hist) != 2 or not all(np.isfinite(h["loss"]) for h in hist):
                raise AssertionError(f"{arch}: non-finite or missing epoch losses: {hist}")
            check_last_maps(torch, tr, f"[{arch}]")
            if arch == "DNPH":
                calls = assign_noise.calls - calls0
                print(f"[DNPH] Hungarian solves: {calls} ({calls // steps} a step), "
                      f"{(assign_noise.host_seconds - host0) / steps * 1e3:.3f} ms a step on "
                      f"the host, the device-to-host copy of the cost included (it waits for "
                      f"the forward), of which the solves "
                      f"{(assign_noise.solve_seconds - solve0) / steps * 1e3:.3f} ms", flush=True)
                if calls != 2 * steps:
                    raise AssertionError(f"DNPH: {calls} Hungarian solves in {steps} steps")
            reset_counts(counters)
            again = train_cli(cfg_path, os.path.join(root, "run"))
            torch.cuda.synchronize()
            relaunched = sum(read_counts(counters).values())
            bad = same_state(torch, tr, again)
            print(f"[{arch}] rerun: epochs trained {len(again.history)}, launches {relaunched}; "
                  f"{len(again.model.state_dict())} model tensors, BertAdam and "
                  f"{sorted(again.extra_optimizers) or 'no other optimizer'}: {len(bad)} differ",
                  flush=True)
            if again.history or relaunched:
                raise AssertionError(f"{arch}: the rerun trained: {again.history}")
            if trackers(again) != trackers(tr) or bad:
                raise AssertionError(f"{arch}: the resumed state differs: {bad[:8]}")
            del again
            if arch == "DSPH":
                by_path["DSPH serving"] = dsph_search(torch, counters, tr)
                remat_memory(torch, tr)
            steady_steps(torch, tr, arch)
            del tr
        finally:
            shutil.rmtree(root, ignore_errors=True)
    return by_path


def steady_steps(torch, tr, arch, n=3):
    """Host clock of ``n`` more train steps on a batch made on the card,
    each ended by a synchronise, after the run's warm-up (outside the main
    path's counts); for DNPH with its Hungarian step split into the
    device→host copy of the cost (which waits for the forward) and the
    solves."""
    from cmh_torch.ops.hungarian import assign_noise

    batch = device_batch(torch, torch.Generator(device="cuda").manual_seed(10), TRAIN_B)
    tr.train_step(batch)
    torch.cuda.synchronize()
    host0, solve0 = assign_noise.host_seconds, assign_noise.solve_seconds
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        tr.train_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    line = (f"[{arch}] steady train steps at batch {TRAIN_B}, host clock: "
            f"{[round(t, 3) for t in times]} ms" + (" (remat)" if tr.remat else ""))
    if arch == "DNPH":
        host = (assign_noise.host_seconds - host0) / n * 1e3
        solve = (assign_noise.solve_seconds - solve0) / n * 1e3
        line += (f"; Hungarian step {host:.3f} ms a step: copy of the cost {host - solve:.3f}, "
                 f"two solves {solve:.3f}")
    print(line, flush=True)
    return [round(t, 3) for t in times]


def remat_memory(torch, tr):
    """Peak device memory of one DSPH train step at batch 100, with
    ``run.remat`` and without (the same trainer; two steps outside the main
    path's counts). Printed, not checked: the recompute of one segment that
    spans the whole forward brings its activations back at once."""
    batch = device_batch(torch, torch.Generator(device="cuda").manual_seed(9), TRAIN_B)
    peaks = {}
    for remat in (True, False):
        tr.remat = remat
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tr.train_step(batch)
        torch.cuda.synchronize()
        peaks[remat] = (torch.cuda.max_memory_allocated(), before)
    tr.remat = True
    print(f"[DSPH] peak device memory of one train step (torch.cuda.max_memory_allocated): "
          f"remat {peaks[True][0] / 2**30:.3f} GiB, without {peaks[False][0] / 2**30:.3f} GiB "
          f"({(peaks[True][0] - peaks[True][1]) / 2**30:.3f} and "
          f"{(peaks[False][0] - peaks[False][1]) / 2**30:.3f} GiB above the "
          f"{peaks[True][1] / 2**30:.3f} GiB held before the step)", flush=True)


def dsph_search(torch, counters, trainer):
    """Phase 7, DSPH: encoders exported from phase 10's trained model and
    reloaded encode 256 images (codes equal to the trainer's model's) into
    a 16-bit index filled past 2^20 items; one search of 4 captions runs
    through K4 and equals a CPU copy of the index."""
    import numpy as np

    from cmh_torch.export import load_encoders, save_encoders
    from cmh_torch.models.clip.tokenizer import SimpleTokenizer, tokenize_caption
    from cmh_torch.serving import _DEVICE_BLOCK, RetrievalIndex

    os.makedirs(WORK, exist_ok=True)
    enc_path = os.path.join(WORK, "dsph_enc.pt")
    save_encoders(trainer.model, trainer.cfg, enc_path)
    enc = load_encoders(enc_path, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(13)
    imgs = torch.randn((B, 224, 224, 3), generator=gen, device="cuda")
    tok = SimpleTokenizer()
    ids, masks = (np.stack(a) for a in zip(*(tokenize_caption(tok, c, MAX_WORDS)
                                              for c in CAPTIONS[:4])))
    reset_counts(counters)
    # ---- the main path: encode, index, search
    codes = enc.encode_image(imgs)
    index = RetrievalIndex(CODE_BITS, device="cuda")
    index.add(codes)
    index.add(torch.randint(0, 2, (INDEX_ITEMS - B, CODE_BITS), generator=gen,
                            device="cuda").float() * 2 - 1)
    queries = enc.encode_text(ids, masks)
    dist, idx = index.search(queries, topk=10)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    # ---- end of the main path
    trainer.model.eval()
    with torch.no_grad():
        want = trainer.method.make_hash_code(trainer.model.encode_image(imgs)).cpu().numpy()
    if not np.array_equal(codes, want):
        raise AssertionError("DSPH: exported encoders' codes differ from the trainer's")
    path = os.path.join(WORK, "dsph_index.npz")
    index.save(path)
    want_d, want_i = RetrievalIndex.load(path, device="cpu").search(queries, topk=10)
    if not (np.array_equal(np.asarray(dist), np.asarray(want_d))
            and np.array_equal(np.asarray(idx), np.asarray(want_i))):
        raise AssertionError("DSPH: the search differs from the plain top-k")
    expect = {k: 0 for k in counters}
    expect.update(layernorm=51, attention=22, hamming=-(-INDEX_ITEMS // _DEVICE_BLOCK))
    print(f"[serving-DSPH] {B} images encoded by the exported encoders (codes equal the "
          f"trainer's), index {len(index)} items, 4 caption queries: results equal the plain "
          f"top-k; launches {launches} expected {expect}", flush=True)
    if launches != expect:
        raise AssertionError(f"DSPH search launches {launches} != expected {expect}")
    return launches


def check_width_maps(torch, trainer, tag):
    """TwDH: each code width's best-i→t ``.mat`` (``i2t-long.mat``,
    ``i2t-short-<k>.mat``) recomputed by the plain counting rank and the
    numpy oracle equals the four mAPs that width's ``valid`` gave in the
    epoch that wrote it."""
    import numpy as np
    import scipy.io as scio

    from cmh_torch.ops.map_bucketed import calc_map_k_4dir
    from cmh_torch.ops.metrics import calc_map_k_numpy

    epochs = {"long": trainer.best_epoch_i,
              **{k: v["i2t"] for k, v in trainer.best_epoch_short.items()}}
    for width, epoch in epochs.items():
        name = "i2t-long" if width == "long" else f"i2t-short-{width}"
        mat = scio.loadmat(os.path.join(trainer.save_dir, "mat_files", f"{name}.mat"))
        args = [mat[k].astype(np.float32)
                for k in ("q_img", "q_txt", "r_img", "r_txt", "q_l", "r_l")]
        plain = calc_map_k_4dir(*(torch.from_numpy(a) for a in args))
        oracle = [calc_map_k_numpy(a, b, args[4], args[5])
                  for a, b in ((args[0], args[3]), (args[1], args[2]),
                               (args[0], args[2]), (args[1], args[3]))]
        got = [h for h in trainer.history if h["epoch"] == epoch][0]["maps_by_width"][width]
        print(f"{tag} {name}.mat ({args[0].shape[1]} bits, epoch {epoch}): mAPs {list(got)}; "
              f"plain {plain}; numpy {oracle}", flush=True)
        if not (np.allclose(got, plain, rtol=0, atol=1e-12)
                and np.allclose(got, oracle, rtol=0, atol=1e-7)):
            raise AssertionError(f"{tag} {name}: the mAPs differ from the recomputation")


def fp32_share(torch, tr):
    """torch.profiler over one more MITH train step on a batch made on the
    card: the device time of the fp32 K1 and K2 kernels (MITH's concept
    transformers) against all the step's kernel time. Printed, not checked."""
    from torch.profiler import ProfilerActivity, profile

    batch = device_batch(torch, torch.Generator(device="cuda").manual_seed(11), TRAIN_B)
    tr.train_step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tr.train_step(batch)
        torch.cuda.synchronize()
    kernels = kernel_events(torch, prof)
    total = sum(_device_us(e) for e in kernels) / 1e3
    fp32 = [e for e in kernels if ("layernorm" in e.key or "attention" in e.key)
            and "kernel<float" in e.key]
    ms = sum(_device_us(e) for e in fp32) / 1e3
    print(f"[MITH] one train step: fp32 K1/K2 kernels {ms:.4f} ms of {total:.3f} ms kernel "
          f"time ({ms / max(total, 1e-9):.2%}), {sum(e.count for e in fp32)} launches: "
          f"{[(e.key[:60], round(_device_us(e) / 1e3, 4), e.count) for e in fp32]}", flush=True)


def train_mith_twdh(torch, counters):
    """Phase 11: MITH and TwDH through the CLI at full width, each run twice
    on one save root (the rerun resumes at epoch 2 and trains nothing)."""
    import numpy as np
    import yaml

    by_path, fp32_by_path = {}, {}
    for arch in ("MITH", "TwDH"):
        root = tempfile.mkdtemp(prefix=f"cmh_smoke_{arch.lower()}_")
        try:
            cfg = method_config(arch)
            cfg_path = os.path.join(root, "config.yaml")
            with open(cfg_path, "w") as f:
                yaml.safe_dump(cfg, f)
            if arch == "MITH":
                steps, expect, expect32 = expected_launches(cfg, fp32=(8, 2))
            else:
                m = cfg["model"]
                steps, expect = expected_launches(cfg, widths=[m["long_dim"], *m["short_dims"]])
                expect32 = {k: 0 for k in read_fp32(counters)}
            reset_counts(counters)
            # ---- the main path: python -m cmh_torch.main, in-process
            t0 = time.perf_counter()
            tr = train_cli(cfg_path, os.path.join(root, "run"))
            torch.cuda.synchronize()
            launches, fp32 = read_counts(counters), read_fp32(counters)
            t_main = time.perf_counter() - t0
            # ---- end of the main path
            by_path[arch], fp32_by_path[arch] = launches, fp32
            hist = tr.history
            train_s = sum(h["seconds"] for h in hist)
            wait_s = sum(h["data_wait_s"] for h in hist)
            print(f"[{arch}] {steps} steps: {train_s / steps * 1e3:.1f} ms a step on the host "
                  f"clock, {(train_s - wait_s) / steps * 1e3:.1f} ms without the data waits; "
                  f"main path {t_main:.1f} s; epoch losses {[h['loss'] for h in hist]}; "
                  f"mAPs {[h.get('maps_by_width', h['maps']) for h in hist]}", flush=True)
            print(f"[{arch}] launches {launches} expected {expect}; fp32 {fp32} expected "
                  f"{expect32}", flush=True)
            if launches != expect or fp32 != expect32:
                raise AssertionError(f"{arch}: launch counts {launches} (fp32 {fp32}) != "
                                     f"expected {expect} (fp32 {expect32})")
            if len(hist) != 2 or not all(np.isfinite(h["loss"]) for h in hist):
                raise AssertionError(f"{arch}: non-finite or missing epoch losses: {hist}")
            if arch == "MITH":
                check_last_maps(torch, tr, "[MITH]")
            else:
                check_width_maps(torch, tr, "[TwDH]")
            reset_counts(counters)
            again = train_cli(cfg_path, os.path.join(root, "run"))
            torch.cuda.synchronize()
            relaunched = sum(read_counts(counters).values())
            bad = same_state(torch, tr, again) + same_tree(torch, tr.method_state,
                                                           again.method_state, "method state")
            if arch == "TwDH" and (again.max_short != tr.max_short
                                   or again.best_epoch_short != tr.best_epoch_short):
                bad.append("max_short")
            print(f"[{arch}] rerun: epochs trained {len(again.history)}, launches {relaunched}; "
                  f"{len(again.model.state_dict())} model tensors, BertAdam, the method state "
                  f"({sorted(again.method_state)})"
                  + (f" and max_short {again.max_short}" if arch == "TwDH" else "")
                  + f": {len(bad)} differ", flush=True)
            if again.history or relaunched:
                raise AssertionError(f"{arch}: the rerun trained: {again.history}")
            if trackers(again) != trackers(tr) or bad:
                raise AssertionError(f"{arch}: the resumed state differs: {bad[:8]}")
            del again
            steady_steps(torch, tr, arch)
            if arch == "MITH":
                fp32_share(torch, tr)
            del tr
        finally:
            shutil.rmtree(root, ignore_errors=True)
    return by_path, fp32_by_path


def same_tree(torch, a, b, what):
    """Names of the tensors of two nested dicts that differ (or the whole
    tree when their keys differ)."""
    if isinstance(a, dict):
        if not isinstance(b, dict) or a.keys() != b.keys():
            return [what]
        return [x for k in a for x in same_tree(torch, a[k], b[k], f"{what}/{k}")]
    return [] if torch.equal(a, b) else [what]


def msgpack_and_search_cpu(torch, counters, index_path):
    """Phase 12: a full-width TwDH ``model-N.msgpack`` in cmh_tpu's layout,
    written from seeded weights with the port's encoder half, read through
    ``run.resume_model`` in test mode (eval codes of 256 pairs equal the
    source model's); then ``search_cpu`` against ``search`` through K4 on
    phase 7's 16-bit index and on a 512-bit TwDH index of 2^18 items."""
    import numpy as np

    from cmh_torch.config import config_from_dict
    from cmh_torch.export import save_encoders
    from cmh_torch.models import convert
    from cmh_torch.native import hash_ops
    from cmh_torch.registry import load_components
    from cmh_torch.serving import RetrievalIndex
    from cmh_torch.utils import flax_msgpack

    cfg = method_config("TwDH")
    root = tempfile.mkdtemp(prefix="cmh_smoke_msgpack_")
    try:
        method = load_components().require_model_class("TwDH").from_config(
            config_from_dict(cfg).model, output_dim=cfg["run"]["output_dim"])
        method.model.init_weights(seed_key(14), "cuda")
        with torch.no_grad():   # BatchNorm statistics off their init
            method.model.hash.img_hash.norm.running_mean.normal_(0, 0.1)
            method.model.hash.img_hash.norm.running_var.uniform_(0.5, 2.0)
        os.makedirs(WORK, exist_ok=True)    # phase 13 serves these encoders
        save_encoders(method.model, config_from_dict(cfg), os.path.join(WORK, "twdh_enc.pt"),
                      method.eval_method_state())
        params, model_state = convert.twdh_state_to_jax(method.model.state_dict())
        path = os.path.join(root, "model-3.msgpack")
        t0 = time.perf_counter()
        with open(path, "wb") as f:
            nbytes = f.write(flax_msgpack.dumps({"params": params, "model_state": model_state}))
        write_s = time.perf_counter() - t0
        del params, model_state
        method.model.to("cuda").eval()
        batch = device_batch(torch, torch.Generator(device="cuda").manual_seed(15), B)
        with torch.no_grad():
            want = [method.make_codes(f(*a)) for f, a in (
                (method.encode_image, (batch["image"],)),
                (method.encode_text, (batch["text"], batch["key_padding_mask"])))]
        cfg["run"].update(is_train=False, resume_model=path, save_dir=os.path.join(root, "test"),
                          log_dir=os.path.join(root, "log"))
        runner = load_components().require_runner_class("TwDHTrainer")

        reset_counts(counters)
        # ---- the main path: test mode from the file, eval codes, two searches
        t0 = time.perf_counter()
        tr = runner.from_config(cfg=config_from_dict(cfg), device="cuda", auto_run=False)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        maps = tr.test()
        tr.model.eval()
        with torch.no_grad():
            got = [tr.method.make_codes(f(*a)) for f, a in (
                (tr.method.encode_image, (batch["image"],)),
                (tr.method.encode_text, (batch["text"], batch["key_padding_mask"])))]
        small = RetrievalIndex.load(index_path, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(16)
        q16 = torch.randint(0, 2, (4, CODE_BITS), generator=gen, device="cuda").float() * 2 - 1
        wide = RetrievalIndex(method.model.output_dim, device="cuda")
        wide.add(got[0][0])
        wide.add(torch.randint(0, 2, ((1 << 18) - B, wide.bits), generator=gen,
                               device="cuda").float() * 2 - 1)
        q512 = got[1][0][:4]
        dev = [small.search(q16, topk=10), wide.search(q512, topk=10)]
        torch.cuda.synchronize()
        launches = read_counts(counters)
        # ---- end of the main path
        wide.save(os.path.join(WORK, "twdh_index.npz"))
        print(f"[msgpack] model-3.msgpack {nbytes} bytes ({os.path.getsize(path)} on disk), "
              f"written in {write_s:.2f} s; trainer built and file read in {load_s:.2f} s; "
              f"test mAPs (long code) {maps}; launches {launches}", flush=True)
        for name, a, b in (("image long", got[0][0], want[0][0]),
                           ("text long", got[1][0], want[1][0]),
                           *((f"{m} short {k}", got[i][1][k], want[i][1][k])
                             for i, m in enumerate(("image", "text")) for k in want[i][1])):
            if not torch.equal(a, b):
                raise AssertionError(f"msgpack: {name} codes differ from the source model's")
        if not np.all(np.isfinite(maps)):
            raise AssertionError(f"msgpack: test mAPs {maps}")
        # 5 eval batches of the test (100 queries, 400 items) and the 256 pairs;
        # one K3 chunk of the long code; K4 on the 2 + 1 gallery blocks
        expect = {k: 0 for k in counters}
        expect.update(layernorm=51 * 6, attention=22 * 6, hamming=3, map_hist=1, map_ap=1)
        if launches != expect:
            raise AssertionError(f"msgpack + search launches {launches} != expected {expect}")
        threads = hash_ops.default_threads()
        for name, index, q, (dd, di) in (("16-bit", small, q16, dev[0]),
                                         ("512-bit TwDH", wide, q512, dev[1])):
            index.search_cpu(q.cpu(), topk=10)       # the build and the host copy
            t0 = time.perf_counter()
            cd, ci = index.search_cpu(q.cpu(), topk=10)
            host_ms = (time.perf_counter() - t0) * 1e3
            equal = np.array_equal(cd, dd) and np.array_equal(ci, di)
            print(f"[search_cpu] {name} index of {len(index)} items, 4 queries: {host_ms:.3f} ms "
                  f"on the host clock, {threads} threads; equal to search through K4: {equal}",
                  flush=True)
            if not equal:
                raise AssertionError(f"search_cpu differs from search on the {name} index")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def train_dimch_umoed(torch, counters):
    """Phase 13: DIMCH and UMoED through the CLI at full width, each run
    twice on one save root (the rerun resumes at epoch 2 and trains
    nothing); after UMoED, its decoder's device time and its exported
    encoders served over HTTP by both backends, and phase 12's TwDH
    encoders behind /search_text. The main paths' threefry launches (the
    init on the card, the dropout masks) are counted apart, for phase 18."""
    import numpy as np
    import yaml

    from cmh_torch.models.common import Dropout

    by_path, fp32_by_path, rand_by_path = {}, {}, {}
    rand = random_counters()
    for arch in ("DIMCH", "UMoED"):
        root = tempfile.mkdtemp(prefix=f"cmh_smoke_{arch.lower()}_")
        try:
            cfg = method_config(arch)
            cfg_path = os.path.join(root, "config.yaml")
            with open(cfg_path, "w") as f:
                yaml.safe_dump(cfg, f)
            if arch == "UMoED":
                # 3 fp32 LayerNorms a decoder layer, in the image and the text head call
                per_pair = 2 * 3 * cfg["model"]["decoder_layers"]
                steps, expect, expect32 = expected_launches(cfg, fp32=(per_pair, 0))
            else:
                steps, expect = expected_launches(cfg)
                expect32 = {k: 0 for k in read_fp32(counters)}
            reset_counts(counters)
            reset_counts(rand)
            drawn0 = (Dropout.masks, Dropout.mask_elements, Dropout.host_seconds)
            # ---- the main path: python -m cmh_torch.main, in-process
            t0 = time.perf_counter()
            tr = train_cli(cfg_path, os.path.join(root, "run"))
            torch.cuda.synchronize()
            launches, fp32 = read_counts(counters), read_fp32(counters)
            rand_by_path[arch] = read_counts(rand)
            t_main = time.perf_counter() - t0
            # ---- end of the main path
            drawn = [b - a for a, b in zip(drawn0, (Dropout.masks, Dropout.mask_elements,
                                                    Dropout.host_seconds))]
            by_path[arch], fp32_by_path[arch] = launches, fp32
            hist = tr.history
            train_s = sum(h["seconds"] for h in hist)
            wait_s = sum(h["data_wait_s"] for h in hist)
            print(f"[{arch}] {steps} steps: {train_s / steps * 1e3:.1f} ms a step on the host "
                  f"clock, {(train_s - wait_s) / steps * 1e3:.1f} ms without the data waits; "
                  f"main path {t_main:.1f} s; epoch losses {[h['loss'] for h in hist]}; "
                  f"mAPs {[h['maps'] for h in hist]}", flush=True)
            print(f"[{arch}] dropout masks: {drawn[0] / steps:.0f} a step, "
                  f"{drawn[1] / steps / 1e6:.1f} M elements a step, drawn on the card "
                  f"({rand_by_path[arch]}); host seconds drawing masks {drawn[2]}", flush=True)
            if drawn[2] != 0:
                raise AssertionError(f"{arch}: {drawn[2]} s of dropout masks drawn on the host")
            print(f"[{arch}] launches {launches} expected {expect}; fp32 {fp32} expected "
                  f"{expect32}", flush=True)
            if launches != expect or fp32 != expect32:
                raise AssertionError(f"{arch}: launch counts {launches} (fp32 {fp32}) != "
                                     f"expected {expect} (fp32 {expect32})")
            if len(hist) != 2 or not all(np.isfinite(h["loss"]) for h in hist):
                raise AssertionError(f"{arch}: non-finite or missing epoch losses: {hist}")
            check_last_maps(torch, tr, f"[{arch}]")
            reset_counts(counters)
            again = train_cli(cfg_path, os.path.join(root, "run"))
            torch.cuda.synchronize()
            relaunched = sum(read_counts(counters).values())
            bad = same_state(torch, tr, again)
            if arch == "UMoED" and umoed_bests(again) != umoed_bests(tr):
                bad.append("the i->i and t->t best tracking")
            print(f"[{arch}] rerun: epochs trained {len(again.history)}, launches {relaunched}; "
                  f"{len(again.model.state_dict())} model tensors and BertAdam"
                  + (f", bests {umoed_bests(again)}" if arch == "UMoED" else "")
                  + f": {len(bad)} differ", flush=True)
            if again.history or relaunched:
                raise AssertionError(f"{arch}: the rerun trained: {again.history}")
            if trackers(again) != trackers(tr) or bad:
                raise AssertionError(f"{arch}: the resumed state differs: {bad[:8]}")
            del again
            RANDOM_STATS[f"{arch} steady ms"] = steady_steps(torch, tr, arch)
            if arch == "UMoED":
                RANDOM_STATS["UMoED masks"] = mask_sizes(torch, tr)
                decoder_time(torch, tr)
                by_path["UMoED serving"] = serve_backends(torch, counters, tr)
            del tr
        finally:
            shutil.rmtree(root, ignore_errors=True)
    by_path["TwDH serving"] = serve_twdh(torch, counters)
    return by_path, fp32_by_path, rand_by_path


def umoed_bests(tr):
    return (tr.max_mapi2i, tr.max_mapt2t, tr.best_epoch_i2i, tr.best_epoch_t2t)


def decoder_time(torch, tr):
    """UMoED's decoder alone: the image and the text head call, forward and
    backward in train mode, on tokens made on the card at batch 100
    (torch.profiler kernel time, after a warm call), beside one whole train
    step's kernel time; and the host ms of that step's dropout masks.
    Printed, not checked."""
    from cmh_torch.models.common import Dropout, dropout_rng
    from cmh_torch.utils import prng

    head = tr.model.hash.hash_module
    gen = torch.Generator(device="cuda").manual_seed(12)
    tokens = [torch.randn(TRAIN_B, n, 512, generator=gen, device="cuda").bfloat16()
              for n in (50, MAX_WORDS)]
    tr.model.train()

    def heads():
        with dropout_rng(prng.PRNGKey(0)):
            loss = sum(head(t)[0].float().square().mean() for t in tokens)
        loss.backward()

    decoder_ms = kernel_busy_ms(torch, heads)
    batch = device_batch(torch, torch.Generator(device="cuda").manual_seed(13), TRAIN_B)
    host0 = Dropout.host_seconds
    step_ms = kernel_busy_ms(torch, lambda: tr.train_step(batch))
    masks_ms = (Dropout.host_seconds - host0) / 2 * 1e3      # two steps: warm and profiled
    if masks_ms:
        raise AssertionError(f"UMoED: {masks_ms} ms of dropout masks drawn on the host")
    tr.model.zero_grad(set_to_none=True)
    print(f"[UMoED] decoder device time (two head calls at batch {TRAIN_B}, "
          f"{UMOED_SLOTS} slots, forward and backward, fp32): {decoder_ms:.3f} ms of kernel "
          f"time; one whole train step {step_ms:.3f} ms of kernel time "
          f"({decoder_ms / max(step_ms, 1e-9):.1%}); its dropout masks {masks_ms:.1f} ms on "
          f"the host", flush=True)


def _serve(app):
    from cmh_torch.server import make_server

    server = make_server(app, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def ask_both_backends(index, enc, asked):
    """``asked`` (path, payload) pairs through one HTTP server a backend
    (``device``: K4 on the card; ``cpu``: the host scorer) on the same index
    and encoders: the answers of each, and /healthz's backend names."""
    from cmh_torch.models.clip.tokenizer import SimpleTokenizer
    from cmh_torch.server import RetrievalApp

    answers, names = {}, []
    for backend in ("device", "cpu"):
        app = RetrievalApp(index, enc, SimpleTokenizer(), backend=backend,
                           max_words=MAX_WORDS, image_size=224)
        server, thread = _serve(app)
        try:
            port = server.server_address[1]
            names.append(request(port, "GET", "/healthz")[1]["backend"])
            answers[backend] = []
            for path, payload in asked:
                status, out = request(port, "POST", path, payload)
                if status != 200:
                    raise AssertionError(f"{backend} {path} -> {status}: {out}")
                answers[backend].append(out)
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
    return answers, names


def serve_backends(torch, counters, trainer):
    """Phase 13, UMoED serving: encoders exported from the trained model
    encode 256 images (codes equal the trainer's) into a 64-bit index of
    2^20 items; the same text, code and image requests over HTTP with
    ``--backend device`` and ``--backend cpu`` must give equal answers."""
    import numpy as np

    from cmh_torch.export import load_encoders, save_encoders
    from cmh_torch.serving import _DEVICE_BLOCK, RetrievalIndex

    os.makedirs(WORK, exist_ok=True)
    enc_path = os.path.join(WORK, "umoed_enc.pt")
    save_encoders(trainer.model, trainer.cfg, enc_path)
    enc = load_encoders(enc_path, device="cuda")
    bits = trainer.method.eval_code_dims()
    gen = torch.Generator(device="cuda").manual_seed(17)
    imgs = torch.randn((B, 224, 224, 3), generator=gen, device="cuda")
    rng = np.random.RandomState(18)
    asked = [("/search_text", {"text": CAPTIONS[i:i + 2], "topk": 10}) for i in (0, 2)]
    asked.append(("/search", {"codes": rng.choice([-1.0, 1.0], (4, bits)).tolist(),
                              "topk": 10}))
    if importlib.util.find_spec("PIL") is not None:
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(rng.randint(0, 255, (240, 320, 3), dtype=np.uint8)).save(buf, "PNG")
        asked.append(("/search_image", {"image_b64": [base64.b64encode(buf.getvalue()).decode()],
                                        "topk": 10}))
    reset_counts(counters)
    # ---- the main path: encode, index, HTTP requests to both backends
    t0 = time.perf_counter()
    codes = enc.encode_image(imgs)
    index = RetrievalIndex(bits, device="cuda")
    index.add(codes)
    index.add(torch.randint(0, 2, ((1 << 20) - B, bits), generator=gen,
                            device="cuda").float() * 2 - 1)
    answers, names = ask_both_backends(index, enc, asked)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    t_main = time.perf_counter() - t0
    # ---- end of the main path
    trainer.model.eval()
    with torch.no_grad():
        want = trainer.method.make_hash_code(trainer.model.encode_image(imgs)).cpu().numpy()
    if not np.array_equal(codes, want):
        raise AssertionError("UMoED: exported encoders' codes differ from the trainer's")
    # a pair's towers (51 K1, 22 K2) and its 18 decoder LayerNorms a head call
    head_ln = 3 * len(trainer.model.hash.hash_module.decoder.layers)
    n_text = sum(p == "/search_text" for p, _ in asked)
    n_image = sum(p == "/search_image" for p, _ in asked)
    blocks = -(-len(index) // _DEVICE_BLOCK)
    expect = {k: 0 for k in counters}
    expect.update(layernorm=(26 + head_ln) * (1 + 2 * n_image) + 2 * n_text * (25 + head_ln),
                  attention=11 * (1 + 2 * n_image + 2 * n_text),
                  hamming=blocks * len(asked))
    equal = answers["device"] == answers["cpu"]
    print(f"[serving-UMoED] {B} images encoded by the exported encoders (codes equal the "
          f"trainer's), {bits}-bit index of {len(index)} items; {len(asked)} requests to each "
          f"of the backends {names}: answers equal {equal}; main path {t_main:.2f} s; launches "
          f"{launches} expected {expect}", flush=True)
    if names != ["device", "cpu"] or not equal:
        raise AssertionError("UMoED: the device and cpu backends answer differently")
    if launches != expect:
        raise AssertionError(f"UMoED serving launches {launches} != expected {expect}")
    return launches


def serve_twdh(torch, counters):
    """Phase 13, TwDH behind /search_text: phase 12's encoders (a tree of
    the long code and the short ones) over phase 12's 512-bit index; the
    answers of both backends equal ``search`` on the encoders' long codes."""
    import numpy as np

    from cmh_torch.export import load_encoders
    from cmh_torch.models.clip.tokenizer import SimpleTokenizer, tokenize_caption
    from cmh_torch.serving import RetrievalIndex

    enc = load_encoders(os.path.join(WORK, "twdh_enc.pt"), device="cuda")
    index = RetrievalIndex.load(os.path.join(WORK, "twdh_index.npz"), device="cuda")
    asked = [("/search_text", {"text": CAPTIONS[i:i + 4], "topk": 10}) for i in (0, 4)]
    reset_counts(counters)
    # ---- the main path: two text requests to each backend
    answers, names = ask_both_backends(index, enc, asked)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    # ---- end of the main path
    tok = SimpleTokenizer()
    for (_, payload), out in zip(asked, answers["device"]):
        ids, masks = zip(*(tokenize_caption(tok, c, MAX_WORDS) for c in payload["text"]))
        long_codes, shorts = enc.encode_text(np.stack(ids), np.stack(masks))
        d, i = index.search(long_codes, topk=10)
        if out != {"dist": d.tolist(), "idx": i.tolist()}:
            raise AssertionError("TwDH /search_text differs from search on the long codes")
    equal = answers["device"] == answers["cpu"]
    expect = {k: 0 for k in counters}
    expect.update(layernorm=25 * 2 * len(asked), attention=11 * 2 * len(asked),
                  hamming=len(asked))
    print(f"[serving-TwDH] {index.bits}-bit index of {len(index)} items; {len(asked)} "
          f"/search_text requests to each of the backends {names}: equal to search on the "
          f"long codes ({sorted(shorts)} short widths beside them), backends equal {equal}; "
          f"launches {launches} expected {expect}", flush=True)
    if not equal:
        raise AssertionError("TwDH: the device and cpu backends answer differently")
    if launches != expect:
        raise AssertionError(f"TwDH serving launches {launches} != expected {expect}")
    return launches


def write_openai_archive(torch, state, path):
    """``state`` as OpenAI writes its CLIP files: floating tensors in fp16,
    the three integer entries, a TorchScript archive. Returns its bytes."""
    from cmh_torch.models.clip.loader import save_torchscript_archive

    half = {k: v.detach().half() if v.is_floating_point() else v for k, v in state.items()}
    save_torchscript_archive({**half, **{k: torch.tensor(v) for k, v in OPENAI_INTS.items()}},
                             path)
    return os.path.getsize(path)


def long_sequences(torch, counters, keep):
    """Phase 14: the row-tiled K2 on its main path and the new modules; the
    seeded ViT-L/14 archive is written under ``keep`` (phase 16 reads it)."""
    by_path, tiled_by_path = {}, {}
    root = tempfile.mkdtemp(prefix="cmh_smoke_long_")
    try:
        by_path["ViT-L/14"], tiled_by_path["ViT-L/14"] = vit_l14_training(torch, counters, root,
                                                                          keep)
        by_path["ViT-B/16 encode"], tiled_by_path["ViT-B/16 encode"] = vit_b16_encode(
            torch, counters)
        by_path["ViT-L/14 fp32"], tiled_by_path["ViT-L/14 fp32"] = vit_l14_fp32(torch, counters)
        by_path["MITH 128-bit"], tiled_by_path["MITH 128-bit"] = mith_128(torch, counters, root)
        resnet_tower(torch, counters, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return by_path, tiled_by_path


def vit_l14_training(torch, counters, root, keep):
    """14a, the slice's main path: DCMHT through the CLI with a seeded
    ViT-L/14 in OpenAI's layout at ``model.clip_path`` of
    configs/DCMHT/synthetic_tpu.yaml's dataset, 2 epochs of 2 steps at batch
    100, each with its valid, no full-state checkpoint (about 5 GB at this
    width). The vision tower's 23 fused blocks a pass (S = 257) take the
    row-tiled K2 both ways; the text tower's 11 (S = 32) the one-block K2."""
    import numpy as np
    import yaml

    from cmh_torch.models.clip.model import CLIP, CLIPConfig

    clip = CLIP(CLIPConfig(**VIT_L14))
    clip.init_weights(seed_key(14), "cuda")
    path = os.path.join(keep, "ViT-L-14.pt")
    t0 = time.perf_counter()
    nbytes = write_openai_archive(torch, clip.state_dict(), path)
    del clip
    print(f"[ViT-L/14] seeded archive in OpenAI's layout: {nbytes} bytes, written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    with open(TRAIN_CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg["model"]["clip_path"] = path
    cfg["run"].update(epochs=2, train_num=200, query_num=100, batch_size=100, display_step=1,
                      checkpoint_every=0, auto_resume=False)
    cfg_path = os.path.join(root, "vit_l14.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    lv, lt = VIT_L14["vision_layers"], VIT_L14["transformer_layers"]
    steps, expect, expect_tiled = expected_launches(cfg, layers=(lv, lt),
                                                    tiled=(lv - 1, lv - 1))
    reset_counts(counters)
    # ---- the main path: python -m cmh_torch.main, in-process
    t0 = time.perf_counter()
    tr = train_cli(cfg_path, os.path.join(root, "vit_l14"))
    torch.cuda.synchronize()
    launches, tiled = read_counts(counters), read_tiled(counters)
    t_main = time.perf_counter() - t0
    # ---- end of the main path
    hist = tr.history
    train_s = sum(h["seconds"] for h in hist)
    wait_s = sum(h["data_wait_s"] for h in hist)
    print(f"[ViT-L/14] {steps} steps: {train_s / steps * 1e3:.1f} ms a step on the host clock, "
          f"{(train_s - wait_s) / steps * 1e3:.1f} ms without the data waits; main path "
          f"{t_main:.1f} s; epoch losses {[h['loss'] for h in hist]}; mAPs "
          f"{[h['maps'] for h in hist]}", flush=True)
    per_step = {k: launches[k] // steps for k in ("layernorm_bwd", "attention_bwd")}
    print(f"[ViT-L/14] launches {launches} expected {expect}; row-tiled K2 {tiled} expected "
          f"{expect_tiled}; a step: K1-bwd {per_step['layernorm_bwd']}, K2-bwd "
          f"{per_step['attention_bwd']} ({tiled['attention_bwd'] // steps} row-tiled), a "
          f"forward: K1-fwd {2 * lv + 2 + 2 * lt + 1}, K2-fwd {lv - 1 + lt - 1} ({lv - 1} "
          f"row-tiled)", flush=True)
    if tr.model.backbone.cfg != CLIPConfig(**VIT_L14):
        raise AssertionError(f"inferred {tr.model.backbone.cfg}, not ViT-L/14")
    if launches != expect or tiled != expect_tiled:
        raise AssertionError(f"ViT-L/14: launch counts {launches} (row-tiled {tiled}) != "
                             f"expected {expect} (row-tiled {expect_tiled})")
    if len(hist) != 2 or not all(np.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"ViT-L/14: non-finite or missing epoch losses: {hist}")
    check_last_maps(torch, tr, "[ViT-L/14]")
    steady_steps(torch, tr, "ViT-L/14")
    del tr
    return launches, tiled


def vit_l14_fp32(torch, counters):
    """14c: ViT-L/14 in fp32 at batch 4, phases 4 and 5 (card against CPU):
    its vision tower's 23 fused blocks a pass (S = 257) take the fp32 row
    tiles (3xTF32) both ways. The launches are those of the card's side."""
    lv = VIT_L14["vision_layers"]
    reset_counts(counters)
    # ---- the main path: an encode and a train step's forward and backward
    t0 = time.perf_counter()
    model_parity(torch, VIT_L14, n=4, tag="[ViT-L/14 parity]")
    # 24 vision blocks, twice ViT-B/32's: the fp32 sums' order differences
    # compound through twice the depth (ViT-B/32's phase 5 holds 1e-4)
    grad_parity(torch, VIT_L14, n=4, tag="[ViT-L/14 grad]", grad_tol=2e-4)
    torch.cuda.synchronize()
    launches, tiled = read_counts(counters), read_tiled(counters)
    # ---- end of the main path
    expect_tiled = {"attention": 2 * (lv - 1), "attention_bwd": lv - 1,
                    "attention_tf32": 2 * (lv - 1), "attention_bwd_tf32": lv - 1}
    print(f"[ViT-L/14 parity] fp32 card against CPU, batch 4: {time.perf_counter() - t0:.1f} s; "
          f"launches {launches}, row-tiled {tiled} expected {expect_tiled}", flush=True)
    if tiled != expect_tiled:
        raise AssertionError(f"ViT-L/14 fp32: row-tiled launches {tiled} != {expect_tiled}")
    return launches, tiled


def vit_b16_encode(torch, counters):
    """14b: ``api.load("ViT-B/16")`` (seeded random init, bf16, on the card)
    encodes 256 images (K2-fwd at S = 197 through the row tiles) and 256
    captions tokenized by ``api.tokenize`` (S = 77, the one-block K2)."""
    from cmh_torch.models.clip import api

    model, cfg = api.load("ViT-B/16", key=seed_key(16))
    images = device_batch(torch, torch.Generator(device="cuda").manual_seed(16), B)["image"]
    ids = api.tokenize(CAPTIONS * (B // len(CAPTIONS))).cuda()
    reset_counts(counters)
    # ---- the main path: encode images and texts
    with torch.no_grad():
        img = model.encode_image(images)[0]
        txt = model.encode_text(ids, ids == 0)[0]
    torch.cuda.synchronize()
    launches, tiled = read_counts(counters), read_tiled(counters)
    # ---- end of the main path
    expect = {k: 0 for k in counters}
    expect.update(layernorm=51, attention=22)
    expect_tiled = {"attention": 11, "attention_bwd": 0, "attention_tf32": 0,
                    "attention_bwd_tf32": 0}
    with torch.no_grad():
        image_ms = cuda_ms(lambda: model.encode_image(images), iters=3, warmup=1)
    print(f"[ViT-B/16] api.load: {cfg}; 256 images and 256 captions encoded to {tuple(img.shape)} "
          f"and {tuple(txt.shape)}; image tower {image_ms:.3f} ms (CUDA events); launches "
          f"{launches} expected {expect}, row-tiled {tiled} expected {expect_tiled}", flush=True)
    if not (torch.isfinite(img.float()).all() and torch.isfinite(txt.float()).all()):
        raise AssertionError("ViT-B/16: non-finite encodings")
    if img.shape != (B, cfg.embed_dim) or txt.shape != (B, cfg.embed_dim):
        raise AssertionError(f"ViT-B/16: encodings of shape {img.shape}, {txt.shape}")
    if launches != expect or tiled != expect_tiled:
        raise AssertionError(f"ViT-B/16: launches {launches} (row-tiled {tiled})")
    del model
    return launches, tiled


def mith_128(torch, counters, root):
    """14d: MITH at 128 bits, one epoch of 2 steps through the CLI: its fp32
    concept transformers run K2 at S = 128, the forward on the one-block
    kernel, the backward on the row tiles."""
    import numpy as np
    import yaml

    cfg = method_config("MITH")
    cfg["run"].update(output_dim=128, epochs=1, checkpoint_every=0, auto_resume=False)
    cfg_path = os.path.join(root, "mith128.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    steps, expect, expect32, expect_tiled = expected_launches(cfg, fp32=(8, 2), tiled=(0, 2),
                                                              tiled_tf32=(0, 2))
    reset_counts(counters)
    # ---- the main path: python -m cmh_torch.main, in-process
    tr = train_cli(cfg_path, os.path.join(root, "mith128"))
    torch.cuda.synchronize()
    launches, fp32, tiled = read_counts(counters), read_fp32(counters), read_tiled(counters)
    # ---- end of the main path
    hist = tr.history
    print(f"[MITH 128-bit] {steps} steps, losses {[h['loss'] for h in hist]}, mAPs "
          f"{[h['maps'] for h in hist]}; launches {launches} expected {expect}; fp32 {fp32} "
          f"expected {expect32}; row-tiled {tiled} expected {expect_tiled}", flush=True)
    if (launches, fp32, tiled) != (expect, expect32, expect_tiled):
        raise AssertionError("MITH 128-bit: launch counts differ from the expected ones")
    if len(hist) != 1 or not np.isfinite(hist[0]["loss"]):
        raise AssertionError(f"MITH 128-bit: non-finite or missing loss: {hist}")
    check_last_maps(torch, tr, "[MITH 128-bit]")
    del tr
    return launches, tiled


def resnet_tower(torch, counters, root):
    """14e: an RN50 tower at its published geometry from a seeded archive in
    OpenAI's layout (``visual.*`` in fp16 with torch's num_batches_tracked):
    256 images in bf16 on the card; 8 in fp32 (cuDNN TF32 off) held against
    the CPU at 1e-4 of the largest output (fp32 sums in another order
    through 16 bottlenecks and the convolutions' algorithms). The tower
    launches no kernel of the port."""
    import numpy as np

    from cmh_torch.models.clip.loader import load_resnet
    from cmh_torch.models.clip.resnet import ModifiedResNet

    tower = ModifiedResNet(**RN50).init_weights(torch.Generator().manual_seed(50))
    state = {"visual." + k: v for k, v in tower.state_dict().items()}
    state.update({k.replace("running_mean", "num_batches_tracked"): torch.tensor(0)
                  for k in state if k.endswith("running_mean")})
    path = os.path.join(root, "RN50.pt")
    nbytes = write_openai_archive(torch, state, path)
    del tower
    bf16, geo = load_resnet(path)
    if geo != RN50:
        raise AssertionError(f"RN50 geometry read as {geo}")
    bf16 = bf16.cuda()
    images = device_batch(torch, torch.Generator(device="cuda").manual_seed(50), B)["image"]
    reset_counts(counters)
    with torch.no_grad():
        out = bf16(images)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: bf16(images), iters=5, warmup=1)
    if sum(read_counts(counters).values()):
        raise AssertionError(f"the ResNet tower launched {read_counts(counters)}")
    if out.shape != (B, 1024) or out.dtype != torch.bfloat16 or not torch.isfinite(out.float()).all():
        raise AssertionError(f"RN50 bf16: {out.shape} {out.dtype}, finite "
                             f"{bool(torch.isfinite(out.float()).all())}")
    del bf16
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu, _ = load_resnet(path, dtype=torch.float32)
    gpu = copy.deepcopy(cpu).cuda()
    img = torch.from_numpy(np.random.RandomState(50).randn(8, 224, 224, 3).astype(np.float32))
    with torch.no_grad():
        want = cpu(img)
        got = gpu(img.cuda()).cpu()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    print(f"[RN50] archive {nbytes} bytes; geometry {geo}; 256 images in bf16 on the card "
          f"{ms:.3f} ms (CUDA events), out {tuple(out.shape)}; fp32 card against CPU on 8 "
          f"images: max rel diff {rel:.3e}", flush=True)
    if not rel <= 1e-4:
        raise AssertionError(f"RN50 fp32 encodings differ card/CPU: {rel}")



def phase15_config(root, name, **run):
    """``configs/DCMHT/synthetic_tpu.yaml`` cut to one epoch of 2 steps at
    batch 100 (200 train items, 100 queries), no full-state checkpoint."""
    import yaml

    with open(TRAIN_CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg["run"].update(epochs=1, train_num=200, query_num=100, display_step=1, seed=0,
                      checkpoint_every=0, auto_resume=False, save_dir=os.path.join(root, name),
                      log_dir=os.path.join(root, name + "_log"), **run)
    return cfg


def trainer_from(cfg):
    from cmh_torch.config import config_from_dict
    from cmh_torch.registry import load_components

    return load_components().require_runner_class(cfg["run"]["arch"]).from_config(
        cfg=config_from_dict(cfg), device="cuda", auto_run=False)


def jax_checkpoint_resume(torch, counters, root):
    """15a: cmh_tpu's full-state ``checkpoint-last.msgpack`` at full ViT-B/32
    width, written by the port's writer (the card's machine has no flax) in
    the flat and the tree format from a DCMHT trainer one step past init,
    resumed through ``run.resume_checkpoint`` in fresh trainers: the state
    and the meta bit-equal the source's, and one more step on the same batch
    gives bit-equal parameters in all three."""
    from cmh_torch.runners import jax_checkpoint

    cfg = phase15_config(root, "source")
    src = trainer_from(cfg)
    batches = [b for _, b in zip(range(2), src.train_loader)]
    src.train_step(batches[0])
    src.global_step, src.max_mapi2t, src.best_epoch_i = 1, 0.125, 0
    paths, write_s, nbytes = {}, {}, {}
    for fmt in ("flat", "tree"):
        paths[fmt] = os.path.join(root, fmt, "checkpoint-last.msgpack")
        os.makedirs(os.path.dirname(paths[fmt]))
        t0 = time.perf_counter()
        jax_checkpoint.write(paths[fmt], src, 1, flat=fmt == "flat")
        write_s[fmt] = time.perf_counter() - t0
        nbytes[fmt] = os.path.getsize(paths[fmt])

    reset_counts(counters)
    # ---- the main path: resume each file, then one more step everywhere
    resumed, load_s = {}, {}
    for fmt, path in paths.items():
        t0 = time.perf_counter()
        tr = trainer_from(phase15_config(root, "resumed_" + fmt, resume_checkpoint=path))
        epoch = tr._resume()
        torch.cuda.synchronize()
        load_s[fmt] = time.perf_counter() - t0
        if epoch != 1:
            raise AssertionError(f"{fmt} checkpoint resumes at epoch {epoch}")
        bad = same_state(torch, src, tr)
        if bad or trackers(tr) != trackers(src):
            raise AssertionError(f"{fmt} checkpoint: the resumed state differs: {bad[:8]}, "
                                 f"{trackers(tr)} != {trackers(src)}")
        resumed[fmt] = tr
    for tr in (src, *resumed.values()):
        tr.train_step(batches[1])
    torch.cuda.synchronize()
    launches = read_counts(counters)
    # ---- end of the main path
    # the parameters bit-equal; the moments too where the step's kernels are
    # deterministic (the embedding's index backward, on the CPU, adds with
    # atomics), and within 1e-6 of their largest otherwise
    moments = {}
    for fmt, tr in resumed.items():
        bad = same_state(torch, src, tr)
        if [b for b in bad if not b.startswith("group ")]:
            raise AssertionError(f"{fmt} checkpoint: the next step differs: {bad[:8]}")
        worst = max(float((a[k] - b[k]).abs().max() / b[k].abs().max())
                    for a, b in zip(tr.optimizer.state_dict()["groups"],
                                    src.optimizer.state_dict()["groups"]) for k in ("m", "v"))
        moments[fmt] = "bit-equal" if not bad else f"within {worst:.3e}"
        if not worst <= 1e-6:
            raise AssertionError(f"{fmt} checkpoint: the next step's moments differ by {worst}")
    print(f"[jax ckpt] checkpoint-last.msgpack of a full-width DCMHT trainer: flat "
          f"{nbytes['flat']} bytes written in {write_s['flat']:.2f} s, tree {nbytes['tree']} "
          f"bytes in {write_s['tree']:.2f} s; trainer built and resumed in "
          f"{load_s['flat']:.2f} s (flat) and {load_s['tree']:.2f} s (tree), host clock; "
          f"state, meta and the next step's parameters bit-equal to the source's, its "
          f"moments {moments}; launches {launches}", flush=True)
    for fmt, path in paths.items():
        os.remove(path)
    return launches


def dp_group_of_one(torch, counters, root):
    """15b: DCMHT through ``cmh_torch.main`` with ``run.distribute`` in an
    NCCL group of one (``run.multi_host``, rank 0 of 1, a free local port),
    one epoch of 2 steps and its ``valid``, against the same YAML without
    it. The group runs the tree BertAdam (as cmh_tpu on a mesh) and so does
    the other run (``optimizer.flat: False``; phase 8d holds the flat path
    against the tree one): the collectives are identities, so both steps'
    losses, the parameters, the moments and the mAPs are bit-equal."""
    import yaml

    from cmh_torch.parallel import dp
    from cmh_torch.runners.base import BaseTrainer

    step = BaseTrainer.train_step
    record = {}

    def timed(self, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, loss_dict = step(self, batch)
        torch.cuda.synchronize()
        record.setdefault(id(self), []).append((float(loss), (time.perf_counter() - t0) * 1e3))
        return loss, loss_dict

    runs, launches = {}, None
    BaseTrainer.train_step = timed
    try:
        for name, extra in (("single", {}),
                            ("dp", {"distribute": True, "multi_host": True,
                                    "distributed_port": dp.free_port(), "num_processes": 1,
                                    "process_id": 0})):
            cfg = phase15_config(root, name, **extra)
            cfg["optimizer"]["flat"] = False
            path = os.path.join(root, name + ".yaml")
            with open(path, "w") as f:
                yaml.safe_dump(cfg, f)
            if name == "dp":
                reset_counts(counters)
                # ---- the main path: the data-parallel run through the CLI
            runs[name] = train_cli(path, os.path.join(root, name))
            torch.cuda.synchronize()
            if name == "dp":
                launches = read_counts(counters)
                # ---- end of the main path
    finally:
        BaseTrainer.train_step = step
    one, single = runs["dp"], runs["single"]
    if one.dp is None or one.dp.world != 1 or one.optimizer.flat or single.optimizer.flat:
        raise AssertionError("the dp run did not run in a group of one, both with the tree "
                             "BertAdam")
    if dp.current() is not None:
        raise AssertionError("the CLI left its process group behind")
    (l1, t1), (l2, t2) = record[id(one)]
    (s1, u1), (s2, u2) = record[id(single)]
    sd_a, sd_b = one.model.state_dict(), single.model.state_dict()
    rel = max(float(((sd_a[k].float() - sd_b[k].float()).abs().max()
                     / sd_b[k].float().abs().max().clamp(min=1e-30))) for k in sd_b)
    ma, mb = one.optimizer.state_dict(), single.optimizer.state_dict()
    mom = 0.0
    for ga, gb in zip(ma["groups"], mb["groups"]):
        for slot in ("m", "v"):
            for x, y in zip(ga[slot], gb[slot]):
                mom = max(mom, float((x - y).abs().max() / y.abs().max().clamp(min=1e-30)))
    maps_a, maps_b = one.history[0]["maps"], single.history[0]["maps"]
    stats = [k for k in sd_b if "running_" in k]
    # what average_gradients all-reduces a step: every gradient, by dtype
    grads = [p for p in one.model.parameters() if p.grad is not None]
    grad_bytes = sum(p.grad.numel() * p.grad.element_size() for p in grads)
    print(f"[dp] DCMHT, 2 steps at batch {TRAIN_B} and a valid, NCCL group of one against one "
          f"process: step losses {[l1, l2]} against {[s1, s2]}; steps {t1:.2f}, {t2:.2f} ms "
          f"against {u1:.2f}, {u2:.2f} ms (host clock, the second steady); parameters and "
          f"BatchNorm statistics ({len(stats)}) within {rel:.3e} of the largest, moments "
          f"within {mom:.3e}; mAPs {maps_a} against {maps_b}; the gradient all-reduce "
          f"{sum(p.numel() for p in grads)} elements, {grad_bytes} bytes a step; "
          f"launches {launches}", flush=True)
    if (l1, l2) != (s1, s2) or rel != 0 or mom != 0 or tuple(maps_a) != tuple(maps_b):
        raise AssertionError("dp: the group of one differs from the single process")
    return launches


def sharded_on_one_card(torch, counters, index_path):
    """15c: the query-sharded mAP at coco scale, shards 0 and 1 of 2 in turn,
    summed, against the unsharded ``calc_map_k_4dir`` (1e-12); the
    gallery-sharded search over ``[cuda:0, cuda:0]`` on phase 7's 16-bit
    index against the unsharded search, bit for bit."""
    import numpy as np

    from cmh_torch.ops.map_bucketed import calc_map_k_4dir, map_sums_4dir
    from cmh_torch.serving import RetrievalIndex

    gen = torch.Generator(device="cuda").manual_seed(150)
    data = {bits: coco_codes(torch, gen, COCO_Q, COCO_N, bits) for bits in (16, 512)}
    index = RetrievalIndex.load(index_path, device="cuda")
    q = torch.randint(0, 2, (64, index.bits), generator=gen, device="cuda").float() * 2 - 1
    reset_counts(counters)
    # ---- the main path: every shard of two in turn, on the one card
    times, got, want = {}, {}, {}
    for bits, args in data.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sums = [map_sums_4dir(*args, shard=s, n_shards=2) for s in range(2)]
        got[bits] = ((sums[0] + sums[1]) / COCO_Q).tolist()
        times[f"{bits}-bit sharded mAP s"] = time.perf_counter() - t0
    shards = index.search(q, topk=10, devices=["cuda:0", "cuda:0"])
    torch.cuda.synchronize()
    launches = read_counts(counters)
    # ---- end of the main path
    for bits, args in data.items():
        t0 = time.perf_counter()
        want[bits] = calc_map_k_4dir(*args)
        times[f"{bits}-bit unsharded mAP s"] = time.perf_counter() - t0
    whole = index.search(q, topk=10)
    times["sharded search ms"] = cuda_ms(lambda: index.search(q, topk=10,
                                                              devices=["cuda:0", "cuda:0"]),
                                         iters=5, warmup=1)
    times["unsharded search ms"] = cuda_ms(lambda: index.search(q, topk=10), iters=5, warmup=1)
    print(f"[sharded] query-sharded mAP, 2 shards of {COCO_Q} queries against {COCO_N} items: "
          f"{got} against unsharded {want}; gallery-sharded search of 64 queries over "
          f"[cuda:0, cuda:0] on {len(index)} items equal to the unsharded: "
          f"{np.array_equal(shards[0], whole[0]) and np.array_equal(shards[1], whole[1])}; "
          f"times {times} (host clock for the mAPs, CUDA events for the searches); "
          f"launches {launches}", flush=True)
    for bits in data:
        if not np.allclose(got[bits], want[bits], rtol=0, atol=1e-12):
            raise AssertionError(f"sharded mAP at {bits} bits differs from the unsharded")
    if not (np.array_equal(shards[0], whole[0]) and np.array_equal(shards[1], whole[1])):
        raise AssertionError("the gallery-sharded search differs from the unsharded")
    return launches


def phase15(torch, counters):
    """Phase 15 in a fresh root outside the repository."""
    root = tempfile.mkdtemp(prefix="cmh_smoke_dp_")
    try:
        t0 = time.perf_counter()
        out = {"cmh_tpu checkpoint": jax_checkpoint_resume(torch, counters, root),
               "dp group of one": dp_group_of_one(torch, counters, root),
               "sharded": sharded_on_one_card(torch, counters, os.path.join(WORK, "index.npz"))}
        print(f"[phase 15] {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out

# ---------------------------------------------------------------- phase 16
TP_TIMEOUT = 300                 # phase 16's workers, in seconds
# the fp32 products of ViT-B/32's vision blocks at tp=2, (a rank's contracted
# width, the whole width): the row splits' forward partials and the column
# splits' backward input gradients
FP32_PRODUCTS = {"out_proj forward": (384, 768), "c_proj forward": (1536, 768),
                 "in_proj input gradient": (1152, 768), "c_fc input gradient": (1536, 768)}
L14_CUT = dict(batch_size=20, train_num=40, query_num=20, seed=1)   # phase 16c's ViT-L/14 run
UMOED_CUT = dict(batch_size=50, train_num=100, query_num=50)  # phase 16d's UMoED run


def kernel_counters():
    from cmh_torch.ops.attention import attention_bwd, fused_attention
    from cmh_torch.ops.hamming import hamming_packed
    from cmh_torch.ops.layernorm import fused_layernorm, layernorm_bwd
    from cmh_torch.ops.map_kernel import map_ap, map_hist

    return {"layernorm": fused_layernorm, "attention": fused_attention,
            "hamming": hamming_packed, "layernorm_bwd": layernorm_bwd,
            "attention_bwd": attention_bwd, "map_hist": map_hist, "map_ap": map_ap}


def parity_inputs(torch, n):
    """grad_parity's batch: ``n`` seeded 224 px images, tokenized captions
    and one-hot labels, on the CPU."""
    import numpy as np

    from cmh_torch.models.clip.tokenizer import SimpleTokenizer, tokenize_caption

    rng = np.random.RandomState(2)
    img = torch.from_numpy(rng.randn(n, 224, 224, 3).astype(np.float32))
    tok = SimpleTokenizer()
    ids, kpm = (torch.from_numpy(np.stack(a)) for a in
                zip(*(tokenize_caption(tok, c, MAX_WORDS) for c in CAPTIONS[:n])))
    labels = torch.from_numpy(np.eye(4, dtype=np.float32)[[0, 1, 2, 3, 0, 1, 2, 3][:n]])
    return img, ids, kpm, labels


def tp_traffic():
    from cmh_torch.parallel import dp, tp

    return {"tp all-reduces": tp.traffic["all_reduces"], "tp bytes": tp.traffic["bytes"],
            "dp all-reduces": dp.traffic["all_reduces"], "dp bytes": dp.traffic["bytes"]}


def reset_traffic():
    from cmh_torch.parallel import dp, tp

    for t in (tp.traffic, dp.traffic):
        t.update(all_reduces=0, bytes=0)


def tp_parity(torch, counters, group, case):
    """16a on one rank: the full-width fp32 DCMHT model of grad_parity with
    this rank's shards, one loss and backward on 8 pairs, TF32 off; rank 0
    also runs the whole model (one process on the card) and compares the
    loss and the gathered gradients."""
    from cmh_torch.models.clip.model import CLIPConfig
    from cmh_torch.models.dcmht import DCMHTModel, dcmht_loss_fn
    from cmh_torch.parallel import tp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = DCMHTModel(CLIPConfig(dtype=torch.float32), CODE_BITS)
    model.init_weights(seed_key(0), "cuda").train()
    whole = copy.deepcopy(model).to("cuda") if group.global_rank == 0 else None
    tp.shard_model_(model, group.shards)
    model.to("cuda")
    img, ids, kpm, labels = (t.to("cuda") for t in parity_inputs(torch, 8))
    loss_fn = dcmht_loss_fn(output_dim=CODE_BITS)
    reset_counts(counters)
    # ---- the main path: the sharded model's forward and backward
    loss, _, _ = loss_fn(model(img, ids, kpm), {"label": labels}, {}, 0)
    loss.backward()
    torch.cuda.synchronize()
    counts, fp32 = read_counts(counters), read_fp32(counters)
    # ---- end of the main path
    grads = {n: p.grad if tp.split_for(n) is None else tp.gather(p.grad, tp.split_for(n),
                                                                 group.shards)
             for n, p in model.named_parameters() if p.grad is not None}
    out = {"loss": float(loss), "launches": counts, "fp32": fp32}
    if whole is not None:
        want, _, _ = loss_fn(whole(img, ids, kpm), {"label": labels}, {}, 0)
        want.backward()
        absorbed = {"backbone.visual.ln_post.bias", "hash.img_hash.atten.in_proj_bias",
                    "hash.img_hash.atten.out_proj.bias"}
        worst = (0.0, "")
        for n, p in whole.named_parameters():
            if p.grad is None or n in absorbed:
                continue
            rel = float((grads[n] - p.grad).abs().max() / p.grad.abs().max())
            worst = max(worst, (rel, n))
        out.update(whole_loss=float(want),
                   loss_rel=abs(float(loss) - float(want)) / abs(float(want)),
                   grad_rel=worst[0], grad_worst=worst[1],
                   missing=sorted(set(n for n, p in whole.named_parameters()
                                      if p.grad is not None) ^ set(grads)))
    return out


def timed_steps(torch, tr, batches):
    """Each batch's train step on the host clock (synchronised), its loss and
    the all-reduces it issued."""
    losses, ms, traffic = [], [], []
    for b in batches:
        reset_traffic()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = tr.train_step(b)
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
        traffic.append(tp_traffic())
    return losses, ms, traffic


def tp_train(torch, counters, group, case):
    """16b, 16c and 16d on one rank: a trainer of ``case["cfg"]`` in the
    group, ``steps`` train steps on its first batches and the ``valid``
    codes and mAPs (no files); with ``save``, the full-state checkpoint
    gathered and written by rank 0; with ``resume``, the checkpoint resumed
    first (rank 0 reads it) and the state held against the file."""
    from cmh_torch.parallel import tp
    from cmh_torch.runners import checkpoint

    tr = trainer_from(case["cfg"])
    out = {}
    if case.get("resume"):
        out["epoch"] = tr._resume_every_rank()
        blob = tr._state_blob(out["epoch"])
        if group.global_rank == 0:
            saved = checkpoint.read(case["resume"])
            bad = [k for k in saved["model"] if not torch.equal(saved["model"][k].cpu(),
                                                                blob["model"][k].cpu())]
            for i, (a, b) in enumerate(zip(saved["optimizer"]["groups"],
                                           blob["optimizer"]["groups"])):
                for slot in ("m", "v"):
                    bad += [f"group {i} {slot} {j}"
                            for j, (x, y) in enumerate(zip(a[slot], b[slot]))
                            if not torch.equal(x.cpu(), y.cpu())]
            bad += [] if saved["optimizer"]["step_count"] == blob["optimizer"]["step_count"] \
                else ["step_count"]
            out["resume_bad"] = bad
        del blob
    batches = [b for _, b in zip(range(case["steps"]), tr.train_loader)]
    reset_counts(counters)
    # ---- the main path: the steps and the valid
    t0 = time.perf_counter()
    out["losses"], out["step_ms"], out["traffic"] = timed_steps(torch, tr, batches)
    _, out["maps"] = tr.valid_codes_and_maps(0, tr.top_k)
    torch.cuda.synchronize()
    out["launches"], out["tiled"] = read_counts(counters), read_tiled(counters)
    out["main_path_s"] = time.perf_counter() - t0
    # ---- end of the main path
    out["sharded"] = len(tp.sharded_names(tr.model))
    out["heads"] = {n: m.heads // (m.shards.size if m.shards else 1)
                    for n, m in tr.model.named_modules()
                    if type(m).__name__ == "MultiHeadAttention" and n.endswith(
                        ("resblocks.0.attn", "layers.0.self_attn"))}
    if case.get("save"):
        t0 = time.perf_counter()
        tr.save_checkpoint(case["save"], epoch=1)
        out["save_s"] = time.perf_counter() - t0
    if case.get("signal"):
        open(case["signal"], "w").close()
    del tr
    torch.cuda.empty_cache()
    return out


def tp_worker(plan_path) -> int:
    """A phase-16 process: rank ``rank`` of a gloo group on ``cuda:0`` (the
    group's ranks share the one card), its cases in order, its results as
    JSON."""
    import torch

    from cmh_torch.parallel import dp

    with open(plan_path) as f:
        plan = json.load(f)
    counters = kernel_counters()
    group = dp.init("localhost", plan["port"], plan["world"], plan["rank"],
                    torch.device("cuda", 0), tp=plan["tp"], backend="gloo")
    results = {}
    try:
        for case in plan["cases"]:
            if case.get("wait"):
                deadline = time.monotonic() + TP_TIMEOUT
                while not os.path.exists(case["wait"]):
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{case['wait']} never appeared")
                    time.sleep(0.2)
            t0 = time.perf_counter()
            results[case["name"]] = {"parity": tp_parity, "train": tp_train}[case["kind"]](
                torch, counters, group, case)
            results[case["name"]]["case_s"] = time.perf_counter() - t0
        from cmh_torch.models.common import Dropout
        if Dropout.host_seconds != 0:
            raise AssertionError(f"{Dropout.host_seconds} s of dropout masks drawn on the host")
    finally:
        dp.shutdown()
    with open(plan["out"], "w") as f:
        json.dump(results, f)
    return 0


def spawn_group(root, name, world, tp_size, cases):
    """``world`` processes of ``python3 chip_smoke.py --tp-worker``, a (dp,
    tp) mesh of gloo ranks on cuda:0."""
    from cmh_torch.parallel import dp

    port, jobs = dp.free_port(), []
    for r in range(world):
        plan = {"port": port, "world": world, "tp": tp_size, "rank": r, "cases": cases,
                "out": os.path.join(root, f"{name}{r}.json")}
        path = os.path.join(root, f"{name}{r}.plan.json")
        with open(path, "w") as f:
            json.dump(plan, f)
        log = open(os.path.join(root, f"{name}{r}.log"), "w")
        jobs.append((subprocess.Popen([sys.executable, os.path.abspath(__file__), "--tp-worker",
                                       path], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT),
                     plan["out"], log.name))
    return jobs


def wait_groups(groups, timeout=TP_TIMEOUT):
    """Every group's per-rank results; a worker that fails or outlives
    ``timeout`` fails the phase (and every worker is stopped)."""
    deadline = time.monotonic() + timeout
    out = {}
    try:
        for name, jobs in groups.items():
            out[name] = []
            for proc, res, log in jobs:
                try:
                    rc = proc.wait(timeout=max(deadline - time.monotonic(), 1))
                except subprocess.TimeoutExpired:
                    rc = None
                if rc != 0:
                    with open(log) as f:
                        tail = f.read()[-3000:]
                    what = "hung" if rc is None else f"exited {rc}"
                    raise AssertionError(f"phase 16 {name}: a worker {what}: {tail}")
                with open(res) as f:
                    out[name].append(json.load(f))
    finally:
        stop_groups(groups)
    return out


def stop_groups(groups):
    """Kill every worker of ``groups`` that is still running."""
    for jobs in groups.values():
        for proc, _, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def fp32_partial_cost(torch):
    """The fp32 products of tensor parallelism at ViT-B/32's vision shapes
    (batch 100, tp=2, rows B·S = 5,000): the bf16 product one process runs
    (which rounds its output), against the fp32 one (``tp.fp32_product``,
    TF32 on its bf16 operands) and the same product with TF32 off; CUDA
    events."""
    from cmh_torch.parallel import tp

    gen = torch.Generator(device="cuda").manual_seed(16)
    out = {}
    for name, (k, n) in FP32_PRODUCTS.items():
        x = torch.randn(TRAIN_B * 50, k, generator=gen, device="cuda").bfloat16()
        w = torch.randn(n, k, generator=gen, device="cuda").bfloat16()
        out[name] = {"bf16_ms": cuda_ms(lambda: torch.matmul(x, w.t())),
                     "fp32_partial_ms": cuda_ms(lambda: tp.fp32_product(x, w.t()))}
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            out[name]["fp32_no_tf32_ms"] = cuda_ms(lambda: torch.matmul(x.float(), w.float().t()))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    return out


def tp_references(torch, root, archive):
    """One process on the card, before any worker starts: DCMHT's first two
    steps (bf16, phase 15's YAML) timed, and the first step of ViT-L/14
    (phase 14's archive) and of UMoED (configs/UMoED/config.yaml cut as
    phase 13's) on their trainers' first batches."""
    out = {}
    for name, cfg, steps in (("DCMHT", tp_config(root, "ref_dcmht"), 2),
                             ("ViT-L/14", tp_config(root, "ref_l14", clip=archive, **L14_CUT), 1),
                             ("UMoED", tp_config(root, "ref_umoed", arch="UMoED", **UMOED_CUT), 1)):
        tr = trainer_from(cfg)
        batches = [b for _, b in zip(range(steps), tr.train_loader)]
        losses, ms, _ = timed_steps(torch, tr, batches)
        out[name] = {"losses": losses, "step_ms": ms}
        del tr
        torch.cuda.empty_cache()
    return out


def tp_config(root, name, arch="DCMHT", clip=None, **run):
    """Phase 15's DCMHT YAML (one epoch of 2 steps at batch 100, no
    checkpoint), ViT-L/14's with ``clip``, or UMoED's phase-13 YAML cut the
    same way."""
    if arch == "DCMHT":
        cfg = phase15_config(root, name)
    else:
        cfg = method_config(arch)
        cfg["run"].update(epochs=1, checkpoint_every=0, auto_resume=False, remat=False,
                          seed=0, save_dir=os.path.join(root, name),
                          log_dir=os.path.join(root, name + "_log"))
    cfg["run"].update(run)
    if clip:
        cfg["model"]["clip_path"] = clip
    return cfg


def phase16(torch, archive):
    """Phase 16: tensor parallelism on the one card, its ranks gloo
    processes sharing cuda:0 (NCCL refuses two ranks on one device)."""
    root = tempfile.mkdtemp(prefix="cmh_smoke_tp_")
    t_start = time.perf_counter()
    try:
        cost = fp32_partial_cost(torch)
        refs = tp_references(torch, root, archive)
        ckpt = os.path.join(root, "dt", "checkpoint-last.pt")
        trained = os.path.join(root, "dt_trained")
        tp2 = {"tp": 2}
        plans = {
            "dt": (4, [{"kind": "train", "name": "dp2 x tp2 DCMHT", "steps": 2, "save": ckpt,
                        "signal": trained, "cfg": tp_config(root, "dt", **tp2)}]),
            "tp": (2, [{"kind": "parity", "name": "tp2 fp32 parity", "wait": trained},
                       {"kind": "train", "name": "tp2 resumed DCMHT", "steps": 1, "wait": ckpt,
                        "resume": ckpt, "cfg": tp_config(root, "tp_resumed", epochs=2,
                                                         resume_checkpoint=ckpt, **tp2)},
                       {"kind": "train", "name": "tp2 ViT-L/14", "steps": 1,
                        "cfg": tp_config(root, "tp_l14", clip=archive, **L14_CUT, **tp2)},
                       {"kind": "train", "name": "tp2 UMoED", "steps": 1,
                        "cfg": tp_config(root, "tp_umoed", arch="UMoED", **UMOED_CUT,
                                         **tp2)}])}
        groups = {}
        try:
            for name, (world, cases) in plans.items():
                groups[name] = spawn_group(root, name, world, 2, cases)
        except BaseException:
            stop_groups(groups)
            raise
        res = wait_groups(groups)
        return check_phase16(res, refs, cost, time.perf_counter() - t_start)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def check_phase16(res, refs, cost, seconds):
    """Phase 16's checks and its lines; returns (launches by path, row-tiled
    launches by path, fp32 launches by path), each summed over the ranks."""
    import numpy as np

    ranks = {"dp2 x tp2 DCMHT": [r["dp2 x tp2 DCMHT"] for r in res["dt"]]}
    ranks.update({k: [r[k] for r in res["tp"]] for k in res["tp"][0]})
    by_path, tiled_by_path, fp32_by_path = {}, {}, {}
    for path, rs in ranks.items():
        by_path[path] = {k: sum(r["launches"][k] for r in rs) for k in rs[0]["launches"]}
        if "tiled" in rs[0]:
            tiled_by_path[path] = {k: sum(r["tiled"][k] for r in rs) for k in rs[0]["tiled"]}
        if "fp32" in rs[0]:
            fp32_by_path[path] = {k: sum(r["fp32"][k] for r in rs) for k in rs[0]["fp32"]}
        idle = [i for i, r in enumerate(rs)
                if not all(r["launches"][k] for k in ("layernorm", "layernorm_bwd",
                                                      "attention", "attention_bwd"))]
        if idle:
            raise AssertionError(f"phase 16 {path}: ranks {idle} never launched K1 or K2 "
                                 "both ways")
    # 16a: fp32 parity of the tp=2 model against one process on the card
    par = ranks["tp2 fp32 parity"][0]
    print(f"[phase 16a] ViT-B/32 DCMHT fp32, 8 pairs, tp=2 against one process on the card "
          f"(TF32 off): loss {par['loss']!r} against {par['whole_loss']!r}, relative "
          f"{par['loss_rel']:.3e}; largest per-tensor gradient difference {par['grad_rel']:.3e} "
          f"of the largest ({par['grad_worst']}); fp32 launches a rank {par['fp32']}",
          flush=True)
    if par["missing"] or not par["loss_rel"] <= 1e-5 or not par["grad_rel"] <= 2e-4:
        raise AssertionError(f"phase 16a: tp=2 differs from one process: {par}")
    # 16b: dp=2 x tp=2, then a fresh tp=2 group resumes its checkpoint
    dt = ranks["dp2 x tp2 DCMHT"]
    if any(r["losses"] != dt[0]["losses"] or r["maps"] != dt[0]["maps"] for r in dt):
        raise AssertionError("phase 16b: the ranks' losses or mAPs differ")
    ref = refs["DCMHT"]
    rel = abs(dt[0]["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    resumed = ranks["tp2 resumed DCMHT"]
    print(f"[phase 16b] DCMHT bf16 dp=2 x tp=2 (gloo, ranks sharing one card): step losses "
          f"{dt[0]['losses']} against one process's {ref['losses']} (first relative "
          f"{rel:.3e}); step ms {[round(x, 2) for x in dt[0]['step_ms']]} against "
          f"{[round(x, 2) for x in ref['step_ms']]} (host clock, the second steady); mAPs "
          f"{dt[0]['maps']}; checkpoint gathered and written in {dt[0]['save_s']:.2f} s; "
          f"a step's all-reduces {dt[0]['traffic'][-1]}", flush=True)
    r0 = resumed[0]
    print(f"[phase 16b] a fresh tp=2 group resumed it at epoch {r0['epoch']}: state against "
          f"the file {r0['resume_bad'][:8] or 'bit-equal'}; step losses {r0['losses']}, step "
          f"ms {[round(x, 2) for x in r0['step_ms']]} (the first after the resume); "
          f"a step's all-reduces {resumed[0]['traffic'][-1]}", flush=True)
    if resumed[0]["resume_bad"] or resumed[0]["epoch"] != 1 or not rel <= 1e-3:
        raise AssertionError("phase 16b: the resumed state differs from the file, or the "
                             "first loss from one process's")
    if any(r["losses"] != resumed[0]["losses"] for r in resumed):
        raise AssertionError("phase 16b: the resumed ranks' losses differ")
    # 16c, 16d: one step each against one process's first step
    for path, key in (("tp2 ViT-L/14", "ViT-L/14"), ("tp2 UMoED", "UMoED")):
        r0, ref = ranks[path][0], refs[key]
        rel = abs(r0["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
        print(f"[phase 16{'c' if 'L/14' in path else 'd'}] {key} tp=2: loss {r0['losses'][0]!r} "
              f"against one process's {ref['losses'][0]!r} (relative {rel:.3e}); step "
              f"{r0['step_ms'][0]:.1f} ms against {ref['step_ms'][0]:.1f} ms (host clock, first "
              f"step); heads a rank {r0['heads']}; {r0['sharded']} parameters sharded; a "
              f"step's all-reduces {r0['traffic'][-1]}; mAPs {r0['maps']}", flush=True)
        if not rel <= 1e-3 or not np.all(np.isfinite(r0["maps"])):
            raise AssertionError(f"phase 16: {key} tp=2 differs from one process: {rel}")
        if any(r["losses"] != r0["losses"] for r in ranks[path]):
            raise AssertionError(f"phase 16: {key}: the ranks' losses differ")
    tiled = tiled_by_path["tp2 ViT-L/14"]
    if not (tiled_launches(tiled, "tiled_fwd_mma") and tiled_launches(tiled, "tiled_bwd_mma")):
        raise AssertionError(f"phase 16c: the row-tiled K2 never launched: {tiled}")
    if 8 not in ranks["tp2 ViT-L/14"][0]["heads"].values():
        raise AssertionError("phase 16c: the vision attention does not run 8 heads a rank")
    for path in ("dp2 x tp2 DCMHT", "tp2 resumed DCMHT", "tp2 ViT-L/14", "tp2 UMoED"):
        if not (by_path[path]["map_hist"] and by_path[path]["map_ap"]):
            raise AssertionError(f"phase 16 {path}: K3 never launched")
    print(f"[phase 16] all-reduces a step and a rank (gloo, ranks sharing one card): "
          f"{ {p: rs[0]['traffic'][-1] for p, rs in ranks.items() if 'traffic' in rs[0]} }",
          flush=True)
    extra = sum(c["fp32_partial_ms"] - c["bf16_ms"] for c in cost.values())
    print(f"[phase 16] fp32 products of a ViT-B/32 vision block at tp=2 (5,000 rows; ms, CUDA "
          f"events): {cost}; their cost over the bf16 products {extra:.5f} ms a block, "
          f"{12 * extra:.4f} ms over the 12 vision blocks of a step", flush=True)
    print(f"[phase 16] {seconds:.1f} s; case seconds "
          f"{ {p: round(rs[0]['case_s'], 1) for p, rs in ranks.items()} }", flush=True)
    return by_path, tiled_by_path, fp32_by_path


# ---------------------------------------------------------------- phase 17
def tool_build_index(torch, counters, keep):
    """17a: ``tools/build_index`` on phase 8's DCMHT model file at full
    width: the index's packed words equal the trainer's retrieval codes of
    that epoch (``i2t-best.mat``), packed; 4 queries searched through K4
    equal the plain top-k; the encoder file serves one caption over HTTP."""
    import numpy as np
    import scipy.io as scio
    import yaml

    from cmh_torch.data.dataset import SyntheticDataset
    from cmh_torch.export import load_encoders
    from cmh_torch.models.clip.tokenizer import SimpleTokenizer, tokenize_caption
    from cmh_torch.ops.hashing import as_uint32, pack_bits
    from cmh_torch.server import RetrievalApp
    from cmh_torch.serving import RetrievalIndex, search_cpu_plain
    from cmh_torch.tools import build_index

    work = tempfile.mkdtemp(prefix="cmh_smoke_index_")
    try:
        enc_path = os.path.join(work, "enc.pt")
        reset_counts(counters)
        # ---- the main path: python -m cmh_torch.tools.build_index, in-process
        t0 = time.perf_counter()
        out = build_index.main(["--config-file", TRAIN_CONFIG, "--model",
                                os.path.join(keep, "dcmht-model.pt"), "--out-index",
                                os.path.join(work, "gallery"), "--out-encoders", enc_path])
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        index = RetrievalIndex.load(out["index"], device="cuda")
        mat = scio.loadmat(os.path.join(keep, "dcmht-i2t-best.mat"))
        queries = mat["q_txt"][:4].astype(np.float32)
        dist, idx = index.search(queries, topk=10)
        enc = load_encoders(enc_path, device="cuda")
        with open(TRAIN_CONFIG) as f:
            run = yaml.safe_load(f)["run"]
        caption = str(SyntheticDataset(num_items=run["query_num"], num_classes=8,
                                       imageResolution=224, seed=2).captions[0][0])
        server, thread = _serve(RetrievalApp(index, enc, SimpleTokenizer(),
                                             max_words=MAX_WORDS, image_size=224))
        try:
            status, served = request(server.server_address[1], "POST", "/search_text",
                                     {"text": [caption], "topk": 10})
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        torch.cuda.synchronize()
        launches = read_counts(counters)
        # ---- end of the main path
        saved = np.load(out["index"])
        want = as_uint32(pack_bits(torch.from_numpy(mat["r_img"].astype(np.float32))))
        g = as_uint32(index._gallery())
        d_plain, i_plain = search_cpu_plain(as_uint32(pack_bits(torch.from_numpy(queries))),
                                            g, 10)
        ids, kpm = tokenize_caption(SimpleTokenizer(), caption, MAX_WORDS)
        code = enc.encode_text(ids[None], kpm[None])
        d_one, i_one = search_cpu_plain(as_uint32(pack_bits(torch.as_tensor(code).float().cpu())),
                                        g, 10)
        print(f"[phase 17a] build_index {json.dumps(out)} in {build_s:.2f} s (host clock, "
              f"the trainer's build and {out['items']} items encoded); packed words "
              f"{saved['packed'].shape} {saved['packed'].dtype} against i2t-best.mat's r_img "
              f"packed {want.shape}: {'equal' if np.array_equal(saved['packed'], want) else 'DIFFER'}"
              f"; 4 searches through K4 {'equal' if np.array_equal(dist, d_plain) and np.array_equal(idx, i_plain) else 'DIFFER'}"
              f" to the plain top-k; /search_text {status}, its code against q_txt[0] "
              f"{'equal' if np.array_equal(np.asarray(code)[0], mat['q_txt'][0]) else 'differs'}; "
              f"launches {launches}", flush=True)
        if not (np.array_equal(saved["packed"], want) and int(saved["count"]) == len(want)
                and int(saved["bits"]) == CODE_BITS):
            raise AssertionError("phase 17a: the index differs from the trainer's codes")
        if not (np.array_equal(dist, d_plain) and np.array_equal(idx, i_plain)):
            raise AssertionError("phase 17a: the searches differ from the plain top-k")
        if status != 200 or served["idx"] != i_one.tolist() or served["dist"] != d_one.tolist():
            raise AssertionError(f"phase 17a: /search_text answered {status} {served}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


def tool_all_methods(torch, counters):
    """17b: ``tools/all_methods_smoke`` for all eight methods in process:
    a train step and a 4-direction ``valid`` each, K3 launched each time."""
    from cmh_torch.tools.all_methods_smoke import RECIPES, run_method

    total, records = None, []
    for method in sorted(RECIPES):
        reset_counts(counters)
        rec = run_method(method, "cuda")
        torch.cuda.synchronize()
        launches = read_counts(counters)
        idle = [k for k in ("layernorm", "layernorm_bwd", "attention", "attention_bwd",
                            "map_hist", "map_ap") if launches[k] == 0]
        if not rec["ok"] or idle:
            raise AssertionError(f"phase 17b: {method}: {rec}, kernels {idle} never launched")
        records.append(rec)
        total = launches if total is None else {k: total[k] + v for k, v in launches.items()}
    print(f"[phase 17b] all_methods_smoke: "
          f"{[{k: r[k] for k in ('method', 'backend', 'loss', 'maps', 'step1_s', 'eval_s')} for r in records]}",
          flush=True)
    return total


def tool_profiles(torch, counters):
    """17c: ``tools/profile_train`` and ``tools/profile_encode`` at their
    defaults (ViT-B/32, batch 256): the port's K1 and K2 kernels among the
    profiled kernels, and the launches a step those of a DCMHT step."""
    from cmh_torch.tools import profile_encode, profile_train

    reset_counts(counters)
    pt = profile_train.main(["--device", "cuda"])
    torch.cuda.synchronize()
    train_launches = read_counts(counters)
    ln, attn = pair_launches()
    expect = {"layernorm": ln, "layernorm_bwd": ln, "attention": attn, "attention_bwd": attn}
    names = [op["name"] for op in pt["ops"]]
    ranks = {}
    for kernel in ("layernorm_fwd_kernel", "layernorm_bwd_kernel", "attention_fwd_mma",
                   "attention_bwd_mma"):
        hit = [i for i, n in enumerate(names) if kernel in n]
        ranks[kernel] = (hit[0] + 1, pt["ops"][hit[0]]["ms"], pt["ops"][hit[0]]["calls"]) \
            if hit else None
    print(f"[phase 17c] profile_train: step {pt['step_ms']:.2f} ms ({pt['pairs_per_s']:.0f} "
          f"pairs/s, host clock), {pt['total_ms']:.3f} ms of kernel time a step over "
          f"{len(names)} kernel names; the port's kernels (rank, ms a step, calls a step): "
          f"{ranks}; launches a step {pt['launches_per_step']} expected {expect}", flush=True)
    if any(v is None for v in ranks.values()):
        raise AssertionError(f"phase 17c: the profile lacks the port's kernels: {ranks}")
    if pt["launches_per_step"] != expect:
        raise AssertionError(f"phase 17c: launches a step {pt['launches_per_step']} != {expect}")
    reset_counts(counters)
    pe = profile_encode.main(["--device", "cuda"])
    torch.cuda.synchronize()
    encode_launches = read_counts(counters)
    print(f"[phase 17c] profile_encode: {json.dumps(pe)}", flush=True)
    if not all(pe[k] > 0 for k in ("product_ms", "encode_only_ms", "encode_map_ms")):
        raise AssertionError(f"phase 17c: profile_encode {pe}")
    return train_launches, encode_launches


def tool_twdh_matrix():
    """17d: ``tools/twdh_matrix`` at its default widths (512 → 16 bits, 80
    classes) on the card, 40 of its 100 default epochs (cut to keep the
    script inside its time limit)."""
    from cmh_torch.ops.hash_centers import generate_hash_centers, load_center_file
    from cmh_torch.tools import twdh_matrix

    work = tempfile.mkdtemp(prefix="cmh_smoke_twdh_")
    try:
        t0 = time.perf_counter()
        out = twdh_matrix.main(["--device", "cuda", "--save-dir", work, "--post-epochs", "40"])
        seconds = time.perf_counter() - t0
        matrix = load_center_file(out["path"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    lossless = twdh_matrix.check(generate_hash_centers(80, 512, 13),
                                 generate_hash_centers(80, 16, 14), matrix)
    print(f"[phase 17d] twdh_matrix: {'lossless' if out['lossless'] else 'not lossless'} "
          f"after {out['epochs']} epochs of 50 steps, {seconds:.1f} s (host clock), matrix "
          f"{matrix.shape}", flush=True)
    if matrix.shape != (1024, 32) or lossless != out["lossless"]:
        raise AssertionError(f"phase 17d: {out}, check of the saved matrix {lossless}")


def tool_epoch_ab(torch, counters):
    """17e: ``tools/epoch_ab --scale full`` with the committed reference
    artifact: 1,000 train items at 224 px, batch 100, 2 timed epochs after
    the warm one, read from JPEG files through the native transforms."""
    from cmh_torch.tools import epoch_ab

    reset_counts(counters)
    out = epoch_ab.main(["--scale", "full", "--device", "cuda", "--ref-artifact",
                         os.path.join(ROOT, "tools", "artifacts", "ref_epoch_full.json")])
    torch.cuda.synchronize()
    launches = read_counts(counters)
    print(f"[phase 17e] epoch_ab: {json.dumps(out)}; launches {launches}", flush=True)
    if not (out["ours_epoch_s"] > 0 and out["ref_source"] == "artifact"
            and len(out["ours_epoch_times_s"]) == 2):
        raise AssertionError(f"phase 17e: epoch_ab {out}")
    return launches


def native_transforms():
    """17f: one native 500×375 → 224 transform against its PIL version on
    the host (host clock, median of 20)."""
    import numpy as np
    from PIL import Image

    from cmh_torch.data import transforms

    img = Image.fromarray(np.random.RandomState(0).randint(0, 256, (375, 500, 3), np.uint8))

    def ms(fn):
        fn()
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return sorted(times)[10] * 1e3

    rows = {}
    for what, fn, plain in (
            ("eval", lambda: transforms.eval_transform(img, 224),
             lambda: transforms.eval_transform_plain(img, 224)),
            ("train", lambda: transforms.train_transform(img, 224, np.random.RandomState(5)),
             lambda: transforms.train_transform_plain(img, 224, np.random.RandomState(5)))):
        equal = np.array_equal(fn(), plain())
        rows[what] = {"native_ms": ms(fn), "plain_ms": ms(plain), "bit_equal": equal}
        if not equal:
            raise AssertionError(f"phase 17f: the native {what} transform differs from PIL's")
    print(f"[phase 17f] one 500x375 -> 224 image on the host (ms, median of 20): {rows}",
          flush=True)


def phase17(torch, counters, keep):
    """Phase 17: the tools on the card, each path's launches counted apart."""
    from cmh_torch.tools import chip_microbench

    t0 = time.perf_counter()
    paths = {"build_index": tool_build_index(torch, counters, keep),
             "all_methods_smoke": tool_all_methods(torch, counters)}
    paths["profile_train"], paths["profile_encode"] = tool_profiles(torch, counters)
    tool_twdh_matrix()
    paths["epoch_ab"] = tool_epoch_ab(torch, counters)
    mb = chip_microbench.main(["--quick"])
    print(f"[phase 17g] chip_microbench --quick: {json.dumps(mb)}", flush=True)
    native_transforms()
    print(f"[phase 17] {time.perf_counter() - t0:.1f} s", flush=True)
    return paths


def random_counters():
    from cmh_torch.ops.random import dropout, dropout_bwd, random_bits

    return {"threefry_bits": random_bits, "dropout_fwd": dropout, "dropout_bwd": dropout_bwd}


def check_threefry(torch):
    """18a: ``threefry_bits`` against the plain threefry at three keys, sizes
    from 1 to 2^28 (n = 1, 2, 3 modulo the vector of 4 words among them) and
    offsets across the counters' hi word (the launch cut there, the second
    starting off a 16-byte boundary), bit for bit; its time at 2^26 words
    beside the plain version's and its bound."""
    from cmh_torch.ops import random as R
    from cmh_torch.utils import prng

    keys = (prng.PRNGKey(0), prng.PRNGKey(1814), prng.fold_in(prng.PRNGKey(-3), 2**32 - 1))
    cases = ((1, 0), (7, 0), (1000, 0), ((1 << 20) + 3, 0), (4096, 2**32 - 1000),
             (4099, 2**32 - 1001), (33, 3 * 2**32 - 6), (1 << 28, 0))
    for key in keys:
        for n, off in cases:
            got = R.random_bits(key, (n,), "cuda", offset=off)
            want = prng.random_bits(key, (n,), off, device="cuda")
            if not torch.equal(got, want):
                raise AssertionError(f"threefry_bits {key} n={n} offset={off}: "
                                     f"{int((got != want).sum())} words differ")
            del got, want
    print(f"[random] threefry_bits equals the plain threefry at {len(keys)} keys, "
          f"{len(cases)} sizes (1 to 2^28, three across the hi word)", flush=True)
    n = 1 << 26
    out = torch.empty(n, dtype=torch.int32, device="cuda")
    lib, key = R._lib(), keys[1]
    stream = torch.cuda.current_stream().cuda_stream

    def bits(o):
        return lib.cmh_threefry_bits(key[0], key[1], 0, 0, o.data_ptr(), n, stream)

    ms = cuda_ms(lambda: bits(out), iters=20)
    plain_ms = cuda_ms(lambda: prng.random_bits(key, (n,), device="cuda"), iters=3, warmup=1)
    row = entry("threefry_bits", "cmh_torch/csrc/threefry.cu",
                "no Pallas counterpart: XLA's threefry2x32 in cmh_tpu "
                "(cmh_tpu/models/mith.py:418, cmh_tpu/runners/base.py:222)",
                [n], 0.0, ms, plain_ms, None, 4 * n, THREEFRY_OPS * n, "int32")
    row["cold_ms"] = cold_ms(bits, (out,), iters=20)
    return [row]


# the configs' dropout rates (configs/*/config.yaml: 0.3; the DSPH and DNPH
# heads' default 0.2; UMoED's blocks' default 0.1)
DROPOUT_RATES = (0.3, 0.2, 0.1)


def prove_division(torch):
    """18c: the dropout kernels' reciprocal quotient against IEEE division at
    every input of each dtype (all 2^32 float32 bit patterns, all 2^16
    bfloat16), for each rate the configs use; the wrapper proves the same at
    its first call for a divisor and takes ``__fdiv_rn`` where it fails."""
    from cmh_torch.ops import random as R

    proofs = {}
    for rate in DROPOUT_RATES:
        for dt in (torch.float32, torch.bfloat16):
            scale = R._scale(rate, dt)[1].float().item()
            t0 = time.perf_counter()
            bad, least, most = R.division_mismatches(scale, dt, "cuda")
            proofs[f"{1 - rate:.1f} {str(dt).split('.')[-1]}"] = bad
            print(f"[random] keep_prob {1 - rate:.1f} in {dt}, divisor {scale!r}: the reciprocal "
                  f"path differs from IEEE division at {bad} of "
                  f"{2**32 if dt == torch.float32 else 2**16} inputs, |x| from {least!r} to "
                  f"{most!r} ({(time.perf_counter() - t0) * 1e3:.1f} ms host clock); the "
                  f"kernels take {'it' if bad == 0 else '__fdiv_rn'}", flush=True)
    return proofs


def check_dropout(torch):
    """18b: ``dropout_fwd`` and ``dropout_bwd`` against the plain dropout, bit
    for bit, in fp32 and bf16: whole, as rank 1's heads of a tp=2 split
    (a last dim of 82, not a multiple of the vector) and at a data-parallel
    row offset, at n = 1, 2, 3 modulo the vector and on a view that starts
    off a 16-byte boundary; their times (hot and cold L2) at UMoED's largest
    mask and at a hash head's, beside the plain version's and
    ``F.dropout``'s (Philox, another function: a yardstick only)."""
    from cmh_torch.ops import random as R
    from cmh_torch.utils import prng

    gen = torch.Generator(device="cuda").manual_seed(18)
    key = prng.flax_key(prng.fold_in(prng.PRNGKey(1814), 5), "hash_module", "layer_0",
                        "drop_ff", 1)
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        probs = torch.rand((TRAIN_B, 8, UMOED_SLOTS, 82), generator=gen, device="cuda").to(dt)
        ffn = torch.randn((TRAIN_B, UMOED_SLOTS, 2048), generator=gen, device="cuda").to(dt)
        flat = torch.randn(4099, generator=gen, device="cuda").to(dt)
        for what, x, part, whole, sl in (
                ("whole", ffn, None, ffn, slice(None)),
                ("tp shard", probs[:, 4:].contiguous(), (1, 4, 8), probs,
                 (slice(None), slice(4, 8))),
                ("dp rows", ffn[TRAIN_B // 2:].contiguous(), (0, TRAIN_B // 2, TRAIN_B), ffn,
                 slice(TRAIN_B // 2, None)),
                *((f"n = {n}", flat[:n], None, flat[:n], slice(None)) for n in (4097, 4098, 4099)),
                ("a view 3 elements in", flat[3:], None, flat[3:], slice(None))):
            for fn in (R.dropout, R.dropout_bwd):
                got = fn(x, key, 0.3, part)
                want = R.dropout_plain(whole, key, 0.3)[sl]
                if not torch.equal(got, want):
                    raise AssertionError(f"{fn.__name__} {what} {dt}: "
                                         f"{int((got != want).sum())} elements differ")
    print("[random] dropout_fwd and dropout_bwd equal the plain dropout, fp32 and bf16, "
          "whole, as a tp shard, at a dp row offset, at n = 1, 2, 3 modulo the vector and "
          "on a view off a 16-byte boundary", flush=True)
    for what, shape in DROPOUT_CASES:
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=gen, device="cuda").to(dt)
            n, size = x.numel(), x.element_size()
            plain_ms = cuda_ms(lambda: R.dropout_plain(x, key, 0.3), iters=5, warmup=2)
            lib_ms = cuda_ms(lambda: torch.nn.functional.dropout(x, 0.3, training=True))
            for name, fn in (("dropout_fwd", R.dropout), ("dropout_bwd", R.dropout_bwd)):
                ms = cuda_ms(lambda: R._launch(fn, x, key, 0.3, None))
                rows.append(entry(name, "cmh_torch/csrc/threefry.cu",
                                  "no Pallas counterpart: XLA's threefry2x32 in cmh_tpu "
                                  "(flax.linen.Dropout)", f"{what} {list(shape)} "
                                  f"{str(dt).split('.')[-1]}", 0.0, ms, plain_ms, lib_ms,
                                  2 * n * size, DROPOUT_OPS * n, "int32"))
                rows[-1]["cold_ms"] = cold_ms(lambda a: R._launch(fn, a, key, 0.3, None), (x,))
    return rows


def mask_sizes(torch, tr):
    """The dropout launches of one UMoED train step by kernel, shape, dtype
    and part, on a batch made on the card (after its steady steps; outside
    the main path's counts)."""
    from cmh_torch.ops import random as R

    seen, launch = {}, R._launch

    def tally(counter, x, key, rate, part):
        k = (counter.kernel.replace("cmh_", ""), tuple(x.shape), str(x.dtype).split(".")[-1],
             rate, part)
        seen[k] = seen.get(k, 0) + 1
        return launch(counter, x, key, rate, part)

    batch = device_batch(torch, torch.Generator(device="cuda").manual_seed(10), TRAIN_B)
    R._launch = tally
    try:
        tr.train_step(batch)
        torch.cuda.synchronize()
    finally:
        R._launch = launch
    return seen


def time_mask_sizes(torch, seen):
    """Each kind of UMoED's dropout launches timed alone (``cuda_ms``), its
    count a step, and the sum: what a step spends in the dropout kernels."""
    from cmh_torch.ops import random as R
    from cmh_torch.utils import prng

    kernels = {"dropout_fwd": R.dropout, "dropout_bwd": R.dropout_bwd}
    key, total, lines = prng.PRNGKey(3), 0.0, []
    for (name, shape, dt, rate, part), count in sorted(seen.items(), key=lambda kv: -math.prod(kv[0][1])):
        x = torch.randn(shape, device="cuda").to(getattr(torch, dt))
        ms = cuda_ms(lambda: R._launch(kernels[name], x, key, rate, part), iters=20)
        total += ms * count
        lines.append(f"{count} x {name} {list(shape)} {dt} rate {rate}"
                     f"{' part ' + str(part) if part else ''}: {ms:.5f} ms")
    print(f"[random] UMoED's dropout launches a step by size ({sum(seen.values())} in "
          f"{len(seen)} kinds), each kind timed alone: " + "; ".join(lines)
          + f"; {total:.4f} ms a step in all", flush=True)
    return total


def phase18(torch, rand_by_path):
    """Phase 18: the threefry kernels against their plain versions, the
    division's proof, their times, UMoED's dropout launches by size, and
    their launches on the training paths; UMoED's steady step."""
    t0 = time.perf_counter()
    rows = check_threefry(torch) + check_dropout(torch)
    RANDOM_STATS["division"] = prove_division(torch)
    if "UMoED masks" in RANDOM_STATS:
        RANDOM_STATS["UMoED dropout ms a step"] = time_mask_sizes(torch, RANDOM_STATS["UMoED masks"])
    for path, need in (("UMoED", ("threefry_bits", "dropout_fwd", "dropout_bwd")),
                       ("DIMCH", ("threefry_bits", "dropout_fwd", "dropout_bwd"))):
        idle = [k for k in need if rand_by_path[path][k] == 0]
        if idle:
            raise AssertionError(f"{path}: kernels {idle} were never launched")
    for r in rows:
        r["launches"] = sum(c[r["name"]] for c in rand_by_path.values())
        r["launches_by_path"] = {p: c[r["name"]] for p, c in rand_by_path.items()}
        print(f"[kernel] {r['name']} {r['shape']}: ms {r['ms']:.5f} cold {r['cold_ms']:.5f} "
              f"plain {r['plain_ms']:.4f} library {r['library_ms']} bound {r['bound_ms']:.5f} "
              f"({r['bound_by']}; {r['bound_ms'] / r['ms']:.1%} of it); "
              f"launches {r['launches_by_path']}", flush=True)
    print(f"[random] UMoED steady steps at batch {TRAIN_B}, host clock: "
          f"{RANDOM_STATS.get('UMoED steady ms')} ms, its masks drawn on the card; phase 18 "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return rows


def main() -> int:
    started = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        import cmh_torch  # noqa: F401
        from cmh_torch.ops import _build
        from cmh_torch.ops.attention import attention_bwd, fused_attention
        from cmh_torch.ops.hamming import hamming_packed
        from cmh_torch.ops.layernorm import fused_layernorm, layernorm_bwd
        from cmh_torch.ops.map_kernel import map_ap, map_hist
    except ImportError as e:
        print(f"chip_smoke: the cmh_torch package is missing: {e}", file=sys.stderr)
        return 2
    # files that one phase writes and a later one reads (phase 14's ViT-L/14 archive)
    shared = tempfile.mkdtemp(prefix="cmh_smoke_shared_")
    try:
        smi = smi_line()
        print(f"[env] {smi}", flush=True)
        print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
              f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)
        print("[env] optional packages: " + ", ".join(
            f"{m}={'yes' if importlib.util.find_spec(m) else 'no'}"
            for m in ("PIL", "yaml", "regex")), flush=True)

        t = time.perf_counter()
        took = _build.build_all()
        print(f"[build] {time.perf_counter() - t:.2f} s ({took or 'cached'})", flush=True)
        for name in took:   # what ptxas said about each kernel it compiled
            log = _build.build_log(name)
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
            spills = [int(r) for r in re.findall(r"(\d+) bytes spill stores", log)]
            if regs and spills:
                print(f"[build] {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
                      f"registers, at most {max(spills)} bytes of spill stores", flush=True)

        gen = torch.Generator(device="cuda").manual_seed(0)
        rows = check_layernorm(torch, gen) + check_attention(torch, gen) + check_hamming(torch, gen)
        rows += check_layernorm_bwd(torch, gen) + check_attention_bwd(torch, gen)
        rows += check_attention_tiled(torch, gen)
        map_rows, _ = check_map(torch, gen)
        rows += map_rows
        for r in rows:
            cold = f" cold {r['cold_ms']:.5f}" if "cold_ms" in r else ""
            popc = f" popcount floor {r['popc_floor_ms']:.5f}" if "popc_floor_ms" in r else ""
            fma = f" fp32 FMA floor {r['fma_floor_ms']:.5f}" if "fma_floor_ms" in r else ""
            print(f"[kernel] {r['name']} {r['shape']}: err {r['max_abs_err']:.3g} "
                  f"ms {r['ms']:.5f}{cold} plain {r['plain_ms']:.4f} library {r['library_ms']} "
                  f"bound {r['bound_ms']:.5f} ({r['bound_by']}){popc}{fma}", flush=True)

        model_parity(torch)
        grad_parity(torch)
        tower_times(torch)
        counters = {"layernorm": fused_layernorm, "attention": fused_attention,
                    "hamming": hamming_packed, "layernorm_bwd": layernorm_bwd,
                    "attention_bwd": attention_bwd, "map_hist": map_hist, "map_ap": map_ap}
        by_path = {"serving": serving(torch, counters)}
        by_path["training"], _ = training(torch, counters, shared)
        preemption(torch)
        flat_optimizer(torch)
        by_path["pretrained"] = pretrained_load(torch, counters)
        by_path.update(train_methods(torch, counters))
        phase11, fp32_by_path = train_mith_twdh(torch, counters)
        by_path.update(phase11)
        by_path["msgpack + search"] = msgpack_and_search_cpu(
            torch, counters, os.path.join(WORK, "index.npz"))
        phase13, fp32_13, rand_by_path = train_dimch_umoed(torch, counters)
        by_path.update(phase13)
        fp32_by_path.update(fp32_13)
        phase14, tiled_by_path = long_sequences(torch, counters, shared)
        by_path.update(phase14)
        by_path.update(phase15(torch, counters))
        phase16_paths, phase16_tiled, phase16_fp32 = phase16(
            torch, os.path.join(shared, "ViT-L-14.pt"))
        by_path.update(phase16_paths)
        tiled_by_path.update(phase16_tiled)
        fp32_by_path.update(phase16_fp32)
        by_path.update(phase17(torch, counters, shared))
        random_rows = phase18(torch, rand_by_path)
        from cmh_torch.models.common import Dropout
        if Dropout.host_seconds != 0:
            raise AssertionError(f"{Dropout.host_seconds} s of dropout masks drawn on the host")
        train_kernels = ("layernorm", "layernorm_bwd", "attention", "attention_bwd",
                         "map_hist", "map_ap")
        for path, need in (("serving", ("layernorm", "attention", "hamming")),
                           ("training", train_kernels), ("pretrained", ("layernorm", "attention")),
                           ("Baseline", train_kernels), ("DSPH", train_kernels),
                           ("DNPH", train_kernels),
                           ("DSPH serving", ("layernorm", "attention", "hamming")),
                           ("MITH", train_kernels), ("TwDH", train_kernels),
                           ("msgpack + search", ("layernorm", "attention", "hamming",
                                                 "map_hist", "map_ap")),
                           ("DIMCH", train_kernels), ("UMoED", train_kernels),
                           ("UMoED serving", ("layernorm", "attention", "hamming")),
                           ("TwDH serving", ("layernorm", "attention", "hamming")),
                           ("ViT-L/14", train_kernels), ("ViT-B/16 encode", ("layernorm", "attention")),
                           ("MITH 128-bit", train_kernels),
                           ("cmh_tpu checkpoint", ("layernorm", "layernorm_bwd", "attention",
                                                   "attention_bwd")),
                           ("dp group of one", train_kernels),
                           ("sharded", ("map_hist", "map_ap", "hamming")),
                           ("tp2 fp32 parity", ("layernorm", "layernorm_bwd", "attention",
                                                "attention_bwd")),
                           ("dp2 x tp2 DCMHT", train_kernels), ("tp2 resumed DCMHT", train_kernels),
                           ("tp2 ViT-L/14", train_kernels), ("tp2 UMoED", train_kernels),
                           ("build_index", ("layernorm", "attention", "hamming")),
                           ("all_methods_smoke", train_kernels),
                           ("profile_train", ("layernorm", "layernorm_bwd", "attention",
                                              "attention_bwd")),
                           ("profile_encode", ("layernorm", "attention", "map_hist", "map_ap")),
                           ("epoch_ab", train_kernels)):
            idle = [k for k in need if by_path[path][k] == 0]
            if idle:
                raise AssertionError(f"{path}: kernels {idle} were never launched")
        # the row-tiled kernels, apart from the one-block K2 (which the text
        # tower still takes on the ViT-L/14 paths): bf16 operands on mma in
        # bf16, 3xTF32 on mma in fp32
        for path, need in (("ViT-L/14", ("tiled_fwd_mma", "tiled_bwd_mma")),
                           ("ViT-B/16 encode", ("tiled_fwd_mma",)),
                           ("ViT-L/14 fp32", ("tiled_fwd_tf32", "tiled_bwd_tf32")),
                           ("MITH 128-bit", ("tiled_bwd_tf32",)),
                           ("tp2 ViT-L/14", ("tiled_fwd_mma", "tiled_bwd_mma"))):
            idle = [k for k in need if tiled_launches(tiled_by_path[path], k) == 0]
            if idle:
                raise AssertionError(f"{path}: the row-tiled kernels {idle} were never launched")
        if by_path["ViT-L/14"]["attention"] == tiled_by_path["ViT-L/14"]["attention"]:
            raise AssertionError("ViT-L/14: the one-block K2 was never launched")
        for path, need in (("MITH", ("layernorm", "layernorm_bwd", "attention", "attention_bwd")),
                           ("UMoED", ("layernorm", "layernorm_bwd")),
                           ("tp2 fp32 parity", ("layernorm", "layernorm_bwd", "attention",
                                                "attention_bwd"))):
            idle = [k for k in need if fp32_by_path[path][k] == 0]
            if idle:
                raise AssertionError(f"{path}: the fp32 kernels {idle} were never launched")

        key = {"layernorm_fwd": "layernorm", "attention_fwd": "attention", "hamming": "hamming",
               "layernorm_bwd": "layernorm_bwd", "attention_bwd": "attention_bwd",
               "map_hist": "map_hist", "map_ap": "map_ap",
               "tiled_fwd_tf32": "attention", "tiled_bwd_tf32": "attention_bwd",
               "tiled_fwd_mma": "attention", "tiled_bwd_mma": "attention_bwd"}
        kernels, seen = [], {}
        for r in rows:   # one entry per kernel at its first shape, the rest under "shapes"
            k = key[r["name"]]
            tiled = r["name"].endswith(("_mma", "_tf32"))
            # launches over the main-path runs, and per path: K2's one-block and
            # row-tiled kernels apart
            if tiled:
                per_path = {p: tiled_launches(c, r["name"]) for p, c in tiled_by_path.items()}
            else:
                per_path = {p: c[k] - tiled_by_path.get(p, {}).get(k, 0)
                            for p, c in by_path.items()}
            r["launches"] = sum(per_path.values())
            r["launches_by_path"] = per_path
            if k in fp32_by_path["MITH"] and not tiled:
                r["fp32_launches_by_path"] = {p: c[k] for p, c in fp32_by_path.items()}
            if r["name"] in seen:
                seen[r["name"]].setdefault("shapes", []).append(
                    {k: r[k] for k in ("shape", "max_abs_err", "ms", "cold_ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms")
                     if k in r})
            else:
                seen[r["name"]] = {k: v for k, v in r.items() if k not in FLOORS}
                kernels.append(seen[r["name"]])
        for r in random_rows:   # phase 18's, their launches counted there
            if r["name"] in seen:
                seen[r["name"]].setdefault("shapes", []).append(
                    {k: r[k] for k in ("shape", "ms", "cold_ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")})
            else:
                seen[r["name"]] = r
                kernels.append(r)
        print(f"[chip_smoke] {time.perf_counter() - started:.1f} s", flush=True)
        print(smi_line(), flush=True)
        print(json.dumps({"kernels": kernels}), flush=True)
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        shutil.rmtree(shared, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-worker"]:
        sys.exit(tp_worker(sys.argv[2]))
    sys.exit(main())
