"""Profile the trainer's train step and break its device time down by kernel.

The port's ``cmh_tpu/tools/profile_train.py``:

    python -m cmh_torch.tools.profile_train [--method DCMHT] [--batch 256]
        [--steps 6] [--outdir DIR] [--tiny] [--device cuda|cpu]

builds the method's trainer on the synthetic dataset (ViT-B/32 at 224
pixels, or the tiny CLIP at 32 with ``--tiny``), makes ``--steps`` batches
on the device ahead of time, warms one step, then times ``--steps`` steps of
``train_step`` (forward, loss, backward, BertAdam) on the host clock,
synchronized, and prints ``train step: … ms (… pairs/s)``. One more window
of ``--steps`` steps runs under ``torch.profiler``: on the card it prints
the device kernels summed by name (ms a step, share of the kernel time,
calls a step), the most expensive first; on the CPU the host operators by
self time. Beside it, the step by the program's phases, read from its spans
(``cmh.forward``, ``cmh.backward``, ... of ``utils/trace.py``) in the
window's Chrome trace: on the card the device ms a step of what was launched,
on any thread, inside each phase; on the CPU each phase's host ms. With
``--outdir`` the window's Chrome trace is written there. The launches a step
of the port's kernels (K1 and K2, each way) come from their wrappers'
counters. ``main`` returns these numbers as a dict.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import tempfile
import time
from typing import Optional

TOP = 40   # rows of the breakdown printed
# train_step's phases, in order (runners/base.py)
PHASES = ("to_device", "forward", "loss", "zero_grad", "backward", "grad_allreduce", "optimizer")


def kernel_launches() -> dict:
    """The launch counters of the train step's kernel wrappers (K1 and K2,
    each way)."""
    from ..ops.attention import attention_bwd, fused_attention
    from ..ops.layernorm import fused_layernorm, layernorm_bwd

    return {"layernorm": fused_layernorm.launches, "layernorm_bwd": layernorm_bwd.launches,
            "attention": fused_attention.launches, "attention_bwd": attention_bwd.launches}


def synthetic_trainer(method: str, batch: int, output_dim: int, tiny: bool, query_num: int,
                      device):
    """The method's trainer on the synthetic dataset (cmh_tpu's profiling
    config): ViT-B/32 at 224 pixels, or the tiny CLIP at 32 with ``tiny``;
    ``batch * 3`` train items."""
    from ..config import config_from_dict
    from ..registry import load_components

    tmp = tempfile.mkdtemp(prefix="cmh_prof_")
    model_cfg = {"arch": method, "clip_path": "/nonexistent.pt"}
    if tiny:
        model_cfg["clip_variant"] = "tiny"
    cfg = config_from_dict({
        "model": model_cfg,
        "optimizer": {"arch": "BertAdam", "lr": 0.001, "clip_lr": 0.00001},
        "dataset": {"arch": "synthetic_dataset", "name": "synthetic", "num_classes": 8,
                    "image_resolution": 32 if tiny else 224,
                    # the tiny CLIP's text context is shorter than the full 77
                    "max_word": 12 if tiny else 32},
        "run": {"arch": f"{method}Trainer", "save_dir": tmp, "log_dir": tmp,
                "output_dim": output_dim, "batch_size": batch, "is_train": True,
                "train_num": batch * 3, "query_num": query_num, "epochs": 1,
                "display_step": 10 ** 9, "seed": 1},
    })
    return load_components().require_runner_class(f"{method}Trainer").from_config(
        cfg=cfg, device=device, auto_run=False)


def device_batches(loader, device) -> list:
    """Every batch of ``loader`` as tensors on ``device``."""
    import torch

    return [{k: torch.as_tensor(v).to(device) for k, v in b.items()} for b in loader]


def synchronize(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profiled(fn, device, outdir: Optional[str] = None, name: str = "window"):
    """Run ``fn`` once under ``torch.profiler`` (CPU and, on the card,
    CUDA activity); with ``outdir`` write the Chrome trace there. Returns
    (profile, trace path or None)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        fn()
        synchronize(device)
    path = None
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        path = os.path.join(outdir, f"{name}.pt.trace.json")
        prof.export_chrome_trace(path)
    return prof, path


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def op_table(prof, device, per: int) -> dict:
    """The profile's time summed by name, ``per`` windows a unit (steps,
    batches): on the card its device kernels (device events whose name no
    host event has), on the CPU its host operators by self time. Returns
    {"kind", "total_ms", "ops": [{"name", "ms", "share", "calls"}, ...]},
    the most expensive first, ms and calls per unit."""
    import torch

    events = prof.key_averages()
    if device.type == "cuda":
        host = {e.key for e in events if e.device_type != torch.autograd.DeviceType.CUDA}
        rows = [(e.key, _device_us(e), e.count) for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in host
                and _device_us(e) > 0]
        kind = "device kernels"
    else:
        rows = [(e.key, e.self_cpu_time_total, e.count) for e in events
                if e.self_cpu_time_total > 0]
        kind = "host operators"
    rows.sort(key=lambda r: r[1], reverse=True)
    total = sum(r[1] for r in rows)
    return {"kind": kind, "total_ms": total / 1e3 / per,
            "ops": [{"name": n, "ms": us / 1e3 / per, "share": us / total,
                     "calls": c / per} for n, us, c in rows]}


def phase_table(path: str, device, per: int) -> dict:
    """train_step by its phases, from the ``cmh.*`` spans of the Chrome
    trace at ``path`` over ``per`` steps: on the card the device time of the
    kernels, copies and sets whose launch, on any thread (the autograd
    engine's too), lies inside a phase; on the CPU the phase's host time.
    Returns {"kind", "step_ms", "phases": [{"name", "ms", "share"}, ...]}
    in the phases' order, ms a step, shares of the step's."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans, launch, device_events = collections.defaultdict(list), {}, []
    for e in events:
        cat, args = e.get("cat"), e.get("args", {})
        if cat == "user_annotation" and e["name"].startswith("cmh."):
            spans[e["name"].split(" ")[0][4:]].append((e["ts"], e["ts"] + e.get("dur", 0)))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launch[args["correlation"]] = e["ts"]
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device_events.append((args.get("correlation"), e.get("dur", 0)))

    def us(name):
        inside = spans.get(name, ())
        if device.type != "cuda":
            return sum(b - a for a, b in inside)
        return sum(d for c, d in device_events
                   if c in launch and any(a <= launch[c] <= b for a, b in inside))

    step = us("train_step")
    rows = [(name, us(name)) for name in PHASES if name in spans]
    return {"kind": "device ms" if device.type == "cuda" else "host ms",
            "step_ms": step / 1e3 / per,
            "phases": [{"name": n, "ms": t / 1e3 / per, "share": t / step if step else 0.0}
                       for n, t in rows]}


def print_table(table: dict, unit: str) -> None:
    print(f"\n=== {table['kind']}: {table['total_ms']:.3f} ms/{unit} ===")
    for op in table["ops"][:TOP]:
        print(f"{op['ms']:9.3f} ms/{unit} {op['share']:6.1%} {op['calls']:8.1f} calls/{unit}  "
              f"{op['name'][:110]}")


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--method", default="DCMHT")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--output-dim", type=int, default=64)
    ap.add_argument("--outdir", default=None,
                    help="write the profiled window's Chrome trace here")
    ap.add_argument("--tiny", action="store_true", help="tiny CLIP (CPU-friendly shapes)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to run (default: the CUDA card)")
    args = ap.parse_args(argv)
    from .. import resolve_device

    device = resolve_device(args.device)
    tr = synthetic_trainer(args.method, args.batch, args.output_dim, args.tiny,
                           args.batch * 4, device)
    batches = device_batches(tr.train_loader, device)

    def steps():
        for i in range(args.steps):
            tr.train_step(batches[i % len(batches)])

    tr.train_step(batches[0])   # warm: first launches, the optimizer's buffers
    synchronize(device)
    before = kernel_launches()
    t0 = time.perf_counter()
    steps()
    synchronize(device)
    dt = (time.perf_counter() - t0) / args.steps
    launches = {k: (v - before[k]) / args.steps for k, v in kernel_launches().items()}
    print(f"train step: {dt * 1e3:.2f} ms  ({args.batch / dt:.0f} pairs/s)")
    print(f"kernel launches a step: {launches}")

    with tempfile.TemporaryDirectory(prefix="cmh_prof_trace_") as tmp:
        prof, trace = profiled(steps, device, args.outdir or tmp,
                               f"train-{args.method}-{args.steps}")
        phases = phase_table(trace, device, args.steps)
    table = op_table(prof, device, args.steps)
    print_table(table, "step")
    print(f"\n=== train_step by phase ({phases['kind']}): {phases['step_ms']:.3f} ms/step ===")
    for p in phases["phases"]:
        print(f"{p['ms']:9.3f} ms/step {p['share']:6.1%}  {p['name']}")
    return {"method": args.method, "batch": args.batch, "steps": args.steps,
            "device": device.type, "step_ms": dt * 1e3, "pairs_per_s": args.batch / dt,
            "launches_per_step": launches, "trace": trace if args.outdir else None,
            "phases": phases, **table}


if __name__ == "__main__":
    main()
