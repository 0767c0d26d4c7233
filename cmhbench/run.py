"""Run one cell of the benchmark and print its result as one JSON line.

    python -m cmhbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with a CUDA card. The cell's
entry in ``BENCHMARK.json`` names its configuration and traffic mix; the
traffic's ``kind`` picks the module in ``kinds/``. ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics, each read
by ``metrics/<name>.py``. Every run checks what its timed path produced
against the plain reference and prints each number compared beside its
limit, last on standard error and last in the result line. Without a card,
or with fewer than the cell asks for, it exits 2; if JAX or the JAX
package was loaded, 3; with no result line either way.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import tempfile
from pathlib import Path

from . import spec
from .common import Context, forbidden_modules, process_start


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout (the port builds
    its CUDA libraries into ``build/cmh_torch/`` itself)."""
    base = spec.ROOT / "build" / "cmhbench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(base / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(base / "triton"))


def context(bench: dict, cell: dict, seed: int, seconds: float, trace: bool,
            started: float, tmp) -> Context:
    """A run of ``cell`` on the first card."""
    import torch

    return Context(cfg=spec.config(bench, cell["config"]), traffic=spec.traffic(cell["traffic"]),
                   limits=spec.limits(cell["name"]), seed=seed, seconds=seconds, trace=trace,
                   device=torch.device("cuda", 0), started=started, tmp=Path(tmp))


def result_line(outcome, names, trace: bool, cell: dict) -> dict:
    """The JSON result: the cell's metrics of this mode, the device, the
    breakdown of a traced run, and the numbers compared, last."""
    import torch

    metrics = {}
    for m in names:
        if trace:
            value = spec.reader(m["name"])(outcome)
        else:
            value = outcome.e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": outcome.memory_peak_bytes}
    line = {"correct": all(c.ok for c in outcome.checks), "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device}
    if trace and outcome.trace is not None:
        t = outcome.trace
        device["busy_s"] = t.busy_s()
        device["window_s"] = t.window_s
        line["breakdown"] = {"device_ops": t.device_ops(), "idle_gaps": t.idle_gaps()}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return line


def main(argv=None) -> int:
    started = process_start()
    args = parse(argv)
    cache_dirs()
    import torch

    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"cmhbench: {args.workload} needs {cell['chips']} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="cmhbench-") as tmp:
        ctx = context(bench, cell, args.seed, args.seconds, bool(args.trace), started, tmp)
        kind = importlib.import_module(f"cmhbench.kinds.{ctx.traffic['kind']}")
        outcome = kind.run(ctx)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"cmhbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    section = "per_layer" if args.trace else "end_to_end"
    line = result_line(outcome, spec.metrics(bench, cell["name"], section), bool(args.trace), cell)
    for c in outcome.checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
