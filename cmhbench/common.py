"""What every kind shares: the run's context, its outcome, the numbers
compared for ``correct``, seeded generators, and the check that nothing of
JAX or of the JAX package was loaded."""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

# compared by whole top-level name: the port's package begins with the JAX
# package's name and is not one of these
FORBIDDEN = ("jax", "jaxlib", "flax", "cmh_tpu")


def forbidden_modules(modules) -> List[str]:
    """The top-level names among ``modules`` (names of ``sys.modules``)
    that are JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in modules} & set(FORBIDDEN))


def process_start() -> float:
    """Wall-clock time at which this process started, from /proc."""
    with open("/proc/self/stat") as f:
        after_comm = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(after_comm[19])          # field 22, starttime
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def generator(seed: int, stream: int, device):
    """A torch.Generator on ``device`` for one stream of draws of a run:
    streams of one seed never share a state, and one seed gives the same
    draws in every run."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(((seed % (1 << 54)) << 8) + stream)
    return g


# the streams of one run
WEIGHTS, INPUTS, GALLERY, SAMPLE = range(4)


@dataclasses.dataclass
class Check:
    """One number compared for ``correct``: it passes at or below its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Context:
    cfg: dict
    traffic: dict
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: object
    started: float            # wall-clock start of the process
    tmp: Path                 # a directory of this run's own


@dataclasses.dataclass
class Outcome:
    """What a kind's run hands back: its end-to-end metrics, its counts, the
    numbers compared, and what the per-layer readers read: host-clock
    numbers (``host``) and the traced window (``trace``)."""
    e2e: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: List[Check]
    host: Dict[str, object] = dataclasses.field(default_factory=dict)
    trace: Optional[object] = None


def code_margin(codes, ref_bits) -> float:
    """The widest margin by which the reference held a bit that ``codes``
    (±1, (N, K)) set the other way, 0 where none does; ``ref_bits`` is the
    reference's (±1 codes, each bit's margin), as the method's reference
    ``bits`` gives them."""
    ref, margin = ref_bits
    flipped = ref != codes.to(ref.device, ref.dtype)
    return float(margin[flipped].max()) if bool(flipped.any()) else 0.0


def pace(what: str, ends: List[float], t0: float, parts: int = 5) -> None:
    """Note on standard error how many ``what`` a second the window
    completed in each of its ``parts`` equal spans (``ends``: the host
    clock at the end of each), to tell drift within a run from a shift
    between runs."""
    if not ends:
        return
    span = (ends[-1] - t0) / parts
    counts = [0] * parts
    for e in ends:
        counts[min(parts - 1, int((e - t0) / span))] += 1
    rates = ", ".join(f"{c / span:.4f}" for c in counts)
    print(f"cmhbench: {what} a second in each {parts}th of the window: {rates}",
          file=sys.stderr, flush=True)


def mark(ctx: Context, what: str) -> None:
    """Note on standard error when a phase of the run ended, in seconds
    since the process started."""
    print(f"cmhbench: {what} at {time.time() - ctx.started:.3f} s", file=sys.stderr, flush=True)
