"""Arithmetic the per-layer readers in ``metrics/`` share."""

from __future__ import annotations

import statistics
from typing import Callable, Iterable, Optional, Tuple

from . import flops


def idle_pct(outcome) -> Optional[float]:
    """Share of the traced window in which nothing ran on the card, %."""
    t = outcome.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)


def roofline_pct(outcome, parts: Iterable[Tuple[str, Callable]]) -> Optional[float]:
    """Over the traced window's calls of the spans ``parts`` names whose
    launches the trace holds: the bound time of each, from the shapes its
    span kept by the span's function (bytes, operations, kind), over the
    device time of every kernel launched inside them, %. None where the
    window holds no such call."""
    t = outcome.trace
    if t is None:
        return None
    bound = measured = 0.0
    for span, fn in parts:
        for kept, device_s in t.span_calls(span):
            if device_s > 0:
                bound += flops.bound_s(*fn(*kept))
                measured += device_s
    return 100.0 * bound / measured if measured > 0 else None


def span_mean_ms(outcome, span: str) -> Optional[float]:
    """Mean host milliseconds of the traced window's calls of ``span``."""
    values = outcome.host.get("span_ms", {}).get(span)
    return statistics.fmean(values) if values else None
