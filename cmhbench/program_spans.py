"""The program's own spans in a traced window, for the per-layer readers.

``cmh_torch/utils/trace.py`` records a span ``cmh.<name>`` (phases of
``train_step`` and ``valid``, kernel entries, ``cmh.wait.<site>`` around
each host wait on the card) while a profiler records, so the window of
``trace.trace_window`` holds them beside the benchmark's own wrappers. This
module reads them from the ``Trace`` it returns:

- ``intervals(t, name)``: the spans ``cmh.<name>`` of every thread, merged
  into disjoint (start, end) intervals; a name ending in ``*`` takes every
  span under that prefix (``wait.*``);
- ``device_s(t, name)``: device seconds of the kernels, copies and sets
  whose launch, on any thread (the autograd engine's too), lies inside
  those intervals;
- ``idle_s(t, name)``: seconds inside them with nothing on the card.

A program without these spans (an earlier commit) leaves every count at 0,
and ``per`` returns None.
"""

from __future__ import annotations

import bisect
from typing import Callable, List, Optional, Tuple

from .trace import _merge

PREFIX = "cmh."


def _matches(name: str) -> Callable[[str], bool]:
    if name.endswith("*"):
        prefix = PREFIX + name[:-1]
        return lambda op: op.startswith(prefix)
    full = PREFIX + name
    return lambda op: op == full


def spans(t, name: str) -> List[Tuple[float, float]]:
    """(start, end) of each span ``cmh.<name>``, on any thread."""
    match = _matches(name)
    return [(a, b) for a, b, op in t._all_ops if match(op)]


def count(t, name: str) -> int:
    return len(spans(t, name))


def intervals(t, name: str) -> List[Tuple[float, float]]:
    return _merge(spans(t, name))


def device_s(t, name: str) -> float:
    """Device seconds of the events launched inside the spans ``name``."""
    inside = intervals(t, name)
    starts = [a for a, _ in inside]
    total = 0.0
    for launches in t._by_launch.values():
        for ts, i in launches:
            k = bisect.bisect_right(starts, ts) - 1
            if k >= 0 and ts <= inside[k][1]:
                total += t.device[i][1] - t.device[i][0]
    return total


def idle_s(t, name: str) -> float:
    """Seconds inside the spans ``name`` in which nothing ran on the card."""
    busy = _merge([(a, b) for a, b, *_ in t.device])
    idle = 0.0
    for a, b in intervals(t, name):
        covered = sum(max(0.0, min(b, y) - max(a, x)) for x, y in busy
                      if x < b and y > a)
        idle += (b - a) - covered
    return idle


def per(outcome, unit: str, value: Callable[[object], float]) -> Optional[float]:
    """``value(trace)`` over the spans ``unit`` of the traced window (its
    steps, its valids); None without a trace or without such spans."""
    t = outcome.trace
    units = count(t, unit) if t is not None else 0
    return value(t) / units if units else None
