"""The traced window: spans from the benchmark's own wrappers, a
``torch.profiler`` trace of the card, and its reduction.

``Spans`` wraps entries of the port (a module's function or a class's
method) for the traced window only: each call runs inside a
``record_function`` named ``cmhbench.<span>``, its host time is kept, and
a recorder may keep what the call's shapes are. ``trace_window`` runs a
block under the profiler and returns a ``Trace``: the card's kernels, the
host's launches and the spans, from the profiler's Chrome trace.

A kernel belongs to a span when the host call that launched it (the runtime
event of the same correlation id) lies inside the span, on the span's
thread. The card is busy where any kernel, copy or memset runs; the window
is the ``cmhbench.window`` span.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import functools
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PREFIX = "cmhbench."


class Spans:
    """Wrappers installed on the port's entries for the traced window.

    ``add(owner, attr, span, record=None)`` wraps ``owner.attr``;
    ``record(context, *args, **kwargs)``, if given, returns what to keep of a
    call (its shapes, as JSON), which the span's name carries after a space.
    ``host_s[span]`` keeps each call's host seconds. ``context`` is a dict a kind may set before a
    call (the lengths of the captions a step feeds) for recorders to read."""

    def __init__(self):
        self._patches: List[Tuple[object, str, object]] = []
        self.host_s: Dict[str, list] = collections.defaultdict(list)
        self.context: Dict[str, object] = {}
        self._lock = threading.Lock()

    def add(self, owner, attr: str, span: str,
            record: Optional[Callable] = None) -> None:
        import torch

        original = getattr(owner, attr)
        name = PREFIX + span

        @functools.wraps(original)
        def wrapper(*args, **kwargs):
            kept = record(self.context, *args, **kwargs) if record else None
            t0 = time.perf_counter()
            with torch.profiler.record_function(name if kept is None else
                                                f"{name} {json.dumps(kept)}"):
                out = original(*args, **kwargs)
            dt = time.perf_counter() - t0
            with self._lock:
                self.host_s[span].append(dt)
            return out

        self._patches.append((owner, attr, original))
        setattr(owner, attr, wrapper)

    def remove(self) -> None:
        while self._patches:
            owner, attr, original = self._patches.pop()
            setattr(owner, attr, original)


@contextlib.contextmanager
def trace_window(tmp, result: dict):
    """Run the block under ``torch.profiler`` inside the span
    ``cmhbench.window`` (the block ends in a synchronize); on exit,
    ``result["trace"]`` holds its ``Trace``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from torch._C._profiler import _ExperimentalConfig

    path = os.path.join(str(tmp), "window.pt.trace.json")
    try:
        # threads started inside the window (an HTTP server's) are traced too
        config = _ExperimentalConfig(profile_all_threads=True)
    except TypeError:            # a PyTorch without the option traces the threads it saw start
        config = None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=config) as prof:
        with record_function(PREFIX + "window"):
            yield
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    try:
        result["trace"] = Trace.from_file(path)
    finally:
        os.remove(path)


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """A traced window's events, times in seconds.

    ``spans[name]`` lists each ``cmhbench.<name>`` span as (thread, start,
    end, the shapes its call kept, its External id). A device event belongs
    to a span when the host call that launched it lies inside the span on
    its thread, or when the profiler linked it to the span itself (the same
    External id: the span was the innermost operation at the launch)."""

    def __init__(self, events: List[dict]):
        self.device = []      # (start, end, name, correlation, category, External id)
        launches = {}         # correlation -> (tid, ts)
        self.spans = collections.defaultdict(list)
        host_ops = []         # (start, end, name) of every thread
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, args = e.get("cat"), e["ts"] * 1e-6, e.get("args", {})
            end = ts + e.get("dur", 0) * 1e-6
            if cat in DEVICE_CATS:
                self.device.append((ts, end, e["name"], args.get("correlation"), cat,
                                    args.get("External id")))
            elif cat in LAUNCH_CATS:
                if args.get("correlation") is not None:
                    launches[args["correlation"]] = (e["tid"], ts)
            elif cat == "user_annotation":
                if e["name"].startswith(PREFIX):
                    name, _, kept = e["name"][len(PREFIX):].partition(" ")
                    self.spans[name].append((e["tid"], ts, end, json.loads(kept) if kept else None,
                                             args.get("External id")))
                host_ops.append((ts, end, e["name"].split(" ", 1)[0]))
            elif cat == "cpu_op":
                host_ops.append((ts, end, e["name"]))
        if not self.spans.get("window"):
            raise ValueError("the trace holds no cmhbench.window span")
        _, self.t0, self.t1, _, _ = self.spans["window"][0]
        self.device = [d for d in self.device if d[1] > self.t0 and d[0] < self.t1]
        self._all_ops = sorted(host_ops)
        # each device event by the thread and time of its launch, and by its External id
        self._by_launch = collections.defaultdict(list)
        self._by_ext = collections.defaultdict(list)
        for i, d in enumerate(self.device):
            where = launches.get(d[3])
            if where is not None:
                self._by_launch[where[0]].append((where[1], i))
            if d[5] is not None:
                self._by_ext[d[5]].append(i)
        for v in self._by_launch.values():
            v.sort()
        self._starts = {t: [x[0] for x in v] for t, v in self._by_launch.items()}

    def span_calls(self, name: str) -> List[tuple]:
        """(the shapes kept, device seconds of its events) of each span ``name``."""
        out = []
        for tid, a, b, kept, ext in self.spans.get(name, ()):
            mine = set(self._by_ext.get(ext, ())) if ext is not None else set()
            starts = self._starts.get(tid)
            if starts:
                lo, hi = bisect.bisect_left(starts, a), bisect.bisect_right(starts, b)
                mine.update(i for _, i in self._by_launch[tid][lo:hi])
            out.append((kept, sum(self.device[i][1] - self.device[i][0] for i in mine)))
        return out

    @classmethod
    def from_file(cls, path) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_s(self) -> float:
        """Seconds of the window in which anything ran on the card."""
        merged = _merge([(max(a, self.t0), min(b, self.t1)) for a, b, *_ in self.device])
        return sum(b - a for a, b in merged)

    def kernels(self) -> int:
        """Kernels that ran in the window."""
        return sum(1 for d in self.device if d[4] == "kernel")

    def span_count(self, name: str) -> int:
        return len(self.spans.get(name, ()))

    def span_device_s(self, name: str) -> float:
        """Device seconds of every event launched inside the spans ``name``."""
        return sum(dev for _, dev in self.span_calls(name))

    def device_ops(self, n: int = 10) -> List[list]:
        """The ``n`` device operations that took the most time: [name, s]."""
        by = collections.Counter()
        for a, b, name, *_ in self.device:
            by[name[:160]] += b - a
        return [[k, v] for k, v in by.most_common(n)]

    def _host_at(self, t: float) -> str:
        """The host span or operation, on any thread, that began last
        before t and had not ended."""
        i = bisect.bisect_right(self._all_ops, (t, float("inf"), ""))
        for a, b, name in reversed(self._all_ops[max(0, i - 4000):i]):
            if b >= t and name != PREFIX + "window":
                return name
        return "python outside any operation"

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle seconds of the window by what its host thread was doing
        when the card went idle, the ``n`` largest: [name, s]."""
        merged = _merge([(max(a, self.t0), min(b, self.t1)) for a, b, *_ in self.device])
        edges = [self.t0] + [x for ab in merged for x in ab] + [self.t1]
        by = collections.Counter()
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                by["idle while " + self._host_at((a + b) / 2)[:140]] += b - a
        return [[k, v] for k, v in by.most_common(n)]
