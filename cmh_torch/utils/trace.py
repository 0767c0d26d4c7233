"""The program's spans, on the profiler's clock.

``span(name, shapes=None)`` marks a block as ``cmh.<name>`` in a
``torch.profiler`` trace (through ``record_function``), so that the
trace's host operations and device kernels fall inside named phases of the
program. ``shapes``, if given, is a sequence of numbers and booleans that
the name carries as JSON after a space (``cmh.k1_fwd [12800, 768, 2]``):
never strings, since the profiler writes names unescaped into its Chrome
trace and a quote there leaves the file unreadable as JSON.

``wait(site)`` is the span ``cmh.wait.<site>`` around a place where the
host blocks on the card (a read to the host, a boolean index, a
synchronize); the count of ``cmh.wait.*`` spans is the program's count of
host syncs.

Spans are on exactly while a profiler session records: an operator's
``run.profile_dir`` window, ``tools/profile_train.py``, a benchmark's traced
window. Otherwise a span costs one read of the profiler's flag: no
``record_function``, no JSON, no clock. The trace is the only store.
"""

from __future__ import annotations

import contextlib
import json
from typing import Optional, Sequence

from torch.autograd import profiler
from torch.autograd.profiler import record_function

PREFIX = "cmh."
WAIT = PREFIX + "wait."
_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether a profiler session is recording (the flag every span reads)."""
    return profiler._is_profiler_enabled


def span(name: str, shapes: Optional[Sequence] = None):
    """A context manager: the span ``cmh.<name>`` while a profiler records,
    else nothing."""
    if not profiler._is_profiler_enabled:
        return _OFF
    if shapes is None:
        return record_function(PREFIX + name)
    return record_function(f"{PREFIX}{name} {json.dumps(list(shapes))}")


def wait(site: str):
    """The span ``cmh.wait.<site>`` around a host wait on the card."""
    if not profiler._is_profiler_enabled:
        return _OFF
    return record_function(WAIT + site)
