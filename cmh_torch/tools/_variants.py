"""Build edited copies of a kernel source and time them through its wrapper.

Shared by the ``*_variants`` tools. A variant is the source, with the
``csrc/*.cuh`` headers it includes written in place (``source``), plus a
few string edits, each of which must find its target exactly once. ``build``
writes every variant into ``build/<dir>/`` and compiles them all at once
with the package's nvcc flags; inside ``swapped(so)`` every wrapper that
loads a kernel library through ``_build.load`` gets that one instead.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import re
import subprocess


def source(name: str) -> str:
    """``csrc/<name>.cu`` with each ``#include "<header>.cuh"`` replaced by
    that header's text, so that an edited copy builds anywhere and an edit
    may reach the shared helpers."""
    from cmh_torch.ops import _build

    text = (_build.CSRC / f"{name}.cu").read_text()
    return re.sub(r'^#include "(\w+\.cuh)"$',
                  lambda m: (_build.CSRC / m[1]).read_text().replace("#pragma once\n", ""),
                  text, flags=re.M)


def edited(text: str, edits, what: str) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"{what}: edit target found {text.count(old)} times: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build(text: str, variants: dict, names, dirname: str) -> dict:
    """Compile ``text`` with each named variant's edits; {name: .so path}."""
    from cmh_torch.ops import _build

    out = _build.BUILD_DIR.parent / dirname
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = out / f"{name}.cu"
        cu.write_text(edited(text, variants[name], name))
        so = out / f"{name}.so"
        with open(out / f"{name}.log", "w") as log:
            procs[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                                             str(cu)], stdout=log, stderr=subprocess.STDOUT), so)
    for name, (p, so) in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"nvcc failed for {name}: {(out / f'{name}.log').read_text()[-3000:]}")
    return {name: so for name, (_, so) in procs.items()}


@contextlib.contextmanager
def swapped(so):
    """Make ``_build.load`` return the library at ``so`` until the block ends."""
    from cmh_torch.ops import _build

    lib = ctypes.CDLL(os.path.abspath(so))
    load = _build.load
    _build.load = lambda _name: lib
    try:
        yield lib
    finally:
        _build.load = load


def bf16_off(got, want) -> str:
    """How many bf16 elements differ from the plain version, or that the
    one-step check fails (the ablations compute wrong results on purpose)."""
    import chip_smoke as cs

    try:
        return cs.bf16_steps_checked(got, want, "").split()[0]
    except AssertionError:
        return "fails the check"
