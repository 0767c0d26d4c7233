"""Build and load the port's host C++ libraries (``cmh_torch/native/*.cpp``).

Each source compiles at first use, with one ``g++`` call, into
``build/cmh_torch/`` at the repository root (beside the CUDA libraries of
``ops/_build.py``), keyed by a hash of the source, the flags and the
machine's architecture, so a changed source rebuilds and a directory copied
to another kind of host never loads a foreign binary. The flags name no
``-march=native``: on x86-64 only ``-mpopcnt``, which every x86-64 host
of the last fifteen years has; ``-ffp-contract=off`` keeps a multiply and
an add two roundings on every host (the image resampler's coefficients
must round as PIL's do). After loading, the library must pass its
self-test. There is no fallback: a failed build raises with the compiler's
message, a failed self-test raises too.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict

HERE = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cmh_torch"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", "-ffp-contract=off"] + (
    ["-mpopcnt"] if platform.machine() in ("x86_64", "AMD64") else [])

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def lib_path(name: str) -> Path:
    """Where ``<name>.cpp``'s library lives, keyed by the source, the flags
    and the machine."""
    h = hashlib.sha256((HERE / f"{name}.cpp").read_bytes())
    h.update(" ".join(GXX_FLAGS + [platform.machine(), platform.system()]).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> float:
    """Compile ``<name>.cpp`` if its library is not built yet; returns the
    seconds it took (0 when cached). Raises with g++'s output on failure."""
    out = lib_path(name)
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(HERE / f"{name}.cpp"), "-o", str(tmp)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: {name}.cpp is built from source at first use") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {name}.cpp ({' '.join(cmd)}):\n"
                           f"{(proc.stdout + proc.stderr)[-4000:]}")
    os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
    return time.perf_counter() - t0


def load(name: str, configure: Callable[[ctypes.CDLL], None],
         self_test: Callable[[ctypes.CDLL], bool]) -> ctypes.CDLL:
    """The loaded library of ``<name>.cpp``, built on first use, configured
    (argument types) and self-tested once."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(lib_path(name)))
            configure(lib)
            if not self_test(lib):
                raise RuntimeError(f"{lib_path(name)} failed its self-test")
            _loaded[name] = lib
        return lib
