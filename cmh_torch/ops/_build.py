"""Build and load the hand-written CUDA kernels in ``cmh_torch/csrc``.

Each ``csrc/<name>.cu`` exports plain C functions and compiles, at first
use, into its own shared library with one ``nvcc`` call:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o build/cmh_torch/<name>-<hash>.so <name>.cu

The libraries are loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds). Outputs live in ``build/cmh_torch/`` at the repository
root, keyed by a hash of the source, the ``csrc/*.cuh`` headers and the
flags, so a changed source or header rebuilds and an unchanged one is reused. ``build_all`` starts every
missing build at once and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cmh_torch"
KERNELS = ("layernorm", "attention", "attention_tiled", "hamming", "map", "threefry")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); "
            "the CUDA kernels are built from source at first use")
    return path


def lib_path(name: str) -> Path:
    """Where ``<name>.cu``'s library lives, keyed by the source, every
    ``csrc/*.cuh`` header (any of which it may include) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    key = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build_all(names: Optional[List[str]] = None) -> Dict[str, float]:
    """Compile every named kernel library that is not built yet, all
    ``nvcc`` processes at once. Returns seconds per library built (empty
    when everything was cached). Raises with the compiler output on
    failure."""
    names = list(names or KERNELS)
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{n}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                    tmp, out, log)
    took, failed = {}, []
    for n, (p, tmp, out, log) in procs.items():
        rc = p.wait()
        log.close()
        took[n] = time.perf_counter() - t0
        if rc == 0:
            os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
        else:
            failed.append(n)
    if failed:
        msgs = "\n".join(
            f"--- {n}.cu ---\n" + (BUILD_DIR / f"{n}.log").read_text()[-4000:]
            for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{msgs}")
    return took


def build_log(name: str) -> str:
    """The compiler's output for the last build of ``name`` (ptxas reports
    registers, shared memory and spills per kernel)."""
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            _loaded[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a kernel's C entry."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
