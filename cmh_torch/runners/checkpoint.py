"""Full-state checkpoint files and the run identity that guards resuming
(counterpart of ``cmh_tpu/runners/base.py:461-582`` and ``:1070-1096``).

A checkpoint is one ``torch.save`` file holding ``{"model", "optimizer",
"extra_optimizers", "method_state", "meta"}`` (the optimizers beside
BertAdam, such as the proxies' SGD, by name; the method state, such as
MITH's banks, as a nested dict of tensors; read back with
``torch.load(weights_only=True)``) and a JSON
sidecar ``<file>.meta.json`` with ``{"epoch", "fingerprint"}``, so a
restart can tell which run wrote a file without reading a multi-GB state.
Both are written to a temporary file and moved into place with
``os.replace``: a kill mid-write never leaves a truncated file under a
valid name. cmh_tpu's full-state ``checkpoint-last.msgpack`` and
``emergency.ckpt.msgpack`` (same sidecar) are candidates too; a trainer
reads and writes them through ``runners/jax_checkpoint.py``.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
from typing import List, Optional

import torch

CHECKPOINT_LAST = "checkpoint-last.pt"     # after every ``checkpoint_every`` epochs
EMERGENCY = "emergency.ckpt.pt"            # on SIGTERM or a crash
# cmh_tpu's names for the same two files
JAX_NAMES = ("checkpoint-last.msgpack", "emergency.ckpt.msgpack")
_SIDECAR = ".meta.json"
# a checkpoint without a sidecar is opened for its fingerprint only up to
# this size: larger ones would stall every restart that scans its siblings
_FALLBACK_MAX_BYTES = 512 * 1024 * 1024


def digest(obj) -> str:
    """The first 16 hex digits of the sha256 of ``obj`` as sorted JSON."""
    return hashlib.sha256(
        json.dumps(obj, sort_keys=True, default=str).encode()).hexdigest()[:16]


def fingerprint_diff(mine: dict, theirs: dict) -> List[str]:
    return sorted(k for k in set(mine) | set(theirs) if mine.get(k) != theirs.get(k))


def write(path: str, blob: dict) -> None:
    """``torch.save`` ``blob`` (its ``meta`` holds ``epoch`` and
    ``fingerprint``) to ``path``, then the sidecar, each atomically."""
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    write_sidecar(path, blob["meta"])


def write_sidecar(path: str, meta: dict) -> None:
    """``<path>.meta.json`` with the meta's ``epoch`` and ``fingerprint``."""
    tmp = path + _SIDECAR + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"epoch": meta["epoch"], "fingerprint": meta["fingerprint"]}, f,
                  indent=1)
    os.replace(tmp, path + _SIDECAR)


def read(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def is_jax(path: str) -> bool:
    """Whether ``path`` names a cmh_tpu (flax msgpack) checkpoint."""
    return path.endswith(".msgpack")


def read_fingerprint(path: str) -> Optional[dict]:
    """The fingerprint of the checkpoint at ``path``: from its sidecar, else
    from the file's meta if it is at most 512 MB; None when neither has one."""
    sidecar = path + _SIDECAR
    if os.path.isfile(sidecar):
        try:
            with open(sidecar) as f:
                return json.load(f).get("fingerprint")
        except (OSError, ValueError):
            pass   # unreadable sidecar: fall through to the file's meta
    try:
        if os.path.getsize(path) > _FALLBACK_MAX_BYTES:
            return None
        if is_jax(path):
            from ..utils import flax_msgpack

            blob = flax_msgpack.load(path)
        else:
            blob = read(path)
        if isinstance(blob, dict) and isinstance(blob.get("meta"), dict):
            return blob["meta"].get("fingerprint")
    except Exception:   # truncated or foreign file: no identity
        pass
    return None


def candidates(root: str) -> List[str]:
    """Every run's checkpoint files under ``root``, newest first."""
    def mtime(p):
        # a sibling run may delete its checkpoint between glob and sort
        try:
            return os.path.getmtime(p)
        except OSError:
            return 0.0

    found = [p for name in (CHECKPOINT_LAST, EMERGENCY, *JAX_NAMES)
             for p in glob.glob(os.path.join(root, "*", name))]
    return sorted(found, key=mtime, reverse=True)
