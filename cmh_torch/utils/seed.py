"""Seeding discipline (counterpart of ``cmh_tpu/utils/seed.py``).

Host randomness (the query/train/retrieval split, the epoch shuffle and the
caption choice) goes through ``random`` and numpy's global generator, seeded
exactly as cmh_tpu seeds them, so the split and the batch order are the
same as cmh_tpu's under one seed. Weight init draws from the returned
``torch.Generator`` instead of a JAX PRNG key.
"""

from __future__ import annotations

import hashlib
import random

import numpy as np
import torch

DEFAULT_SEED = 1814


def set_seed(seed: int = DEFAULT_SEED) -> torch.Generator:
    """Seed ``random`` and ``np.random``; return a CPU generator for init."""
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)


def derived_seed(*parts: int) -> int:
    """A 63-bit seed that is a pure function of the integers ``parts``: the
    first 8 bytes of their sha256. Per-step randomness (dropout masks, DNPH's
    noise) draws from generators seeded by (run seed, step, …), the role of
    cmh_tpu's ``jax.random.fold_in``, so a resumed or recomputed step draws
    what the uninterrupted one drew."""
    digest = hashlib.sha256(",".join(str(int(p)) for p in parts).encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)
