"""Seeding discipline (counterpart of ``cmh_tpu/utils/seed.py``).

Host randomness (the query/train/retrieval split, the epoch shuffle and the
caption choice) goes through ``random`` and numpy's global generator, seeded
exactly as cmh_tpu seeds them, so the split and the batch order are the
same as cmh_tpu's under one seed. Everything else draws from the returned
root key, ``PRNGKey(seed)`` (``utils/prng.py``), as cmh_tpu does.
"""

from __future__ import annotations

import random

import numpy as np

from .prng import PRNGKey, Key

DEFAULT_SEED = 1814


def set_seed(seed: int = DEFAULT_SEED) -> Key:
    """Seed ``random`` and ``np.random``; return the root key ``PRNGKey(seed)``."""
    random.seed(seed)
    np.random.seed(seed)
    return PRNGKey(seed)
