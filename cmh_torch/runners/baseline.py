"""Baseline trainer (counterpart of ``cmh_tpu/runners/baseline.py``): the
generic loop, sign binarization."""

from __future__ import annotations

from ..registry import registry
from .base import BaseTrainer


@registry.register_runner("BaselineTrainer")
class BaselineTrainer(BaseTrainer):
    def __init__(self, cfg, **kwargs):
        self.hash_func = cfg.model.get("hash_func", "tanh")
        self.hash_scale = 1
        super().__init__(cfg, **kwargs)
