"""DCMHT trainer (counterpart of ``cmh_tpu/runners/dcmht.py``): the generic
loop with the method contract pinned — softmax hash required, pair-argmax
binarization."""

from __future__ import annotations

from ..registry import registry
from .base import BaseTrainer


@registry.register_runner("DCMHTTrainer")
class DCMHTTrainer(BaseTrainer):
    def __init__(self, cfg, **kwargs):
        self.hash_func = cfg.model.get("hash_func", "softmax")
        assert self.hash_func == "softmax", (
            "DCMHT must adopt the 'softmax' hash technique.")
        self.hash_scale = 2
        super().__init__(cfg, **kwargs)
