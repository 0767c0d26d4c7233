"""MITH trainer (counterpart of ``cmh_tpu/runners/mith.py``): the tanh hash
required. The memory banks live in the method state, which the base
trainer threads through the loss and keeps in its checkpoints."""

from __future__ import annotations

from ..registry import registry
from .base import BaseTrainer


@registry.register_runner("MITHTrainer")
class MITHTrainer(BaseTrainer):
    def __init__(self, cfg, **kwargs):
        self.hash_func = cfg.model.get("hash_func", "tanh")
        assert self.hash_func == "tanh", "MITH must adopt the 'tanh' hash technique."
        self.hash_scale = 1
        super().__init__(cfg, **kwargs)
