"""DIMCH trainer (counterpart of ``cmh_tpu/runners/dimch.py``): the text
token set is ``dataset.max_word`` tokens long, which the trainer hands the
model as ``model.txt_token_size``; sign binarization of the instances'
merged hash."""

from __future__ import annotations

from ..registry import registry
from .base import BaseTrainer


@registry.register_runner("DIMCHTrainer")
class DIMCHTrainer(BaseTrainer):
    def __init__(self, cfg, **kwargs):
        self.hash_func = cfg.model.get("hash_func", "tanh")
        self.hash_scale = 2 if self.hash_func == "softmax" else 1
        cfg.model.update({"txt_token_size": cfg.dataset.get("max_word", 32)})
        super().__init__(cfg, **kwargs)
