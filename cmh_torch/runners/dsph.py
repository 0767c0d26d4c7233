"""DSPH trainer (counterpart of ``cmh_tpu/runners/dsph.py``): tanh hash
required. The class proxies leave BertAdam for SGD with momentum and
coupled weight decay from ``optimizer.hyp`` (``DSPHMethod.
extra_param_groups``); the base trainer steps both optimizers and keeps
both states in its checkpoints."""

from __future__ import annotations

from ..registry import registry
from .base import BaseTrainer


@registry.register_runner("DSPHTrainer")
class DSPHTrainer(BaseTrainer):
    def __init__(self, cfg, **kwargs):
        self.hash_func = cfg.model.get("hash_func", "tanh")
        assert self.hash_func == "tanh", "DSPH must adopt the 'tanh' hash technique."
        self.hash_scale = 1
        super().__init__(cfg, **kwargs)
