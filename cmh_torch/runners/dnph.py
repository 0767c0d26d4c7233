"""DNPH trainer (counterpart of ``cmh_tpu/runners/dnph.py``): tanh hash
required. The proxies leave BertAdam for plain SGD at ``optimizer.loss.lr``
(``DNPHMethod.extra_param_groups``); eval codes come from the hash heads
alone, the class predictions are dropped."""

from __future__ import annotations

from ..registry import registry
from .base import BaseTrainer


@registry.register_runner("DNPHTrainer")
class DNPHTrainer(BaseTrainer):
    def __init__(self, cfg, **kwargs):
        self.hash_func = cfg.model.get("hash_func", "tanh")
        assert self.hash_func == "tanh", "DNPH must adopt the 'tanh' hash technique."
        self.hash_scale = 1
        super().__init__(cfg, **kwargs)
