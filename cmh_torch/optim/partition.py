"""Learning-rate groups by top-level module (counterpart of
``cmh_tpu/optim/partition.py`` and ``runners/base.py:253-289``).

Parameters whose names start with ``backbone.`` form the backbone group
(``clip_lr`` / ``backbone_lr``); every other parameter (the hash heads)
takes the head ``lr``.
"""

from __future__ import annotations

from typing import Dict, List

from torch import nn


def param_groups(model: nn.Module, lr: float, backbone_lr: float) -> List[Dict]:
    backbone, rest = [], []
    for name, p in model.named_parameters():
        (backbone if name.startswith("backbone.") else rest).append(p)
    groups = [{"params": backbone, "lr": backbone_lr, "name": "backbone"},
              {"params": rest, "lr": lr, "name": "default"}]
    return [g for g in groups if g["params"]]
