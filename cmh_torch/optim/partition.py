"""Learning-rate groups by top-level module (counterpart of
``cmh_tpu/optim/partition.py`` and ``runners/base.py:253-289``).

Parameters whose names start with ``backbone.`` form the backbone group
(``clip_lr`` / ``backbone_lr``); every other parameter (the hash heads)
takes the head ``lr``, except those in ``exclude``: a method's extra groups
(``Method.extra_param_groups``, such as DSPH's and DNPH's proxies), which
an optimizer of their own trains.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

from torch import nn


def param_groups(model: nn.Module, lr: float, backbone_lr: float,
                 exclude: Iterable[nn.Parameter] = ()) -> List[Dict]:
    skip = {id(p) for p in exclude}
    backbone, rest = [], []
    for name, p in model.named_parameters():
        if id(p) in skip:
            continue
        (backbone if name.startswith("backbone.") else rest).append(p)
    groups = [{"params": backbone, "lr": backbone_lr, "name": "backbone"},
              {"params": rest, "lr": lr, "name": "default"}]
    return [g for g in groups if g["params"]]
