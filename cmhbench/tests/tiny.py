"""A configuration, traffic and context small enough for the CPU: the
port's tiny CLIP geometry (``CLIPConfig.tiny()``) in float32."""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path

import torch

from cmhbench import spec
from cmhbench.common import Context

CLIP = {"embed_dim": 32, "image_resolution": 32, "vision_layers": 2, "vision_width": 64,
        "vision_patch_size": 8, "context_length": 16, "vocab_size": 49408,
        "transformer_width": 64, "transformer_heads": 1, "transformer_layers": 2}


def config() -> dict:
    with open(spec.PKG / "configs" / "dcmht-vitb32-64bit.json") as f:
        cfg = json.load(f)
    cfg.update(clip=dict(CLIP), dtype="float32", output_dim=8, max_word=12)
    cfg["run"] = {"train_num": 64, "epochs": 2}
    return cfg


def traffic(name: str, **changes) -> dict:
    t = copy.deepcopy(spec.traffic(name))
    t.update(changes)
    return t


def context(cfg, traffic, tmp: Path, limits, seed: int = 7, seconds: float = 0.3) -> Context:
    return Context(cfg=cfg, traffic=traffic, limits=limits, seed=seed, seconds=seconds,
                   trace=False, device=torch.device("cpu"), started=time.time(),
                   tmp=Path(tmp))
