"""Standalone CLIP loader and tokenizer API.

Counterpart of ``cmh_tpu/models/clip/api.py`` (the reference's stand-alone
``clip.py``): ``available_models()``, ``load()`` and ``tokenize()``. Nothing
downloads: ``load`` reads a local TorchScript archive or state-dict file
(shape-inferred geometry) and otherwise builds the named configuration
from a seeded random init. ViT-B/16 (S = 197 vision tokens) and ViT-L/14
(S = 257) run their vision attention on the row-tiled K2 kernels.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import List, Optional, Tuple, Union

import torch

from ... import resolve_device
from ...utils import prng
from .loader import NON_PARAMETER_KEYS, infer_config, read_torch_state_dict
from .model import CLIP, CLIPConfig
from .tokenizer import EOT_ID, SOT_ID, SimpleTokenizer

_MODEL_CONFIGS = {
    "ViT-B/32": CLIPConfig(),
    "ViT-B/16": CLIPConfig(vision_patch_size=16),
    "ViT-L/14": CLIPConfig(
        embed_dim=768, vision_layers=24, vision_width=1024,
        vision_patch_size=14, transformer_width=768, transformer_heads=12,
        transformer_layers=12,
    ),
}


def available_models() -> List[str]:
    return list(_MODEL_CONFIGS)


def load(name: str = "ViT-B/32", checkpoint_path: str = "", dtype=torch.bfloat16,
         device=None, key: Optional[prng.Key] = None) -> Tuple[CLIP, CLIPConfig]:
    """(module in eval mode, config). ``checkpoint_path`` naming a local
    TorchScript archive or state-dict file loads its weights with the
    geometry inferred from their shapes; otherwise ``name``'s configuration
    gets cmh_tpu's random init from ``key`` (default ``PRNGKey(0)``, as
    cmh_tpu's ``clip/loader.py:187``), drawn on the module's device. The module
    lies on the card unless ``device="cpu"`` is asked for; without a card
    that raises ``no CUDA device``."""
    dev = resolve_device("cuda" if device is None else device)
    if checkpoint_path and os.path.exists(checkpoint_path):
        sd = read_torch_state_dict(checkpoint_path)
        cfg = infer_config(sd, dtype=dtype)
        model = CLIP(cfg)
        model.load_state_dict({k: v for k, v in sd.items() if k not in NON_PARAMETER_KEYS},
                              strict=True)
    else:
        if name not in _MODEL_CONFIGS:
            raise ValueError(f"unknown model '{name}'; available: {available_models()}")
        cfg = dataclasses.replace(_MODEL_CONFIGS[name], dtype=dtype)
        model = CLIP(cfg)
        model.init_weights(prng.PRNGKey(0) if key is None else key, dev)
    return model.to(dev).eval(), cfg


@functools.lru_cache(maxsize=1)
def _tokenizer() -> SimpleTokenizer:
    return SimpleTokenizer()


def tokenize(texts: Union[str, List[str]], context_length: int = 77,
             truncate: bool = False) -> torch.Tensor:
    """[SOT] + BPE + [EOT], zero-padded to ``context_length``, as a CPU
    int32 tensor (reference ``tokenize``, cmh_tpu's ids); an overlong input
    raises ``RuntimeError`` unless ``truncate``, which keeps the first
    ``context_length`` ids with [EOT] last."""
    if isinstance(texts, str):
        texts = [texts]
    result = torch.zeros((len(texts), context_length), dtype=torch.int32)
    for i, text in enumerate(texts):
        tokens = [SOT_ID] + _tokenizer().encode(text) + [EOT_ID]
        if len(tokens) > context_length:
            if not truncate:
                raise RuntimeError(f"Input {text} is too long for context length "
                                   f"{context_length}")
            tokens = tokens[:context_length]
            tokens[-1] = EOT_ID
        result[i, :len(tokens)] = torch.tensor(tokens, dtype=torch.int32)
    return result
