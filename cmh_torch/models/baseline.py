"""Baseline: two 2-layer MLP tanh heads and the symmetric Bayesian loss
(counterpart of ``cmh_tpu/models/baseline.py``).

Per-modality head = Linear(d → d/2) → relu → dropout → Linear(d/2 → K) →
tanh, kaiming-uniform(fan_out) weights and zero biases, under the reference
names ``hash.{img,txt}_hash.{0,3}``. Loss = the Bayesian likelihood of the
½·codeᵀcode similarities both ways, plus ``quan_alpha`` times the tanh
quantization error. As in cmh_tpu, text goes through its own head (the
reference routes it through the image head).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.metrics import calc_label_sim
from ..registry import registry
from . import convert, flax_init
from .base import Method, resolve_clip_cfg
from .clip.model import CLIP, CLIPConfig
from .common import Dropout
from .losses import bayesian_loss, tanh_hash_loss


def mlp_hash(width: int, output_dim: int, dropout: float) -> nn.Sequential:
    return nn.Sequential(nn.Linear(width, width // 2), nn.ReLU(), Dropout(dropout),
                         nn.Linear(width // 2, output_dim), nn.Tanh())


class BaselineModel(nn.Module):
    def __init__(self, clip_cfg: CLIPConfig, output_dim: int = 16, dropout: float = 0.3):
        super().__init__()
        self.output_dim = output_dim
        self.backbone = CLIP(clip_cfg)
        width = clip_cfg.embed_dim
        self.hash = nn.ModuleDict({"img_hash": mlp_hash(width, output_dim, dropout),
                                   "txt_hash": mlp_hash(width, output_dim, dropout)})

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        cls_token, _, _ = self.backbone.encode_image(image)
        return self.hash.img_hash(cls_token.float())

    def encode_text(self, text: torch.Tensor, key_padding_mask=None) -> torch.Tensor:
        eos_token, _, _, _ = self.backbone.encode_text(text, key_padding_mask)
        return self.hash.txt_hash(eos_token.float())

    def forward(self, image, text, key_padding_mask=None):
        return self.encode_image(image), self.encode_text(text, key_padding_mask)

    def init_weights(self, key, device=None) -> "BaselineModel":
        """cmh_tpu's init from ``key`` (``models/flax_init.py``)."""
        return flax_init.init_(self, key, "Baseline", device)


def baseline_loss_fn(*, quan_alpha: float):
    def loss(outputs, batch, method_state, step):
        img_hash, txt_hash = outputs
        label_sim = calc_label_sim(batch["label"], batch["label"])
        b_ab = bayesian_loss(img_hash, txt_hash, label_sim)
        b_ba = bayesian_loss(txt_hash, img_hash, label_sim)
        quan_i = tanh_hash_loss(img_hash)
        quan_t = tanh_hash_loss(txt_hash)
        total = (b_ab + b_ba) / 2.0 + quan_alpha * (quan_t + quan_i) / 2.0
        loss_dict = {
            "All loss": total,
            "Bayesian": {"i2t": b_ab, "t2i": b_ba},
            "Quan": {"Image": quan_i, "Text": quan_t},
        }
        return total, loss_dict, method_state

    return loss


@registry.register_model("Baseline")
class BaselineMethod(Method):
    arch = "Baseline"
    code_mode = "sign"

    def state_from_jax(self, params, model_state):
        return convert.baseline_state_from_jax(params)

    def state_to_jax(self, state_dict):
        return convert.baseline_state_to_jax(state_dict)

    @classmethod
    def from_config(cls, cfg_model, output_dim: int = 16, train_num: int = 10000,
                    clip_cfg: Optional[CLIPConfig] = None) -> "BaselineMethod":
        m = cfg_model or {}
        model = BaselineModel(resolve_clip_cfg(m, clip_cfg), output_dim=output_dim,
                              dropout=m.get("dropout", 0.3))
        return cls(model, baseline_loss_fn(quan_alpha=m.get("quan_alpha", 0.001)),
                   cfg_model, train_num)
