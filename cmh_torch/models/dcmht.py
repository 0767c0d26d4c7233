"""DCMHT model, loss and method (counterpart of ``cmh_tpu/models/dcmht.py``).

Per-modality head = single-token attention → norm (BatchNorm for images,
LayerNorm for text) → Linear(embed → 2K) → relu → pairwise softmax (or
tanh). ``module.train()`` makes the image BatchNorm use and update batch
statistics; ``module.eval()`` uses the running ones. The loss is the
clipped euclidean (or cosine-BCE) similarity over intra (i↔t) and inter
(i↔i, t↔t) pairs plus the soft-argmax quantization ``1 − mean((2c−1)²)``;
it takes every row of the batch, padded rows included, as cmh_tpu's does.
The eval code is pair-argmax → ±1.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.hashing import pair_argmax_code, sign_code, softmax_hash, tanh_hash
from ..ops.metrics import calc_label_sim, cosine_similarity, euclidean_similarity
from ..registry import registry
from . import convert, flax_init
from .base import Method, resolve_clip_cfg
from .clip.model import CLIP, CLIPConfig
from .common import BatchNorm1d, FlaxLayerNorm, SingleTokenAttention


class ModalityHash(nn.Module):
    """One modality's projection head (reference hash/hash.py:15-55)."""

    def __init__(self, input_dim: int, output_dim: int, layernorm: bool,
                 hash_func: str = "softmax"):
        super().__init__()
        self.hash_func = hash_func
        self.atten = SingleTokenAttention(input_dim)
        self.norm = FlaxLayerNorm(input_dim) if layernorm else BatchNorm1d(input_dim)
        self.fc2 = nn.Linear(input_dim, output_dim * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm(self.atten(x))
        x = torch.relu(torch.matmul(x, self.fc2.weight.t()) + self.fc2.bias)
        return softmax_hash(x) if self.hash_func == "softmax" else tanh_hash(x)

class Hash(nn.Module):
    def __init__(self, embed: int, output_dim: int, hash_func: str):
        super().__init__()
        self.img_hash = ModalityHash(embed, output_dim, False, hash_func)
        self.txt_hash = ModalityHash(embed, output_dim, True, hash_func)


class DCMHTModel(nn.Module):
    """CLIP backbone + DCMHT hash heads. State-dict keys follow the
    reference torch model (``backbone.*``, ``hash.img_hash.*``,
    ``hash.txt_hash.*``)."""

    def __init__(self, clip_cfg: CLIPConfig, output_dim: int = 16,
                 hash_func: str = "softmax"):
        super().__init__()
        self.clip_cfg = clip_cfg
        self.output_dim = output_dim
        self.hash_func = hash_func
        self.backbone = CLIP(clip_cfg)
        self.hash = Hash(clip_cfg.embed_dim, output_dim, hash_func)

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        cls_token, _, _ = self.backbone.encode_image(image)
        return self.hash.img_hash(cls_token.float())

    def encode_text(self, text: torch.Tensor, key_padding_mask=None) -> torch.Tensor:
        eos_token, _, _, _ = self.backbone.encode_text(text, key_padding_mask)
        return self.hash.txt_hash(eos_token.float())

    def forward(self, image: torch.Tensor, text: torch.Tensor,
                key_padding_mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(image codes, text codes), the continuous relaxations."""
        return self.encode_image(image), self.encode_text(text, key_padding_mask)

    def make_hash_code(self, code: torch.Tensor) -> torch.Tensor:
        if self.hash_func == "softmax":
            return pair_argmax_code(code)
        return sign_code(code)

    def init_weights(self, key, device=None) -> "DCMHTModel":
        """cmh_tpu's init from ``key`` (``models/flax_init.py``)."""
        return flax_init.init_(self, key, "DCMHT", device)

    @classmethod
    def from_config(cls, cfg) -> "DCMHTModel":
        """Build from a config tree (``configs/DCMHT/*.yaml``): the CLIP
        geometry by ``models.base.resolve_clip_cfg`` (``model.clip_variant:
        tiny``, then the checkpoint at ``model.clip_path``, then ViT-B/32),
        ``model.hash_func`` and ``run.output_dim`` the head. Weights come
        from ``init_weights``, a state dict or
        ``DCMHTMethod.load_pretrained_backbone``."""
        m = cfg.get("model") or {}
        run = cfg.get("run") or {}
        return cls(resolve_clip_cfg(m), output_dim=int(run.get("output_dim", 16)),
                   hash_func=m.get("hash_func", "softmax"))


def _similarity_loss(a, b, label_sim, *, output_dim, vartheta, threshold,
                     similarity_function):
    """(positive, negative) similarity terms (cmh_tpu ``_similarity_loss``)."""
    if similarity_function == "cosine":
        sim = torch.clamp(cosine_similarity(a, b), threshold, 1.0 - threshold)
        m = torch.mean(-label_sim * torch.log(sim)
                       - (1.0 - label_sim) * torch.log(1.0 - sim))
        return m, m
    sim = euclidean_similarity(a, b)
    positive = sim * label_sim
    max_value = float(output_dim * 2 * vartheta) ** 0.5
    negative = torch.clamp(sim * (1.0 - label_sim), max=max_value)
    negative = max_value * (1.0 - label_sim) - negative
    return torch.mean(positive**2), torch.mean(negative**2)


def soft_argmax_hash_loss(code: torch.Tensor) -> torch.Tensor:
    """Quantization: 1 − mean((2c−1)²) over pair probabilities."""
    return 1.0 - torch.mean((2.0 * code - 1.0) ** 2)


def dcmht_loss_fn(*, output_dim, vartheta=0.75, threshold=0.1,
                  quan_alpha=0.001, similarity_function="euclidean"):
    """The DCMHT loss, ``loss(outputs, batch, method_state, step) -> (total,
    loss_dict, method_state)`` with cmh_tpu's loss-dict layout."""

    def loss(outputs, batch, method_state, step) -> Tuple[torch.Tensor, Dict, Dict]:
        img_hash, txt_hash = outputs
        labels = batch["label"]
        label_sim = calc_label_sim(labels, labels)
        kw = dict(output_dim=output_dim, vartheta=vartheta, threshold=threshold,
                  similarity_function=similarity_function)
        intra_p, intra_n = _similarity_loss(img_hash, txt_hash, label_sim, **kw)
        inter_pi, inter_ni = _similarity_loss(img_hash, img_hash, label_sim, **kw)
        inter_pt, inter_nt = _similarity_loss(txt_hash, txt_hash, label_sim, **kw)
        quan_img = soft_argmax_hash_loss(img_hash)
        quan_txt = soft_argmax_hash_loss(txt_hash)
        similarity_loss = (intra_p + intra_n) + (inter_pt + inter_pi + inter_ni + inter_nt)
        total = similarity_loss + quan_alpha * ((quan_img + quan_txt) / 2.0)
        loss_dict = {
            "All loss": total,
            "Intra": {"Positive": intra_p, "Negative": intra_n},
            "Inter": {
                "Positive": {"i2t": inter_pi, "t2i": inter_pt},
                "Negative": {"i2t": inter_ni, "t2i": inter_nt},
            },
            "Quan": {"Image": quan_img, "Text": quan_txt},
        }
        return total, loss_dict, method_state

    return loss


@registry.register_model("DCMHT")
class DCMHTMethod(Method):
    """DCMHT on the method contract: pair-argmax codes, no extra optimizer."""

    arch = "DCMHT"

    def __init__(self, model: DCMHTModel, loss, cfg_model=None, train_num: int = 10000):
        super().__init__(model, loss, cfg_model, train_num)
        self.code_mode = "pair_argmax" if model.hash_func == "softmax" else "sign"

    def state_from_jax(self, params, model_state):
        return convert.dcmht_state_from_jax(params, model_state["batch_stats"])

    def state_to_jax(self, state_dict):
        return convert.dcmht_state_to_jax(state_dict)

    @classmethod
    def from_config(cls, cfg_model, output_dim: int = 16, train_num: int = 10000,
                    clip_cfg: Optional[CLIPConfig] = None) -> "DCMHTMethod":
        m = cfg_model or {}
        model = DCMHTModel(resolve_clip_cfg(m, clip_cfg), output_dim=output_dim,
                           hash_func=m.get("hash_func", "softmax"))
        loss = dcmht_loss_fn(
            output_dim=output_dim, vartheta=m.get("vartheta", 0.75),
            threshold=m.get("threshold", 0.1),
            quan_alpha=m.get("quan_alpha", 0.001),
            similarity_function=m.get("similarity_function", "euclidean"))
        return cls(model, loss, cfg_model, train_num)
