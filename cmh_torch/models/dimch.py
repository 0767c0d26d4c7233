"""DIMCH: dynamic-instance multi-concept hashing over token sets
(counterpart of ``cmh_tpu/models/dimch.py``).

Per modality the CLIP token sequence (the image's cls and patch tokens, all
``txt_token_size`` text tokens) becomes ``setDim`` instances through a
Conv1d that mixes tokens (tokens are its channels, the embedding its
spatial axis, kernel 3, padding 1); each instance goes through an MLP
(``fc1``, ReLU, dropout, ``fc2``) and the item's code is the tanh or
``softmax_hash`` of the instances' mean. State-dict names are the
reference's: ``hash.{img,txt}_token_hash.token_layer`` and
``.hash_layer.{0,3}``.

The loss: the smooth (or plain) chamfer similarity of the L2-normalised
instance sets → a DCG-weighted triplet both ways, MMD (RBF) between the
modalities' instances, the batchwise uniformity of each modality, then a
weighted triplet on the cosine distances of the codes and the quantization
term (``tanh_hash_loss``, or ``soft_argmax_hash_loss`` for softmax codes).
``from_config`` doubles ``output_dim`` for the softmax hash. The text
tower runs without the key-padding mask unless ``model.mask_padding``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.distances import (batchwise_uniformity_loss, cos_distance, mmd_rbf_loss,
                             normalize, setwise_similarity, weighted_triplet_loss)
from ..ops.hashing import softmax_hash
from ..ops.metrics import full_fp32
from ..registry import registry
from . import convert, flax_init
from .base import Method, resolve_clip_cfg
from .clip.model import CLIP, CLIPConfig
from .common import Dropout
from .dcmht import soft_argmax_hash_loss
from .losses import tanh_hash_loss


class TokenHash(nn.Module):
    """Conv1d token → instance mixer and the per-instance hash MLP."""

    def __init__(self, input_tokens: int, output_dim: int, embed_dim: int, set_dim: int,
                 dropout: float = 0.3, hash_func: str = "tanh"):
        super().__init__()
        self.hash_func = hash_func
        self.token_layer = nn.Conv1d(input_tokens, set_dim, 3, padding=1)
        self.hash_layer = nn.Sequential(nn.Linear(embed_dim, embed_dim // 2), nn.ReLU(),
                                        Dropout(dropout), nn.Linear(embed_dim // 2, output_dim))

    def mix(self, tokens: torch.Tensor) -> torch.Tensor:
        """The Conv1d over (B, T, D) as one fp32 product of the kernel with
        the windows (no cuDNN convolution, which would run fp32 in TF32)."""
        x = nn.functional.pad(tokens.float(), (1, 1)).unfold(2, 3, 1)     # (B, T, D, 3)
        with full_fp32():
            y = torch.einsum("btjk,otk->boj", x, self.token_layer.weight)
        return torch.relu(y + self.token_layer.bias[:, None])              # (B, M, D)

    def forward(self, tokens: torch.Tensor):
        embeds = self.hash_layer(self.mix(tokens))                         # (B, M, K)
        merged = embeds.mean(dim=1)
        hashed = softmax_hash(merged) if self.hash_func == "softmax" else torch.tanh(merged)
        return embeds, hashed

class DIMCHModel(nn.Module):
    def __init__(self, clip_cfg: CLIPConfig, output_dim: int = 16, set_dim: int = 8,
                 txt_token_size: int = 32, dropout: float = 0.3, hash_func: str = "tanh",
                 mask_padding: bool = False):
        super().__init__()
        self.output_dim = output_dim
        self.mask_padding = mask_padding
        self.backbone = CLIP(clip_cfg)
        d = clip_cfg.embed_dim
        self.hash = nn.ModuleDict({
            "img_token_hash": TokenHash(clip_cfg.num_patches + 1, output_dim, d, set_dim,
                                        dropout, hash_func),
            "txt_token_hash": TokenHash(txt_token_size, output_dim, d, set_dim, dropout,
                                        hash_func)})

    def encode_image(self, image, with_embeds: bool = False):
        cls_token, seq_tokens, _ = self.backbone.encode_image(image)
        embeds, hashed = self.hash.img_token_hash(
            torch.cat([cls_token[:, None, :], seq_tokens], dim=1))
        return (embeds, hashed) if with_embeds else hashed

    def encode_text(self, text, key_padding_mask=None, with_embeds: bool = False):
        kpm = key_padding_mask if self.mask_padding else None
        _, tokens, _, _ = self.backbone.encode_text(text, kpm)
        embeds, hashed = self.hash.txt_token_hash(tokens)
        return (embeds, hashed) if with_embeds else hashed

    def forward(self, image, text, key_padding_mask=None):
        img_embeds, img_hash = self.encode_image(image, with_embeds=True)
        txt_embeds, txt_hash = self.encode_text(text, key_padding_mask, with_embeds=True)
        return img_embeds, img_hash, txt_embeds, txt_hash

    def init_weights(self, key, device=None) -> "DIMCHModel":
        """cmh_tpu's init from ``key`` (``models/flax_init.py``)."""
        return flax_init.init_(self, key, "DIMCH", device)


def dimch_loss_fn(*, set_dim, hash_func, distance_cfg, chamfer_cfg, hash_cfg):
    mode = distance_cfg.get("mode", "chamfer")
    kw = dict(mode=mode, denominator=distance_cfg.get("denominator", 2.0),
              temperature=distance_cfg.get("temperature", 16.0),
              temperature_txt_scale=distance_cfg.get("temperature_txt_scale", 1.0))
    mmd_alpha = chamfer_cfg.get("mmd_alpha", 0.01)
    unif_alpha = chamfer_cfg.get("unif_alpha", 0.01)
    mmd_gamma = chamfer_cfg.get("mmd_gamma", 0.5)
    token_margin = chamfer_cfg.get("token_triplet_margin", 0.2)
    triplet_alpha = hash_cfg.get("triplet_alpha", 1.0)
    quan_alpha = hash_cfg.get("quan_alpha", 0.001)
    hash_triplet_alpha = hash_cfg.get("hash_triplet_alpha", 0.5)
    triplet_margin = hash_cfg.get("triplet_margin", 0.3)
    quantization = soft_argmax_hash_loss if hash_func == "softmax" else tanh_hash_loss

    def loss(outputs, batch, method_state, step):
        img_embeds, img_hash, txt_embeds, txt_hash = outputs
        labels = batch["label"]
        img_n, txt_n = normalize(img_embeds), normalize(txt_embeds)
        i2t_sim = setwise_similarity(img_n, txt_n, **kw)
        t2i_sim = setwise_similarity(txt_n, img_n, **kw)
        tokens_i2t = weighted_triplet_loss(torch.clamp(1.0 - i2t_sim, min=0.0), labels,
                                           margin=token_margin)
        tokens_t2i = weighted_triplet_loss(torch.clamp(1.0 - t2i_sim, min=0.0), labels,
                                           margin=token_margin)
        mmd = mmd_rbf_loss(img_n.reshape(-1, img_n.shape[-1]),
                           txt_n.reshape(-1, txt_n.shape[-1]), gamma=mmd_gamma)
        div = (batchwise_uniformity_loss(img_n, set_dim)
               + batchwise_uniformity_loss(txt_n, set_dim))
        total = ((tokens_i2t + tokens_t2i) / 2.0 * triplet_alpha
                 + mmd_alpha * mmd + unif_alpha * div)
        hash_i2t = weighted_triplet_loss(cos_distance(img_hash, txt_hash), labels,
                                         margin=triplet_margin)
        hash_t2i = weighted_triplet_loss(cos_distance(txt_hash, img_hash), labels,
                                         margin=triplet_margin)
        quan_i, quan_t = quantization(img_hash), quantization(txt_hash)
        total = (total + (hash_i2t + hash_t2i) / 2.0 * hash_triplet_alpha
                 + (quan_i + quan_t) / 2.0 * quan_alpha)
        loss_dict = {
            "All loss": total,
            "Tokens": {"Similarity": {"i2t": tokens_i2t, "t2i": tokens_t2i},
                       "Maximum Mean Discrepancy": mmd, "Diversity": div},
            "Hash": {"Triplet": {"i2t": hash_i2t, "t2i": hash_t2i},
                     "Quantization": {"image": quan_i, "text": quan_t}},
        }
        return total, loss_dict, method_state

    return loss


def config_section(m, name):
    """A model config's sub-section, or an empty dict when it is absent."""
    sec = m.get(name, None)
    return sec if sec is not None else {}


@registry.register_model("DIMCH")
class DIMCHMethod(Method):
    arch = "DIMCH"
    code_mode = "sign"

    def state_from_jax(self, params, model_state):
        return convert.dimch_state_from_jax(params)

    def state_to_jax(self, state_dict):
        return convert.dimch_state_to_jax(state_dict)

    @classmethod
    def from_config(cls, cfg_model, output_dim: int = 16, train_num: int = 10000,
                    clip_cfg: Optional[CLIPConfig] = None) -> "DIMCHMethod":
        m = cfg_model or {}
        # cmh_tpu's defaults (the reference signature): softmax, setDim 64
        hash_func = m.get("hash_func", "softmax")
        set_dim = m.get("setDim", 64)
        if "softmax" in hash_func:
            output_dim *= 2
        model = DIMCHModel(resolve_clip_cfg(m, clip_cfg), output_dim=output_dim,
                           set_dim=set_dim, txt_token_size=m.get("txt_token_size", 32),
                           dropout=m.get("dropout", 0.3), hash_func=hash_func,
                           mask_padding=m.get("mask_padding", False))
        loss = dimch_loss_fn(set_dim=set_dim, hash_func=hash_func,
                             distance_cfg=config_section(m, "distance"),
                             chamfer_cfg=config_section(m, "chamfer"),
                             hash_cfg=config_section(m, "hash_pars"))
        return cls(model, loss, cfg_model, train_num)
