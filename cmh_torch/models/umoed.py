"""UMoED: a unified (Soft-MoE) decoder hashing with learned code slots
(counterpart of ``cmh_tpu/models/umoed.py``).

- ``setDim`` learned slots attend to a modality's CLIP tokens through a
  post-norm transformer decoder (self-attention, cross-attention to the
  tokens, an FFN whose second half is a Soft-MoE under ``MoE``); a
  classifier maps each slot to ``vocab = 2^(outputDim / setDim)`` logits.
  With ``fusion`` one head serves both modalities.
- Hashes: ``linear_subspace`` (each slot's argmax → its ±1 codeword), or
  the softmax pairs or tanh of the slots' mean or concatenation.
- The loss: a slot-aligned pairwise set distance (or the chamfer family) →
  the DCG-weighted triplet both ways, or the Bayesian likelihood without
  ``triplet``, plus the per-sample batchwise uniformity of each modality.

The decoder runs in fp32: its 3 LayerNorms a layer are kernel K1 in fp32,
and its attention takes the explicit path (cross-attention, dropout on the
probabilities), as in cmh_tpu, where the decoder asks for the weights.
State-dict names are the reference torch ones that cmh_tpu's
``umoed_from_torch_state`` reads: ``hash.hash_module`` (or
``hash.{img,txt}_token_hash``) ``.decoder_learned_parameters``,
``.first_layer``, ``.decoder.layers.{i}.{self_attn,multihead_attn,norm1,2,3}``,
``.linear1``/``.linear2`` (plain) or ``.linear``/``.moe.{phi,experts.weight,
experts.bias}`` (Soft-MoE), ``.classifier``.

As in cmh_tpu, text goes through its own head in non-fusion mode;
``compat_nonfusion_txt_via_img`` routes it through the image head, as the
reference does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.distances import (batchwise_uniformity_loss_per_sample, normalize,
                             setwise_similarity, weighted_triplet_loss)
from ..ops.hashing import linear_subspace_hash, softmax_hash, tanh_hash
from ..ops.metrics import calc_label_sim, euclidean_similarity, full_fp32
from ..parallel import tp
from ..registry import registry
from . import convert, flax_init
from .base import Method, resolve_clip_cfg
from .clip.model import CLIP, CLIPConfig, LayerNormFp32, MultiHeadAttention
from .common import Dropout
from .dimch import config_section


class SoftMoE(nn.Module):
    """Soft mixture of experts over a token sequence: dispatch weights a
    softmax over the tokens, combine weights a softmax over all (expert,
    slot) pairs, the experts one batched product.

    With ``shards`` (``parallel/tp.py``) this rank holds its experts: the
    dispatch softmax is over the tokens, so it stays local; the combine
    softmax over every rank's (expert, slot) pairs takes the group's
    largest logit, and its numerator (the experts' outputs weighted by
    ``exp``) and denominator are each summed over the group."""

    shards = None

    def __init__(self, in_features: int, out_features: int, num_experts: int,
                 slots_per_expert: int):
        super().__init__()
        self.phi = nn.Parameter(torch.empty(in_features, num_experts, slots_per_expert))
        self.experts = nn.Module()
        self.experts.weight = nn.Parameter(torch.empty(num_experts, in_features, out_features))
        self.experts.bias = nn.Parameter(torch.empty(num_experts, out_features))

    def shard_(self, shards) -> None:
        """Run on this rank's experts (``tp.shard_model_`` keeps them)."""
        self.shards = shards

    def forward(self, x: torch.Tensor) -> torch.Tensor:            # (B, M, D_in)
        x, sh = x.float(), self.shards
        with full_fp32():
            if sh is not None:
                x = tp.copy_to_shards(x, sh)
            logits = torch.einsum("bmd,dnp->bmnp", x, self.phi)
            dispatch = torch.softmax(logits, dim=1)
            b, m = logits.shape[:2]
            xs = torch.einsum("bmd,bmnp->bnpd", x, dispatch)
            ys = (torch.einsum("bnpd,nde->bnpe", xs, self.experts.weight)
                  + self.experts.bias[None, :, None, :])
            if sh is None:
                combine = torch.softmax(logits.reshape(b, m, -1), dim=-1).reshape(logits.shape)
                return torch.einsum("bnpe,bmnp->bme", ys, combine)
            top = tp.all_reduce_(logits.detach().reshape(b, m, -1).amax(-1), sh,
                                 op=torch.distributed.ReduceOp.MAX)
            e = torch.exp(logits - top[:, :, None, None])
            num = tp.sum_shards(torch.einsum("bnpe,bmnp->bme", ys, e), sh)
            return num / tp.sum_shards(e.sum(dim=(2, 3)), sh)[..., None]

class SoftMoEEncoderLayer(nn.Module):
    """Post-norm transformer encoder layer with a Soft-MoE FFN (cmh_tpu's
    ``SoftMoEEncoderLayer``; the shipped UMoED head uses the decoder only)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, num_experts: int = 8, slots_per_expert: int = 8):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead, torch.float32, dropout)
        self.norm1, self.norm2 = LayerNormFp32(d_model), LayerNormFp32(d_model)
        self.linear = nn.Linear(d_model, dim_feedforward)
        self.moe = SoftMoE(dim_feedforward, d_model, num_experts, slots_per_expert)
        self.drop1, self.drop_ff, self.drop2 = (Dropout(dropout) for _ in range(3))

    def forward(self, src, key_padding_mask=None):
        sa, _ = self.self_attn(src, key_padding_mask=key_padding_mask)
        x = self.norm1(src + self.drop1(sa))
        h = self.moe(self.drop_ff(torch.relu(self.linear(x))))
        return self.norm2(x + self.drop2(h))

class DecoderLayer(nn.Module):
    """Post-norm transformer decoder layer (torch's
    ``TransformerDecoderLayer``), its FFN's second half a Soft-MoE under
    ``moe``."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, moe: bool = False, num_experts: int = 8,
                 slots_per_expert: int = 8):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead, torch.float32, dropout)
        self.multihead_attn = MultiHeadAttention(d_model, nhead, torch.float32, dropout)
        self.norm1, self.norm2, self.norm3 = (LayerNormFp32(d_model) for _ in range(3))
        if moe:
            self.linear = nn.Linear(d_model, dim_feedforward)
            self.moe = SoftMoE(dim_feedforward, d_model, num_experts, slots_per_expert)
        else:
            self.linear1 = nn.Linear(d_model, dim_feedforward)
            self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.is_moe = moe
        self.drop1, self.drop2, self.drop_ff, self.drop3 = (Dropout(dropout) for _ in range(4))

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        sa, _ = self.self_attn(tgt)
        x = self.norm1(tgt + self.drop1(sa))
        ca, _ = self.multihead_attn(x, kv=memory)
        x = self.norm2(x + self.drop2(ca))
        first = self.linear if self.is_moe else self.linear1
        h = self.drop_ff(torch.relu(first(x)))
        h = self.moe(h) if self.is_moe else self.linear2(h)
        return self.norm3(x + self.drop3(h))

class UMoEDTokenHash(nn.Module):
    """Learned slots → decoder over a modality's tokens → per-slot classifier
    → hash."""

    def __init__(self, embed_dim: int, hidden_dim: int, vocab_size: int, set_dim: int,
                 decoder_heads: int = 8, decoder_layers: int = 6, dropout: float = 0.3,
                 moe: bool = False, num_experts: int = 8, slots_per_expert: int = 8,
                 hash_func: str = "linear_subspace", merge_func: str = "concatenate"):
        super().__init__()
        self.hash_func, self.merge_func = hash_func, merge_func
        if hidden_dim != embed_dim:
            self.first_layer = nn.Linear(embed_dim, hidden_dim)
        self.decoder_learned_parameters = nn.Parameter(torch.empty(set_dim, hidden_dim))
        self.decoder = nn.Module()
        self.decoder.layers = nn.ModuleList(
            DecoderLayer(hidden_dim, decoder_heads, 2048, dropout, moe, num_experts,
                         slots_per_expert) for _ in range(decoder_layers))
        self.classifier = nn.Linear(hidden_dim, vocab_size)

    def forward(self, tokens: torch.Tensor):
        x = tokens.float()
        if hasattr(self, "first_layer"):
            x = torch.relu(self.first_layer(x))
        slots = self.decoder_learned_parameters
        tgt = slots[None].expand(x.shape[0], *slots.shape)
        for layer in self.decoder.layers:
            tgt = layer(tgt, x)
        embeds = self.classifier(tgt)                                    # (B, M, V)
        if self.hash_func == "linear_subspace":
            return embeds, linear_subspace_hash(embeds)
        h = embeds.mean(dim=1) if self.merge_func == "mean" else embeds.reshape(
            embeds.shape[0], -1)
        return embeds, softmax_hash(h) if self.hash_func == "softmax" else tanh_hash(h)

class UMoEDModel(nn.Module):
    def __init__(self, clip_cfg: CLIPConfig, output_dim: int = 64, set_dim: int = 64,
                 dropout: float = 0.3, decoder_heads: int = 8, decoder_layers: int = 6,
                 hidden_dim: int = 512, moe: bool = True, num_experts: int = 8,
                 slots_per_expert: int = 8, fusion: bool = True,
                 hash_func: str = "linear_subspace", merge_func: str = "concatenate",
                 mask_padding: bool = False, compat_nonfusion_txt_via_img: bool = False):
        super().__init__()
        if output_dim % set_dim:
            raise ValueError(f"'outputDim={output_dim}' must be the integer times of "
                             f"'setDim={set_dim}'")
        self.output_dim, self.set_dim = output_dim, set_dim
        self.hash_func, self.merge_func = hash_func, merge_func
        self.fusion, self.mask_padding = fusion, mask_padding
        self.compat_nonfusion_txt_via_img = compat_nonfusion_txt_via_img
        self.vocab = 2 ** (output_dim // set_dim)
        self.backbone = CLIP(clip_cfg)

        def head():
            return UMoEDTokenHash(clip_cfg.embed_dim, hidden_dim, self.vocab, set_dim,
                                  decoder_heads, decoder_layers, dropout, moe, num_experts,
                                  slots_per_expert, hash_func, merge_func)

        names = ("hash_module",) if fusion else ("img_token_hash", "txt_token_hash")
        self.hash = nn.ModuleDict({name: head() for name in names})

    def _img_head(self) -> UMoEDTokenHash:
        return self.hash["hash_module" if self.fusion else "img_token_hash"]

    def _txt_head(self) -> UMoEDTokenHash:
        if self.fusion:
            return self.hash.hash_module
        if self.compat_nonfusion_txt_via_img:
            return self.hash.img_token_hash
        return self.hash.txt_token_hash

    def _image_tokens(self, image):
        cls_token, seq_tokens, _ = self.backbone.encode_image(image)
        return torch.cat([cls_token[:, None, :], seq_tokens], dim=1)

    def _text_tokens(self, text, key_padding_mask):
        kpm = key_padding_mask if self.mask_padding else None
        return self.backbone.encode_text(text, kpm)[1]

    def encode_image(self, image, with_embeds: bool = False):
        embeds, hashed = self._img_head()(self._image_tokens(image))
        return (embeds, hashed) if with_embeds else hashed

    def encode_text(self, text, key_padding_mask=None, with_embeds: bool = False):
        embeds, hashed = self._txt_head()(self._text_tokens(text, key_padding_mask))
        return (embeds, hashed) if with_embeds else hashed

    def encode_fusion(self, image, text, key_padding_mask=None):
        """Both modalities' tokens through the shared head at once."""
        if not self.fusion:
            raise ValueError("fusion encoding needs fusion=True")
        fused = torch.cat([self._image_tokens(image),
                           self._text_tokens(text, key_padding_mask)], dim=1)
        return self.hash.hash_module(fused)

    def forward(self, image, text, key_padding_mask=None):
        img_embeds, img_hash = self.encode_image(image, with_embeds=True)
        txt_embeds, txt_hash = self.encode_text(text, key_padding_mask, with_embeds=True)
        return img_embeds, img_hash, txt_embeds, txt_hash

    def init_weights(self, key, device=None) -> "UMoEDModel":
        """cmh_tpu's init from ``key`` (``models/flax_init.py``)."""
        return flax_init.init_(self, key, "UMoED", device)


def pairwise_set_distance(img, txt, extreme: bool = False, t: float = 0.01,
                          return_sim: bool = False, mode: str = "cosine"):
    """Slot-aligned distance between every pair of sets (B, T, L) × (K, T, L)
    → (B, K): the mean over slots of 1 − max(⟨img_t, txt_t⟩, 0) (``cosine``;
    with ``return_sim`` the mean similarity), else the mean of the slots'
    euclidean distances over T² (the diagonal of each (T, T) block).
    ``extreme`` first sharpens each slot with softmax(x / t)."""
    if extreme:
        img, txt = torch.softmax(img / t, dim=-1), torch.softmax(txt / t, dim=-1)
    if mode == "cosine":
        with full_fp32():
            sim = torch.clamp(torch.einsum("btl,ktl->btk", img.float(), txt.float()), min=0.0)
        return sim.mean(dim=1) if return_sim else (1.0 - sim).mean(dim=1)
    if return_sim:
        raise ValueError("euclidean pairwise distance cannot return similarity")
    b, tkn, l = img.shape
    block = euclidean_similarity(img.reshape(-1, l), txt.reshape(-1, l))
    block = block.reshape(b, tkn, -1, tkn).permute(0, 2, 1, 3)
    diag = torch.eye(tkn, device=block.device)
    return (block * diag).mean(dim=-1).mean(dim=-1)


def umoed_loss_fn(*, set_dim, extreme, extreme_t, triplet, distance_mode, distance_cfg,
                  chamfer_cfg, hash_cfg):
    mode = distance_cfg.get("mode", "chamfer")
    kw = dict(mode=mode, denominator=distance_cfg.get("denominator", 2.0),
              temperature=distance_cfg.get("temperature", 16.0),
              temperature_txt_scale=distance_cfg.get("temperature_txt_scale", 1.0))
    unif_alpha = chamfer_cfg.get("unif_alpha", 0.01)
    token_margin = chamfer_cfg.get("token_triplet_margin", 0.2)
    triplet_alpha = hash_cfg.get("triplet_alpha", 1.0)

    def bayesian(sim, label_sim):
        s = torch.clamp(sim, -64.0, 64.0)
        return -torch.mean(label_sim * s - torch.logaddexp(s, torch.zeros_like(s)))

    def loss(outputs, batch, method_state, step):
        img_embeds, img_hash, txt_embeds, txt_hash = outputs
        labels = batch["label"]
        img_n, txt_n = normalize(img_embeds), normalize(txt_embeds)
        if triplet:
            if mode == "pairwise":
                i2t = pairwise_set_distance(img_n, txt_n, extreme, extreme_t,
                                            mode=distance_mode)
                t2i = pairwise_set_distance(txt_n, img_n, extreme, extreme_t,
                                            mode=distance_mode)
            else:
                i2t = torch.clamp(1.0 - setwise_similarity(img_n, txt_n, **kw), min=0.0)
                t2i = torch.clamp(1.0 - setwise_similarity(txt_n, img_n, **kw), min=0.0)
            tokens_i2t = weighted_triplet_loss(i2t, labels, margin=token_margin)
            tokens_t2i = weighted_triplet_loss(t2i, labels, margin=token_margin)
        else:
            label_sim = calc_label_sim(labels, labels)
            tokens_i2t = bayesian(pairwise_set_distance(
                img_n, txt_n, extreme, extreme_t, return_sim=True, mode=distance_mode),
                label_sim)
            tokens_t2i = bayesian(pairwise_set_distance(
                txt_n, img_n, extreme, extreme_t, return_sim=True, mode=distance_mode),
                label_sim)
        div_i = batchwise_uniformity_loss_per_sample(img_n, set_dim)
        div_t = batchwise_uniformity_loss_per_sample(txt_n, set_dim)
        div = (div_i + div_t + 0.0) / 3.0
        triplet_total = (tokens_i2t + tokens_t2i) / 4.0
        total = triplet_total * triplet_alpha + unif_alpha * div
        loss_dict = {
            "All loss": total,
            "Tokens": {
                "Similarity": {"i2t": tokens_i2t, "t2i": tokens_t2i,
                               "All": triplet_total * triplet_alpha},
                "Diversity": {"i": div_i, "t": div_t, "All": div * unif_alpha},
            },
        }
        return total, loss_dict, method_state

    return loss


@registry.register_model("UMoED")
class UMoEDMethod(Method):
    arch = "UMoED"
    code_mode = "sign"   # linear_subspace codes are already ±1

    def eval_code_dims(self) -> int:
        """``output_dim`` bits for ``linear_subspace``; a vocab of codes
        (``mean``) or set_dim of them (``concatenate``) for tanh and softmax."""
        m = self.model
        if m.hash_func == "linear_subspace":
            return m.output_dim
        return m.vocab if m.merge_func == "mean" else m.set_dim * m.vocab

    def state_from_jax(self, params, model_state):
        return convert.umoed_state_from_jax(params)

    def state_to_jax(self, state_dict):
        return convert.umoed_state_to_jax(state_dict)

    @classmethod
    def from_config(cls, cfg_model, output_dim: int = 16, train_num: int = 10000,
                    clip_cfg: Optional[CLIPConfig] = None) -> "UMoEDMethod":
        m = cfg_model or {}
        clip_cfg = resolve_clip_cfg(m, clip_cfg)
        # cmh_tpu's defaults (the reference signature): softmax, mean, 3 experts
        hash_func = m.get("hash_func", "softmax")
        if "softmax" in hash_func:
            output_dim *= 2
        hidden = m.get("hidden_dim", 512)
        if hidden is None or isinstance(hidden, str):
            hidden = clip_cfg.embed_dim
        set_dim = m.get("setDim", 64)
        model = UMoEDModel(
            clip_cfg, output_dim=output_dim, set_dim=set_dim, dropout=m.get("dropout", 0.3),
            decoder_heads=m.get("decoder_heads", 8), decoder_layers=m.get("decoder_layers", 6),
            hidden_dim=hidden, moe=m.get("MoE", False), num_experts=m.get("num_experts", 3),
            slots_per_expert=m.get("slots_per_expert", 8), fusion=m.get("fusion", True),
            hash_func=hash_func, merge_func=m.get("merge_func", "mean"),
            mask_padding=m.get("mask_padding", False),
            compat_nonfusion_txt_via_img=m.get("compat_nonfusion_txt_via_img", False))
        loss = umoed_loss_fn(
            set_dim=set_dim, extreme=m.get("extreme", True), extreme_t=m.get("extreme_T", 0.01),
            triplet=m.get("triplet", True), distance_mode=m.get("distance_mode", "cosine"),
            distance_cfg=config_section(m, "distance"), chamfer_cfg=config_section(m, "chamfer"),
            hash_cfg=config_section(m, "hash_pars"))
        return cls(model, loss, cfg_model, train_num)
