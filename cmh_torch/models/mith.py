"""MITH: multi-granularity interactive transformer hashing (counterpart of
``cmh_tpu/models/mith.py``).

- Global concept learning (``hash.gcl_i``, the same module also under
  ``hash.gcl_t``, as in the reference): pre-LN residual MLPs (flax's
  LayerNorm, tanh-approximate GELU) and a bias-free concept projection with
  tanh, shared by both modalities and by the cls and the tokens.
- Localized token aggregation: per token, the top ``top_k_label`` of the
  detached concept scores, −inf for pads and non-positive scores, a softmax
  over tokens per concept (all −inf columns give 0), tokens pooled into K
  concept tokens.
- Local concept transforming (``hash.lct_i``, ``hash.lct_t``): aggregation,
  the sin-cos positional table, a 2-layer CLIP ``Transformer`` of width
  ``embed_dim`` built in **fp32** (block 0 through kernels K1 and K2 in
  fp32 on the card, block 1 on the explicit path) and K per-bit linear
  heads with tanh (``hashing.fc_list.{k}``, the reference's layout).
- Loss: memory-bank Bayesian likelihoods against four train-set-sized banks
  in ``method_state``, the joint sign target, quantization, cls InfoNCE and
  per-sample token InfoNCE, and the two-way cls↔token distillation.

The banks are written before they are read: each is a new tensor with the
batch's detached codes at the batch's indices. A ragged last batch is
padded with wrapped samples, so an index can occur twice in a batch; then
the **last** row of the batch with that index is written (every duplicate
row writes the value of the last one, so the result does not depend on the
order of the scatter). The initial banks are cmh_tpu's standard normals from
``jax.random.PRNGKey(20)`` (``utils/prng.py``). The eval code
is ``sign(cls_hash + tokens_hash)``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.metrics import calc_label_sim, matmul_fp32
from ..registry import registry
from ..utils import prng
from . import convert, flax_init
from .base import Method, resolve_clip_cfg
from .clip.model import CLIP, CLIPConfig, Transformer
from .common import Dropout, FlaxLayerNorm
from .losses import bayesian_loss, l2_normalize


class ResidualMLPs(nn.Module):
    """Pre-LN residual MLP blocks: x + fc2(drop(act(fc1(ln(x)))))."""

    def __init__(self, org_dim: int, num_layers: int = 2, dropout: float = 0.0,
                 activation: str = "gelu"):
        super().__init__()

        def act():   # jax.nn.gelu's default is the tanh form
            return nn.GELU(approximate="tanh") if activation == "gelu" else nn.ReLU()

        self.mlps = nn.ModuleList(
            nn.Sequential(nn.Linear(org_dim, 4 * org_dim), act(), Dropout(dropout),
                          nn.Linear(4 * org_dim, org_dim)) for _ in range(num_layers))
        self.lns = nn.ModuleList(FlaxLayerNorm(org_dim) for _ in range(num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for ln, mlp in zip(self.lns, self.mlps):
            x = x + mlp(ln(x))
        return x

def sincos_positional_encoding(max_len: int, d_model: int) -> np.ndarray:
    """The fixed sin-cos table scaled by d^-½, (max_len, d_model) float32."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                 * (-math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe / (d_model**0.5)


class BitwiseHashing(nn.Module):
    """K per-bit linear heads → tanh. Trained as one (K, d) weight and one
    (K,) bias, as cmh_tpu trains them (BertAdam clips each tensor by its own
    norm, so K tensors would take other steps); state dicts keep the
    reference's K ``Linear(d, 1)`` modules, ``fc_list.{k}.weight`` (1, d)
    and ``fc_list.{k}.bias`` (1,)."""

    def __init__(self, org_dim: int, k_bits: int):
        super().__init__()
        self.k_bits = k_bits
        self.weight = nn.Parameter(torch.empty(k_bits, org_dim))
        self.bias = nn.Parameter(torch.empty(k_bits))

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # (N, K, D) → (N, K)
        return torch.tanh((x.float() * self.weight).sum(-1) + self.bias)

    def _keys(self, prefix: str):
        return [(f"{prefix}fc_list.{k}.weight", f"{prefix}fc_list.{k}.bias")
                for k in range(self.k_bits)]

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        for k, (wk, bk) in enumerate(self._keys(prefix)):
            w, b = self.weight[k:k + 1], self.bias[k:k + 1]
            destination[wk] = w if keep_vars else w.detach()
            destination[bk] = b if keep_vars else b.detach()

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict,
                              missing_keys, unexpected_keys, error_msgs):
        keys = self._keys(prefix)
        missing = [k for pair in keys for k in pair if k not in state_dict]
        if missing:
            missing_keys.extend(missing)
            return
        known = {k for pair in keys for k in pair}
        unexpected_keys.extend(k for k in state_dict if k.startswith(prefix) and k not in known)
        w = torch.cat([state_dict[wk].reshape(1, -1) for wk, _ in keys])
        b = torch.cat([state_dict[bk].reshape(1) for _, bk in keys])
        if w.shape != self.weight.shape:
            error_msgs.append(f"{prefix}fc_list: weights of {tuple(w.shape)}, the model has "
                              f"{tuple(self.weight.shape)}")
            return
        with torch.no_grad():
            self.weight.copy_(w)
            self.bias.copy_(b)

class GlobalConceptLearning(nn.Module):
    """(Residual MLPs →) bias-free concept projection with tanh; returns
    (the MLPs' output, the concept scores)."""

    def __init__(self, k_concept: int, org_dim: int, dropout: float = 0.0,
                 activation: str = "gelu", res_mlp_layers: int = 2):
        super().__init__()
        self.mlp = (ResidualMLPs(org_dim, res_mlp_layers, dropout, activation)
                    if res_mlp_layers else None)
        self.common_concept_embedding = nn.Linear(org_dim, k_concept, bias=False)

    def forward(self, x: torch.Tensor):
        if self.mlp is not None:
            x = self.mlp(x)
        return x, torch.tanh(self.common_concept_embedding(x))

def localized_token_aggregation(x: torch.Tensor, concept_embed: torch.Tensor, top_k: int,
                                key_padding_mask: Optional[torch.Tensor] = None):
    """Top-k concept pooling of tokens. ``x`` (N, L, D) tokens,
    ``concept_embed`` (N, L, K) concept scores (detached here) → (merged (N,
    K, D) fp32, pseudo labels (N, L, K) 0/1 fp32)."""
    k = concept_embed.shape[-1]
    if not 0 < top_k <= k:
        raise ValueError(f"top_k_label={top_k} must be in [1, {k}] (the code length)")
    sim = concept_embed.detach().float()
    neg_inf = torch.full((), float("-inf"), device=sim.device)
    if key_padding_mask is not None:
        sim = torch.where(key_padding_mask[:, :, None], neg_inf, sim)
    sim = torch.where(sim > 0, sim, neg_inf)
    # keep each token's top_k concepts (ties do not matter: a threshold)
    val_min = torch.topk(sim, top_k, dim=-1).values[..., -1:]
    sim = torch.where(sim >= val_min, sim, neg_inf)
    pseudo_label = (sim > 0).float()
    # softmax over tokens per concept; all −inf columns → 0
    m = sim.max(dim=1, keepdim=True).values
    m = torch.where(torch.isfinite(m), m, torch.zeros((), device=m.device))
    e = torch.where(torch.isfinite(sim), torch.exp(sim - m), torch.zeros((), device=sim.device))
    denom = e.sum(dim=1, keepdim=True)
    weights = torch.where(denom > 0, e / torch.clamp(denom, min=1e-30),
                          torch.zeros((), device=e.device))
    merged = torch.einsum("nlk,nld->nkd", weights, x.float())
    return merged, pseudo_label


class LocalConceptTransforming(nn.Module):
    """Aggregation → positional table → fp32 Transformer → per-bit heads;
    returns (codes (N, K), pseudo labels, transformed concept tokens)."""

    def __init__(self, clip_embed_dim: int, k_bits: int, transformer_layers: int = 2,
                 dropout: float = 0.0, top_k: int = 8):
        super().__init__()
        self.top_k = top_k
        self.width = clip_embed_dim
        self.pe_drop = Dropout(dropout)
        self.transformer = Transformer(clip_embed_dim, transformer_layers,
                                       max(1, clip_embed_dim // 64), torch.float32)
        self.hashing = BitwiseHashing(clip_embed_dim, k_bits)
        self._pe = torch.from_numpy(sincos_positional_encoding(k_bits, clip_embed_dim))

    def forward(self, tokens, concept_embed, key_padding_mask=None):
        x, pseudo_label = localized_token_aggregation(tokens, concept_embed, self.top_k,
                                                      key_padding_mask)
        if self._pe.device != x.device:
            self._pe = self._pe.to(x.device)
        x = self.pe_drop(x + self._pe[None, : x.shape[1]])
        x, _ = self.transformer(x)
        return self.hashing(x), pseudo_label, x

class MITHHead(nn.Module):
    def __init__(self, d: int, output_dim: int, dropout: float, transformer_layers: int,
                 activation: str, top_k_label: int, res_mlp_layers: int):
        super().__init__()
        self.gcl_i = GlobalConceptLearning(output_dim, d, dropout, activation, res_mlp_layers)
        self.gcl_t = self.gcl_i           # one module under both names
        self.lct_i = LocalConceptTransforming(d, output_dim, transformer_layers, dropout,
                                              top_k_label)
        self.lct_t = LocalConceptTransforming(d, output_dim, transformer_layers, dropout,
                                              top_k_label)
        self.img_concept_proj = nn.Linear(d, d)
        self.txt_concept_proj = nn.Linear(d, d)


class MITHModel(nn.Module):
    """CLIP backbone + MITH heads, with the reference torch names."""

    def __init__(self, clip_cfg: CLIPConfig, output_dim: int = 16, dropout: float = 0.0,
                 transformer_layers: int = 2, activation: str = "gelu",
                 top_k_label: int = 8, res_mlp_layers: int = 2):
        super().__init__()
        if not 0 < top_k_label <= output_dim:
            raise ValueError(f"top_k_label={top_k_label} must be in [1, {output_dim}] "
                             "(the code length)")
        self.output_dim = output_dim
        self.backbone = CLIP(clip_cfg)
        self.hash = MITHHead(clip_cfg.embed_dim, output_dim, dropout, transformer_layers,
                             activation, top_k_label, res_mlp_layers)

    def _branch(self, cls, tokens, kpm, lct, proj):
        cls, tokens = cls.float(), tokens.float()
        gcl = self.hash.gcl_i
        res_cls, cls_hash = gcl(cls)
        _, token_concepts = gcl(tokens)
        tokens_hash, _, trans_tokens = lct(tokens, token_concepts.detach(), kpm)
        return l2_normalize(res_cls), cls_hash, tokens_hash, l2_normalize(proj(trans_tokens))

    def encode_image_full(self, image):
        cls, tokens, _ = self.backbone.encode_image(image)
        return self._branch(cls, tokens, None, self.hash.lct_i, self.hash.img_concept_proj)

    def encode_text_full(self, text, key_padding_mask=None):
        # the padding mask (EOS slot included) reaches the aggregation only
        eos, tokens, _, new_kpm = self.backbone.encode_text(text, key_padding_mask)
        return self._branch(eos, tokens, new_kpm, self.hash.lct_t, self.hash.txt_concept_proj)

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        """The eval code before the sign: cls_hash + tokens_hash."""
        _, cls_hash, tokens_hash, _ = self.encode_image_full(image)
        return cls_hash + tokens_hash

    def encode_text(self, text: torch.Tensor, key_padding_mask=None) -> torch.Tensor:
        _, cls_hash, tokens_hash, _ = self.encode_text_full(text, key_padding_mask)
        return cls_hash + tokens_hash

    def forward(self, image, text, key_padding_mask=None):
        """The 8-tuple the loss takes: image (res_cls, cls_hash, tokens_hash,
        trans_tokens), then text's."""
        return self.encode_image_full(image) + self.encode_text_full(text, key_padding_mask)

    def init_weights(self, key, device=None) -> "MITHModel":
        """cmh_tpu's init from ``key`` (``models/flax_init.py``)."""
        return flax_init.init_(self, key, "MITH", device)


def info_nce_loss(out_1: torch.Tensor, out_2: torch.Tensor, temperature: float = 0.07):
    """Bidirectional InfoNCE on pooled features."""
    scores = matmul_fp32(out_1, out_2.t()) / temperature
    diag = torch.arange(scores.shape[0], device=scores.device)
    loss0 = -F.log_softmax(scores, dim=-1)[diag, diag].mean()
    loss1 = -F.log_softmax(scores.t(), dim=-1)[diag, diag].mean()
    return 0.5 * (loss0 + loss1)


def info_nce_loss_bmm(out_1: torch.Tensor, out_2: torch.Tensor, temperature: float = 0.07):
    """Per-sample token-to-token InfoNCE over (N, K, D) concept tokens."""
    sim = torch.einsum("nkd,njd->nkj", out_1.float(), out_2.float()) / temperature
    diag = torch.arange(sim.shape[1], device=sim.device)
    loss_1 = -F.log_softmax(sim, dim=-1)[:, diag, diag].mean()
    loss_2 = -F.log_softmax(sim.transpose(1, 2), dim=-1)[:, diag, diag].mean()
    return 0.5 * (loss_1 + loss_2)


def write_bank(bank: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """A new bank with ``rows`` at ``idx``; of repeated indices the last
    row is written, whatever order the scatter takes."""
    idx = idx.long()
    order = torch.arange(idx.shape[0], device=idx.device)
    last = torch.full((bank.shape[0],), -1, dtype=torch.long, device=idx.device)
    last = last.scatter_reduce(0, idx, order, reduce="amax")
    return bank.index_copy(0, idx, rows.detach().to(bank.dtype)[last[idx]])


BANKS = ("img_cls", "txt_cls", "img_tokens", "txt_tokens")


def mith_loss_fn(*, output_dim, hyper_tokens_intra, hyper_distill, hyper_info_nce,
                 hyper_cls_inter, hyper_quan, hyper_alpha, hyper_lambda):
    def loss(outputs, batch, method_state, step):
        (res_img_cls, img_cls_hash, tokens_hash_i, trans_tokens_i,
         res_txt_cls, txt_cls_hash, tokens_hash_t, trans_tokens_t) = outputs
        idx = batch["index"]
        label_sim = calc_label_sim(method_state["train_labels"], batch["label"])

        # the banks first: the batch sees its fresh codes
        banks = {name: write_bank(method_state[name], idx, h)
                 for name, h in zip(BANKS, (img_cls_hash, txt_cls_hash,
                                            tokens_hash_i, tokens_hash_t))}
        new_state = dict(method_state, **banks)

        lam = hyper_lambda
        sg = torch.Tensor.detach
        b_target = torch.sign(sg(img_cls_hash) * lam + sg(tokens_hash_i) * (1 - lam)
                              + sg(txt_cls_hash) * lam + sg(tokens_hash_t) * (1 - lam))

        intra_i = bayesian_loss(banks["img_tokens"], tokens_hash_i, label_sim)
        intra_t = bayesian_loss(banks["txt_tokens"], tokens_hash_t, label_sim)
        tokens_intra = hyper_tokens_intra * (intra_i + intra_t)

        inter_i2t = bayesian_loss(banks["img_cls"], txt_cls_hash, label_sim)
        inter_t2i = bayesian_loss(banks["txt_cls"], img_cls_hash, label_sim)
        cls_inter = hyper_cls_inter * (inter_i2t + inter_t2i)

        bsz = img_cls_hash.shape[0]
        h_i = img_cls_hash * 0.5 + tokens_hash_i * 0.5
        h_t = txt_cls_hash * 0.5 + tokens_hash_t * 0.5
        quan_i = torch.sum((h_i - b_target) ** 2) / bsz / output_dim
        quan_t = torch.sum((h_t - b_target) ** 2) / bsz / output_dim
        quan = hyper_quan * (quan_i + quan_t)

        nce_cls = info_nce_loss(res_img_cls, res_txt_cls)
        nce_tokens = info_nce_loss_bmm(trans_tokens_i, trans_tokens_t)
        nce = hyper_info_nce * (nce_cls + hyper_alpha * nce_tokens)

        item_1 = (torch.sum((sg(img_cls_hash) - tokens_hash_i) ** 2)
                  + torch.sum((sg(txt_cls_hash) - tokens_hash_t) ** 2))
        item_2 = 0.1 * (torch.sum((img_cls_hash - sg(tokens_hash_i)) ** 2)
                        + torch.sum((txt_cls_hash - sg(tokens_hash_t)) ** 2))
        distillation = hyper_distill * (item_1 + item_2) / bsz

        total = tokens_intra + cls_inter + quan + nce + distillation
        loss_dict = {
            "All loss": total,
            "LikeHood": {
                "intra_tokens": {"image": intra_i, "text": intra_t},
                "cls_inter": {"image": inter_i2t, "text": inter_t2i},
            },
            "Quantization": {"image": quan_i, "text": quan_t},
            "InfoNCE": {"cls": nce_cls, "tokens": nce_tokens},
            "Distillation": distillation,
        }
        return total, loss_dict, new_state

    return loss


@registry.register_model("MITH")
class MITHMethod(Method):
    arch = "MITH"
    code_mode = "sign"

    def init_method_state(self) -> Dict[str, torch.Tensor]:
        """The four banks, standard normals from ``split(PRNGKey(20), 4)``
        whatever the run seed (cmh_tpu ``models/mith.py:414-421``), and the
        train labels as fp32."""
        if self.train_labels is None:
            raise ValueError("MITH needs the trainer's train_labels before its banks")
        keys = prng.split(prng.PRNGKey(20), 4)
        shape = (self.train_num, self.output_dim)
        state = {name: prng.normal(k, shape) for name, k in zip(BANKS, keys)}
        state["train_labels"] = torch.as_tensor(np.asarray(self.train_labels), dtype=torch.float32)
        return state

    def state_from_jax(self, params, model_state):
        return convert.mith_state_from_jax(params)

    def state_to_jax(self, state_dict):
        return convert.mith_state_to_jax(state_dict)

    @classmethod
    def from_config(cls, cfg_model, output_dim: int = 16, train_num: int = 10000,
                    clip_cfg: Optional[CLIPConfig] = None) -> "MITHMethod":
        m = cfg_model or {}
        model = MITHModel(resolve_clip_cfg(m, clip_cfg), output_dim=output_dim,
                          dropout=m.get("drop_out", 0.0),
                          transformer_layers=m.get("transformer_layers", 2),
                          activation=m.get("activation", "gelu"),
                          top_k_label=m.get("top_k_label", 8),
                          res_mlp_layers=m.get("res_mlp_layers", 2))
        loss = mith_loss_fn(
            output_dim=output_dim,
            hyper_tokens_intra=m.get("hyper_tokens_intra", 1.0),
            hyper_distill=m.get("hyper_distill", 1.0),
            hyper_info_nce=m.get("hyper_info_nce", 50.0),
            hyper_cls_inter=m.get("hyper_cls_inter", 10.0),
            hyper_quan=m.get("hyper_quan", 8.0),
            hyper_alpha=m.get("hyper_alpha", 0.01),
            hyper_lambda=m.get("hyper_lambda", 0.99))
        return cls(model, loss, cfg_model, train_num)
