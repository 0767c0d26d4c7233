"""CLIP backbone (ViT image tower + causal text transformer), forward only.

Counterpart of ``cmh_tpu/models/clip/model.py:37-463``: batch-first
layouts, bf16 (or fp32) matmul compute with fp32 parameters and fp32
LayerNorm statistics, attention returning head-averaged weights from the
last block. Parameters carry the reference torch CLIP names
(``visual.conv1.weight``, ``transformer.resblocks.{i}.attn.in_proj_weight``,
…), so ``models/convert.py`` maps the JAX tree onto them one to one.

Every LayerNorm goes through kernel K1 (``ops/layernorm.py``) and every
attention block but the last through kernel K2 (``ops/attention.py``); the
last block takes the explicit path because its weights are returned.

Under tensor parallelism (``parallel/tp.py``) an attention and a block's MLP
hold this rank's shards (``shards`` set): the attention runs its own heads,
through K2 or the explicit path, and the row-split products are summed over
the group in fp32, rounded once and given their bias once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from ...ops.attention import fused_attention
from ...ops.layernorm import fused_layernorm
from ...parallel import tp
from ...utils import trace
from .. import flax_init
from ..common import Dropout

EOT_TOKEN_ID = 49407


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    image_resolution: int = 224
    vision_layers: int = 12
    vision_width: int = 768
    vision_patch_size: int = 32
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12
    # compute dtype for matmuls; params always fp32
    dtype: torch.dtype = torch.bfloat16

    @property
    def vision_heads(self) -> int:
        return self.vision_width // 64

    @property
    def grid_size(self) -> int:
        return self.image_resolution // self.vision_patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size**2

    @classmethod
    def tiny(cls, dtype=torch.float32) -> "CLIPConfig":
        """Small config for tests (same geometry as cmh_tpu's tiny())."""
        return cls(
            embed_dim=32,
            image_resolution=32,
            vision_layers=2,
            vision_width=64,
            vision_patch_size=8,
            context_length=16,
            vocab_size=49408,
            transformer_width=64,
            transformer_heads=2,
            transformer_layers=2,
            dtype=dtype,
        )


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           dtype: torch.dtype) -> torch.Tensor:
    """x @ Wᵀ (+ b) in ``dtype``, the bias added after the product is
    rounded, as flax's Dense does."""
    y = torch.matmul(x.to(dtype), weight.to(dtype).t())
    return y if bias is None else y + bias.to(dtype)


def _dense_in(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              dtype: torch.dtype, shards: Optional[tp.Shards]) -> torch.Tensor:
    """``_dense`` of a column split: ``weight`` holds this rank's output
    features, ``x`` is whole on every rank."""
    if shards is None:
        return _dense(x, weight, bias, dtype)
    return tp.column_product(x.to(dtype), weight.to(dtype), shards) + bias.to(dtype)


def _dense_out(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               dtype: torch.dtype, shards: Optional[tp.Shards]) -> torch.Tensor:
    """``_dense`` of a row split: the ranks' fp32 partial products summed,
    rounded once to ``dtype``, the whole bias added once."""
    if shards is None:
        return _dense(x, weight, bias, dtype)
    y = tp.row_product(x.to(dtype), weight.to(dtype), shards).to(dtype)
    return y + bias.to(dtype)


class LayerNormFp32(nn.Module):
    """LayerNorm computed in fp32 whatever the activation dtype (kernel K1)."""

    def __init__(self, width: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_layernorm(x, self.weight, self.bias)


class MultiHeadAttention(nn.Module):
    """Packed-QKV attention returning head-averaged weights.

    Self-attention by default; with ``kv`` (B, S, D) it is cross-attention
    (q from x, k and v from ``kv``, through the rows of the same packed
    in-projection, as torch's ``nn.MultiheadAttention``). ``attn_dropout``
    drops attention probabilities in training (a ``Dropout`` under
    ``dropout_rng``). Kernel K2 is self-attention only and returns no
    weights, so the explicit path runs whenever ``kv`` is given, dropout is
    active or the weights are asked for (cmh_tpu ``models/clip/model.py:203``).
    With ``shards`` (``parallel/tp.py``) it holds this rank's heads."""

    shards: Optional[tp.Shards] = None

    def __init__(self, width: int, heads: int, dtype: torch.dtype,
                 attn_dropout: float = 0.0):
        super().__init__()
        self.heads = heads
        self.dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)
        self.attn_drop = Dropout(attn_dropout)

    def shard_(self, shards: tp.Shards) -> None:
        """Run on this rank's heads (``tp.shard_model_`` keeps their rows of
        the in-projection and columns of the out-projection); the dropout
        draws this rank's heads' part of the whole mask."""
        if self.heads % shards.size:
            raise ValueError(f"{self.heads} attention heads do not divide by tp={shards.size} "
                             "(the port splits the attention by heads)")
        self.shards = shards
        self.attn_drop.shard = (1, shards.rank, shards.size)   # (B, H, L, S) by heads

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None,
                key_padding_mask: Optional[torch.Tensor] = None,
                need_weights: bool = True, kv: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        b, l, d = x.shape
        sh, dt = self.shards, self.dtype
        hd = d // self.heads
        h = self.heads // (sh.size if sh else 1)              # this rank's heads
        w, bias = self.in_proj_weight, self.in_proj_bias
        e = h * hd                                            # a q, k or v block's rows
        if kv is None:
            q, k, v = _dense_in(x, w, bias, dt, sh).split(e, dim=-1)
        else:
            q = _dense_in(x, w[:e], bias[:e], dt, sh)
            k = _dense_in(kv, w[e:2 * e], bias[e:2 * e], dt, sh)
            v = _dense_in(kv, w[2 * e:], bias[2 * e:], dt, sh)
        q, k, v = (t.reshape(b, t.shape[1], h, hd).transpose(1, 2)
                   for t in (q, k, v))                       # (B, H, L, hd)
        scale = hd**-0.5
        dropping = self.attn_drop.p > 0.0 and self.training

        if not (need_weights or kv is not None or dropping):
            out = fused_attention(q, k, v, scale, attn_mask, key_padding_mask)
            out = out.transpose(1, 2).reshape(b, l, e).to(dt)
            return _dense_out(out, self.out_proj.weight, self.out_proj.bias, dt, sh), None

        # explicit path: q scaled in the compute dtype before an
        # fp32-accumulated dot, as cmh_tpu's einsum path does
        logits = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
        if attn_mask is not None:
            logits = logits + attn_mask.float()
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :],
                                        float("-inf"))
        weights = torch.softmax(logits, dim=-1)              # (B, H, L, S) fp32
        used = self.attn_drop(weights)
        out = torch.matmul(used.to(dt).float(), v.float())
        out = out.transpose(1, 2).reshape(b, l, e).to(dt)
        out = _dense_out(out, self.out_proj.weight, self.out_proj.bias, dt, sh)
        if sh is None:
            return out, weights.mean(dim=1)
        # the mean over every rank's heads
        return out, tp.sum_shards(weights.sum(dim=1), sh) / self.heads


class MLP(nn.Module):
    shards: Optional[tp.Shards] = None

    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, width * 4)
        self.c_proj = nn.Linear(width * 4, width)

    def shard_(self, shards: tp.Shards) -> None:
        """Run ``c_fc`` as a column split and ``c_proj`` as a row split."""
        self.shards = shards

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        sh = self.shards
        y = quick_gelu(_dense_in(x, self.c_fc.weight, self.c_fc.bias, dtype, sh))
        return _dense_out(y, self.c_proj.weight, self.c_proj.bias, dtype, sh)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.attn = MultiHeadAttention(width, heads, dtype)
        self.ln_1 = LayerNormFp32(width)
        self.mlp = MLP(width)
        self.ln_2 = LayerNormFp32(width)

    def forward(self, x, attn_mask=None, key_padding_mask=None,
                need_weights=True):
        attn_out, attn_weight = self.attn(self.ln_1(x), attn_mask,
                                          key_padding_mask, need_weights)
        x = x + attn_out
        return x + self.mlp(self.ln_2(x).to(self.dtype), self.dtype), attn_weight


class Transformer(nn.Module):
    """Stack of residual attention blocks; returns the last block's
    head-averaged attention (the only block that computes it)."""

    def __init__(self, width: int, layers: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, dtype) for _ in range(layers))

    def forward(self, x, attn_mask=None, key_padding_mask=None):
        attn_weight = None
        last = len(self.resblocks) - 1
        for i, blk in enumerate(self.resblocks):
            x, attn_weight = blk(x, attn_mask, key_padding_mask,
                                 need_weights=(i == last))
        return x, attn_weight


class VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        w, p = cfg.vision_width, cfg.vision_patch_size
        self.conv1 = nn.Module()
        self.conv1.weight = nn.Parameter(torch.empty(w, 3, p, p))
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(
            torch.empty(cfg.num_patches + 1, w))
        self.ln_pre = LayerNormFp32(w)
        self.transformer = Transformer(w, cfg.vision_layers, cfg.vision_heads,
                                       cfg.dtype)
        self.ln_post = LayerNormFp32(w)
        self.proj = nn.Parameter(torch.empty(w, cfg.embed_dim))

    def forward(self, image: torch.Tensor):
        """image (B, H, W, 3) NHWC → (cls, patch_tokens, cls→patch attention).

        The non-overlapping patch convolution is patchify + one matmul
        (``cmh_tpu/models/clip/model.py:332-344``), never a cuDNN
        convolution (which would run fp32 in TF32)."""
        cfg = self.cfg
        dt, width = cfg.dtype, cfg.vision_width
        p, g = cfg.vision_patch_size, cfg.grid_size
        b = image.shape[0]
        x = image.to(dt).reshape(b, g, p, g, p * 3)
        x = x.permute(0, 1, 3, 2, 4).reshape(b, g * g, p * p * 3)
        # torch (out, in, kh, kw) → (kh, kw, in, out), flattened over (kh, kw, in)
        kernel = self.conv1.weight.permute(2, 3, 1, 0).reshape(p * p * 3, width)
        x = torch.matmul(x, kernel.to(dt))
        cls_tok = self.class_embedding.to(dt).expand(b, 1, width)
        x = torch.cat([cls_tok, x], dim=1)
        x = x + self.positional_embedding.to(dt)[None]
        x = self.ln_pre(x)
        x, attn_weight = self.transformer(x)
        x = self.ln_post(x)
        x = torch.matmul(x.to(dt), self.proj.to(dt))
        return x[:, 0, :], x[:, 1:, :], attn_weight[:, 0, 1:]


class CLIP(nn.Module):
    """Vision tower + text transformer with a shared embedding space."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        tw = cfg.transformer_width
        self.visual = VisionTransformer(cfg)
        self.transformer = Transformer(tw, cfg.transformer_layers,
                                       cfg.transformer_heads, cfg.dtype)
        self.token_embedding = nn.Embedding(cfg.vocab_size, tw)
        self.positional_embedding = nn.Parameter(
            torch.empty(cfg.context_length, tw))
        self.ln_final = LayerNormFp32(tw)
        self.text_projection = nn.Parameter(torch.empty(tw, cfg.embed_dim))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))

    def encode_image(self, image: torch.Tensor):
        """Returns (cls_token, patch_tokens, patch_attention)."""
        return self.visual(image)

    def encode_text(self, text: torch.Tensor,
                    key_padding_mask: Optional[torch.Tensor] = None):
        """Returns (eos_token, seq_tokens, eos_attention, new_key_padding_mask).

        The EOS position is ``argmax(text)`` (the EOT id is the largest in
        the vocabulary); the returned attention row has its EOS column
        zeroed and the returned padding mask also masks the EOS slot."""
        cfg = self.cfg
        dt = cfg.dtype
        b, l = text.shape
        text = text.long()
        x = self.token_embedding.weight[text].to(dt)
        x = x + self.positional_embedding[:l].to(dt)
        causal = torch.full((l, l), float("-inf"), device=x.device).triu(1)
        x, attn_weight = self.transformer(x, causal, key_padding_mask)

        eos_idx = torch.argmax(text, dim=-1)
        rows = torch.arange(b, device=x.device)
        eos_attn = attn_weight[rows, eos_idx].clone()
        # the 0.0 goes to the card as a host tensor: the host waits for the card
        with trace.wait("eos_attn_zero"):
            eos_attn[rows, eos_idx] = 0.0

        new_kpm = None
        if key_padding_mask is not None:
            new_kpm = key_padding_mask | (text == EOT_TOKEN_ID)

        x = self.ln_final(x)
        x = torch.matmul(x.to(dt), self.text_projection.to(dt))
        return x[rows, eos_idx], x, eos_attn, new_kpm

    def init_weights(self, key, device=None) -> "CLIP":
        """cmh_tpu's ``CLIP(cfg).init(key, ...)`` (``models/flax_init.py``)."""
        return flax_init.init_clip_(self, key, device)

