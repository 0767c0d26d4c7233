"""DSPH: deep semantic-preserving hashing with learnable class proxies
(counterpart of ``cmh_tpu/models/dsph.py``).

Per-modality head = Linear → dropout(0.2) → tanh (``nn.Linear``'s default
init) under ``hash.{img,txt}_hash.fc``. The HyP loss takes the cosine of the
codes against the L2-normalized class proxies (``hyp.proxies``, (numclass,
K), kaiming-normal with fan_out = numclass): a pull 1 − cos on positive
classes, a push relu(cos − threshold) on negative ones, for both
modalities, plus an α-weighted term over the pairs of multi-label items
that share no label. The threshold comes from the reference's code table
(this package's copy, ``dsph_codetable.json``). The proxies are trained by
SGD with momentum and weight decay from ``optimizer.hyp``, not by BertAdam.
"""

from __future__ import annotations

import json
import math
import os
from typing import List, Optional

import torch
from torch import nn

from ..ops.metrics import matmul_fp32
from ..registry import registry
from . import convert, flax_init
from .base import Method, resolve_clip_cfg
from .clip.model import CLIP, CLIPConfig
from .common import LinearHash
from .losses import l2_normalize

_CODETABLE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "dsph_codetable.json")


def lookup_threshold(output_dim: int, numclass: int) -> float:
    """codetable[output_dim][ceil(log2 numclass)] (reference DSPH.py:33-35)."""
    with open(_CODETABLE_PATH) as f:
        row = json.load(f)[str(output_dim)]
    value = row[math.ceil(math.log(numclass, 2))]
    if value is None:
        raise ValueError(f"codetable has no entry for {output_dim} bits / {numclass} classes")
    return float(value)


class DSPHModel(nn.Module):
    def __init__(self, clip_cfg: CLIPConfig, output_dim: int = 16, numclass: int = 80,
                 dropout: float = 0.2):
        super().__init__()
        self.output_dim = output_dim
        self.backbone = CLIP(clip_cfg)
        width = clip_cfg.embed_dim
        self.hash = nn.ModuleDict({"img_hash": LinearHash(width, output_dim, dropout),
                                   "txt_hash": LinearHash(width, output_dim, dropout)})
        self.hyp = nn.ParameterDict({"proxies": nn.Parameter(torch.empty(numclass, output_dim))})

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        cls_token, _, _ = self.backbone.encode_image(image)
        return self.hash.img_hash(cls_token)

    def encode_text(self, text: torch.Tensor, key_padding_mask=None) -> torch.Tensor:
        eos_token, _, _, _ = self.backbone.encode_text(text, key_padding_mask)
        return self.hash.txt_hash(eos_token)

    def forward(self, image, text, key_padding_mask=None):
        return (self.encode_image(image), self.encode_text(text, key_padding_mask),
                self.hyp.proxies)

    def init_weights(self, key, device=None) -> "DSPHModel":
        """cmh_tpu's init from ``key`` (``models/flax_init.py``)."""
        return flax_init.init_(self, key, "DSPH", device)


def hyp_loss(img, txt, proxies, labels, *, threshold: float, alpha: float):
    """Reference HyP.forward (loss/HyP.py:18-69) in cmh_tpu's masked form:
    the multi-label subset is a mask over the whole batch."""
    p = labels
    proxies_n = l2_normalize(proxies)
    xn, tn = l2_normalize(img), l2_normalize(txt)
    cos = matmul_fp32(xn, proxies_n.t())
    cos_t = matmul_fp32(tn, proxies_n.t())
    pos, neg = 1.0 - cos, torch.relu(cos - threshold)
    pos_t, neg_t = 1.0 - cos_t, torch.relu(cos_t - threshold)

    is_pos, is_neg = p == 1, p == 0
    p_num = torch.clamp(is_pos.sum(), min=1)
    n_num = torch.clamp(is_neg.sum(), min=1)
    zero = torch.zeros((), dtype=cos.dtype, device=cos.device)
    total = (torch.where(is_pos, pos, zero).sum() / p_num
             + torch.where(is_neg, neg, zero).sum() / n_num
             + torch.where(is_pos, pos_t, zero).sum() / p_num
             + torch.where(is_neg, neg_t, zero).sum() / n_num)

    if alpha > 0:
        multi = (labels.sum(dim=1) > 1).float()
        zero_mask = multi[:, None] * multi[None, :] * (matmul_fp32(labels, labels.t()) == 0)
        denom = zero_mask.sum()
        safe = torch.clamp(denom, min=1.0)
        reg = sum(torch.sum(zero_mask * alpha * torch.relu(sim - threshold)) / safe
                  for sim in (matmul_fp32(xn, xn.t()), matmul_fp32(tn, tn.t()),
                              matmul_fp32(xn, tn.t())))
        total = total + (denom > 0).float() * reg
    return total


def dsph_loss_fn(*, threshold: float, alpha: float):
    def loss(outputs, batch, method_state, step):
        img, txt, proxies = outputs
        total = hyp_loss(img, txt, proxies, batch["label"], threshold=threshold, alpha=alpha)
        return total, {"All loss": total}, method_state

    return loss


@registry.register_model("DSPH")
class DSPHMethod(Method):
    arch = "DSPH"
    code_mode = "sign"

    def state_from_jax(self, params, model_state):
        return convert.dsph_state_from_jax(params)

    def state_to_jax(self, state_dict):
        return convert.dsph_state_to_jax(state_dict)

    def jax_extra_opt_state(self, name, trace):
        """cmh_tpu chains ``add_decayed_weights`` (no state) before the SGD."""
        return {"0": {}, "1": super().jax_extra_opt_state(name, trace)}

    def extra_param_groups(self, cfg_optimizer) -> List[dict]:
        """The proxies on SGD(lr, momentum, weight_decay) from
        ``optimizer.hyp`` (cmh_tpu ``runners/dsph.py:27-37``): torch couples
        the decay into the gradient before the momentum buffer, which starts
        at the first gradient, as optax's chain does."""
        hyp = cfg_optimizer.get("hyp", None) or {}
        return [{"name": "proxies", "params": [self.model.hyp.proxies],
                 "lr": hyp.get("lr", 0.02), "momentum": hyp.get("momentum", 0.9),
                 "weight_decay": hyp.get("weight_decay", 0.0005)}]

    @classmethod
    def from_config(cls, cfg_model, output_dim: int = 16, train_num: int = 10000,
                    clip_cfg: Optional[CLIPConfig] = None) -> "DSPHMethod":
        m = cfg_model or {}
        numclass = m.get("numclass", 80)
        model = DSPHModel(resolve_clip_cfg(m, clip_cfg), output_dim=output_dim,
                          numclass=numclass, dropout=m.get("dropout", 0.2))
        loss = dsph_loss_fn(threshold=lookup_threshold(output_dim, numclass),
                            alpha=m.get("alpha", 0.8))
        return cls(model, loss, cfg_model, train_num)
