"""DCMHT's plain reference: its hash heads and loss on OpenAI CLIP's
towers, trained by BertAdam.

Departures from the published CLIP model, all as DCMHT defines it: the
image head's norm is a BatchNorm over the batch in training; the euclidean
similarity is ``sqrt(|a|^2 - 2 a.b + |b|^2)`` with zero where that is not
positive. The heads and the loss run in float32 whatever ``mm`` is; the
heads' parameters are under ``hash.img_hash.`` and ``hash.txt_hash.``.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict, List, Optional, Tuple

import torch

from . import training
from .clip import Matmul, Params, encode_image, encode_text, fp32_matmul, layer_norm


def hash_head(P: Params, x: torch.Tensor, pre: str, train: bool) -> torch.Tensor:
    """DCMHT's head: attention over one token (its value and output
    projections), a norm, fc2, relu, and a softmax over each pair."""
    d = x.shape[1]
    v = x @ P[pre + "atten.in_proj_weight"][2 * d:].t() + P[pre + "atten.in_proj_bias"][2 * d:]
    x = v @ P[pre + "atten.out_proj.weight"].t() + P[pre + "atten.out_proj.bias"]
    if pre + "norm.running_mean" in P:             # the image head's BatchNorm
        if train:
            mean, var = x.mean(0), x.var(0, unbiased=False)
        else:
            mean, var = P[pre + "norm.running_mean"], P[pre + "norm.running_var"]
        x = (x - mean) / torch.sqrt(var + 1e-5) * P[pre + "norm.weight"] + P[pre + "norm.bias"]
    else:
        x = layer_norm(x, P, pre + "norm")
    x = torch.relu(x @ P[pre + "fc2.weight"].t() + P[pre + "fc2.bias"])
    return torch.softmax(x.reshape(x.shape[0], -1, 2), dim=-1).reshape(x.shape[0], -1)


def image_codes(P: Params, image, mm: Matmul = fp32_matmul) -> torch.Tensor:
    """(B, H, W, 3) images → (B, 2K) eval pair probabilities (``P`` bare)."""
    return hash_head(P, encode_image(P, image, mm), "hash.img_hash.", False)


def text_codes(P: Params, text, mm: Matmul = fp32_matmul) -> torch.Tensor:
    """(B, L) token ids → (B, 2K) eval pair probabilities (``P`` bare)."""
    return hash_head(P, encode_text(P, text, mm), "hash.txt_hash.", False)


def bits(probs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(±1 codes (N, K), each bit's margin (N, K)) of pair probabilities:
    +1 where the second of a pair is larger (a tie reads -1, as the
    port's pair argmax reads one); the margin is the gap between the two."""
    p = probs.reshape(probs.shape[0], -1, 2)
    return (p[..., 1] > p[..., 0]).float() * 2 - 1, (p[..., 1] - p[..., 0]).abs()


def _euclidean(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    sq = (a * a).sum(-1, keepdim=True) - 2.0 * a @ b.t() + (b * b).sum(-1)[None, :]
    return torch.where(sq > 0, torch.sqrt(torch.where(sq > 0, sq, torch.ones_like(sq))),
                       torch.zeros_like(sq))


def dcmht_loss(img: torch.Tensor, txt: torch.Tensor, labels: torch.Tensor, model: dict):
    """DCMHT's loss: the clipped euclidean similarity terms over the image
    to text, image to image and text to text pairs, plus quan_alpha times
    the mean of both codes' 1 - mean((2c - 1)^2)."""
    k = img.shape[1] // 2
    top = math.sqrt(k * 2 * model["vartheta"])
    sim_labels = (labels @ labels.t() > 0).float()

    def terms(a, b):
        s = _euclidean(a, b)
        pos = s * sim_labels
        neg = top * (1.0 - sim_labels) - torch.clamp(s * (1.0 - sim_labels), max=top)
        return (pos ** 2).mean(), (neg ** 2).mean()

    intra_p, intra_n = terms(img, txt)
    inter_pi, inter_ni = terms(img, img)
    inter_pt, inter_nt = terms(txt, txt)
    quan = ((1.0 - ((2 * img - 1) ** 2).mean()) + (1.0 - ((2 * txt - 1) ** 2).mean())) / 2
    return (intra_p + intra_n) + (inter_pt + inter_pi + inter_ni + inter_nt) \
        + model["quan_alpha"] * quan


def head_loss(P: Params, emb_i: torch.Tensor, emb_t: torch.Tensor, labels: torch.Tensor,
              model: dict) -> torch.Tensor:
    """The loss of a training batch from the towers' outputs."""
    return dcmht_loss(hash_head(P, emb_i, "hash.img_hash.", True),
                      hash_head(P, emb_t, "hash.txt_hash.", True), labels, model)


def train_steps(P: Params, batches: List[dict], model: dict, opt: dict, t_total: int,
                mm: Matmul = fp32_matmul, rows: Optional[int] = None, chunk: int = 32
                ) -> Tuple[List[float], Dict[str, float], Dict[str, float]]:
    """``training.train_steps`` with DCMHT's loss and BertAdam."""
    return training.train_steps(P, batches, partial(head_loss, model=model), opt, t_total,
                                mm=mm, rows=rows, chunk=chunk)
