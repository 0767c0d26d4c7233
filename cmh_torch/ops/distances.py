"""Set-wise similarities (the chamfer family) and the DCG-weighted triplet
loss (counterpart of ``cmh_tpu/ops/distances.py``), shared by DIMCH and
UMoED.

The sets stay (B, M, D) tensors: one (B, C, M, N) cosine tensor, then max,
logsumexp or mean over the token axes. fp32 products run in full fp32
(``metrics.full_fp32``).

- ``setwise_similarity``: ``chamfer``, ``smooth_chamfer``, ``max`` and
  ``avg`` (sigmoid-averaged, α = 1, β = 0) between L2-normalised sets;
- ``cos_distance``: clamp(1 − cos, 0) between code rows;
- ``weighted_triplet_loss``: every (anchor, positive, negative) triplet of a
  (B, B) distance matrix, weighted by ``generate_weight_sim``'s DCG weights,
  the mean over the terms above 1e-16;
- ``mmd_rbf_loss``: MMD under exp(−γ·‖x − y‖);
- ``batchwise_uniformity_loss`` (DIMCH: every pair of the flattened (B·M, D)
  rows) and ``batchwise_uniformity_loss_per_sample`` (UMoED: pairs within a
  sample only).
"""

from __future__ import annotations

import torch

from .metrics import euclidean_similarity, full_fp32, generate_weight_sim


def _pair_sim(img: torch.Tensor, txt: torch.Tensor) -> torch.Tensor:
    """(B, M, D) × (C, N, D) → (B, C, M, N) dot products in fp32."""
    with full_fp32():
        return torch.einsum("bmd,cnd->bcmn", img.float(), txt.float())


def chamfer_similarity(img, txt, denominator: float = 2.0):
    """Mean over img tokens of the max over txt tokens, plus the symmetric
    term, over ``denominator``."""
    sim = _pair_sim(img, txt)
    m, n = sim.shape[2], sim.shape[3]
    right = sim.amax(dim=3).sum(dim=2)
    left = sim.amax(dim=2).sum(dim=2)
    return (right / m + left / n) / denominator


def smooth_chamfer_similarity(img, txt, temperature: float = 16.0,
                              temperature_txt_scale: float = 1.0,
                              denominator: float = 2.0):
    """The chamfer similarity with each max a logsumexp at ``temperature``."""
    sim = _pair_sim(img, txt)
    m, n = sim.shape[2], sim.shape[3]
    t1 = temperature * temperature_txt_scale
    right = torch.logsumexp(t1 * sim, dim=3).sum(dim=2)
    left = torch.logsumexp(temperature * sim, dim=2).sum(dim=2)
    return (right / (m * t1) + left / (n * temperature)) / denominator


def max_similarity(img, txt):
    """The max over all token pairs."""
    return _pair_sim(img, txt).amax(dim=(2, 3))


def avg_similarity(img, txt, alpha: float = 1.0, beta: float = 0.0):
    """The mean of sigmoid(α·sim + β) over all token pairs."""
    return torch.sigmoid(alpha * _pair_sim(img, txt) + beta).mean(dim=(2, 3))


def setwise_similarity(img, txt, mode: str = "chamfer", denominator: float = 2.0,
                       temperature: float = 16.0, temperature_txt_scale: float = 1.0):
    """(B, C) similarities of the sets by ``mode`` (cmh_tpu's substring
    dispatch: ``smooth`` before ``chamfer``)."""
    if "smooth" in mode:
        return smooth_chamfer_similarity(img, txt, temperature, temperature_txt_scale,
                                         denominator)
    if "chamfer" in mode:
        return chamfer_similarity(img, txt, denominator)
    if "max" in mode:
        return max_similarity(img, txt)
    if "avg" in mode:
        return avg_similarity(img, txt)
    raise ValueError(f"unknown setwise distance mode '{mode}'")


def normalize(x: torch.Tensor) -> torch.Tensor:
    """x / max(‖x‖, 1e-8) over the last axis."""
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-8)


def cos_distance(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """clamp(1 − cos, 0) between every source and target row."""
    with full_fp32():
        cos = normalize(source.float()) @ normalize(target.float()).t()
    return torch.clamp(1.0 - cos, min=0.0)


def weighted_triplet_loss(pairwise_dist, s_labels, t_labels=None, margin: float = 0.0,
                          weighted: bool = True, reduction: str = "mean"):
    """loss[a, p, n] = clamp(w·mask·(d_ap − d_an + margin), 0) with mask =
    pos(a, p)·(1 − pos(a, n)) and w = weight(a, p) − weight(a, n); the sum,
    or the mean over the terms above 1e-16."""
    if t_labels is None:
        t_labels = s_labels
    label_sim, weights = generate_weight_sim(s_labels, t_labels)
    triplet = pairwise_dist[:, :, None] - pairwise_dist[:, None, :] + margin
    mask = label_sim[:, :, None] * (1.0 - label_sim[:, None, :])
    w = (weights[:, :, None] - weights[:, None, :]) if weighted else 1.0
    triplet = torch.clamp(w * mask * triplet, min=0.0)
    if reduction == "sum":
        return triplet.sum()
    num_positive = (triplet > 1e-16).float().sum()
    return triplet.sum() / (num_positive + 1e-16)


def mmd_rbf_loss(x, y, gamma: float = None):
    """MMD with the kernel exp(−γ·‖a − b‖) (γ defaults to 1/D)."""
    if gamma is None:
        gamma = 1.0 / x.shape[-1]

    def k(a, b):
        return torch.exp(-gamma * euclidean_similarity(a, b))

    return k(x, x).mean() - 2.0 * k(x, y).mean() + k(y, y).mean()


def batchwise_uniformity_loss(embs, num_embeds: int, t: float = 20.0):
    """DIMCH's diversity term: Σ_{i<j} exp(−t·‖e_i − e_j‖²) over every pair of
    the flattened (B·M, D) rows, over M(M − 1)/2."""
    if num_embeds == 1:
        return torch.zeros((), device=embs.device)
    flat = embs.reshape(-1, embs.shape[-1])
    rbf = torch.exp(-t * euclidean_similarity(flat, flat) ** 2)
    return torch.triu(rbf, diagonal=1).sum() / (num_embeds * (num_embeds - 1) * 0.5)


def batchwise_uniformity_loss_per_sample(embs, num_embeds: int, t: float = 20.0):
    """UMoED's diversity term: the same sum over the pairs within each
    sample's (M, D) set, averaged over the batch."""
    if num_embeds == 1:
        return torch.zeros((), device=embs.device)
    d2 = torch.square(embs[:, :, None, :] - embs[:, None, :, :]).sum(-1)
    rbf = torch.exp(-t * d2)
    m = embs.shape[1]
    upper = torch.triu(torch.ones((m, m), dtype=embs.dtype, device=embs.device), diagonal=1)
    per = (rbf * upper[None]).sum(dim=(1, 2)) / (num_embeds * (num_embeds - 1) * 0.5)
    return per.mean()
