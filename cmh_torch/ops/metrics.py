"""Retrieval metrics (counterpart of ``cmh_tpu/ops/metrics.py``).

Label similarity, the DCG-weighted label similarity of the triplet losses
(``generate_weight_sim``), the pairwise euclidean and cosine similarities of
the DCMHT loss, Hamming distances between ±1 codes, the argsort mAP that wide
codes take, and ``calc_map_k_numpy``, the independent numpy oracle the
tests hold every mAP path against. Float32 matmuls here run in full fp32:
``full_fp32`` turns TF32 off on the card for their duration, as cmh_tpu asks
for ``precision="highest"``.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch


@contextlib.contextmanager
def full_fp32():
    """fp32 matmuls without TF32 on the card for the block's duration."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def matmul_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    with full_fp32():
        return torch.matmul(a.float(), b.float())


def calc_label_sim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a @ bᵀ > 0) as float — multi-label ground-truth similarity."""
    return (matmul_fp32(a, b.t()) > 0).float()


def generate_weight_sim(a: torch.Tensor, b: torch.Tensor):
    """DCG-style weighted similarity (cmh_tpu ``ops/metrics.py:37-52``):
    (label_sim, weights), weights[i, j] = (2^{s_ij} − 1) / Z_i with s = a·bᵀ
    in full fp32 and Z_i the ideal DCG of row i (its s sorted descending,
    discounted by log2(j + 2))."""
    sim_origin = matmul_fp32(a, b.t())
    batch = a.shape[0]
    label_sim = (sim_origin > 0).float()
    ideal = torch.sort(sim_origin, dim=1, descending=True).values
    th = torch.log2(torch.arange(batch, dtype=torch.float32, device=a.device) + 2.0)
    z = torch.sum((torch.pow(2.0, ideal) - 1.0) / th[None, :], dim=1, keepdim=True)
    weights = (torch.pow(2.0, sim_origin) - 1.0) / z
    return label_sim, weights


def euclidean_similarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise euclidean distance with a zero subgradient where the squared
    distance is 0 (cmh_tpu's ``where(sq > 0, sqrt(where(sq > 0, sq, 1)), 0)``,
    not ``torch.cdist``)."""
    a, b = a.float(), b.float()
    sq = ((a * a).sum(-1, keepdim=True) - 2.0 * matmul_fp32(a, b.t())
          + (b * b).sum(-1)[None, :])
    positive = sq > 0.0
    safe = torch.where(positive, sq, torch.ones_like(sq))
    return torch.where(positive, torch.sqrt(safe), torch.zeros_like(sq))


def cosine_similarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = a / torch.linalg.norm(a, dim=-1, keepdim=True)
    b = b / torch.linalg.norm(b, dim=-1, keepdim=True)
    return matmul_fp32(a, b.t())


def calc_hamming_dist(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Hamming distance between ±1 codes: 0.5·(K − B1·B2ᵀ). The ±1 products
    and their integer sums are exact in fp32 (and in TF32, whose inputs
    hold ±1 exactly) for any code length below 2^24."""
    if b1.dim() < 2:
        b1 = b1[None, :]
    return 0.5 * (b2.shape[1] - matmul_fp32(b1, b2.t()))


def calc_map_k(q_b, r_b, query_labels, retrieval_labels,
               k: Optional[int] = None, chunk: int = 256) -> float:
    """mAP@k over the Hamming ranking by a stable sort per query (distance,
    then gallery index), the route for codes wider than the counting-rank
    kernel takes. Each contribution is the fp32 quotient rank_rel / rank,
    summed per query in fp64; a query with no relevant item scores 0."""
    q_b = torch.as_tensor(q_b, dtype=torch.float32)
    r_b = torch.as_tensor(r_b, dtype=torch.float32, device=q_b.device)
    ql = torch.as_tensor(query_labels, dtype=torch.float32, device=q_b.device)
    rl = torch.as_tensor(retrieval_labels, dtype=torch.float32, device=q_b.device)
    n = r_b.shape[0]
    rank = torch.arange(1, n + 1, device=q_b.device, dtype=torch.float32)
    ap_sum = torch.zeros((), dtype=torch.float64, device=q_b.device)
    for start in range(0, q_b.shape[0], chunk):
        hamm = calc_hamming_dist(q_b[start:start + chunk], r_b).long()
        key = hamm * n + torch.arange(n, device=q_b.device)
        order = torch.argsort(key, dim=-1)
        gnd = calc_label_sim(ql[start:start + chunk], rl).gather(1, order)
        csum = torch.cumsum(gnd, dim=-1)
        total = csum[:, -1] if k is None else torch.clamp(csum[:, -1], max=float(k))
        contrib = torch.where((gnd > 0) & (csum <= total[:, None]),
                              csum / rank[None, :], torch.zeros_like(csum))
        ap = contrib.double().sum(-1) / torch.clamp(total.double(), min=1.0)
        ap_sum += torch.where(total > 0, ap, torch.zeros_like(ap)).sum()
    return float(ap_sum) / q_b.shape[0]


def calc_map_k_numpy(q_b, r_b, query_labels, retrieval_labels, k=None) -> float:
    """Pure-numpy oracle of the reference calc_map_k, for the tests."""
    q_b = np.asarray(q_b, dtype=np.float64)
    r_b = np.asarray(r_b, dtype=np.float64)
    ql = np.asarray(query_labels, dtype=np.float64)
    rl = np.asarray(retrieval_labels, dtype=np.float64)
    num_query = ql.shape[0]
    if k is None:
        k = rl.shape[0]
    gnds = (ql @ rl.T > 0).astype(np.float64)
    hamms = 0.5 * (r_b.shape[1] - q_b @ r_b.T)
    ap_sum = 0.0
    for i in range(num_query):
        ind = np.argsort(hamms[i], kind="stable")
        gnd = gnds[i][ind]
        total = int(min(gnd.sum(), k))
        if total == 0:
            continue
        count = np.arange(1, total + 1, dtype=np.float64)
        tindex = np.nonzero(gnd)[0][:total].astype(np.float64) + 1.0
        ap_sum += float(np.mean(count / tindex))
    return ap_sum / num_query
