"""Exact Hamming top-k and the 4-direction mAP, written out plainly.

Codes are ±1 rows. For the top-k they are packed eight bits a byte, the
distance is a byte-table popcount of the xor, and the order is a stable
sort: ascending distance, ties by the lower gallery index. The mAP ranks
the whole retrieval set for each query by a stable sort on the Hamming
distance and averages over the queries, in float64, each relevant item's
rank among the relevant over its rank; a query with no relevant item
counts 0.
"""

from __future__ import annotations

from typing import Tuple

import torch

_POPCOUNT = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.uint8)


def pack_bytes(codes: torch.Tensor) -> torch.Tensor:
    """(N, K) ±1 codes, K a multiple of 8 → (N, K / 8) uint8, bit j of
    byte i set where code[:, 8 i + j] > 0."""
    bits = (codes > 0).to(torch.uint8).reshape(codes.shape[0], -1, 8)
    weights = (2 ** torch.arange(8, device=codes.device)).to(torch.uint8)
    return (bits * weights).sum(-1, dtype=torch.uint8)


def topk(query: torch.Tensor, gallery: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One packed query (W,) against the packed gallery (N, W): the k
    nearest (distances, indices), int64."""
    table = _POPCOUNT.to(gallery.device)
    dist = table[torch.bitwise_xor(gallery, query[None, :]).long()].sum(1, dtype=torch.int32)
    order = torch.sort(dist, stable=True).indices[:k]
    return dist[order].long(), order


def mean_ap(q: torch.Tensor, r: torch.Tensor, q_labels: torch.Tensor,
            r_labels: torch.Tensor, chunk: int = 256, dtype=torch.float64) -> float:
    """mAP over the whole ranking of ``r`` for each query of ``q``, its
    counts, quotients and sums in ``dtype``."""
    n = r.shape[0]
    rank = torch.arange(1, n + 1, device=q.device, dtype=torch.float64).to(dtype)
    total = 0.0
    for s in range(0, q.shape[0], chunk):
        qc = q[s:s + chunk].double()
        dist = 0.5 * (r.shape[1] - qc @ r.double().t())
        order = torch.sort(dist, dim=1, stable=True).indices
        rel = ((q_labels[s:s + chunk].double() @ r_labels.double().t()) > 0).to(dtype)
        rel = rel.gather(1, order)
        hits = rel.cumsum(1)
        count = rel.sum(1)
        ap = (hits / rank * rel).sum(1) / count.clamp(min=1)
        total += float(torch.where(count > 0, ap, torch.zeros_like(ap)).double().sum())
    return total / q.shape[0]


def maps_4dir(q_img, q_txt, r_img, r_txt, q_labels, r_labels, dtype=torch.float64):
    """(i→t, t→i, i→i, t→t) mAP."""
    return tuple(mean_ap(a, b, q_labels, r_labels, dtype=dtype)
                 for a, b in ((q_img, r_txt), (q_txt, r_img), (q_img, r_img), (q_txt, r_txt)))
