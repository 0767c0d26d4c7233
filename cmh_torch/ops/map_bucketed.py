"""Four-direction mAP for ``valid`` (counterpart of ``cmh_tpu/ops/map_bucketed.py``
and of ``calc_map_k_4dir_pallas`` in ``cmh_tpu/ops/map_pallas.py``).

``calc_map_k_4dir`` is the sort-free counting rank: per query chunk, the
four retrieval directions (i→t, t→i, i→i, t→t) are stacked on the query axis
of one ``2·d + rel`` word matrix, and one call of each pass
(``map_kernel.map_hist`` and ``map_kernel.map_ap``) covers the chunk. On
CUDA tensors the passes launch kernels K3-hist and K3-ap; on CPU tensors
they run their plain versions, the counterpart of ``_map_chunk_bucketed``.
``calc_map_k_4dir_auto`` routes ``valid``: codes up to ``MAX_KERNEL_BITS``
(4094) bits take the counting rank, wider codes four argsort passes
(``metrics.calc_map_k``).

``map_sums_4dir`` is one query shard's work, a plain function of (shard,
shards) that returns its fp64 AP sums, so one card can run every shard in
turn; ``calc_map_k_4dir_sharded`` is the data-parallel ``valid``'s thin
wrapper around it, one all-reduce over the group.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils import trace
from .map_kernel import MAX_KERNEL_BITS, average_precision, pack_words, query_chunk
from .metrics import calc_label_sim, calc_map_k


def map_sums_4dir(q_img, q_txt, r_img, r_txt, query_labels, retrieval_labels,
                  k: Optional[int] = None, shard: int = 0, n_shards: int = 1,
                  chunk: Optional[int] = None) -> torch.Tensor:
    """The (i→t, t→i, i→i, t→t) AP sums, fp64 on the codes' device, of query
    shard ``shard`` of ``n_shards``: the queries padded to a multiple of
    ``n_shards`` with zero-label rows (whose AP is 0, as cmh_tpu pads them),
    then cut into equal shards ranked against the whole gallery."""
    q_img = torch.as_tensor(q_img, dtype=torch.float32)
    dev = q_img.device
    q_txt, r_img, r_txt, ql, rl = (
        torch.as_tensor(t, dtype=torch.float32, device=dev)
        for t in (q_txt, r_img, r_txt, query_labels, retrieval_labels))
    bits = int(q_img.shape[1])
    per = -(-q_img.shape[0] // n_shards)
    pad = per * n_shards - q_img.shape[0]
    if pad:
        q_img, q_txt = (torch.cat([q, q.new_ones(pad, bits)]) for q in (q_img, q_txt))
        ql = torch.cat([ql, ql.new_zeros(pad, ql.shape[1])])
    rows = slice(shard * per, (shard + 1) * per)
    q_img, q_txt, ql = q_img[rows], q_txt[rows], ql[rows]
    chunk = chunk or query_chunk(bits)
    sums = torch.zeros(4, dtype=torch.float64, device=dev)
    for start in range(0, per, chunk):
        stop = min(start + chunk, per)
        gnd = calc_label_sim(ql[start:stop], rl)
        qi, qt = q_img[start:stop], q_txt[start:stop]
        words = torch.cat([pack_words(qc, rc, gnd, bits)
                           for qc, rc in ((qi, r_txt), (qt, r_img),
                                          (qi, r_img), (qt, r_txt))])
        ap = average_precision(words, bits, k)
        sums += ap.reshape(4, stop - start).sum(1)
    return sums


def calc_map_k_4dir(q_img, q_txt, r_img, r_txt, query_labels, retrieval_labels,
                    k: Optional[int] = None, chunk: Optional[int] = None
                    ) -> Tuple[float, float, float, float]:
    """(i→t, t→i, i→i, t→t) mAP@k by counting ranks, on the codes' device."""
    sums = map_sums_4dir(q_img, q_txt, r_img, r_txt, query_labels, retrieval_labels, k,
                         chunk=chunk)
    with trace.wait("map_read"):
        return tuple(float(m) for m in (sums / len(q_img)).cpu())


def calc_map_k_4dir_sharded(q_img, q_txt, r_img, r_txt, query_labels, retrieval_labels,
                            k: Optional[int] = None, group=None
                            ) -> Tuple[float, float, float, float]:
    """``calc_map_k_4dir`` sharded over the queries of a data-parallel group
    (``parallel/dp.py``; cmh_tpu ``calc_map_k_4dir_sharded`` and
    ``calc_map_k_4dir_pallas_sharded``): every rank ranks its shard against
    the whole gallery through K3 and one all-reduce sums the four AP sums,
    so every rank returns the same mAPs. Codes up to ``MAX_KERNEL_BITS``
    (cmh_tpu stops at 1022); wider codes take the argsort route on every
    rank. Under tensor parallelism ``group`` is the data-parallel group:
    the ranks of one tensor-parallel group rank the same shard."""
    import torch.distributed as dist

    if int(torch.as_tensor(q_img).shape[1]) > MAX_KERNEL_BITS:
        return calc_map_k_4dir_auto(q_img, q_txt, r_img, r_txt, query_labels,
                                    retrieval_labels, k)
    sums = map_sums_4dir(q_img, q_txt, r_img, r_txt, query_labels, retrieval_labels, k,
                         shard=group.rank, n_shards=group.world)
    dist.all_reduce(sums, group=group.pg)
    with trace.wait("map_read"):
        return tuple(float(m) for m in (sums / len(q_img)).cpu())


def calc_map_k_4dir_auto(q_img, q_txt, r_img, r_txt, query_labels,
                         retrieval_labels, k: Optional[int] = None):
    """Route the 4-direction eval by the codes' width (see the module
    docstring)."""
    if int(torch.as_tensor(q_img).shape[1]) > MAX_KERNEL_BITS:
        return tuple(calc_map_k(a, b, query_labels, retrieval_labels, k)
                     for a, b in ((q_img, r_txt), (q_txt, r_img),
                                  (q_img, r_img), (q_txt, r_txt)))
    return calc_map_k_4dir(q_img, q_txt, r_img, r_txt, query_labels,
                           retrieval_labels, k)
