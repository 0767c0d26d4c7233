"""Counting-rank mAP over Hamming rankings (kernels K3-hist and K3-ap).

Counterpart of ``cmh_tpu/ops/map_pallas.py``. Hamming distances are integers
in [0, bits], so each item's rank under the stable ordering (distance
ascending, ties by gallery index) is counted instead of sorted:

    N_rank(i) = #{j : d_j < d_i} + #{j ≤ i : d_j == d_i}
    R_rank(i) = the same counts over relevant items
    AP = (1/total) · Σ_{relevant i, R_rank(i) ≤ total} R_rank(i) / N_rank(i)

with total = min(#relevant, k). Each (query, item) pair is one word
``2·d + relevance``: uint8 up to 126 bits, int16 above. Pass 1 (K3-hist)
counts per-(query, bucket) histograms of all and of relevant items; the
strictly-smaller prefixes ``less`` and ``less_r`` and ``total`` are plain
torch on the tiny (Q, bits+1) tensors, as cmh_tpu does them outside Pallas;
pass 2 (K3-ap) sums the contributions. A CUDA tensor launches the kernels
in ``csrc/map.cu``; a CPU tensor takes ``map_hist_plain`` and
``map_ap_plain``. Each contribution is the fp32 quotient R/N, summed per
query in fp64 by the kernel and the plain version alike.

``map_bucketed.calc_map_k_4dir`` drives the passes over query chunks.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .metrics import calc_hamming_dist

MAX_KERNEL_BITS = 4094      # cmh_tpu's MAX_PALLAS_BITS
_AP_BLOCK = 128             # gallery items per step of the plain pass 2


def packed_dtype(bits: int) -> torch.dtype:
    """Narrowest word for ``2·(bits+1)``, cmh_tpu's boundary (126 bits)."""
    return torch.uint8 if 2 * (bits + 1) <= 255 else torch.int16


def query_chunk(bits: int) -> int:
    """Queries per chunk (``map_bucketed._pallas_tiles``): the word matrix
    of a chunk is 4·chunk × N words."""
    if bits <= 126:
        return 1024
    if bits <= 255:
        return 512
    return 256 if bits <= 1022 else 128


def pack_words(q_codes: torch.Tensor, r_codes: torch.Tensor,
               gnd: torch.Tensor, bits: int) -> torch.Tensor:
    """(Q, N) ``2·hamming + relevance`` words from ±1 codes and 0/1 ground
    truth; the distances come from an exact fp32 ±1 product."""
    d = calc_hamming_dist(q_codes, r_codes)
    return (2.0 * d + gnd).to(packed_dtype(bits))


def _split(words: torch.Tensor):
    w = words.long()
    return w >> 1, w & 1


def map_hist_plain(words: torch.Tensor, bits: int):
    """Pass 1 in plain torch: (Q, bits+1) int32 histograms of all and of
    relevant items per distance."""
    d, r = _split(words)
    shape = (words.shape[0], bits + 1)
    hist = torch.zeros(shape, dtype=torch.int64, device=words.device)
    rhist = torch.zeros_like(hist)
    hist.scatter_add_(1, d, torch.ones_like(d))
    rhist.scatter_add_(1, d, r)
    return hist.int(), rhist.int()


def map_ap_plain(words: torch.Tensor, less: torch.Tensor, less_r: torch.Tensor,
                 total: torch.Tensor, block: int = _AP_BLOCK) -> torch.Tensor:
    """Pass 2 in plain torch: (Q,) fp64 sums of R_rank/N_rank. The gallery
    goes in blocks; the counts of earlier blocks are carried per bucket, and
    the within-block tie prefix is a lower-triangular equality count."""
    d, r = _split(words)
    nq, n = words.shape
    eq = torch.zeros(less.shape, dtype=torch.int64, device=words.device)
    eqr = torch.zeros_like(eq)
    less, less_r = less.long(), less_r.long()
    tot = total.long()[:, None]
    acc = torch.zeros(nq, dtype=torch.float64, device=words.device)
    for s in range(0, n, block):
        db, rb = d[:, s:s + block], r[:, s:s + block]
        m = db.shape[1]
        tri = torch.ones((m, m), dtype=torch.bool, device=words.device).tril()
        same = (db[:, :, None] == db[:, None, :]) & tri       # [q, i, j]: j ≤ i, d_j == d_i
        within = same.sum(-1)
        within_r = (same & rb[:, None, :].bool()).sum(-1)
        n_rank = less.gather(1, db) + eq.gather(1, db) + within
        r_rank = less_r.gather(1, db) + eqr.gather(1, db) + within_r
        live = rb.bool() & (r_rank <= tot)
        q = r_rank.float() / n_rank.float()
        acc += torch.where(live, q, torch.zeros_like(q)).double().sum(1)
        eq.scatter_add_(1, db, torch.ones_like(db))
        eqr.scatter_add_(1, db, rb)
    return acc


def _lib():
    lib = _build.load("map")
    if lib.cmh_map_hist.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.cmh_map_hist.argtypes = [p, p, p, i, ll, i, i, i, p]
        lib.cmh_map_hist.restype = i
        lib.cmh_map_ap.argtypes = [p, p, p, p, p, i, ll, i, i, i, p]
        lib.cmh_map_ap.restype = i
        lib.cmh_map_max_buckets.argtypes = []
        lib.cmh_map_max_buckets.restype = i
    return lib


def _check_words(words: torch.Tensor, v: int, lib) -> None:
    if words.dim() != 2 or words.dtype not in (torch.uint8, torch.int16):
        raise TypeError("map kernels take a 2-D uint8 or int16 word matrix, "
                        f"got {words.dtype} {tuple(words.shape)}")
    if v > lib.cmh_map_max_buckets():
        raise ValueError(f"map kernels take at most "
                         f"{lib.cmh_map_max_buckets() - 1} bits, got {v - 1}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def map_hist(words: torch.Tensor, bits: int):
    """Pass 1: (hist, rhist), each (Q, bits+1) int32. On a CUDA tensor this
    launches K3-hist (counted in ``map_hist.launches``); on a CPU tensor it
    runs ``map_hist_plain``."""
    if words.device.type == "cpu":
        return map_hist_plain(words, bits)
    lib, v = _lib(), bits + 1
    _check_words(words, v, lib)
    words = words.contiguous()
    nq, n = words.shape
    out = torch.empty((2, nq, v), dtype=torch.int32, device=words.device)
    rc = lib.cmh_map_hist(words.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                          nq, n, v, int(words.dtype == torch.int16),
                          words.device.index or 0, _stream(words))
    _build.check(rc, "map_hist")
    map_hist.launches += 1
    return out[0], out[1]


def map_ap(words: torch.Tensor, less: torch.Tensor, less_r: torch.Tensor,
           total: torch.Tensor) -> torch.Tensor:
    """Pass 2: (Q,) fp64 sums of R_rank/N_rank. On a CUDA tensor this
    launches K3-ap (counted in ``map_ap.launches``); on a CPU tensor it runs
    ``map_ap_plain``."""
    if words.device.type == "cpu":
        return map_ap_plain(words, less, less_r, total)
    lib = _lib()
    nq, n = words.shape
    v = less.shape[1]
    _check_words(words, v, lib)
    if less.shape != (nq, v) or less_r.shape != (nq, v) or total.shape != (nq,):
        raise ValueError("less, less_r must be (Q, bits+1) and total (Q,)")
    words = words.contiguous()
    less, less_r, total = (t.to(torch.int32).contiguous()
                           for t in (less, less_r, total))
    ap = torch.empty(nq, dtype=torch.float64, device=words.device)
    rc = lib.cmh_map_ap(words.data_ptr(), less.data_ptr(), less_r.data_ptr(),
                        total.data_ptr(), ap.data_ptr(), nq, n, v,
                        int(words.dtype == torch.int16), words.device.index or 0,
                        _stream(words))
    _build.check(rc, "map_ap")
    map_ap.launches += 1
    return ap


map_hist.launches = 0
map_ap.launches = 0


def rank_counts(hist: torch.Tensor, rhist: torch.Tensor, k: Optional[int]):
    """Between the passes: strictly-smaller prefix counts and the per-query
    cap total = min(#relevant, k), all int32."""
    less = torch.cumsum(hist, dim=1, dtype=torch.int32) - hist
    less_r = torch.cumsum(rhist, dim=1, dtype=torch.int32) - rhist
    total = rhist.sum(1, dtype=torch.int32)
    if k is not None:
        total = torch.clamp(total, max=int(k))
    return less, less_r, total


def average_precision(words: torch.Tensor, bits: int, k: Optional[int]) -> torch.Tensor:
    """(Q,) fp64 AP of each query row of a word matrix; 0 where total is 0."""
    hist, rhist = map_hist(words, bits)
    less, less_r, total = rank_counts(hist, rhist, k)
    ap = map_ap(words, less, less_r, total)
    t = total.double()
    return torch.where(total > 0, ap / torch.clamp(t, min=1.0), torch.zeros_like(ap))

