"""Counting-rank mAP over Hamming rankings (kernels K3-hist and K3-ap).

Counterpart of ``cmh_tpu/ops/map_pallas.py``. Hamming distances are integers
in [0, bits], so each item's rank under the stable ordering (distance
ascending, ties by gallery index) is counted instead of sorted:

    N_rank(i) = #{j : d_j < d_i} + #{j ≤ i : d_j == d_i}
    R_rank(i) = the same counts over relevant items
    AP = (1/total) · Σ_{relevant i, R_rank(i) ≤ total} R_rank(i) / N_rank(i)

with total = min(#relevant, k). Each (query, item) pair is one word
``2·d + relevance``: uint8 up to 126 bits, int16 above.

Each row of N items is cut into S = ⌈N / L⌉ segments of L items
(``segment_len``), so that the card can give every (row, segment) pair a
warp of its own. Pass 1 (K3-hist) counts per-segment histograms of all and
of relevant items, (Q, S, bits+1). Between the passes, ``rank_counts`` forms
in plain torch, as cmh_tpu does outside Pallas, each segment's starting
counters: the items of the row at a smaller distance plus the items at the
same distance in earlier segments (``start``, and ``start_r`` over relevant
items), and ``total``. Pass 2 (K3-ap) walks each segment from its starting
counters and gives one fp64 partial sum a segment, added over S in a fixed
order. A CUDA tensor launches the kernels in ``csrc/map.cu``; a CPU tensor
takes ``map_hist_plain`` and ``map_ap_plain``, which take the same split for
any L ≥ 1 (L ≥ N is a single segment). Each contribution is the fp32
quotient R/N, summed in fp64 by the kernel and the plain version alike.

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
TILE_BYTES = 512            # one warp-wide load of K3: 16 bytes a lane
MIN_SEGMENT = 4096          # items: eight tiles of uint8 words


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


def segment_len(bits: int) -> int:
    """Gallery items per segment, L: whole 512-byte tiles, at least
    ``MIN_SEGMENT`` and at least 4·V (V = bits + 1), so that each pass
    handles at most one counter of a segment (2·V of them: zeroed, summed
    and written by pass 1, read by pass 2) for every two of its items. So
    L is 4,096 up to 1,023 bits, and 16,384 at 4,094. Longer segments would
    leave the few rows of a wide code's chunk too few warps."""
    tile = TILE_BYTES // (torch.iinfo(packed_dtype(bits)).bits // 8)
    need = max(MIN_SEGMENT, 4 * (bits + 1))
    return -(-need // tile) * tile


def pack_words(q_codes: torch.Tensor, r_codes: torch.Tensor,
               gnd: torch.Tensor, bits: int) -> torch.Tensor:
    """(Q, N) ``2·hamming + relevance`` words from ±1 codes and 0/1 ground
    truth; the distances come from an exact fp32 ±1 product."""
    d = calc_hamming_dist(q_codes, r_codes)
    return (2.0 * d + gnd).to(packed_dtype(bits))


def _split(words: torch.Tensor):
    w = words.long()
    return w >> 1, w & 1


def _segments(n: int, seg_len: int) -> int:
    if seg_len < 1:
        raise ValueError(f"segment length must be at least 1, got {seg_len}")
    return -(-n // seg_len)


def map_hist_plain(words: torch.Tensor, bits: int, seg_len: Optional[int] = None):
    """Pass 1 in plain torch: (Q, S, bits+1) int32 histograms of all and of
    relevant items per segment of ``seg_len`` items (``segment_len(bits)``
    by default) and distance."""
    d, r = _split(words)
    nq, n = words.shape
    seg_len = segment_len(bits) if seg_len is None else seg_len
    s, v = _segments(n, seg_len), bits + 1
    idx = d + v * (torch.arange(n, device=words.device) // seg_len)
    hist = torch.zeros((nq, s * v), dtype=torch.int64, device=words.device)
    rhist = torch.zeros_like(hist)
    hist.scatter_add_(1, idx, torch.ones_like(d))
    rhist.scatter_add_(1, idx, r)
    return hist.view(nq, s, v).int(), rhist.view(nq, s, v).int()


def map_ap_plain(words: torch.Tensor, start: torch.Tensor, start_r: torch.Tensor,
                 total: torch.Tensor, seg_len: Optional[int] = None,
                 block: int = _AP_BLOCK) -> torch.Tensor:
    """Pass 2 in plain torch: (Q,) fp64 sums of R_rank/N_rank. Each segment
    starts from its counters ``start``/``start_r`` (Q, S, V) and goes in
    blocks; the counts of earlier blocks are carried per bucket, and the
    within-block tie prefix is a lower-triangular equality count. The
    segments' partial sums are added over S."""
    d, r = _split(words)
    nq, n = words.shape
    seg_len = segment_len(start.shape[2] - 1) if seg_len is None else seg_len
    tot = total.long()[:, None]
    parts = torch.zeros((nq, _segments(n, seg_len)), dtype=torch.float64, device=words.device)
    for s in range(parts.shape[1]):
        eq, eqr = start[:, s].long(), start_r[:, s].long()
        stop = min(n, (s + 1) * seg_len)
        for b in range(s * seg_len, stop, block):
            db, rb = d[:, b:min(b + block, stop)], r[:, b:min(b + block, stop)]
            m = db.shape[1]
            tri = torch.ones((m, m), dtype=torch.bool, device=words.device).tril()
            same = (db[:, :, None] == db[:, None, :]) & tri       # [q, i, j]: j ≤ i, d_j == d_i
            n_rank = eq.gather(1, db) + same.sum(-1)
            r_rank = eqr.gather(1, db) + (same & rb[:, None, :].bool()).sum(-1)
            live = rb.bool() & (r_rank <= tot)
            q = r_rank.float() / n_rank.float()
            parts[:, s] += torch.where(live, q, torch.zeros_like(q)).double().sum(1)
            eq = eq.scatter_add(1, db, torch.ones_like(db))
            eqr = eqr.scatter_add(1, db, rb)
    return parts.sum(1)


def _lib():
    lib = _build.load("map")
    if lib.cmh_map_hist.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.cmh_map_hist.argtypes = [p, p, p, i, ll, i, i, i, i, p]
        lib.cmh_map_hist.restype = i
        lib.cmh_map_ap.argtypes = [p, p, p, p, p, i, ll, i, i, i, i, p]
        lib.cmh_map_ap.restype = i
        lib.cmh_map_max_buckets.argtypes = []
        lib.cmh_map_max_buckets.restype = i
        lib.cmh_map_max_segment.argtypes = []
        lib.cmh_map_max_segment.restype = i
    return lib


def _check_words(words: torch.Tensor, v: int, seg_len: int, lib) -> None:
    if words.dim() != 2 or words.dtype not in (torch.uint8, torch.int16):
        raise TypeError("map kernels take a 2-D uint8 or int16 word matrix, "
                        f"got {words.dtype} {tuple(words.shape)}")
    if v > lib.cmh_map_max_buckets():
        raise ValueError(f"map kernels take at most "
                         f"{lib.cmh_map_max_buckets() - 1} bits, got {v - 1}")
    if not 1 <= seg_len <= lib.cmh_map_max_segment():
        raise ValueError(f"map kernels take segments of 1 to "
                         f"{lib.cmh_map_max_segment()} items, got {seg_len}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def map_hist(words: torch.Tensor, bits: int, seg_len: Optional[int] = None):
    """Pass 1: (seg_hist, seg_rhist), each (Q, S, bits+1) int32, for
    segments of ``seg_len`` items (``segment_len(bits)`` by default). On a
    CUDA tensor this launches K3-hist (counted in ``map_hist.launches``); on
    a CPU tensor it runs ``map_hist_plain``."""
    if words.device.type == "cpu":
        return map_hist_plain(words, bits, seg_len)
    lib, v = _lib(), bits + 1
    seg_len = segment_len(bits) if seg_len is None else seg_len
    _check_words(words, v, seg_len, lib)
    words = words.contiguous()
    nq, n = words.shape
    out = torch.empty((2, nq, _segments(n, seg_len), v), dtype=torch.int32,
                      device=words.device)
    rc = lib.cmh_map_hist(words.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                          nq, n, v, seg_len, int(words.dtype == torch.int16),
                          words.device.index or 0, _stream(words))
    _build.check(rc, "map_hist")
    map_hist.launches += 1
    return out[0], out[1]


def map_ap(words: torch.Tensor, start: torch.Tensor, start_r: torch.Tensor,
           total: torch.Tensor, seg_len: Optional[int] = None) -> torch.Tensor:
    """Pass 2: (Q,) fp64 sums of R_rank/N_rank, from each segment's starting
    counters (``rank_counts``). On a CUDA tensor this launches K3-ap
    (counted in ``map_ap.launches``), which gives one partial sum a
    segment, and adds them over S; on a CPU tensor it runs
    ``map_ap_plain``."""
    if words.device.type == "cpu":
        return map_ap_plain(words, start, start_r, total, seg_len)
    lib = _lib()
    nq, n = words.shape
    v = start.shape[-1]
    seg_len = segment_len(v - 1) if seg_len is None else seg_len
    _check_words(words, v, seg_len, lib)
    s = _segments(n, seg_len)
    if start.shape != (nq, s, v) or start_r.shape != (nq, s, v) or total.shape != (nq,):
        raise ValueError(f"start, start_r must be (Q, S, bits+1) = {(nq, s, v)} and total "
                         f"(Q,), got {tuple(start.shape)}, {tuple(start_r.shape)}, "
                         f"{tuple(total.shape)}")
    words = words.contiguous()
    start, start_r, total = (t.to(torch.int32).contiguous()
                             for t in (start, start_r, total))
    part = torch.empty((nq, s), dtype=torch.float64, device=words.device)
    rc = lib.cmh_map_ap(words.data_ptr(), start.data_ptr(), start_r.data_ptr(),
                        total.data_ptr(), part.data_ptr(), nq, n, v, seg_len,
                        int(words.dtype == torch.int16), words.device.index or 0,
                        _stream(words))
    _build.check(rc, "map_ap")
    map_ap.launches += 1
    return part.sum(1)


map_hist.launches = 0
map_ap.launches = 0


def rank_counts(seg_hist: torch.Tensor, seg_rhist: torch.Tensor, k: Optional[int]):
    """Between the passes, from the (Q, S, V) per-segment histograms: each
    segment's starting counters ``start`` = (items of the row at a smaller
    distance) + (items at the same distance in earlier segments) and
    ``start_r`` the same over relevant items, both (Q, S, V), and the
    per-query cap total = min(#relevant, k), (Q,); all int32."""
    both = torch.stack((seg_hist, seg_rhist))            # (2, Q, S, V)
    rows = both.sum(2, dtype=torch.int32)                # (2, Q, V)
    less = torch.cumsum(rows, dim=2, dtype=torch.int32) - rows
    start = less[:, :, None] + torch.cumsum(both, dim=2, dtype=torch.int32) - both
    total = rows[1].sum(1, dtype=torch.int32)
    if k is not None:
        total = torch.clamp(total, max=int(k))
    return start[0], start[1], total


def average_precision(words: torch.Tensor, bits: int, k: Optional[int]) -> torch.Tensor:
    """(Q,) fp64 AP of each query row of a word matrix; 0 where total is 0."""
    seg_len = segment_len(bits)
    start, start_r, total = rank_counts(*map_hist(words, bits, seg_len), k)
    ap = map_ap(words, start, start_r, total, seg_len)
    t = total.double()
    return torch.where(total > 0, ap / torch.clamp(t, min=1.0), torch.zeros_like(ap))
