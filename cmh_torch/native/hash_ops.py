"""ctypes binding of the host top-k by Hamming distance (``hash_ops.cpp``).

``hamming_topk`` is the exact top-k over packed uint32 codes with the
ascending-distance, lower-index tie order of ``RetrievalIndex.search`` on
the card; ``RetrievalIndex.search_cpu`` calls it. The library is built at
first use (``_build.py``) and refuses to load if its self-test fails.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import numpy as np

from . import _build


def _configure(lib: ctypes.CDLL) -> None:
    lib.hamming_topk.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int,
    ]
    lib.hamming_topk.restype = None


def _call(lib, query: np.ndarray, gallery: np.ndarray, k: int,
          n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    n_query, words = query.shape
    out_dist = np.empty((n_query, k), dtype=np.int32)
    out_idx = np.empty((n_query, k), dtype=np.int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.hamming_topk(
        query.ctypes.data_as(u32p), n_query, gallery.ctypes.data_as(u32p),
        gallery.shape[0], words, k,
        out_dist.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n_threads)
    return out_dist, out_idx


def _self_test(lib: ctypes.CDLL) -> bool:
    """A known case with a distance tie: gallery rows 1 and 2 are both at
    distance 1 from the query, and the lower index must come first, on one
    thread and on two."""
    query = np.asarray([[0b1010]], dtype=np.uint32)
    gallery = np.asarray([[0b0101], [0b1011], [0b1000], [0b1010]], dtype=np.uint32)
    return all(
        [d.tolist(), i.tolist()] == [[[0, 1, 1]], [[3, 1, 2]]]
        for d, i in (_call(lib, query, gallery, 3, t) for t in (1, 2)))


def library() -> ctypes.CDLL:
    return _build.load("hash_ops", _configure, _self_test)


def default_threads() -> int:
    """The threads ``n_threads=0`` gives: one per CPU the process may run on."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


def hamming_topk(query: np.ndarray, gallery: np.ndarray, k: int,
                 n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Exact top-k Hamming over packed uint32 codes (Q, W) × (N, W):
    (distances (Q, k) int32, indices (Q, k) int64), ascending distance, ties
    by lower gallery index. ``n_threads=0`` takes ``default_threads()``."""
    lib = library()
    query = np.ascontiguousarray(query, dtype=np.uint32)
    gallery = np.ascontiguousarray(gallery, dtype=np.uint32)
    if query.ndim != 2 or gallery.ndim != 2 or query.shape[1] != gallery.shape[1]:
        raise ValueError(f"query (Q, W) and gallery (N, W) packed words, got "
                         f"{query.shape} and {gallery.shape}")
    if not 0 < k <= gallery.shape[0]:
        raise ValueError(f"k={k} outside (0, {gallery.shape[0]}]")
    return _call(lib, query, gallery, k, n_threads or default_threads())
