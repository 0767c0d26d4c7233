"""Retrieval serving: packed-code index with exact top-k search.

Counterpart of ``cmh_tpu/serving.py:RetrievalIndex`` (single device). The
gallery is held as 32-bit packed words on the index's device; a search
scores the queries against blocks of ``_DEVICE_BLOCK`` gallery rows with
kernel K4 (``ops/hamming.py``), so the (Q, N) distance matrix never exists
whole, and keeps each block's best ``topk`` candidates.

Ties go to the lower gallery index, as ``lax.top_k`` orders them in
cmh_tpu: candidates are ranked on the unique int64 key ``dist·N + index``
(the same key as cmh_tpu's ``search_cpu``), so the per-block selection and
the final merge can never trade a lower-index tie for a higher one. The
top-k itself is plain PyTorch, as cmh_tpu does it in XLA outside any
kernel.

``search_cpu`` answers the same top-k on the host CPU, for a deployment
host without a card, through the port's copy of cmh_tpu's native scorer
(``native/hash_ops.cpp``, built with g++ at first use; a failed build
raises, nothing falls back). ``search_cpu_plain`` is cmh_tpu's numpy path,
the plain version the tests hold it against.

``search(devices=[...])`` shards the gallery over devices (cmh_tpu's
``search(mesh=)``, ``serving.py:479-607``); the HTTP server stays one card
a process, as cmh_tpu's does.

``save``/``load`` use cmh_tpu's npz layout (uint32 ``packed``, ``bits``,
``count``), so an index written by either package loads in the other.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import resolve_device
from .ops.hamming import hamming_packed
from .ops.hashing import as_uint32, from_uint32, pack_bits

# gallery block rows: bounds the live distance tile at (Q, block)
_DEVICE_BLOCK = 1 << 20
# gallery rows a block of the numpy search (cmh_tpu serving._FALLBACK_BLOCK)
_PLAIN_BLOCK = 1 << 16


def topk_blocked(q_packed: torch.Tensor, g_packed: torch.Tensor, topk: int,
                 block: int, bits: int = 0, offset: int = 0,
                 n_total: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by Hamming distance over ``g_packed`` in gallery blocks
    of ``block`` rows: (dist, idx), each (Q, topk) int64, ascending
    distance, ties by lower index. ``g_packed`` may be the rows from
    ``offset`` of a gallery of ``n_total`` rows (a shard): the indices are
    then the gallery's."""
    n = n_total or g_packed.shape[0]
    cand = []
    for start in range(0, g_packed.shape[0], block):
        d = hamming_packed(q_packed, g_packed[start:start + block], bits=bits)
        idx = torch.arange(offset + start, offset + start + d.shape[1], device=d.device)
        key = d.to(torch.int64) * n + idx
        cand.append(torch.topk(key, min(topk, key.shape[1]), dim=1,
                               largest=False, sorted=True).values)
    keys = cand[0] if len(cand) == 1 else _smallest(torch.cat(cand, dim=1), topk)
    return keys // n, keys % n


def _smallest(keys: torch.Tensor, topk: int) -> torch.Tensor:
    return torch.topk(keys, min(topk, keys.shape[1]), dim=1, largest=False,
                      sorted=True).values


class RetrievalIndex:
    """Append-only binary-code index over one modality's gallery."""

    def __init__(self, bits: int, device="cuda"):
        self.bits = bits
        self.device = resolve_device(device)
        self._chunks = []
        self._packed: Optional[torch.Tensor] = None
        # the gallery's packed words on the host, for search_cpu
        self._host_packed: Optional[np.ndarray] = None
        self._lock = threading.Lock()
        self._count = 0
        # devices → [(device, first row, the shard's packed rows)], until the next add
        self._shards = {}

    def __len__(self) -> int:
        return self._count

    def add(self, codes) -> None:
        """Add ±1 codes (N, bits) (numpy or tensor) to the gallery."""
        codes = torch.as_tensor(codes, dtype=torch.float32, device=self.device)
        if codes.dim() != 2 or codes.shape[1] != self.bits:
            raise ValueError(f"codes must be (N, {self.bits}), got "
                             f"{tuple(codes.shape)}")
        with self._lock:
            self._chunks.append(pack_bits(codes))
            self._count += codes.shape[0]
            self._packed = None
            self._host_packed = None
            self._shards.clear()

    def _gallery(self) -> torch.Tensor:
        with self._lock:
            if self._packed is None:
                if not self._chunks:
                    raise ValueError("index is empty")
                self._packed = torch.cat(self._chunks, dim=0)
                self._chunks = [self._packed]
            return self._packed

    def search(self, query_codes, topk: int = 10, block: Optional[int] = None,
               devices: Optional[Sequence] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k by Hamming distance: (distances (Q, topk) int32,
        indices (Q, topk) int32) in ascending-distance order, ties by
        insertion order. Bit-equal to cmh_tpu's ``search``.

        With ``devices`` (cmh_tpu's ``search(mesh=)``), the gallery is split
        once into even shards of ⌈N / len(devices)⌉ rows, one on each device
        in turn (a device may be named twice), kept until the next ``add``;
        each shard runs K4 and its own top-k with the gallery's indices, and
        the candidates, in shard order, are merged on the first device on
        the unique key distance·N + index, so the results are the unsharded
        search's bit for bit."""
        q = torch.as_tensor(query_codes, dtype=torch.float32, device=self.device)
        if q.dim() != 2 or q.shape[1] != self.bits:
            raise ValueError(f"queries must be (Q, {self.bits}), got "
                             f"{tuple(q.shape)}")
        if not 0 < topk <= self._count:
            raise ValueError(f"topk={topk} outside (0, {self._count}]")
        block = _DEVICE_BLOCK if block is None else block
        qp = pack_bits(q)
        if devices:
            n = self._count
            shards = self._sharded(devices)
            first = shards[0][0]
            keys = [(d * n + i).to(first) for d, i in (
                topk_blocked(qp.to(dev), rows, topk, block, self.bits, offset=start, n_total=n)
                for dev, start, rows in shards)]
            keys = _smallest(torch.cat(keys, dim=1), topk)
            dist, idx = keys // n, keys % n
        else:
            dist, idx = topk_blocked(qp, self._gallery(), topk, block, self.bits)
        return (dist.to(torch.int32).cpu().numpy(),
                idx.to(torch.int32).cpu().numpy())

    def _sharded(self, devices: Sequence):
        """The gallery's shards over ``devices``, split once until the next
        ``add``: a device that holds the gallery gets views of its rows."""
        key = tuple(str(resolve_device(d)) for d in devices)
        gallery = self._gallery()
        with self._lock:
            if key not in self._shards:
                n = gallery.shape[0]
                per = -(-n // len(key))
                self._shards[key] = [(torch.device(d), i * per, gallery[i * per:(i + 1) * per].to(d))
                                     for i, d in enumerate(key) if i * per < n]
            return self._shards[key]

    def search_cpu(self, query_codes, topk: int = 10, n_threads: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k on the host CPU: (distances (Q, topk) int32, indices
        (Q, topk) int64), the results and tie order of ``search``, from a
        host copy of the packed gallery kept beside the device one. Scored
        by the native scorer (``native/hash_ops.cpp``), threaded over
        queries, or over the gallery when there are fewer queries than
        threads; ``n_threads=0`` takes one per CPU."""
        from .native import hash_ops

        q = np.asarray(torch.as_tensor(query_codes, dtype=torch.float32).cpu())
        if q.ndim != 2 or q.shape[1] != self.bits:
            raise ValueError(f"queries must be (Q, {self.bits}), got {q.shape}")
        if not 0 < topk <= self._count:
            raise ValueError(f"topk={topk} outside (0, {self._count}]")
        qp = as_uint32(pack_bits(torch.from_numpy(q)))
        return hash_ops.hamming_topk(qp, self._host_gallery(), topk, n_threads)

    def _host_gallery(self) -> np.ndarray:
        gallery = self._gallery()
        with self._lock:
            if self._host_packed is None:
                self._host_packed = np.ascontiguousarray(as_uint32(gallery))
            return self._host_packed

    def save(self, path: str) -> None:
        np.savez(path, packed=as_uint32(self._gallery()), bits=self.bits,
                 count=self._count)

    @classmethod
    def load(cls, path: str, device="cuda") -> "RetrievalIndex":
        data = np.load(path)
        index = cls(int(data["bits"]), device=device)
        index._chunks = [from_uint32(data["packed"]).to(index.device)]
        index._count = int(data["count"])
        return index


def search_cpu_plain(q_packed: np.ndarray, gallery: np.ndarray, topk: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """``search_cpu``'s function in numpy (cmh_tpu ``serving.py:630-656``):
    a byte-table popcount, blocked over the gallery so the (Q, block, bytes)
    intermediate stays bounded; candidates are ranked on the unique key
    dist·N + index, so a block's selection never trades a lower-index tie
    for a higher one. (dist int32, idx int64), each (Q, topk)."""
    lut = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                        axis=1).sum(axis=1).astype(np.int32)
    qb = np.ascontiguousarray(q_packed, np.uint32).view(np.uint8).reshape(len(q_packed), -1)
    gallery = np.ascontiguousarray(gallery, np.uint32)
    nq, n_total = qb.shape[0], gallery.shape[0]
    block = max(topk, _PLAIN_BLOCK)
    cand = np.empty((nq, 0), np.int64)
    for start in range(0, n_total, block):
        gb = gallery[start:start + block].view(np.uint8).reshape(
            min(block, n_total - start), -1)
        dist = lut[qb[:, None, :] ^ gb[None, :, :]].sum(axis=-1, dtype=np.int32)
        key = dist.astype(np.int64) * n_total + np.arange(
            start, start + dist.shape[1], dtype=np.int64)[None, :]
        kk = min(topk, key.shape[1])
        part = np.argpartition(key, kk - 1, axis=1)[:, :kk]
        cand = np.concatenate([cand, np.take_along_axis(key, part, axis=1)], axis=1)
    cand = np.sort(cand, axis=1)[:, :topk]
    return (cand // n_total).astype(np.int32), cand % n_total
