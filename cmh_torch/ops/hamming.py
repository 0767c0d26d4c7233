"""Hamming distances between packed codes (kernel K4).

Counterpart of ``cmh_tpu/ops/hamming_pallas.py:hamming_packed``: (Q, W) ×
(N, W) packed words → (Q, N) ``Σ_w popcount(q_w XOR g_w)``. Words are int32
tensors holding uint32 bit patterns (``ops/hashing.py``). The output is
uint8 when the true code length ``bits`` is at most 255 (which includes
225–255-bit codes padded to 8 words) and int32 above that; torch's uint16
lacks most operations. A CUDA tensor launches the hand-written kernel in
``csrc/hamming.cu``; a CPU tensor takes ``hamming_plain``. The kernel reads
any 4-byte-aligned gallery view (a row slice of a larger gallery) in place
and writes every output row at whatever alignment it starts; the wrapper
only chooses how many queries a block takes (``query_tile``), from the
launch geometry the library reports for the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import trace
from . import _build

_MAX_WORDS = 384
_MAX_QUERIES = 65535 * 32
# the query tile (query_tile); _SUB_Q and _MAX_TILE_Q are csrc/hamming.cu's
# kSubQ and kMaxTileQ
_SUB_Q = 8
_MAX_TILE_Q = 64              # one tile covers a request's queries
_TILE_Q_WORDS = 16384         # a block's query words, at most 64 KB of shared memory
_WAVES = 1.0                  # split queries until the grid fills this many resident waves


def out_dtype(bits: int, words: int) -> torch.dtype:
    max_d = bits if 0 < bits <= 32 * words else 32 * words
    return torch.uint8 if max_d <= 255 else torch.int32


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 values that hold 32-bit words."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (v * 0x01010101 & 0xFFFFFFFF) >> 24


def hamming_plain(q_packed: torch.Tensor, g_packed: torch.Tensor,
                  bits: int = 0) -> torch.Tensor:
    """The kernel's function in plain PyTorch (int64 widening, masked to
    32 bits before any shift)."""
    q = q_packed.to(torch.int64) & 0xFFFFFFFF
    g = g_packed.to(torch.int64) & 0xFFFFFFFF
    d = _popcount32(q[:, None, :] ^ g[None, :, :]).sum(dim=-1)
    return d.to(out_dtype(bits, q_packed.shape[1]))


def _lib():
    lib = _build.load("hamming")
    if lib.cmh_hamming.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cmh_hamming.argtypes = [p, p, p, i, i, i, i, i, i, p]
        lib.cmh_hamming.restype = i
        lib.cmh_hamming_geometry.argtypes = [i, i, i, i, ctypes.POINTER(i)]
        lib.cmh_hamming_geometry.restype = None
    return lib


@functools.lru_cache(maxsize=None)
def _geometry(lib, index: int, out_u8: bool, words: int):
    """(gallery rows a block, blocks the card holds at once) of the kernel
    for (out_u8, words): the SM count times the blocks an SM holds, at the
    largest query tile's shared memory."""
    geo = (ctypes.c_int * 2)()
    lib.cmh_hamming_geometry(int(out_u8), words, _tile_cap(words), index, geo)
    if geo[1] < 1:
        raise RuntimeError(f"hamming: no resident block for {words} words")
    return geo[0], geo[1] * torch.cuda.get_device_properties(index).multi_processor_count


def _tile_cap(words: int) -> int:
    return max(_SUB_Q, min(_MAX_TILE_Q, _TILE_Q_WORDS // words // _SUB_Q * _SUB_Q))


def query_tile(nq: int, ng: int, words: int, rows_per_block: int, resident: int) -> int:
    """Queries a block takes (grid.y is ceil(nq / tile)): all of them up to
    64, fewer for codes so wide that their words would pass 64 KB, halved
    (not below 8) while the grid of ``rows_per_block``-row gallery tiles has
    fewer blocks than ``_WAVES`` times the ``resident`` blocks the card
    holds at once."""
    tile = min(nq, _tile_cap(words))
    blocks_x = -(-ng // rows_per_block)
    while tile > _SUB_Q and blocks_x * -(-nq // tile) < _WAVES * resident:
        tile = max(_SUB_Q, tile // 2)
    return tile


def _launch(q: torch.Tensor, g: torch.Tensor, bits: int) -> torch.Tensor:
    nq, w = q.shape
    ng = g.shape[0]
    if w > _MAX_WORDS or nq > _MAX_QUERIES or ng > 2**31 - 1:
        raise ValueError(f"hamming kernel takes at most {_MAX_WORDS} words, "
                         f"{_MAX_QUERIES} queries and 2^31 - 1 gallery rows, "
                         f"got {w}, {nq} and {ng}")
    # a row slice of the gallery stays a view: the kernel reads any
    # 4-byte-aligned start
    q, g = q.contiguous(), g.contiguous()
    dt = out_dtype(bits, w)
    u8 = dt == torch.uint8
    out = torch.empty((nq, ng), dtype=dt, device=q.device)
    index = q.device.index or 0
    lib = _lib()
    tile = query_tile(nq, ng, w, *_geometry(lib, index, u8, w))
    rc = lib.cmh_hamming(q.data_ptr(), g.data_ptr(), out.data_ptr(), nq, ng, w, int(u8), tile,
                         index, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "hamming")
    hamming_packed.launches += 1
    return out


def hamming_packed(q_packed: torch.Tensor, g_packed: torch.Tensor,
                   bits: int = 0) -> torch.Tensor:
    """(Q, N) Hamming distances between packed codes.

    ``bits`` is the true code length when known (defaults to 32·W); it
    picks the output type. Pad bits must be 0 in both operands, as
    ``pack_bits`` leaves them. On a CUDA tensor this launches the kernel
    (counted in ``hamming_packed.launches``); on a CPU tensor it runs
    ``hamming_plain``. Under a profiler either is the span ``cmh.k4`` with
    (Q, N, words, the distances' element size)."""
    if q_packed.dim() != 2 or g_packed.dim() != 2:
        raise ValueError("packed codes must be 2-D (rows, words)")
    if q_packed.shape[1] != g_packed.shape[1]:
        raise ValueError(f"word-width mismatch: {q_packed.shape[1]} vs "
                         f"{g_packed.shape[1]}")
    if q_packed.dtype != torch.int32 or g_packed.dtype != torch.int32:
        raise TypeError("packed codes are int32 bit patterns (ops/hashing.py)")
    if q_packed.device != g_packed.device:
        raise ValueError("queries and gallery must be on one device")
    (nq, w), ng = q_packed.shape, g_packed.shape[0]
    with trace.span("k4", (nq, ng, w, out_dtype(bits, w).itemsize)):
        if q_packed.device.type == "cpu":
            return hamming_plain(q_packed, g_packed, bits)
        if q_packed.device.type != "cuda":
            raise ValueError(f"no hamming kernel for device {q_packed.device}")
        return _launch(q_packed, g_packed, bits)


hamming_packed.launches = 0
