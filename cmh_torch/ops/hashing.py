"""Hash activations, binarization and bit packing (counterpart of
``cmh_tpu/ops/hashing.py:30-121``).

``linear_subspace_hash`` (UMoED) maps each slot's 2^m logits to the ±1
codeword of its argmax: row i of ``subspace_codebook(m)`` is i in binary,
most significant bit first, 0 → −1.

Packed codes are int32 tensors holding the uint32 bit patterns that
``cmh_tpu`` packs (bit j of word w set iff code[:, 32w + j] > 0, K
zero-padded to a multiple of 32): PyTorch has no shift for uint32 on the
CPU, so shifts run on int64 values masked to 32 bits. ``as_uint32`` and
``from_uint32`` convert to and from numpy uint32 without changing a bit.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
SUPPORTED_SUBSPACE_BITS = (1, 2, 4, 8, 16)


def softmax_hash(embed: torch.Tensor, return_vector: bool = True) -> torch.Tensor:
    """Pairwise softmax relaxation over (B, 2K) or (..., K, 2)."""
    if embed.dim() == 2:
        embed = embed.reshape(embed.shape[0], -1, 2)
    elif embed.shape[-1] != 2:
        raise ValueError(
            f"softmax hash must input a shape of B,K,2. It is {tuple(embed.shape)}")
    probs = torch.softmax(embed, dim=-1)
    if return_vector:
        return probs.reshape(probs.shape[0], -1)
    return probs


def tanh_hash(embed: torch.Tensor) -> torch.Tensor:
    return torch.tanh(embed)


def subspace_codebook(bits: int) -> np.ndarray:
    """(2^bits, bits) float32 ±1 table: row i = i in binary, MSB first, 0 → −1."""
    if bits not in SUPPORTED_SUBSPACE_BITS:
        raise ValueError(f"linear_subspace_hash only supports code sizes "
                         f"{SUPPORTED_SUBSPACE_BITS}, got {bits}.")
    idx = np.arange(2**bits, dtype=np.uint32)
    shifts = np.arange(bits - 1, -1, -1, dtype=np.uint32)
    return ((idx[:, None] >> shifts[None, :]) & 1).astype(np.float32) * 2.0 - 1.0


def linear_subspace_hash(logits: torch.Tensor) -> torch.Tensor:
    """(B, T, 2^m) logits → (B, T·m) ±1 codes: each slot's argmax (the first
    maximum on a tie, as ``jnp.argmax``) gathered from the codebook."""
    batch, tokens, vocab = logits.shape
    bits = vocab.bit_length() - 1
    if 2**bits != vocab:
        raise ValueError(f"vocab size {vocab} is not a power of two")
    table = torch.from_numpy(subspace_codebook(bits)).to(logits.device)
    return table[torch.argmax(logits, dim=-1)].reshape(batch, tokens * bits)


def sign_code(code: torch.Tensor) -> torch.Tensor:
    """Continuous code → ±1, with 0 → +1."""
    one = torch.ones((), dtype=code.dtype, device=code.device)
    return torch.where(code >= 0, one, -one)


def pair_argmax_code(code: torch.Tensor) -> torch.Tensor:
    """Softmax-pair code (B, 2K) or (B, K, 2) → ±1 float32 (B, K): argmax
    over each pair (the first index on a tie), 0 → −1, 1 → +1."""
    if code.dim() == 2:
        code = code.reshape(code.shape[0], -1, 2)
    hard = torch.argmax(code, dim=-1)
    return hard.float() * 2.0 - 1.0


def pack_bits(codes: torch.Tensor) -> torch.Tensor:
    """±1 codes (N, K) → packed words (N, ceil(K/32)) as int32 bit patterns."""
    n, k = codes.shape
    words = -(-k // 32)
    bits = (codes > 0).to(torch.int64)
    if words * 32 - k:
        bits = torch.nn.functional.pad(bits, (0, words * 32 - k))
    shifts = torch.arange(32, dtype=torch.int64, device=codes.device)
    packed = (bits.reshape(n, words, 32) << shifts).sum(dim=-1)
    packed = torch.where(packed > 0x7FFFFFFF, packed - (1 << 32), packed)
    return packed.to(torch.int32)


def unpack_bits(packed: torch.Tensor, k: int) -> torch.Tensor:
    """Packed words (N, W) → ±1 float32 codes (N, k)."""
    n, w = packed.shape
    shifts = torch.arange(32, dtype=torch.int64, device=packed.device)
    bits = ((packed.to(torch.int64) & _MASK32)[:, :, None] >> shifts) & 1
    return bits.reshape(n, w * 32)[:, :k].float() * 2.0 - 1.0


def as_uint32(packed: torch.Tensor) -> np.ndarray:
    """int32 packed words → the same bits as a numpy uint32 array."""
    return packed.detach().cpu().numpy().view(np.uint32)


def from_uint32(packed: np.ndarray) -> torch.Tensor:
    """numpy uint32 packed words → the same bits as an int32 tensor."""
    arr = np.ascontiguousarray(packed, dtype=np.uint32)
    return torch.from_numpy(arr.view(np.int32).copy())
