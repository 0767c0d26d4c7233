"""Operations and bytes from shapes, and the table of peaks they are held to.

Peaks are one NVIDIA H100 SXM's, from NVIDIA's data sheet (dense, no
sparsity): bf16 989 TFLOP/s on the tensor cores, fp32 67 TFLOP/s outside
them (an FMA counted as two), HBM 3.35 TB/s. 32-bit integer work issues at
one warp instruction a clock a sub-partition: 132 SMs x 128 thread
instructions x 1.98 GHz (the card's highest SM clock).

A kernel's bound time is the larger of its operations over the peak for
their type and its bytes over the bandwidth, counting each input byte read
once and each output byte written once. For causal and padded attention
only the (query, key) pairs the valid rows need are counted.

Model FLOPs count each product of a tower or a head once forward and, in
training, once more for each operand that needs a gradient; nothing is
counted twice for recomputation.
"""

from __future__ import annotations

from typing import Optional, Sequence

PEAK = {"bf16": 989e12, "fp32": 67e12, "int32": 132 * 128 * 1.98e9}
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, ops: float, kind: str) -> float:
    """The least time the card takes for ``ops`` operations of ``kind``
    and ``nbytes`` bytes of memory traffic."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK[kind])


# ------------------------------------------------------------------ kernels
def k1_fwd(rows: int, d: int, esize: int):
    """LayerNorm forward at (rows, d): x read, y written, gamma and beta
    (fp32) read; about 8 fp32 operations an element."""
    return 2 * rows * d * esize + 2 * d * 4, 8 * rows * d, "fp32"


def k1_bwd(rows: int, d: int, esize: int):
    """LayerNorm backward: x, dy and gamma read, dx, dgamma and dbeta
    written; about 12 fp32 operations an element."""
    return 3 * rows * d * esize + 3 * d * 4, 12 * rows * d, "fp32"


def attention_pairs(b: int, s: int, causal: bool,
                    lengths: Optional[Sequence[int]] = None) -> int:
    """(query, key) pairs the inputs need, summed over the batch: every
    pair without masks; (i, j) with j <= i under a causal mask; and with a
    key-padding mask only the first ``lengths[r]`` rows of row r, whose
    keys are valid."""
    if lengths is None:
        per = s * (s + 1) // 2 if causal else s * s
        return b * per
    if causal:
        return sum(n * (n + 1) // 2 for n in lengths)
    return sum(n * n for n in lengths)


def k2_fwd(b: int, h: int, s: int, hd: int, esize: int, mask: bool, bias: bool,
           lengths: Optional[Sequence[int]] = None):
    """Attention forward: q, k, v read and the output written; the (S, S)
    mask and the (B, S) key bias, fp32, read once; QK^T and PV two FMAs a
    pair and head dimension."""
    nbytes = 4 * b * h * s * hd * esize + (s * s * 4 if mask else 0) + (b * s * 4 if bias else 0)
    pairs = attention_pairs(b, s, mask, lengths if bias else None)
    return nbytes, 4 * h * hd * pairs, "bf16" if esize == 2 else "fp32"


def k2_bwd(b: int, h: int, s: int, hd: int, esize: int, mask: bool, bias: bool,
           lengths: Optional[Sequence[int]] = None):
    """Attention backward: q, k, v and dout read, dq, dk, dv written, the
    masks read; five products a pair (the logits again, dV, dP, dQ, dK)."""
    nbytes = 7 * b * h * s * hd * esize + (s * s * 4 if mask else 0) + (b * s * 4 if bias else 0)
    pairs = attention_pairs(b, s, mask, lengths if bias else None)
    return nbytes, 10 * h * hd * pairs, "bf16" if esize == 2 else "fp32"


def k3_hist(q: int, n: int, wsize: int, v: int, segments: int):
    """mAP pass 1: the (Q, N) word matrix read, the two (Q, S, V) int32
    histograms written; a compare and an add an item."""
    return q * n * wsize + 2 * q * segments * v * 4, 2 * q * n, "fp32"


def k3_ap(q: int, n: int, wsize: int, v: int, segments: int):
    """mAP pass 2: the words, both (Q, S, V) starting counters and the (Q,)
    totals read, the (Q, S) fp64 partial sums written; four operations an
    item."""
    return (q * n * wsize + 2 * q * segments * v * 4 + q * 4 + q * segments * 8,
            4 * q * n, "fp32")


def k4(nq: int, ng: int, words: int, out_esize: int):
    """Packed Hamming distances: both code sets read, the (Q, N) distances
    written; an xor, a popcount and an add a word pair, 32-bit integer
    work."""
    return (nq + ng) * words * 4 + nq * ng * out_esize, 3 * nq * ng * words, "int32"


# ------------------------------------------------------------------- towers
def _block(tokens: int, width: int, attn_tokens: int, causal: bool) -> float:
    """One residual block's forward FLOPs: the in-, out-, fc and proj
    products (24 t w^2) and QK^T and PV over every (query, key) pair the
    block computes."""
    pairs = attn_tokens * (attn_tokens + 1) // 2 if causal else attn_tokens * attn_tokens
    return 24.0 * tokens * width * width + 4.0 * pairs * width


def vision_forward(clip: dict) -> float:
    """Image tower forward FLOPs for one image: patch embedding, the
    blocks, and the projection of every token."""
    g = clip["image_resolution"] // clip["vision_patch_size"]
    s = g * g + 1
    w = clip["vision_width"]
    patch = 2.0 * g * g * 3 * clip["vision_patch_size"] ** 2 * w
    # the port computes every block's attention with S x S pairs
    blocks = clip["vision_layers"] * _block(s, w, s, causal=False)
    return patch + blocks + 2.0 * s * w * clip["embed_dim"]


def text_forward(clip: dict, tokens: int) -> float:
    """Text tower forward FLOPs for one caption of ``tokens`` positions
    (the padded length, as the tower runs it), causal attention."""
    w = clip["transformer_width"]
    blocks = clip["transformer_layers"] * _block(tokens, w, tokens, causal=True)
    return blocks + 2.0 * tokens * w * clip["embed_dim"]


def pair_forward(clip: dict, tokens: int, heads: float) -> float:
    """Forward FLOPs of one image-text pair through both towers, with
    ``heads`` the method's heads' forward FLOPs for the pair
    (``methods/<method>.py``'s ``head_flops``)."""
    return vision_forward(clip) + text_forward(clip, tokens) + heads


def pair_train(clip: dict, tokens: int, heads: float) -> float:
    """Forward and backward FLOPs of one training pair: every product
    three times (forward, the gradient of each operand) except the patch
    embedding, whose input, the image, takes no gradient."""
    g = clip["image_resolution"] // clip["vision_patch_size"]
    patch = 2.0 * g * g * 3 * clip["vision_patch_size"] ** 2 * clip["vision_width"]
    return 3.0 * pair_forward(clip, tokens, heads) - patch
