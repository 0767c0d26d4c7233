"""Self-attention (kernels K2-fwd, K2-bwd).

Counterpart of ``cmh_tpu/ops/attention_pallas.py:fused_attention`` and its
``custom_vjp``: softmax(scale·QKᵀ + mask + key-padding bias)·V over
(B, H, S, hd), with fp32 logits and softmax and the probabilities rounded to
the compute dtype before the PV product. The backward recomputes the
softmax and uses the UNROUNDED fp32 probabilities for dV, as the Pallas
backward does; autograd of the forward would differentiate through the
rounding instead. A CUDA tensor launches the hand-written kernels; a CPU
tensor takes ``attention_plain`` and ``attention_bwd_plain``.

Two CUDA routes, chosen by S alone (``route``):

- one block per (batch, head), ``csrc/attention.cu``, for S up to
  ``BF16_MAX_S`` in bf16 and, in fp32, while the (batch, head) fits in
  shared memory (``one_block_smem``). In bf16 they run on the tensor cores
  (the forward's logits on the CUDA cores, so that P rounds to bf16 as in
  the plain version), read q, k, v and dout where they lie (the strided
  head views of a packed projection) and write their outputs in
  (B, S, H, hd) memory, returned as (B, H, S, hd) views, so merging the
  heads back is free (``kernel_strides``, ``kernel_output``). They take
  hd ∈ {32, 64}. The fp32 kernels, for the parity checks, take contiguous
  (B, H, S, hd) tensors.
- row tiles, ``csrc/attention_tiled.cu``, for every longer S (ViT-B/16's
  197, ViT-L/14's 257, MITH's concept tokens above 117 bits), with the same
  in-place reads and output layout, every product on the tensor cores:
  tiles of 16 rows, the other side streamed through shared memory. In bf16
  (hd ∈ {32, 64}) the forward walks the keys once, its logits fp32 FMA
  chains written once into the tile's logit rows, then the softmax from
  those rows (in ``torch.softmax``'s summation order) and P·V on the tensor
  cores; the rows live in shared memory while one tile's fit
  (``tiled_fwd_tiles`` > 0: S ≤ 3152 at hd 64, 3376 at hd 32) and past that
  in device memory (``_launch_rows``: one slot of rows a resident block of a
  persistent grid, so the scratch does not grow with B·H). The backward is
  three launches over fp32 scratch (row max, row sum, its reciprocal and
  D = Σ w·dW; dK and dV per key tile; dQ per query tile) with all five
  products on the tensor cores, W and dlog in three bf16 pieces. In fp32
  (hd ≤ 128) the same shape of kernels in TF32 as 3xTF32 (each operand
  split into two TF32 pieces, three products): a forward of one walk with
  an online softmax, and the three backward launches. Their launches are
  counted apart in ``launches_tiled``, and the fp32 ones also in
  ``launches_tiled_tf32``.

The scale multiplies the fp32 logits, as in the Pallas kernel. (The JAX
einsum path, ``cmh_tpu/models/clip/model.py:226-228``, scales q in the
compute dtype before the dot instead; the port keeps that form only for the
explicit last-block path that returns attention weights.)
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

_MAX_SMEM = 227 * 1024   # dynamic shared memory a block can have on sm_90
_HALF_SMEM = 113 * 1024  # each of two blocks on one SM (228 KB, 1 KB a block kept)
_CHUNK = 64              # rows of a chunk the bf16 row-tiled kernels stream
# largest S the one-block bf16 kernels are built for (16 × their largest
# row-tile count, csrc/attention.cu:max_kc_fwd/max_kc_bwd), by head dim
BF16_MAX_S = {"fwd": {32: 208, 64: 176}, "bwd": {32: 144, 64: 128}}
TILED_MAX_HD = 128       # widest head the row-tiled kernels are built for


def one_block_smem(which: str, s: int, hd: int) -> int:
    """Dynamic shared memory of one fp32 (batch, head) in the one-block
    kernels (csrc/attention.cu:cmh_attention_smem_bytes and
    cmh_attention_bwd_smem_bytes)."""
    if which == "fwd":
        return (3 * s * (hd + 1) + s * s) * 4
    return (4 * s * (hd + 1) + 2 * s * s) * 4


def tiled_fwd_smem(s: int, hd: int, tiles: int) -> int:
    """Dynamic shared memory of a bf16 row-tiled forward block of ``tiles``
    16-row tiles, two warps each (csrc/attention_tiled.cu:fwd_mma_smem): per
    tile its 16 fp32 logit rows of 16·⌈S/16⌉ + 8 words, its Q rows as fp32
    (hd × 16) and 48 floats for its warps' row maxima and sums; per block one
    K chunk of 64 rows as fp32 (hd × 64) and the bf16 tile it lands in."""
    rows = 16 * -(-s // 16) + 8
    return (tiles * (16 * rows * 4 + 16 * hd * 4 + 48 * 4)
            + _CHUNK * hd * 4 + _CHUNK * (hd + 8) * 2)


def tiled_fwd_tiles(s: int, hd: int) -> int:
    """16-row tiles of a bf16 row-tiled forward block (csrc/attention_tiled.cu:
    fwd_mma_tiles): the most, of 4 down to 1, that leave room for a second
    block on the SM; else 1 while one tile's logit rows fit; else 0, and the
    rows live in device memory (``_launch_rows``)."""
    for n in (4, 3, 2, 1):
        if tiled_fwd_smem(s, hd, n) <= _HALF_SMEM:
            return n
    return 1 if tiled_fwd_smem(s, hd, 1) <= _MAX_SMEM else 0


def route(dtype: torch.dtype, which: str, s: int, hd: int) -> str:
    """"one_block" or "tiled": the CUDA kernels that take sequence length
    ``s`` (``which`` is "fwd" or "bwd"). bf16 goes to the row tiles past
    ``BF16_MAX_S``, fp32 once one (batch, head) outgrows shared memory."""
    if dtype == torch.bfloat16:
        return "one_block" if s <= BF16_MAX_S[which].get(hd, 0) else "tiled"
    return "tiled" if one_block_smem(which, s, hd) > _MAX_SMEM else "one_block"


def kpm_bias(key_padding_mask: torch.Tensor) -> torch.Tensor:
    """(B, S) bool, True = pad → (B, S) fp32 additive bias (−inf / 0)."""
    zero = torch.zeros((), dtype=torch.float32, device=key_padding_mask.device)
    return torch.where(key_padding_mask, float("-inf"), zero)


def _acc(x: torch.Tensor) -> torch.Tensor:
    """fp32 working copy (fp64 stays fp64, for gradcheck)."""
    return x.double() if x.dtype == torch.float64 else x.float()


def _softmax(q, k, scale, mask, bias) -> torch.Tensor:
    """fp32 probabilities softmax(scale·q kᵀ + mask + bias)."""
    logits = torch.matmul(_acc(q), _acc(k).transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask.to(logits.dtype)
    if bias is not None:
        logits = logits + bias.to(logits.dtype)[:, None, None, :]
    return torch.softmax(logits, dim=-1)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, mask: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch. ``mask`` is an (S, S) fp32
    additive mask, ``bias`` the (B, S) fp32 key-padding bias."""
    w = _softmax(q, k, scale, mask, bias)
    out = torch.matmul(_acc(w.to(v.dtype)), _acc(v))
    return out.to(q.dtype)


def attention_bwd_plain(q, k, v, scale: float, mask, bias, dout):
    """The backward kernel's function: (dq, dk, dv) in q's dtype, computed
    in fp32 from the unrounded probabilities."""
    w = _softmax(q, k, scale, mask, bias)
    do = _acc(dout)
    dv = torch.matmul(w.transpose(-1, -2), do)
    dw = torch.matmul(do, _acc(v).transpose(-1, -2))
    dlog = w * (dw - (dw * w).sum(-1, keepdim=True))
    dq = torch.matmul(dlog, _acc(k)) * scale
    dk = torch.matmul(dlog.transpose(-1, -2), _acc(q)) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def kernel_strides(t: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """(t, its (b, h, s) element strides) as the bf16 and row-tiled kernels
    read a (B, H, S, hd) tensor: in place when hd is contiguous and every row
    starts on a 16-byte boundary (true of the head views of a packed
    projection), else from a contiguous copy."""
    st = t.stride()
    unit = 16 // t.element_size()
    if st[3] != 1 or t.data_ptr() % 16 or any(x % unit for x in st[:3]):
        t = t.contiguous()
        st = t.stride()
    return t, tuple(st[:3])


def kernel_output(like: torch.Tensor) -> torch.Tensor:
    """An empty (B, H, S, hd) tensor in (B, S, H, hd) memory, the layout the
    bf16 kernels write: ``out.transpose(1, 2).reshape(B, S, H·hd)`` is then a
    view."""
    b, h, s, hd = like.shape
    return torch.empty((b, s, h, hd), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _lib():
    lib = _build.load("attention")
    if lib.cmh_attention_fwd_f32.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.cmh_attention_fwd_f32.argtypes = [p] * 6 + [i, i, i, i, f, i, p]
        lib.cmh_attention_bwd_f32.argtypes = [p] * 9 + [i, i, i, i, f, i, p]
        lib.cmh_attention_fwd_bf16.argtypes = [p] * 7 + [i, i, i, i, f, i, p]
        lib.cmh_attention_bwd_bf16.argtypes = [p] * 10 + [i, i, i, i, f, i, p]
        for name in ("fwd_f32", "bwd_f32", "fwd_bf16", "bwd_bf16"):
            getattr(lib, f"cmh_attention_{name}").restype = i
        for name in ("cmh_attention_smem_bytes", "cmh_attention_bwd_smem_bytes"):
            getattr(lib, name).argtypes = [i, i]
            getattr(lib, name).restype = ctypes.c_long
    return lib


def _tiled_lib():
    lib = _build.load("attention_tiled")
    if lib.cmh_attention_tiled_fwd.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.cmh_attention_tiled_fwd.argtypes = [i] + [p] * 7 + [i, i, i, i, f, i, p]
        lib.cmh_attention_tiled_fwd_rows.argtypes = [p] * 7 + [i, i, i, i, f, p, i, p]
        lib.cmh_attention_tiled_bwd.argtypes = [i] + [p] * 11 + [i, i, i, i, f, i, p]
        for name in ("fwd", "fwd_rows", "bwd", "fwd_tiles"):
            getattr(lib, f"cmh_attention_tiled_{name}").restype = i
        lib.cmh_attention_tiled_fwd_rows_bytes.argtypes = [i, i]
        lib.cmh_attention_tiled_fwd_rows_bytes.restype = ctypes.c_long
        lib.cmh_attention_tiled_fwd_tiles.argtypes = [i, i]
        lib.cmh_attention_tiled_fwd_smem.argtypes = [i, i]
        lib.cmh_attention_tiled_fwd_smem.restype = ctypes.c_long
    return lib


def _prepare(q, k, v, mask, bias, which: str):
    """Check the kernels' preconditions (``which`` is "fwd" or "bwd") and
    pick the route; fp32 masks on q's device."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention kernels take one (B, H, S, hd) shape for "
                         f"q, k and v, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, hd = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"attention kernel takes float32 or bfloat16 q/k/v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dtype == torch.bfloat16 and hd not in BF16_MAX_S[which]:
        raise ValueError(f"bf16 attention kernels take hd 32 or 64, got {hd}")
    way = route(q.dtype, which, s, hd)
    if way != "one_block" and hd > TILED_MAX_HD:
        raise ValueError(f"the row-tiled attention kernels take hd <= {TILED_MAX_HD}, "
                         f"got {hd} at S={s}")
    if mask is not None and mask.shape != (s, s):
        raise ValueError(f"mask must be ({s}, {s}), got {tuple(mask.shape)}")
    if bias is not None and bias.shape != (b, s):
        raise ValueError(f"key-padding bias must be ({b}, {s}), got "
                         f"{tuple(bias.shape)}")
    if mask is not None:
        mask = mask.to(device=q.device, dtype=torch.float32).contiguous()
    if bias is not None:
        bias = bias.to(device=q.device, dtype=torch.float32).contiguous()
    return way, mask, bias


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _stream(t: torch.Tensor):
    return t.device.index or 0, torch.cuda.current_stream(t.device).cuda_stream


def _launch_rows(q, k, v, scale, mask, bias) -> torch.Tensor:
    """The bf16 row-tiled forward with its logit rows in device memory, a
    scratch sized by the blocks the card holds (``tiled_fwd_tiles`` is 0
    past the S at which one tile's rows fit in shared memory; this runs at
    any S). Counts no launch: ``_launch`` does."""
    b, h, s, hd = q.shape
    lib = _tiled_lib()
    (q, sq), (k, sk), (v, sv) = (kernel_strides(t) for t in (q, k, v))
    out = kernel_output(q)
    device, stream = _stream(q)
    nbytes = lib.cmh_attention_tiled_fwd_rows_bytes(s, device)
    if nbytes < 0:
        raise RuntimeError("attention_fwd: could not size the logit rows' scratch")
    rows = torch.empty(nbytes // 4, dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(*sq, *sk, *sv, *out.stride()[:3])
    rc = lib.cmh_attention_tiled_fwd_rows(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), _ptr(bias), out.data_ptr(),
        strides, b, h, s, hd, float(scale), rows.data_ptr(), device, stream)
    _build.check(rc, "attention_fwd")
    return out


def _launch(q, k, v, scale, mask, bias) -> torch.Tensor:
    way, mask, bias = _prepare(q, k, v, mask, bias, "fwd")
    b, h, s, hd = q.shape
    bf16 = q.dtype == torch.bfloat16
    if way != "one_block" and bf16 and tiled_fwd_tiles(s, hd) == 0:
        out, rc = _launch_rows(q, k, v, scale, mask, bias), 0   # checked there
    elif way != "one_block":
        (q, sq), (k, sk), (v, sv) = (kernel_strides(t) for t in (q, k, v))
        out = kernel_output(q) if bf16 else torch.empty_like(q)
        strides = (ctypes.c_longlong * 12)(*sq, *sk, *sv, *out.stride()[:3])
        rc = _tiled_lib().cmh_attention_tiled_fwd(
            int(bf16), q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), _ptr(bias),
            out.data_ptr(), strides, b, h, s, hd, float(scale), *_stream(q))
    elif bf16:
        (q, sq), (k, sk), (v, sv) = (kernel_strides(t) for t in (q, k, v))
        out = kernel_output(q)
        strides = (ctypes.c_longlong * 9)(*sq, *sk, *sv)
        rc = _lib().cmh_attention_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), _ptr(bias),
            out.data_ptr(), strides, b, h, s, hd, float(scale), *_stream(q))
    else:
        q, k, v = (t.contiguous() for t in (q, k, v))
        out = torch.empty_like(q)
        rc = _lib().cmh_attention_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), _ptr(bias),
            out.data_ptr(), b, h, s, hd, float(scale), *_stream(q))
    _build.check(rc, "attention_fwd")
    fused_attention.launches += 1
    fused_attention.launches_fp32 += not bf16
    fused_attention.launches_tiled += way != "one_block"
    fused_attention.launches_tiled_tf32 += way == "tiled" and not bf16
    return out


def _launch_bwd(q, k, v, scale, mask, bias, dout):
    way, mask, bias = _prepare(q, k, v, mask, bias, "bwd")
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError("dout must have q's shape and dtype")
    b, h, s, hd = q.shape
    bf16 = q.dtype == torch.bfloat16
    if way != "one_block":
        (q, sq), (k, sk), (v, sv), (dout, so) = (
            kernel_strides(t) for t in (q, k, v, dout))
        dq, dk, dv = ((kernel_output(q) if bf16 else torch.empty_like(q)) for _ in range(3))
        stats = torch.empty((4, b * h, s), dtype=torch.float32, device=q.device)
        strides = (ctypes.c_longlong * 21)(*sq, *sk, *sv, *so, *dq.stride()[:3],
                                            *dk.stride()[:3], *dv.stride()[:3])
        rc = _tiled_lib().cmh_attention_tiled_bwd(
            int(bf16), q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), _ptr(bias),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            strides, b, h, s, hd, float(scale), *_stream(q))
    elif bf16:
        (q, sq), (k, sk), (v, sv), (dout, so) = (
            kernel_strides(t) for t in (q, k, v, dout))
        dq, dk, dv = (kernel_output(q) for _ in range(3))
        strides = (ctypes.c_longlong * 12)(*sq, *sk, *sv, *so)
        rc = _lib().cmh_attention_bwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), _ptr(bias),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), strides,
            b, h, s, hd, float(scale), *_stream(q))
    else:
        q, k, v, dout = (t.contiguous() for t in (q, k, v, dout))
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        rc = _lib().cmh_attention_bwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), _ptr(bias),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, s,
            hd, float(scale), *_stream(q))
    _build.check(rc, "attention_bwd")
    attention_bwd.launches += 1
    attention_bwd.launches_fp32 += not bf16
    attention_bwd.launches_tiled += way != "one_block"
    attention_bwd.launches_tiled_tf32 += way == "tiled" and not bf16
    return dq, dk, dv


def _forward(q, k, v, scale, mask, bias):
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale, mask, bias)
    return _launch(q, k, v, scale, mask, bias)


def attention_bwd(q, k, v, scale: float, mask, bias, dout):
    """(dq, dk, dv) of the attention at (B, H, S, hd). On a CUDA tensor this
    launches the backward kernel (counted in ``attention_bwd.launches``, the
    fp32 ones also in ``launches_fp32``, the row-tiled ones in
    ``launches_tiled`` and of those the fp32 (3xTF32) ones in
    ``launches_tiled_tf32``); on a CPU tensor it runs ``attention_bwd_plain``."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, scale, mask, bias, dout)
    return _launch_bwd(q, k, v, scale, mask, bias, dout)


class _AttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, mask, bias):
        ctx.save_for_backward(q, k, v, mask, bias)
        ctx.scale = scale
        return _forward(q, k, v, scale, mask, bias)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, bias = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, ctx.scale, mask, bias, dout)
        # the masks get no gradient (attention_pallas.py:194-196)
        return dq, dk, dv, None, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, attn_mask: Optional[torch.Tensor] = None,
                    key_padding_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """softmax(scale·q@kᵀ + masks) @ v over (B, H, S, hd), in q's dtype.

    ``attn_mask`` is (S, S) additive; ``key_padding_mask`` (B, S) bool with
    True at pads. Differentiable in q, k and v. On a CUDA tensor this
    launches the kernel (counted in ``fused_attention.launches``, an fp32
    one also in ``launches_fp32``, a row-tiled one in ``launches_tiled`` and, if
    it is fp32 (3xTF32), in ``launches_tiled_tf32``); on a CPU tensor it runs
    ``attention_plain``. Outside autograd nothing is saved
    for a backward."""
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            "fused_attention is self-attention only (S_kv == S_q): got "
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention kernel for device {q.device}")
    bias = kpm_bias(key_padding_mask) if key_padding_mask is not None else None
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _AttentionFn.apply(q, k, v, float(scale), attn_mask, bias)
    return _forward(q, k, v, scale, attn_mask, bias)


# launches, and of them those of the fp32 kernels, of the row-tiled ones and
# of the fp32 (3xTF32) row-tiled ones
for _fn in (fused_attention, attention_bwd):
    _fn.launches = _fn.launches_fp32 = _fn.launches_tiled = _fn.launches_tiled_tf32 = 0
