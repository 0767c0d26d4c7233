"""Self-attention for short sequences (kernels K2-fwd, K2-bwd).

Counterpart of ``cmh_tpu/ops/attention_pallas.py:fused_attention`` and its
``custom_vjp``: softmax(scale·QKᵀ + mask + key-padding bias)·V over
(B, H, S, hd), with fp32 logits and softmax and the probabilities rounded to
the compute dtype before the PV product. The backward recomputes the
softmax and uses the UNROUNDED fp32 probabilities for dV, as the Pallas
backward does; autograd of the forward would differentiate through the
rounding instead. A CUDA tensor launches the hand-written kernels in
``csrc/attention.cu``; a CPU tensor takes ``attention_plain`` and
``attention_bwd_plain``.

In bf16 the kernels run on the tensor cores (the forward's logits on the
CUDA cores, so that P rounds to bf16 as in the plain version), read q, k, v
and dout where they lie (the strided head views of a packed projection) and
write their outputs in (B, S, H, hd) memory, returned as (B, H, S, hd)
views, so merging the heads back is free (``kernel_strides``,
``kernel_output``). They take hd ∈ {32, 64} and S up to ``BF16_MAX_S``. The fp32 kernels, for the parity
checks, take contiguous (B, H, S, hd) tensors.

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
# largest S the bf16 kernels are built for (16 × their largest row-tile
# count, csrc/attention.cu:max_kc_fwd/max_kc_bwd), by head dim
BF16_MAX_S = {"fwd": {32: 208, 64: 176}, "bwd": {32: 144, 64: 128}}


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
    """(t, its (b, h, s) element strides) as the bf16 kernels read a
    (B, H, S, hd) tensor: in place when hd is contiguous and every row
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


def _prepare(q, k, v, mask, bias, which: str):
    """Check the kernels' preconditions (``which`` is "fwd" or "bwd"), all
    but the fp32 shared-memory size before the library is loaded; fp32
    masks on q's device."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention kernels take one (B, H, S, hd) shape for "
                         f"q, k and v, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, hd = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"attention kernel takes float32 or bfloat16 q/k/v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dtype == torch.bfloat16:
        limits = BF16_MAX_S[which]
        if hd not in limits:
            raise ValueError(f"bf16 attention kernels take hd 32 or 64, got {hd}")
        if s > limits[hd]:
            raise ValueError(f"bf16 attention {which} kernel takes S <= "
                             f"{limits[hd]} at hd={hd}, got S={s}")
    if mask is not None and mask.shape != (s, s):
        raise ValueError(f"mask must be ({s}, {s}), got {tuple(mask.shape)}")
    if bias is not None and bias.shape != (b, s):
        raise ValueError(f"key-padding bias must be ({b}, {s}), got "
                         f"{tuple(bias.shape)}")
    lib = _lib()
    if q.dtype == torch.float32:
        smem = getattr(lib, "cmh_attention_smem_bytes" if which == "fwd"
                       else "cmh_attention_bwd_smem_bytes")(s, hd)
        if smem > _MAX_SMEM:
            raise ValueError(f"attention kernel holds one (batch, head) in shared "
                             f"memory: S={s}, hd={hd} needs {smem} bytes")
    if mask is not None:
        mask = mask.to(device=q.device, dtype=torch.float32).contiguous()
    if bias is not None:
        bias = bias.to(device=q.device, dtype=torch.float32).contiguous()
    return lib, mask, bias


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _stream(t: torch.Tensor):
    return t.device.index or 0, torch.cuda.current_stream(t.device).cuda_stream


def _launch(q, k, v, scale, mask, bias) -> torch.Tensor:
    lib, mask, bias = _prepare(q, k, v, mask, bias, "fwd")
    b, h, s, hd = q.shape
    if q.dtype == torch.bfloat16:
        (q, sq), (k, sk), (v, sv) = (kernel_strides(t) for t in (q, k, v))
        out = kernel_output(q)
        strides = (ctypes.c_longlong * 9)(*sq, *sk, *sv)
        rc = lib.cmh_attention_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), _ptr(bias),
            out.data_ptr(), strides, b, h, s, hd, float(scale), *_stream(q))
    else:
        q, k, v = (t.contiguous() for t in (q, k, v))
        out = torch.empty_like(q)
        rc = lib.cmh_attention_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), _ptr(bias),
            out.data_ptr(), b, h, s, hd, float(scale), *_stream(q))
    _build.check(rc, "attention_fwd")
    fused_attention.launches += 1
    fused_attention.launches_fp32 += q.dtype == torch.float32
    return out


def _launch_bwd(q, k, v, scale, mask, bias, dout):
    lib, mask, bias = _prepare(q, k, v, mask, bias, "bwd")
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError("dout must have q's shape and dtype")
    b, h, s, hd = q.shape
    if q.dtype == torch.bfloat16:
        (q, sq), (k, sk), (v, sv), (dout, so) = (
            kernel_strides(t) for t in (q, k, v, dout))
        dq, dk, dv = (kernel_output(q) for _ in range(3))
        strides = (ctypes.c_longlong * 12)(*sq, *sk, *sv, *so)
        rc = lib.cmh_attention_bwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), _ptr(bias),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), strides,
            b, h, s, hd, float(scale), *_stream(q))
    else:
        q, k, v, dout = (t.contiguous() for t in (q, k, v, dout))
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        rc = lib.cmh_attention_bwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), _ptr(bias),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, s,
            hd, float(scale), *_stream(q))
    _build.check(rc, "attention_bwd")
    attention_bwd.launches += 1
    attention_bwd.launches_fp32 += q.dtype == torch.float32
    return dq, dk, dv


def _forward(q, k, v, scale, mask, bias):
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale, mask, bias)
    return _launch(q, k, v, scale, mask, bias)


def attention_bwd(q, k, v, scale: float, mask, bias, dout):
    """(dq, dk, dv) of the attention at (B, H, S, hd). On a CUDA tensor this
    launches the backward kernel (counted in ``attention_bwd.launches``); on
    a CPU tensor it runs ``attention_bwd_plain``."""
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
    one also in ``launches_fp32``); on a CPU
    tensor it runs ``attention_plain``. Outside autograd nothing is saved
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


# launches, and of them those of the fp32 kernels
fused_attention.launches = fused_attention.launches_fp32 = 0
attention_bwd.launches = attention_bwd.launches_fp32 = 0
