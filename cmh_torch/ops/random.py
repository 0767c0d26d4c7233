"""Random bits and flax's dropout on the card (``csrc/threefry.cu``).

``random_bits(key, shape, device)`` is ``jax.random.bits``: on a CUDA device
it launches ``threefry_bits``, on the CPU it runs ``utils/prng.random_bits``.
``dropout(x, key, rate, part)`` is ``flax.linen.Dropout`` in train mode
under the mask key ``key``: on a CUDA tensor the forward launches
``dropout_fwd`` and the backward ``dropout_bwd``, which derives the same mask
again from the key (no mask is stored); on a CPU tensor both run
``dropout_plain``. Each wrapper counts its launches (``random_bits.launches``,
``dropout.launches``, ``dropout_bwd.launches``).

A key is two uint32 words computed on the host (``utils/prng``), passed to
the kernel as arguments, so no launch waits for the card.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

from ..utils import prng
from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# (dim, start, whole): the tensor is elements start … start + size − 1 along
# dim of an array whose size there is ``whole``
Part = Tuple[int, int, int]


def _lib():
    lib = _build.load("threefry")
    if lib.cmh_threefry_bits.argtypes is None:
        u32, u64, i64, i, p, f = (ctypes.c_uint32, ctypes.c_uint64, ctypes.c_int64,
                                  ctypes.c_int, ctypes.c_void_p, ctypes.c_float)
        lib.cmh_threefry_bits.argtypes = [u32, u32, u64, i64, p, p]
        lib.cmh_threefry_bits.restype = i
        for fn in (lib.cmh_dropout_fwd, lib.cmh_dropout_bwd):
            fn.argtypes = [u32, u32, p, p, i64, f, f, i64, i64, i64, i64, i, p]
            fn.restype = i
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _device(device) -> torch.device:
    device = torch.device("cpu" if device is None else device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no threefry kernel for device {device}")
    return device


def random_bits(key: prng.Key, shape: Sequence[int], device=None,
                offset: int = 0) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` at the flat indices plus
    ``offset``, as an int64 tensor of uint32 values on ``device``."""
    device = _device(device)
    if device.type == "cpu":
        return prng.random_bits(key, shape, offset)
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.int32, device=device)
    rc = _lib().cmh_threefry_bits(key[0], key[1], int(offset), n, out.data_ptr(),
                                  _stream(out))
    _build.check(rc, "threefry_bits")
    random_bits.launches += 1
    return (out.to(torch.int64) & prng.MASK).reshape(tuple(shape))


def _part(shape: Sequence[int], part: Optional[Part]) -> Tuple[int, int, int, int]:
    """(inner, part size, whole size, start) of the kernel's index map."""
    if part is None:
        return 1, 1, 1, 0
    dim, start, whole = part
    dim %= len(shape)
    if not 0 <= start <= whole - shape[dim]:
        raise ValueError(f"part {part} does not fit a dimension of size {shape[dim]}")
    return math.prod(shape[dim + 1:]), shape[dim], whole, start


def whole_index(shape: Sequence[int], part: Optional[Part], device=None) -> torch.Tensor:
    """Each element's flat index in the whole array (``part`` as in
    ``dropout``), an int64 tensor of ``shape``: the kernel's index map."""
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    inner, size, whole, start = _part(shape, part)
    if size != whole:
        t = i // inner
        i = ((t // size) * whole + start + t % size) * inner + i % inner
    return i.reshape(tuple(shape))


def _scale(rate: float, dtype: torch.dtype) -> Tuple[float, torch.Tensor]:
    """(the float32 keep threshold, keep_prob rounded to ``dtype``): flax
    compares float32 uniforms with keep_prob and divides by it weakly typed,
    so in x's dtype (bf16 0.9 → 0.8984375)."""
    keep = 1.0 - float(rate)
    return (torch.tensor(keep, dtype=torch.float32).item(),
            torch.tensor(keep, dtype=dtype))


def dropout_plain(x: torch.Tensor, key: prng.Key, rate: float,
                  part: Optional[Part] = None) -> torch.Tensor:
    """flax's ``Dropout``: where the float32 uniform of the element's whole
    index is below keep_prob, x / keep_prob; elsewhere 0."""
    threshold, scale = _scale(rate, x.dtype)
    idx = whole_index(x.shape, part, x.device)
    y0, y1 = prng.threefry2x32(key, idx >> 32, idx & prng.MASK)
    keep = prng.bits_to_unit(y0 ^ y1) < threshold
    return torch.where(keep, x / scale.to(x.device), torch.zeros((), dtype=x.dtype,
                                                                 device=x.device))


def _launch(fn_name: str, x: torch.Tensor, key: prng.Key, rate: float,
            part: Optional[Part]) -> torch.Tensor:
    if x.dtype not in _DTYPES:
        raise TypeError(f"dropout kernel takes float32 or bfloat16, got {x.dtype}")
    x = x.contiguous()
    threshold, scale = _scale(rate, x.dtype)
    inner, size, whole, start = _part(x.shape, part)
    out = torch.empty_like(x)
    rc = getattr(_lib(), fn_name)(key[0], key[1], x.data_ptr(), out.data_ptr(), x.numel(),
                                  threshold, scale.float().item(), inner, size, whole,
                                  start, _DTYPES[x.dtype], _stream(x))
    _build.check(rc, fn_name)
    return out


def _apply(x, key, rate, part, fn_name: str):
    if x.device.type == "cpu":
        return dropout_plain(x, key, rate, part)
    if x.device.type != "cuda":
        raise ValueError(f"no dropout kernel for device {x.device}")
    return _launch(fn_name, x, key, rate, part)


def dropout_bwd(grad: torch.Tensor, key: prng.Key, rate: float,
                part: Optional[Part] = None) -> torch.Tensor:
    """The gradient of ``dropout`` at ``grad``: the same mask, derived again
    from the key, times 1/keep_prob (flax's transpose of ``select(mask,
    x / kp, 0)``). On a CUDA tensor it launches ``dropout_bwd``."""
    out = _apply(grad, key, rate, part, "cmh_dropout_bwd")
    dropout_bwd.launches += grad.device.type == "cuda"
    return out


class _DropoutFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, key, rate, part):
        ctx.key, ctx.rate, ctx.part = key, rate, part
        return _forward(x, key, rate, part)

    @staticmethod
    def backward(ctx, grad):
        return dropout_bwd(grad, ctx.key, ctx.rate, ctx.part), None, None, None


def _forward(x, key, rate, part):
    out = _apply(x, key, rate, part, "cmh_dropout_fwd")
    dropout.launches += x.device.type == "cuda"
    return out


def dropout(x: torch.Tensor, key: prng.Key, rate: float,
            part: Optional[Part] = None) -> torch.Tensor:
    """flax's ``Dropout(rate)`` in train mode with the mask key ``key``,
    differentiable in ``x``. ``part`` = (dim, start, whole) when ``x`` is
    the elements start … of dimension ``dim`` of cmh_tpu's array at the site,
    whose size there is ``whole``: each element draws its bit of the whole
    mask. On a CUDA tensor it launches ``dropout_fwd``."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _DropoutFn.apply(x, key, rate, part)
    return _forward(x, key, rate, part)


random_bits.launches = dropout.launches = dropout_bwd.launches = 0
