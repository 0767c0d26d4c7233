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
the kernel as arguments, so no launch waits for the card. The kernels count
in 32 bits: ``launches`` cuts a call where its whole indices cross a
multiple of 2^32, so that each launch has one hi word, and hands each launch
its part map's division as a multiply and a shift (``magic``).
"""

from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..utils import prng, trace
from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SPAN = 1 << 32        # counters under one hi word
MAX_N = 1 << 31       # elements a launch, and the bound of the part map's numerators

# (dim, start, whole): the tensor is elements start … start + size − 1 along
# dim of an array whose size there is ``whole``
Part = Tuple[int, int, int]


def _lib():
    lib = _build.load("threefry")
    if lib.cmh_threefry_bits.argtypes is None:
        u32, i, p, f = ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p, ctypes.c_float
        lib.cmh_threefry_bits.argtypes = [u32, u32, u32, u32, p, u32, p]
        lib.cmh_threefry_bits.restype = i
        for fn in (lib.cmh_dropout_fwd, lib.cmh_dropout_bwd):
            fn.argtypes = [u32, u32, u32, u32, p, p, u32, u32, f, i, u32, u32, u32, i, u32, i, p]
            fn.restype = i
        lib.cmh_dropout_division_mismatches.argtypes = [f, i, p, p]
        lib.cmh_dropout_division_mismatches.restype = i
    return lib


class Launch(NamedTuple):
    """One kernel launch of a call: its elements start … start + n − 1 have
    whole indices (hi, lo + j + ((r0 + j) // period) · gap) for j < n, or
    (hi, lo + j) when period is 0."""
    start: int
    n: int
    hi: int
    lo: int
    period: int
    r0: int


def launches(n: int, period: int = 0, gap: int = 0, base: int = 0) -> List[Launch]:
    """The launches of a call over ``n`` elements whose whole indices are
    base + i + (i // period) · gap (base + i when period is 0). A launch
    ends where the whole indices cross a multiple of 2^32, after at most
    2^31 elements, and where r0 + j would reach 2^31; a period past 2^31
    ends it before its first jump instead, so that it counts on without one."""
    def whole(i):
        return base + i + (i // period) * gap if period else base + i

    def first_at(b):   # the first element whose whole index is at least b
        t = b - base
        if t <= 0 or not period:
            return max(t, 0)
        o, rem = divmod(t, period + gap)
        return o * period + rem if rem < period else (o + 1) * period

    out, i = [], 0
    while i < n:
        g = whole(i)
        end = min(n, first_at((g // SPAN + 1) * SPAN), i + MAX_N)
        p, r0 = period, (i % period if period else 0)
        if p > MAX_N:
            end, p, r0 = min(end, i + p - r0), 0, 0
        elif p:
            end = min(end, i + MAX_N - r0)
        out.append(Launch(i, end - i, (g >> 32) & prng.MASK, g & prng.MASK, p, r0))
        i = end
    return out


def magic(period: int) -> Tuple[int, int]:
    """(m, s), m < 2^32, with (k · m) >> s == k // period for every
    k < 2^31 (Granlund and Montgomery's round-up multiplier); (0, 0) for no
    period."""
    if not period:
        return 0, 0
    bits = (period - 1).bit_length()
    return -(-(1 << (31 + bits)) // period), 31 + bits


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
    ``offset``, as an int64 tensor of uint32 values on ``device``. Under a
    profiler it is the span ``cmh.t`` with (elements, 4, False)."""
    device = _device(device)
    n = math.prod(shape)
    with trace.span("t", (n, 4, False)):
        if device.type == "cpu":
            return prng.random_bits(key, shape, offset)
        out = torch.empty(n, dtype=torch.int32, device=device)
        lib, stream = _lib(), _stream(out)
        for ln in launches(n, base=int(offset)):
            rc = lib.cmh_threefry_bits(key[0], key[1], ln.hi, ln.lo,
                                       out.data_ptr() + 4 * ln.start, ln.n, stream)
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


def part_map(shape: Sequence[int], part: Optional[Part]) -> Tuple[int, int, int]:
    """(period, gap, base) of the index map: local element i of ``shape``
    is whole element base + i + (i // period) · gap (base + i at period 0)."""
    inner, size, whole, start = _part(shape, part)
    if size == whole:
        return 0, 0, 0
    return size * inner, (whole - size) * inner, start * inner


def _aligned_like(x: torch.Tensor) -> torch.Tensor:
    """An empty tensor shaped as the contiguous ``x`` whose address equals
    x's modulo 16 bytes, so that the kernel's 16-byte loads and stores
    share one head of single elements."""
    skew = x.data_ptr() % 16
    if skew == 0:
        return torch.empty_like(x)
    buf = torch.empty(x.numel() + 16 // x.element_size(), dtype=x.dtype, device=x.device)
    k = (skew - buf.data_ptr() % 16) % 16 // x.element_size()
    return buf[k:k + x.numel()].view(x.shape)


def division_mismatches(scale: float, dtype: torch.dtype, device) -> Tuple[int, float, float]:
    """How many inputs of ``dtype`` (every float32 bit pattern, or every
    bfloat16) the kernels' reciprocal path divides by ``scale`` otherwise
    than IEEE division does, counted on the card exhaustively; and the least
    and the greatest |x| among them (NaN when there are none)."""
    out = torch.tensor([0, -1, 0], dtype=torch.int64, device=device)
    rc = _lib().cmh_dropout_division_mismatches(scale, _DTYPES[dtype], out.data_ptr(),
                                                _stream(out))
    _build.check(rc, "dropout_division_mismatches")
    count, least, most = out.tolist()
    if not count:
        return 0, math.nan, math.nan
    as_float = torch.tensor([least, most], dtype=torch.int64).to(torch.int32).view(torch.float32)
    return count, *as_float.tolist()


_PROVEN = {}   # (scale, dtype, device): the reciprocal path gives IEEE's quotients


def _fast_division(scale: float, dtype: torch.dtype, device: torch.device) -> bool:
    """Whether the kernels may divide by ``scale`` through the reciprocal:
    proved on the card at the first call for each divisor and dtype."""
    k = (scale, dtype, device)
    if k not in _PROVEN:
        _PROVEN[k] = division_mismatches(scale, dtype, device)[0] == 0
    return _PROVEN[k]


def _launch(counter, x: torch.Tensor, key: prng.Key, rate: float,
            part: Optional[Part]) -> torch.Tensor:
    """``counter`` (``dropout`` or ``dropout_bwd``) names the kernel's C
    entry and counts its launches."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"dropout kernel takes float32 or bfloat16, got {x.dtype}")
    x = x.contiguous()
    threshold, scale = _scale(rate, x.dtype)
    scale = scale.float().item()
    period, gap, base = part_map(x.shape, part)
    out = _aligned_like(x)
    fn = getattr(_lib(), counter.kernel)
    size, stream = x.element_size(), _stream(x)
    below = math.ceil(threshold * 2**23)   # the uniform (bits >> 9) / 2^23 below threshold
    fast = int(_fast_division(scale, x.dtype, x.device))
    for ln in launches(x.numel(), period, gap, base):
        m, shift = magic(ln.period)
        rc = fn(key[0], key[1], ln.hi, ln.lo, x.data_ptr() + size * ln.start,
                out.data_ptr() + size * ln.start, ln.n, below, scale, fast, ln.period, ln.r0,
                m, shift, gap & prng.MASK, _DTYPES[x.dtype], stream)
        _build.check(rc, counter.kernel)
        counter.launches += 1
    return out


def _apply(x, key, rate, part, counter):
    """Either way of dropout; under a profiler the span ``cmh.t`` with
    (elements, element size, True)."""
    with trace.span("t", (x.numel(), x.element_size(), True)):
        if x.device.type == "cpu":
            return dropout_plain(x, key, rate, part)
        if x.device.type != "cuda":
            raise ValueError(f"no dropout kernel for device {x.device}")
        return _launch(counter, x, key, rate, part)


def dropout_bwd(grad: torch.Tensor, key: prng.Key, rate: float,
                part: Optional[Part] = None) -> torch.Tensor:
    """The gradient of ``dropout`` at ``grad``: the same mask, derived again
    from the key, times 1/keep_prob (flax's transpose of ``select(mask,
    x / kp, 0)``). On a CUDA tensor it launches ``dropout_bwd``."""
    return _apply(grad, key, rate, part, dropout_bwd)


class _DropoutFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, key, rate, part):
        ctx.key, ctx.rate, ctx.part = key, rate, part
        return _forward(x, key, rate, part)

    @staticmethod
    def backward(ctx, grad):
        return dropout_bwd(grad, ctx.key, ctx.rate, ctx.part), None, None, None


def _forward(x, key, rate, part):
    return _apply(x, key, rate, part, dropout)


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
dropout.kernel, dropout_bwd.kernel = "cmh_dropout_fwd", "cmh_dropout_bwd"
