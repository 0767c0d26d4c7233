"""JAX's threefry2x32 random streams and flax's per-module keys, in torch.

cmh_tpu draws every random number from JAX keys: ``PRNGKey(seed)``, keys
split and folded off it, flax's per-module ``make_rng`` keys, and
``jax.random``'s samplers on top. This module computes the same keys and the
same draws without JAX, so a seed gives the port cmh_tpu's init, dropout
masks and per-step noise.

A key is a pair of uint32 words, held as a tuple of Python ints. Key
derivation (``PRNGKey``, ``split``, ``fold_in``, ``flax_key``) is pure Python
on the host, so a kernel launch that takes a key never waits for the card.
The samplers (``random_bits``, ``uniform``, ``normal``, ...) are int64 torch
ops (uint32 values masked to 32 bits) on the CPU or any device; they are the
plain version of ``csrc/threefry.cu``.

The generator is Threefry-2x32 with 20 rounds (Salmon et al., SC'11), as
``jax/_src/prng.py`` lowers it; counters and key derivation follow jax 0.9's
default partitionable mode (``jax_threefry_partitionable``) with x64 off, as
cmh_tpu runs. ``flax_key`` is flax 0.12's ``_fold_in_static``.
"""

from __future__ import annotations

import hashlib
import math
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

Key = Tuple[int, int]
MASK = 0xFFFFFFFF
PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
LECUN_TRUNCATION = 0.87962566103423978   # std of a standard normal cut at ±2


def threefry2x32(key: Key, x0, x1):
    """Threefry-2x32 of the counter pair (``x0``, ``x1``) under ``key``: 20
    rounds, a key injection every 4. ``x0``/``x1`` are Python ints or int64
    tensors of uint32 values; returns the two output words alike."""
    ks = (key[0] & MASK, key[1] & MASK, (key[0] ^ key[1] ^ PARITY) & MASK)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def PRNGKey(seed: int) -> Key:  # noqa: N802 (jax's name)
    """``jax.random.PRNGKey(seed)`` with x64 off: the key (0, seed mod 2^32)."""
    return (0, int(seed) & MASK)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in``: threefry of ``key`` over (0, data mod 2^32)."""
    return threefry2x32(key, 0, int(data) & MASK)


def split(key: Key, num: Union[int, Sequence[int]] = 2) -> List[Key]:
    """``jax.random.split(key, num)``, its keys in flat C order (a tuple
    ``num`` is a shape): key i is threefry of ``key`` over the (hi, lo) words
    of i."""
    n = num if isinstance(num, int) else math.prod(num)
    return [threefry2x32(key, i >> 32, i & MASK) for i in range(n)]


def flax_key(key: Key, *suffix: Union[str, int]) -> Key:
    """flax's ``LazyRng.create(key, *suffix).as_jax_rng()``: ``fold_in`` of
    the first 4 bytes (big-endian) of the SHA-1 of the suffix, strings as
    UTF-8 and ints as minimal big-endian bytes, with no separator. A
    parameter's key is ``flax_key(init_key, *scope_path, n)`` and a dropout
    mask's ``flax_key(step_key, *scope_path, n)``, n being the scope's
    ``make_rng`` count for that stream (from 1)."""
    if not suffix:
        return key
    m = hashlib.sha1()
    for x in suffix:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(int(x).to_bytes((int(x).bit_length() + 7) // 8, "big"))
    return fold_in(key, int.from_bytes(m.digest()[:4], "big"))


def _threefry_u32(key: Key, x0: np.ndarray, x1: np.ndarray) -> np.ndarray:
    """``threefry2x32`` of uint32 arrays in place (numpy's uint32 arithmetic
    wraps, so no masks); returns word 1 XOR word 2."""
    ks = tuple(np.uint32(k) for k in (key[0] & MASK, key[1] & MASK,
                                       (key[0] ^ key[1] ^ PARITY) & MASK))
    x0 += ks[0]
    x1 += ks[1]
    t = np.empty_like(x1)
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 += x1
            np.left_shift(x1, np.uint32(r), out=t)
            x1 >>= np.uint32(32 - r)
            x1 |= t
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0 ^ x1


def random_bits(key: Key, shape: Sequence[int], offset: int = 0, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: word 1 XOR word 2 of the
    threefry of each flat C-order index (plus ``offset``); an int64 tensor of
    uint32 values. The plain version: numpy uint32 arithmetic on the CPU, in
    chunks of 2^16 elements that stay in cache; int64 torch ops elsewhere."""
    n = math.prod(shape)
    if device is not None and torch.device(device).type != "cpu":
        out = torch.empty(n, dtype=torch.int64, device=device)
        for lo in range(0, n, 1 << 22):
            idx = torch.arange(lo, min(n, lo + (1 << 22)), dtype=torch.int64,
                               device=device) + int(offset)
            y0, y1 = threefry2x32(key, idx >> 32, idx & MASK)
            out[lo:lo + idx.numel()] = y0 ^ y1
        return out.reshape(tuple(shape))
    out = np.empty(n, np.uint32)
    for lo in range(0, n, 1 << 16):
        idx = np.arange(lo, min(n, lo + (1 << 16)), dtype=np.uint64) + np.uint64(offset)
        out[lo:lo + idx.size] = _threefry_u32(key, (idx >> np.uint64(32)).astype(np.uint32),
                                              idx.astype(np.uint32))
    return torch.from_numpy(out.astype(np.int64)).reshape(tuple(shape))


def _bits(key: Key, shape: Sequence[int], device) -> torch.Tensor:
    """The samplers' bits: the plain version on the CPU; on the card the
    ``threefry_bits`` kernel (``ops/random.py``)."""
    if device is None or torch.device(device).type == "cpu":
        return random_bits(key, shape)
    from ..ops.random import random_bits as card_bits
    return card_bits(key, shape, device=device)


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits → float32 in [0, 1): the top 23 bits as the mantissa of a
    float in [1, 2), minus 1 (``jax.random.uniform``'s construction)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def uniform(key: Key, shape: Sequence[int], minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``. XLA
    contracts ``floats · (max − min) + min`` into one fused multiply-add; the
    product is exact in float64, so the sum is taken there and rounded once."""
    lo, hi = _f32(minval).to(device), _f32(maxval).to(device)
    floats = bits_to_unit(_bits(key, shape, device))
    return torch.maximum(lo, (floats.double() * (hi - lo).double() + lo.double()).float())


def bernoulli(key: Key, p: float, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` (mode 'low'): a float32
    uniform below p."""
    return uniform(key, shape, device=device) < _f32(p).to(device)


def randint(key: Key, shape: Sequence[int], minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32): two bit
    streams from ``split(key)`` folded modulo the span in uint32 arithmetic."""
    k1, k2 = split(key)
    higher, lower = _bits(k1, shape, device), _bits(k2, shape, device)
    span = max((int(maxval) - int(minval)) & MASK, 1) if maxval > minval else 1
    multiplier = (((2 ** 16) % span) ** 2 & MASK) % span
    offset = ((higher % span) * multiplier & MASK) + lower % span
    offset = (offset & MASK) % span
    return (int(minval) + offset).to(torch.int32)


# XLA's float32 ErfInv (Giles, "Approximating the erfinv function"): a
# degree-8 polynomial in w = −log1p(−x²), one set of coefficients for w < 5
# and one in √w past it.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``, its Horner steps as fused multiply-adds
    (each taken in float64 and rounded once, as the CPU backend contracts
    them). ``log1p`` is torch's, not XLA's: on 2^20 uniforms 1.0% of the
    results differ from ``jax.lax.erf_inv``'s by 1–2 ulps (2.4e-7 at most),
    where ``torch.erfinv`` differs on 67% by up to 5.8e-6 relative."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    p = _horner(_ERFINV_LT5, (w - 2.5).double())
    if not bool(small.all()):     # the tails, |x| above about 0.9966
        big = ~small
        p[big] = _horner(_ERFINV_GE5, (torch.sqrt(w[big]) - 3.0).double())
    return torch.where(x.abs() == 1, x * torch.finfo(torch.float32).max, p * x)


def _horner(coefs, w: torch.Tensor) -> torch.Tensor:
    """The float32 polynomial at float64 ``w``, each step one fused
    multiply-add (exact product, one rounding to float32)."""
    p = torch.full(w.shape, coefs[0], dtype=torch.float32, device=w.device)
    for c in coefs[1:]:
        p = torch.addcmul(torch.tensor(float(_f32(c)), dtype=torch.float64, device=w.device),
                          p.double(), w).float()
    return p


def normal(key: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: √2·erfinv of a uniform on
    (nextafter(−1, 0), 1). The uniforms are JAX's bit for bit; ``erfinv``
    leaves the draws within a few float32 ulps of JAX's."""
    lo = torch.nextafter(_f32(-1.0), _f32(0.0)).item()
    u = uniform(key, shape, lo, 1.0, device=device)
    return _f32(math.sqrt(2)).to(device) * erfinv(u)


def truncated_normal(key: Key, lower: float, upper: float, shape: Sequence[int],
                     device=None) -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape, float32)``:
    √2·erfinv of a uniform between erf(lower/√2) and erf(upper/√2), clipped
    inside (lower, upper)."""
    sqrt2 = _f32(math.sqrt(2))
    lo, hi = _f32(lower), _f32(upper)
    a, b = torch.erf(lo / sqrt2).item(), torch.erf(hi / sqrt2).item()
    out = sqrt2.to(device) * erfinv(uniform(key, shape, a, b, device=device))
    inf = _f32(math.inf)
    return out.clamp(torch.nextafter(lo, inf).item(), torch.nextafter(hi, -inf).item())


# ------------------------------------------------------ flax's initializers
def _fans(shape: Sequence[int]) -> Tuple[int, int]:
    """``jax.nn.initializers``' fans: in axis −2, out axis −1, the rest a
    receptive field."""
    receptive = math.prod(shape) // (shape[-2] * shape[-1])
    return shape[-2] * receptive, shape[-1] * receptive


def lecun_normal(key: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``nn.initializers.lecun_normal()``: a normal cut at ±2, scaled to the
    variance 1/fan_in."""
    std = torch.sqrt(_f32(1.0 / _fans(shape)[0])) / _f32(LECUN_TRUNCATION)
    return truncated_normal(key, -2.0, 2.0, shape, device) * std.to(device)


def xavier_uniform(key: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``nn.initializers.xavier_uniform()``: uniform on [−1, 1) times
    √(3 / fan_avg)."""
    fan_in, fan_out = _fans(shape)
    bound = torch.sqrt(3 * _f32(1.0 / ((fan_in + fan_out) / 2)))
    return uniform(key, shape, -1.0, 1.0, device) * bound.to(device)


def normal_init(std: float):
    """``nn.initializers.normal(std)``: a normal times float32 ``std``."""
    return lambda key, shape, device=None: normal(key, shape, device) * _f32(std).to(device)


def uniform_init(bound: float):
    """``jax.random.uniform(key, shape, float32, -bound, bound)`` as an
    initializer (cmh_tpu's torch-default and kaiming inits)."""
    return lambda key, shape, device=None: uniform(key, shape, -bound, bound, device)


def constant(value: float):
    """An initializer that ignores its key (flax still counts the call)."""
    return lambda key, shape, device=None: torch.full(tuple(shape), float(value), device=device)


zeros, ones = constant(0.0), constant(1.0)
