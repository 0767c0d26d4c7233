"""The threefry kernels' launch arithmetic, emulated on the CPU and held
against JAX.

``csrc/threefry.cu`` counts in 32 bits: ``ops/random.launches`` cuts a call
where its whole indices cross a multiple of 2^32, and gives each launch its
hi word, the low word of its first index, and the part map's division as a
multiply and a shift (``ops/random.magic``). A thread takes one 16-byte
vector (4 float32 or words, 8 bfloat16) after a head of single elements up
to x's first 16-byte boundary, and single elements again in the tail. This
file runs that arithmetic here, element by element in the kernel's order,
and holds the bits against ``jax.random.bits`` and JAX's threefry of the
same counters, and the dropout against flax's ``Dropout``.
"""

import math

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (before any torch work)
import torch
from jax._src import prng as jax_prng

from cmh_torch.ops import random as port_random
from cmh_torch.utils import prng

WIDTH = {torch.float32: 4, torch.bfloat16: 8}   # elements a thread: one 16-byte vector


def kernel_order(n, head, width):
    """The launch elements in the order the kernel's threads take them:
    the head, whole vectors, the tail (``dropout_kernel``)."""
    head = min(head, n)
    nv = (n - head) // width
    body = [head + v * width + e for v in range(nv) for e in range(width)]
    return list(range(head)) + body + [head + nv * width + t for t in range(n - head - nv * width)]


def head_of(skew_bytes, size, n):
    """Single elements before the first 16-byte boundary (``head_of``)."""
    return min(n, (16 - skew_bytes % 16) % 16 // size)


def kernel_counters(ln, gap, j):
    """(hi, lo) of the launch's elements ``j``, in the kernel's uint32
    arithmetic (``counter``: the part map's division by multiply and shift)."""
    j = np.asarray(j, dtype=np.uint64)
    off = j
    if ln.period:
        m, s = port_random.magic(ln.period)
        q = ((np.uint64(ln.r0) + j) * np.uint64(m)) >> np.uint64(s)
        off = j + q * np.uint64(gap & prng.MASK)
    lo = (np.uint64(ln.lo) + off) & np.uint64(prng.MASK)
    return np.full(j.shape, ln.hi, dtype=np.uint64), lo


def kernel_bits(key, ln, gap, j):
    hi, lo = kernel_counters(ln, gap, j)
    y0, y1 = prng.threefry2x32(key, torch.from_numpy(hi.astype(np.int64)),
                               torch.from_numpy(lo.astype(np.int64)))
    return (y0 ^ y1).numpy()


def jax_bits(key, idx):
    """JAX's threefry2x32 (word 1 XOR word 2) of the whole indices ``idx``."""
    idx = np.asarray(idx, dtype=np.uint64)
    count = jnp.concatenate([jnp.asarray((idx >> np.uint64(32)).astype(np.uint32)),
                             jnp.asarray((idx & np.uint64(prng.MASK)).astype(np.uint32))])
    y = np.asarray(jax_prng.threefry_2x32(jnp.asarray(key, dtype=jnp.uint32), count))
    return (y.reshape(2, -1)[0] ^ y.reshape(2, -1)[1]).astype(np.int64)


def kernel_dropout(x, key, rate, part=None, skew=0):
    """``dropout_kernel`` on the CPU: x's storage ``skew`` elements past a
    16-byte boundary, each launch's elements in the threads' order."""
    threshold, scale = port_random._scale(rate, x.dtype)
    below = math.ceil(threshold * 2**23)
    period, gap, base = port_random.part_map(x.shape, part)
    size, width = x.element_size(), WIDTH[x.dtype]
    flat, out = x.reshape(-1).float(), torch.full((x.numel(),), float("nan"))
    for ln in port_random.launches(x.numel(), period, gap, base):
        order = kernel_order(ln.n, head_of((skew + ln.start) * size, size, ln.n), width)
        assert sorted(order) == list(range(ln.n))
        bits = kernel_bits(key, ln, gap, order)
        keep = torch.from_numpy((bits >> 9) < below)
        idx = torch.as_tensor(order, dtype=torch.int64) + ln.start
        out[idx] = torch.where(keep, flat[idx] / scale.float(), torch.zeros(()))
    return out.to(x.dtype).reshape(x.shape)


@pytest.mark.parametrize("period", [1, 2, 3, 7, 82, 656, 5248, 20992, 131073,
                                    2**30 + 1, 2**31 - 1, 2**31])
def test_magic_divides_every_numerator_below_2_to_31(period):
    m, s = port_random.magic(period)
    assert 0 < m < 2**32 and s < 64
    rng = np.random.RandomState(period % 2**31)
    ks = {0, 1, 2**31 - 1, *rng.randint(0, 2**31, 2000).tolist()}
    for c in range(0, 2**31 // period + 1, max(1, 2**31 // period // 500)):
        ks |= {k for k in (c * period - 1, c * period, c * period + 1) if 0 <= k < 2**31}
    assert all((k * m) >> s == k // period for k in ks)


def check_plan(n, period, gap, base):
    """The launches tile [0, n), keep one hi word and the kernel's 32-bit
    bounds, and give every element its whole index (checked at each end,
    next to each jump and at random elements)."""
    def whole(i):
        return base + i + (i // period) * gap if period else base + i

    plan = port_random.launches(n, period, gap, base)
    assert plan[0].start == 0 and plan[-1].start + plan[-1].n == n
    rng = np.random.RandomState(n % 2**31)
    for ln, nxt in zip(plan, plan[1:] + [None]):
        assert 0 < ln.n <= 2**31 and (nxt is None or nxt.start == ln.start + ln.n)
        assert ln.period == 0 or ln.r0 + ln.n <= 2**31
        assert whole(ln.start) >> 32 == whole(ln.start + ln.n - 1) >> 32 == ln.hi
        js = {0, ln.n - 1, *rng.randint(0, ln.n, 50).tolist()}
        if period:
            first = (ln.start // period + 1) * period - ln.start
            js |= {j for b in range(first, min(ln.n, first + 5 * period), period)
                   for j in (b - 1, b) if 0 <= j < ln.n}
        js = sorted(js)
        hi, lo = kernel_counters(ln, gap, js)
        want = np.array([whole(ln.start + j) for j in js], dtype=np.uint64)
        np.testing.assert_array_equal((hi << np.uint64(32)) | lo, want)
    return plan


@pytest.mark.parametrize("n,period,gap,base,launches", [
    (11, 0, 0, 2**32 - 5, 2),                       # random_bits at an offset
    (3 * 2**31 + 7, 0, 0, 0, 4),                    # past 2^31 elements
    (2 * 20, 10, 429496720, 429496729 * 10, 2),     # a part: a row crosses 2^32
    (6, 2, 2**31 + 6, 2**31 + 2, 2),                # a jump crosses 2^32
    (2 * 656 * 100, 656, 656, 656, 1),              # UMoED's heads, rank 1 of tp=2
    (2**31 + 100, 3, 5, 0, 2),                      # the numerators' bound
    (3 * (2**31 + 5), 2**31 + 5, 2**31 + 5, 0, 6),  # a period past 2^31
])
def test_launches_split_at_each_bound(n, period, gap, base, launches):
    assert len(check_plan(n, period, gap, base)) == launches


@pytest.mark.parametrize("n", [1, 5, 6, 7, 8, 1001])
def test_bits_are_jax_random_bits(n):
    key = prng.PRNGKey(1814)
    jk = jax.random.PRNGKey(1814)
    (ln,) = port_random.launches(n)
    order = kernel_order(n, 0, 4)
    got = np.empty(n, dtype=np.int64)
    got[order] = kernel_bits(key, ln, 0, order)
    np.testing.assert_array_equal(got, np.asarray(jax.random.bits(jk, (n,))).astype(np.int64))


@pytest.mark.parametrize("offset,n", [(2**32 - 5, 11), (2**32 - 6, 7), (3 * 2**32 - 1, 9)])
def test_bits_across_the_hi_word_are_jaxs(offset, n):
    """A launch ends at the hi word's end; the next one starts its vectors
    after a head of single words (its start is no longer 16-byte aligned)."""
    key = prng.PRNGKey(7)
    got = np.empty(n, dtype=np.int64)
    plan = port_random.launches(n, base=offset)
    assert len(plan) == 2
    for ln in plan:
        order = kernel_order(ln.n, head_of(4 * ln.start, 4, ln.n), 4)
        got[ln.start + np.array(order)] = kernel_bits(key, ln, 0, order)
    np.testing.assert_array_equal(got, jax_bits(key, np.arange(offset, offset + n)))


def flax_dropout(x, rate):
    """flax's Dropout at the root of ``apply`` under PRNGKey(11); its mask
    key is flax_key(PRNGKey(11), 1)."""
    jdt = jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32
    out = nn.Dropout(rate, deterministic=False).apply(
        {}, jnp.asarray(x.float().numpy()).astype(jdt), rngs={"dropout": jax.random.PRNGKey(11)})
    return torch.from_numpy(np.asarray(out.astype(jnp.float32))).to(x.dtype)


MASK_KEY = prng.flax_key(prng.PRNGKey(11), 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1,), (9,), (3, 17), (2, 5, 13), (4, 3, 82)])
def test_dropout_at_every_skew_is_flaxs(dtype, shape):
    """n ≡ 1, 2, 3 … mod the vector, at every start within 16 bytes."""
    x = torch.from_numpy(np.random.RandomState(3).uniform(-3, 3, shape).astype(np.float32)).to(dtype)
    want = flax_dropout(x, 0.3)
    for skew in range(WIDTH[dtype]):
        assert torch.equal(kernel_dropout(x, MASK_KEY, 0.3, skew=skew), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("part", [(1, 4, 8), (1, 3, 8), (0, 2, 5), (2, 1, 3)])
def test_a_part_at_the_vector_width_is_flaxs(dtype, part):
    """A shard of UMoED's attention probabilities (last dim 82, not a
    multiple of the vector) and blocks of rows: each is its slice of flax's
    mask over the whole array."""
    dim, start, whole = part
    shape = [3, 8, 2, 82]
    shape[dim] = whole
    full = torch.from_numpy(np.random.RandomState(4).normal(size=shape).astype(np.float32)).to(dtype)
    size = 4 if dim == 1 else 2 if dim == 0 else 1
    x = full.narrow(dim, start, size).contiguous()
    want = flax_dropout(full, 0.3).narrow(dim, start, size)
    for skew in (0, 1, 3):
        assert torch.equal(kernel_dropout(x, MASK_KEY, 0.3, (dim, start, whole), skew), want)
    assert torch.equal(port_random.dropout(x, MASK_KEY, 0.3, (dim, start, whole)), want)


def test_a_part_across_the_hi_word_draws_jaxs_bits():
    """Rows of 10 whose whole indices cross 2^32 inside the first row and
    2^33 inside the second: a launch ends at each, and each element draws
    JAX's bits of its whole index."""
    shape, part = (2, 1, 10), (1, 429496729, 429496730)
    period, gap, base = port_random.part_map(shape, part)
    idx = port_random.whole_index(shape, part).reshape(-1).numpy()
    assert idx[0] < 2**32 <= idx[-1]
    key = prng.PRNGKey(9)
    got = np.empty(idx.size, dtype=np.int64)
    plan = port_random.launches(idx.size, period, gap, base)
    assert [ln.n for ln in plan] == [6, 6, 8]
    for ln in plan:
        j = np.arange(ln.n)
        got[ln.start + j] = kernel_bits(key, ln, gap, j)
    np.testing.assert_array_equal(got, jax_bits(key, idx))


def test_the_output_aligns_as_its_input():
    """The wrapper's output sits at x's address modulo 16 bytes, so that
    one head serves the loads and the stores."""
    for dtype in (torch.float32, torch.bfloat16):
        buf = torch.zeros(64, dtype=dtype)
        for k in range(WIDTH[dtype]):
            x = buf[k:k + 37]
            out = port_random._aligned_like(x)
            assert out.shape == x.shape and out.is_contiguous()
            assert out.data_ptr() % 16 == x.data_ptr() % 16
