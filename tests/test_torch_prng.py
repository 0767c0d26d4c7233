"""``cmh_torch/utils/prng.py`` and the plain dropout of ``ops/random.py``
against ``jax.random`` and flax on the CPU (jax 0.9's partitionable
threefry, x64 off, as cmh_tpu runs).

Keys, bits, uniforms, Bernoullis and randints are held bit for bit. Normal
and truncated-normal draws go through the port's copy of XLA's float32
``erf_inv`` polynomial (its fused multiply-adds taken in float64, torch's
``log1p``), not through ``torch.erfinv``: they are held within 1e-6
absolute (a few float32 ulps of a unit normal's largest values; 2.4e-7 was
the largest error over 2^20 draws) and must agree exactly on most
elements. flax's per-module keys are held against ``LazyRng``, and the
plain dropout against ``flax.linen.Dropout`` and ``jax.grad`` of it, in
fp32 and bf16, bit for bit.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (before any torch work)
import torch
from flax.core.scope import LazyRng
from hypothesis import given, settings
from hypothesis import strategies as st

from cmh_torch.ops import random as port_random
from cmh_torch.utils import prng

SEEDS = st.integers(min_value=-2**31, max_value=2**31 - 1)
# odd sizes, a few ranks; drawn from a fixed set so that JAX compiles each once
SHAPES = st.sampled_from([(1,), (7,), (3, 5), (2, 3, 9), (1001,)])
FEW = settings(max_examples=20, deadline=None, database=None)


def _key(k) -> tuple:
    return tuple(int(v) for v in np.asarray(k))


@FEW
@given(seed=SEEDS)
def test_prngkey_split_and_fold_in(seed):
    jk = jax.random.PRNGKey(seed)
    key = prng.PRNGKey(seed)
    assert key == _key(jk)
    for num in (2, 3):
        assert prng.split(key, num) == [_key(k) for k in jax.random.split(jk, num)]
    flat = np.asarray(jax.random.split(jk, (2, 3))).reshape(-1, 2)
    assert prng.split(key, (2, 3)) == [_key(k) for k in flat]
    for data in (0, 1, 2**32 - 1, abs(seed) % 1000):
        assert prng.fold_in(key, data) == _key(jax.random.fold_in(jk, data))


@FEW
@given(seed=SEEDS, shape=SHAPES)
def test_bits_uniform_bernoulli_randint(seed, shape):
    jk, key = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    bits = np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(prng.random_bits(key, shape).numpy(), bits)
    np.testing.assert_array_equal(port_random.random_bits(key, shape).numpy(), bits)
    for lo, hi in ((0.0, 1.0), (-1.0, 1.0), (-0.3, 0.3), (-0.0883883, 0.0883883)):
        np.testing.assert_array_equal(prng.uniform(key, shape, lo, hi).numpy(),
                                      np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, hi)))
    for p in (0.5, 0.7, 0.9):
        np.testing.assert_array_equal(prng.bernoulli(key, p, shape).numpy(),
                                      np.asarray(jax.random.bernoulli(jk, p, shape)))
    for lo, hi in ((0, 2), (0, 10), (-5, 1000), (3, 100003)):
        np.testing.assert_array_equal(prng.randint(key, shape, lo, hi).numpy(),
                                      np.asarray(jax.random.randint(jk, shape, lo, hi)))


def test_bits_at_an_offset_across_the_hi_word():
    """Counters past 2^32 elements carry into the hi word."""
    from jax._src import prng as jax_prng

    jk, key = jax.random.PRNGKey(1814), prng.PRNGKey(1814)
    off, n = 2**32 - 5, 11
    idx = np.arange(off, off + n, dtype=np.uint64)
    count = jnp.concatenate([jnp.asarray((idx >> 32).astype(np.uint32)),
                             jnp.asarray((idx & 0xFFFFFFFF).astype(np.uint32))])
    y = np.asarray(jax_prng.threefry_2x32(jk, count)).reshape(2, n)
    want = (y[0] ^ y[1]).astype(np.int64)
    np.testing.assert_array_equal(prng.random_bits(key, (n,), offset=off).numpy(), want)
    # an index map that crosses it too: a part of a (2^31 + 8)-wide dimension
    idx = port_random.whole_index((2, 3), (1, 2**31 + 2, 2**31 + 8))
    assert int(idx[1, 0]) == (2**31 + 8) + 2**31 + 2 > 2**32


@FEW
@given(seed=SEEDS, shape=SHAPES)
def test_normal_and_truncated_normal_within_tolerance(seed, shape):
    jk, key = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for got, want in ((prng.normal(key, shape), jax.random.normal(jk, shape)),
                      (prng.truncated_normal(key, -2.0, 2.0, shape),
                       jax.random.truncated_normal(jk, -2.0, 2.0, shape))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_normal_mostly_bit_equal_on_many_draws():
    jk, key = jax.random.PRNGKey(3), prng.PRNGKey(3)
    got, want = prng.normal(key, (1 << 16,)).numpy(), np.asarray(jax.random.normal(jk, (1 << 16,)))
    assert np.abs(got - want).max() <= 1e-6 and (got != want).mean() < 0.02


@FEW
@given(seed=SEEDS, path=st.lists(st.sampled_from(
    ["backbone", "visual", "hash_img", "drop", "layer_0", "attn_drop", "ü"]), max_size=4),
    counter=st.integers(min_value=1, max_value=300))
def test_flax_key_is_flax_lazy_rng(seed, path, counter):
    jk = jax.random.PRNGKey(seed)
    want = _key(LazyRng.create(jk, *path, counter).as_jax_rng())
    assert prng.flax_key(prng.PRNGKey(seed), *path, counter) == want


def test_flax_initializers():
    """lecun_normal and normal within the normal tolerance, xavier_uniform
    and uniform bounds bit for bit."""
    jk, key = jax.random.PRNGKey(7), prng.PRNGKey(7)
    for shape in ((64, 192), (8, 8, 3, 64), (33, 17)):
        std = (1.0 / np.prod(shape[:-1])) ** 0.5 / 0.87962566103423978
        np.testing.assert_allclose(prng.lecun_normal(key, shape).numpy(),
                                   np.asarray(nn.initializers.lecun_normal()(jk, shape)),
                                   rtol=0, atol=1e-6 * std)
        np.testing.assert_array_equal(prng.xavier_uniform(key, shape).numpy(),
                                      np.asarray(nn.initializers.xavier_uniform()(jk, shape)))
        np.testing.assert_allclose(prng.normal_init(0.02)(key, shape).numpy(),
                                   np.asarray(nn.initializers.normal(0.02)(jk, shape)),
                                   rtol=0, atol=2e-8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
def test_plain_dropout_is_flax_dropout(dtype, rate):
    """The mask key of a Dropout at the root of ``apply`` is flax_key(key, 1);
    bf16 divides by keep_prob rounded to bf16, as flax does."""
    x = np.random.RandomState(0).uniform(-3, 3, (4, 3, 5, 7)).astype(np.float32)
    g = np.random.RandomState(1).normal(size=x.shape).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jk = jax.random.PRNGKey(11)
    drop = nn.Dropout(rate, deterministic=False)

    def f(v):
        return drop.apply({}, v, rngs={"dropout": jk})

    want = np.asarray(f(jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    jgrad = jax.grad(lambda v: jnp.sum(f(v).astype(jnp.float32) * g))(jnp.asarray(x).astype(jdt))
    mask_key = prng.flax_key(prng.PRNGKey(11), 1)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    got = port_random.dropout(xt, mask_key, rate)
    (got.float() * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(got.detach().float().numpy(), want)
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  np.asarray(jgrad.astype(jnp.float32)))


@pytest.mark.parametrize("dim", [0, 1, 2, 3])
def test_a_part_draws_its_elements_of_the_whole_mask(dim):
    """A tensor-parallel shard or a data-parallel block of rows: the parts'
    masks, put together, are the whole array's."""
    x = torch.from_numpy(np.random.RandomState(2).randn(4, 6, 5, 3).astype(np.float32))
    key = prng.PRNGKey(5)
    whole = port_random.dropout(x, key, 0.3)
    n = x.shape[dim]
    for size in (1, 2):
        parts = [port_random.dropout(x.narrow(dim, s, size).contiguous(), key, 0.3,
                                     (dim, s, n)) for s in range(0, n - n % size, size)]
        torch.testing.assert_close(torch.cat(parts, dim), whole.narrow(dim, 0, n - n % size),
                                   rtol=0, atol=0)
    with pytest.raises(ValueError, match="does not fit"):
        port_random.dropout(x, key, 0.3, (dim, 1, n))
