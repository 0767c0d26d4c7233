"""cmh_torch's hashing ops and RetrievalIndex against cmh_tpu on the CPU.

Integer paths must match exactly: packed words, distances, top-k indices
and their tie order, and the npz files each package writes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (before any torch work)
import torch

from cmh_torch.ops import hashing as th
from cmh_torch.serving import RetrievalIndex
from cmh_tpu.ops import hashing as jh
from cmh_tpu.serving import RetrievalIndex as JaxIndex
from cmh_tpu.serving import _pack_bits_host


def _codes(n, bits, seed):
    rng = np.random.RandomState(seed)
    return rng.choice([-1.0, 1.0], size=(n, bits)).astype(np.float32)


@pytest.mark.parametrize("bits", [8, 16, 32, 33, 64, 70, 255, 256])
def test_pack_bits_bit_identical(bits):
    c = _codes(37, bits, bits)
    got = th.as_uint32(th.pack_bits(torch.from_numpy(c)))
    np.testing.assert_array_equal(got, np.asarray(jh.pack_bits(jnp.asarray(c))))
    np.testing.assert_array_equal(got, _pack_bits_host(c))
    back = th.unpack_bits(th.from_uint32(got), bits)
    np.testing.assert_array_equal(back.numpy(), c)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jh.unpack_bits(jnp.asarray(got), bits)))


def test_hash_activations_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(5, 16).astype(np.float32)
    x[0, :2] = [0.5, 0.5]       # an exact tie: argmax takes the first index
    x[1, 2] = 0.0               # sign of 0 is +1
    t = torch.from_numpy(x)
    np.testing.assert_allclose(th.softmax_hash(t).numpy(),
                               np.asarray(jh.softmax_hash(jnp.asarray(x))), atol=1e-7)
    np.testing.assert_allclose(th.tanh_hash(t).numpy(),
                               np.asarray(jh.tanh_hash(jnp.asarray(x))), atol=1e-7)
    np.testing.assert_array_equal(th.sign_code(t).numpy(),
                                  np.asarray(jh.sign_code(jnp.asarray(x))))
    np.testing.assert_array_equal(th.pair_argmax_code(t).numpy(),
                                  np.asarray(jh.pair_argmax_code(jnp.asarray(x))))


def _both(gallery, bits, split=None):
    a, b = RetrievalIndex(bits, device="cpu"), JaxIndex(bits)
    for part in (np.split(gallery, [split]) if split else [gallery]):
        a.add(part)
        b.add(part)
    return a, b


@pytest.mark.parametrize("bits,n,topk", [(8, 300, 7), (16, 200, 10), (64, 300, 5),
                                         (70, 150, 150), (256, 90, 4)])
def test_search_equals_cmh_tpu(bits, n, topk):
    gallery = _codes(n, bits, bits)
    queries = _codes(9, bits, bits + 1)
    queries[0] = gallery[17]                     # distance 0 must rank first
    port, ref = _both(gallery, bits, split=n // 3)
    d, i = port.search(queries, topk=topk)
    for rd, ri in (ref.search(queries, topk=topk), ref.search_cpu(queries, topk=topk)):
        np.testing.assert_array_equal(d, rd)
        np.testing.assert_array_equal(i, ri)
    assert d.dtype == np.int32 and i.dtype == np.int32
    assert d[0, 0] == 0 and i[0, 0] == 17


def test_all_tie_gallery_orders_by_index():
    bits = 16
    gallery = np.repeat(_codes(1, bits, 0), 50, axis=0)
    queries = _codes(3, bits, 1)
    port, ref = _both(gallery, bits)
    d, i = port.search(queries, topk=20)
    np.testing.assert_array_equal(i, np.tile(np.arange(20), (3, 1)))
    rd, ri = ref.search(queries, topk=20)
    np.testing.assert_array_equal(d, rd)
    np.testing.assert_array_equal(i, ri)


@pytest.mark.parametrize("block,topk", [(64, 10), (64, 100), (7, 3)])
def test_blocked_search_equals_unblocked(block, topk):
    """Gallery blocks smaller than N (and than topk) merge to the exact
    answer of cmh_tpu's unblocked search, ties included (8-bit codes)."""
    bits = 8
    gallery = _codes(301, bits, 5)
    queries = _codes(6, bits, 6)
    port, ref = _both(gallery, bits)
    d, i = port.search(queries, topk=topk, block=block)
    rd, ri = ref.search(queries, topk=topk)
    np.testing.assert_array_equal(d, rd)
    np.testing.assert_array_equal(i, ri)


@pytest.mark.parametrize("block", [777, (1 << 10) + 3])
def test_blocked_search_16_bit_equals_cmh_tpu(block):
    """The serving width (16 bits) in blocks that start off a 16-byte
    boundary of the packed gallery, the last one short."""
    bits = 16
    gallery = _codes(3000, bits, 16)
    queries = _codes(5, bits, 17)
    queries[1] = gallery[2999]
    port, ref = _both(gallery, bits, split=1100)
    d, i = port.search(queries, topk=40, block=block)
    rd, ri = ref.search(queries, topk=40)
    np.testing.assert_array_equal(d, rd)
    np.testing.assert_array_equal(i, ri)
    assert d[1, 0] == 0 and i[1, 0] == 2999


def test_npz_interop_both_ways(tmp_path):
    bits = 24
    gallery = _codes(120, bits, 7)
    queries = _codes(5, bits, 8)
    port, ref = _both(gallery, bits, split=50)
    port.save(str(tmp_path / "port.npz"))
    ref.save(str(tmp_path / "jax.npz"))
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    for key in ("packed", "bits", "count"):
        np.testing.assert_array_equal(a[key], b[key])
    assert a["packed"].dtype == np.uint32
    from_jax = RetrievalIndex.load(str(tmp_path / "jax.npz"), device="cpu")
    from_port = JaxIndex.load(str(tmp_path / "port.npz"))
    assert len(from_jax) == len(from_port) == 120
    want = ref.search(queries, topk=6)
    for got in (from_jax.search(queries, topk=6), from_port.search_cpu(queries, topk=6)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_index_rejects_bad_queries():
    index = RetrievalIndex(8, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        index._gallery()
    index.add(_codes(4, 8, 0))
    with pytest.raises(ValueError, match="topk"):
        index.search(_codes(1, 8, 1), topk=5)
    with pytest.raises(ValueError):
        index.search(_codes(1, 9, 1), topk=2)
    with pytest.raises(ValueError):
        index.add(_codes(2, 7, 1))
