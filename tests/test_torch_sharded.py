"""The sharded ``valid`` and the sharded search of the port on the CPU.

- ``map_sums_4dir``, one query shard's fp64 AP sums: 83 queries over 3
  shards (the last padded with zero-label queries), summed and divided by
  the query count, equal the unsharded ``calc_map_k_4dir`` within 1e-12 at
  16 and 1,024 bits, mAP@all and mAP@10 (past cmh_tpu's 1,022-bit limit the
  port's unsharded path is the reference), and cmh_tpu's
  ``calc_map_k_4dir_sharded`` on the conftest's 8-device mesh at 16 bits
  within 1e-6 (cmh_tpu adds its AP sums in fp32). ``calc_map_k_4dir_sharded``
  in a gloo group of one equals the unsharded mAPs; two ranks are held in
  ``test_torch_dp.py``.
- ``RetrievalIndex.search(devices=[...])`` over three shards on the CPU,
  with runs of equal codes across the shard boundaries (ties), gives the
  unsharded search's and cmh_tpu's ``search(mesh=)`` distances and indices
  bit for bit, a shard list that names one device three times included.
"""

import jax
import numpy as np
import pytest
import torch_threads  # noqa: F401  (before any torch work)
import torch

from cmh_torch.ops.map_bucketed import calc_map_k_4dir, calc_map_k_4dir_sharded, map_sums_4dir
from cmh_torch.parallel import dp
from cmh_torch.serving import RetrievalIndex


def _inputs(bits, num_query=83, num_r=211, classes=5, seed=0):
    rng = np.random.RandomState(seed)

    def codes(n):
        c = rng.choice([-1.0, 1.0], size=(n, bits)).astype(np.float32)
        c[n // 3: n // 3 + 9] = c[n // 3]            # tied distances
        return c

    ql = (rng.rand(num_query, classes) > 0.6).astype(np.float32)
    ql[np.arange(num_query), rng.randint(0, classes, num_query)] = 1
    rl = (rng.rand(num_r, classes) > 0.6).astype(np.float32)
    ql[:4] = 0                                       # queries with no relevant item
    return codes(num_query), codes(num_query), codes(num_r), codes(num_r), ql, rl


@pytest.mark.parametrize("bits", [16, 1024])
@pytest.mark.parametrize("k", [None, 10])
def test_shards_sum_to_the_unsharded_maps(bits, k):
    args = [torch.from_numpy(a) for a in _inputs(bits)]
    want = calc_map_k_4dir(*args, k)
    sums = [map_sums_4dir(*args, k, shard=s, n_shards=3) for s in range(3)]
    assert all(s.dtype == torch.float64 for s in sums)
    got = (sum(sums) / 83).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert 0 < min(want) < max(want) < 1


@pytest.mark.parametrize("k", [None, 10])
def test_shards_equal_cmh_tpus_sharded_map(k):
    from cmh_tpu.ops.map_bucketed import calc_map_k_4dir_sharded as jax_sharded
    from cmh_tpu.parallel.mesh import make_mesh

    arrays = _inputs(16)
    want = jax_sharded(*arrays, k, mesh=make_mesh())
    got = sum(map_sums_4dir(*map(torch.from_numpy, arrays), k, shard=s, n_shards=3)
              for s in range(3)) / 83
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_the_collective_in_a_group_of_one():
    args = [torch.from_numpy(a) for a in _inputs(16, seed=2)]
    group = dp.init("localhost", dp.free_port(), 1, 0, torch.device("cpu"))
    try:
        got = calc_map_k_4dir_sharded(*args, None, group=group)
    finally:
        dp.shutdown()
    np.testing.assert_allclose(got, calc_map_k_4dir(*args), rtol=0, atol=1e-12)


@pytest.mark.parametrize("bits,topk", [(16, 10), (64, 37)])
def test_gallery_shards_are_the_unsharded_search(bits, topk):
    from cmh_tpu.parallel.mesh import make_mesh
    from cmh_tpu.serving import RetrievalIndex as JaxIndex

    rng = np.random.RandomState(bits)
    n = 8 * 125
    gallery = rng.choice([-1.0, 1.0], size=(n, bits)).astype(np.float32)
    per = -(-n // 3)
    for edge in (per, 2 * per):                      # equal codes across both shard edges
        gallery[edge - 5:edge + 20] = gallery[edge - 5]
    queries = np.concatenate([gallery[[per - 5, 2 * per]],
                              rng.choice([-1.0, 1.0], size=(5, bits)).astype(np.float32)])
    index = RetrievalIndex(bits, device="cpu")
    index.add(gallery[:600])
    index.add(gallery[600:])
    want = index.search(queries, topk=topk, block=128)
    for devices in (["cpu"] * 3, ["cpu", "cpu"]):
        got = index.search(queries, topk=topk, block=128, devices=devices)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert (want[0][:2, :10] == 0).all()             # the ties reach across an edge
    assert want[1][0].min() < per <= want[1][0].max()
    jindex = JaxIndex(bits)
    jindex.add(gallery)
    jd, ji = jindex.search(queries, topk=topk, mesh=make_mesh())
    np.testing.assert_array_equal(want[0], jd)
    np.testing.assert_array_equal(want[1], ji)
    assert jax.device_count() == 8
