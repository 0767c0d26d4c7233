"""``RetrievalIndex.search_cpu`` (the port's copy of cmh_tpu's native
scorer, ``cmh_torch/native/hash_ops.cpp``) against cmh_tpu's ``search_cpu``,
the port's ``search`` and the numpy ``search_cpu_plain``, on the CPU.

Everything here is exact: distances, indices and their order, ties by
lower gallery index, at 16, 64 and 512 bits, on one thread, on threads over
the queries and on threads over the gallery. A build that fails, or a
library that fails its self-test, raises; nothing falls back.
"""

import numpy as np
import pytest
import torch_threads  # noqa: F401  (before any torch work)
import torch

from cmh_torch.native import _build, hash_ops
from cmh_torch.ops.hashing import as_uint32, pack_bits
from cmh_torch.serving import RetrievalIndex, search_cpu_plain
from cmh_tpu.serving import RetrievalIndex as JaxIndex


def _gallery(bits, n=3000, seed=0):
    """±1 codes with many exact ties: blocks of repeated rows and rows one
    bit away from row 0."""
    rng = np.random.RandomState(seed)
    g = rng.choice([-1.0, 1.0], (n, bits)).astype(np.float32)
    g[100:160] = g[0]
    g[2000:2040] = g[0]
    g[500:520] = g[0]
    g[500:520, 3] *= -1
    queries = np.concatenate([g[:1], -g[5:6], rng.choice([-1.0, 1.0], (5, bits))])
    return g, queries.astype(np.float32)


@pytest.mark.parametrize("bits", [16, 64, 512])
@pytest.mark.parametrize("topk", [1, 64, 150])
def test_search_cpu_equals_cmh_tpu_and_search(bits, topk):
    g, q = _gallery(bits)
    port = RetrievalIndex(bits, device="cpu")
    port.add(g[:1700])
    port.add(g[1700:])
    jax_index = JaxIndex(bits)
    jax_index.add(g)
    want_d, want_i = jax_index.search_cpu(q, topk=topk)
    dev_d, dev_i = port.search(q, topk=topk)
    for threads in (0, 1, 3, 16):
        d, i = port.search_cpu(q, topk=topk, n_threads=threads)
        assert d.dtype == np.int32 and i.dtype == np.int64 and d.shape == (len(q), topk)
        np.testing.assert_array_equal(d, want_d)
        np.testing.assert_array_equal(i, want_i)
        np.testing.assert_array_equal(d, dev_d)
        np.testing.assert_array_equal(i, dev_i)
    pd, pi = search_cpu_plain(as_uint32(pack_bits(torch.from_numpy(q))), port._host_gallery(), topk)
    np.testing.assert_array_equal(pd, want_d)
    np.testing.assert_array_equal(pi, want_i)
    if topk >= 64:      # row 0's 100 copies come back in index order
        assert want_i[0, :4].tolist() == [0, 100, 101, 102] and not want_d[0, :61].any()


def test_host_copy_follows_the_gallery(tmp_path):
    g, q = _gallery(64, n=400, seed=1)
    index = RetrievalIndex(64, device="cpu")
    index.add(g[:200])
    assert index.search_cpu(q, topk=5)[1].max() < 200
    index.add(np.concatenate([g[200:], q[2:3]]))      # row 400 equals query 2
    d, i = index.search_cpu(q, topk=5)
    assert (d[2, 0], i[2, 0]) == (0, 400)
    np.testing.assert_array_equal(i, index.search(q, topk=5)[1])
    index.save(str(tmp_path / "index.npz"))
    loaded = RetrievalIndex.load(str(tmp_path / "index.npz"), device="cpu")
    for a, b in zip(loaded.search_cpu(q, topk=5), (d, i)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="topk=402"):
        index.search_cpu(q, topk=402)
    with pytest.raises(ValueError, match="queries must be"):
        index.search_cpu(q[:, :32], topk=1)


def test_a_failed_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "GXX_FLAGS", _build.GXX_FLAGS + ["-fno-such-flag"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for hash_ops.cpp.*no-such-flag"):
        hash_ops.library()
    assert not list(tmp_path.glob("*.so"))


def test_a_failed_self_test_raises(monkeypatch):
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(hash_ops, "_self_test", lambda lib: False)
    with pytest.raises(RuntimeError, match="failed its self-test"):
        hash_ops.hamming_topk(np.zeros((1, 1), np.uint32), np.zeros((2, 1), np.uint32), 1)


def test_library_is_keyed_by_source_flags_and_machine(monkeypatch):
    path = _build.lib_path("hash_ops")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libhash_ops-")
    assert "-march=native" not in _build.GXX_FLAGS
    monkeypatch.setattr(_build.platform, "machine", lambda: "another")
    assert _build.lib_path("hash_ops") != path
