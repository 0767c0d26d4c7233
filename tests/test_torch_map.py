"""cmh_torch's counting-rank mAP (the plain versions of kernels K3-hist and
K3-ap, and the 4-direction driver) against cmh_tpu.

The references: ``calc_map_k_4dir_pallas(..., interpret=True)`` (the Pallas
kernels in interpret mode), ``map_bucketed.calc_map_k_4dir`` (the XLA
counting rank) and ``calc_map_k_numpy`` (a stable argsort per query in
numpy). Histograms and totals are integers and must be exact. Each AP term
is the fp32 quotient R_rank / N_rank in the port and in cmh_tpu, and the
fp64 one in numpy: one fp32 rounding (2^-24 relative) a term, so the port
agrees with numpy to NUMPY_TOL; cmh_tpu adds its terms in fp32 and the port
in fp64, so they agree to PALLAS_TOL.
"""

import numpy as np
import pytest
import torch_threads  # noqa: F401  (before any torch work)
import torch

from cmh_torch.ops.map_bucketed import calc_map_k_4dir, calc_map_k_4dir_auto
from cmh_torch.ops.map_kernel import (map_ap, map_ap_plain, map_hist, map_hist_plain,
                                      pack_words, packed_dtype, rank_counts)
from cmh_torch.ops.metrics import calc_label_sim, calc_map_k, calc_map_k_numpy
from cmh_tpu.ops import map_bucketed as jax_bucketed
from cmh_tpu.ops.map_pallas import calc_map_k_4dir_pallas


NUMPY_TOL = 1e-7
PALLAS_TOL = 1e-6


def _data(nq, nr, bits, n_cls, seed, empty=0):
    rng = np.random.RandomState(seed)
    qi, qt = (rng.choice([-1.0, 1.0], (nq, bits)).astype(np.float32) for _ in range(2))
    ri, rt = (rng.choice([-1.0, 1.0], (nr, bits)).astype(np.float32) for _ in range(2))
    ql = (rng.rand(nq, n_cls) > 0.6).astype(np.float32)
    rl = (rng.rand(nr, n_cls) > 0.6).astype(np.float32)
    ql[:empty] = 0              # queries with no relevant item score AP 0
    return qi, qt, ri, rt, ql, rl


def _numpy_4dir(qi, qt, ri, rt, ql, rl, k):
    return [calc_map_k_numpy(a, b, ql, rl, k)
            for a, b in ((qi, rt), (qt, ri), (qi, ri), (qt, rt))]


def _pallas_tiles(bits):
    tq, tn, _ = jax_bucketed._pallas_tiles(bits)
    return dict(tq=min(tq, 8), tn=min(tn, 64))


@pytest.mark.parametrize("bits", [16, 64, 126, 127, 128, 1024, 2048])
def test_counting_rank_matches_pallas_and_numpy(bits):
    nr = 150 if bits <= 128 else 60
    data = _data(13, nr, bits, 5, seed=bits, empty=2)
    got = calc_map_k_4dir(*data, k=None, chunk=5)           # ragged query tail
    np.testing.assert_allclose(got, _numpy_4dir(*data, None), rtol=0, atol=NUMPY_TOL)
    pal = calc_map_k_4dir_pallas(*data, None, chunk=8, interpret=True,
                                 **_pallas_tiles(bits))
    np.testing.assert_allclose(got, pal, rtol=0, atol=PALLAS_TOL)


@pytest.mark.parametrize("k", [5, 50])
def test_map_at_k_caps_total(k):
    data = _data(11, 200, 16, 4, seed=k)
    got = calc_map_k_4dir(*data, k=k)
    np.testing.assert_allclose(got, _numpy_4dir(*data, k), rtol=0, atol=NUMPY_TOL)
    np.testing.assert_allclose(got, jax_bucketed.calc_map_k_4dir(*data, k=k, chunk=8,
                                                                 block=32),
                               rtol=0, atol=PALLAS_TOL)
    assert not np.allclose(got, calc_map_k_4dir(*data, k=None))


def test_heavy_ties_break_by_gallery_index():
    data = _data(9, 300, 4, 3, seed=1)          # 4-bit codes: 5 buckets for 300 items
    got = calc_map_k_4dir(*data)
    np.testing.assert_allclose(got, _numpy_4dir(*data, None), rtol=0, atol=NUMPY_TOL)
    np.testing.assert_allclose(got, jax_bucketed.calc_map_k_4dir(*data, chunk=4, block=16),
                               rtol=0, atol=PALLAS_TOL)


@pytest.mark.parametrize("bits", [4, 64, 127, 1024])
def test_histograms_and_totals_are_exact(bits):
    qi, _, ri, _, ql, rl = _data(7, 97, bits, 4, seed=3 + bits, empty=1)
    gnd = calc_label_sim(torch.from_numpy(ql), torch.from_numpy(rl))
    words = pack_words(torch.from_numpy(qi), torch.from_numpy(ri), gnd, bits)
    assert words.dtype == (torch.uint8 if bits <= 126 else torch.int16)
    hist, rhist = map_hist(words, bits)        # a CPU tensor: the plain version
    assert hist.shape == rhist.shape == (len(qi), 1, bits + 1)   # 97 items: one segment
    d = (0.5 * (bits - qi @ ri.T)).astype(np.int64)
    g = ((ql @ rl.T) > 0).astype(np.int64)
    for i in range(len(qi)):
        np.testing.assert_array_equal(hist[i, 0].numpy(), np.bincount(d[i], minlength=bits + 1))
        np.testing.assert_array_equal(rhist[i, 0].numpy(),
                                      np.bincount(d[i], weights=g[i], minlength=bits + 1))
    start, start_r, total = rank_counts(hist, rhist, k=10)
    np.testing.assert_array_equal(total.numpy(), np.minimum(g.sum(1), 10))
    np.testing.assert_array_equal(start[:, 0, 0].numpy(), 0)
    np.testing.assert_array_equal((start + hist)[:, 0, -1].numpy(), len(ri))
    ap = map_ap(words, start, start_r, total)
    assert ap.dtype == torch.float64 and float(ap[0]) == 0.0     # no relevant item


def test_plain_pass2_does_not_depend_on_its_block():
    qi, _, ri, _, ql, rl = _data(6, 333, 8, 3, seed=5)
    gnd = calc_label_sim(torch.from_numpy(ql), torch.from_numpy(rl))
    words = pack_words(torch.from_numpy(qi), torch.from_numpy(ri), gnd, 8)
    less, less_r, total = rank_counts(*map_hist_plain(words, 8), None)
    ref = map_ap_plain(words, less, less_r, total, block=333)
    for block in (1, 7, 32, 128):
        torch.testing.assert_close(map_ap_plain(words, less, less_r, total, block=block),
                                   ref, rtol=1e-14, atol=1e-14)


def test_auto_routes_wide_codes_to_argsort():
    data = _data(5, 40, 4100, 3, seed=9)
    got = calc_map_k_4dir_auto(*(torch.from_numpy(a) for a in data))
    np.testing.assert_allclose(got, _numpy_4dir(*data, None), rtol=0, atol=NUMPY_TOL)
    assert calc_map_k(data[0], data[3], data[4], data[5]) == pytest.approx(got[0], abs=1e-12)
    assert packed_dtype(126) == torch.uint8 and packed_dtype(127) == torch.int16
