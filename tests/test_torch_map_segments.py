"""The segment split of the counting-rank mAP (kernels K3-hist and K3-ap).

Each row of N gallery items is cut into segments of L items; pass 1 counts
per-segment histograms, ``rank_counts`` turns them into each segment's
starting counters, and pass 2 gives one partial sum a segment. Here the plain
versions, which take the same split for any L ≥ 1, are held against the
single-segment split (L ≥ N): histograms summed over the segments exactly,
APs within 1e-12 (the same fp32 quotients, fp64 sums in another order),
and the 4-direction mAP through segmented passes against cmh_tpu's Pallas
kernels in interpret mode (PALLAS_TOL: cmh_tpu sums in fp32).
"""

import numpy as np
import pytest
import torch_threads  # noqa: F401  (before any torch work)
import torch

from cmh_torch.ops import map_kernel
from cmh_torch.ops.map_bucketed import calc_map_k_4dir
from cmh_torch.ops.map_kernel import (MIN_SEGMENT, TILE_BYTES, map_ap,
                                      map_ap_plain, map_hist, map_hist_plain, pack_words,
                                      packed_dtype, rank_counts, segment_len)
from cmh_torch.ops.metrics import calc_label_sim
from cmh_tpu.ops import map_bucketed as jax_bucketed
from cmh_tpu.ops.map_pallas import calc_map_k_4dir_pallas

AP_TOL = 1e-12
PALLAS_TOL = 1e-6


def _words(nq, n, bits, seed, empty=1):
    rng = np.random.RandomState(seed)
    q = rng.choice([-1.0, 1.0], (nq, bits)).astype(np.float32)
    r = rng.choice([-1.0, 1.0], (n, bits)).astype(np.float32)
    ql = (rng.rand(nq, 4) > 0.6).astype(np.float32)
    rl = (rng.rand(n, 4) > 0.6).astype(np.float32)
    ql[:empty] = 0                  # a query with no relevant item
    gnd = calc_label_sim(torch.from_numpy(ql), torch.from_numpy(rl))
    return pack_words(torch.from_numpy(q), torch.from_numpy(r), gnd, bits)


def _seg_len(case, n):
    return {"n-1": max(1, n - 1), "n": n, ">n": n + 7}.get(case, case)


@pytest.mark.parametrize("case", [1, 32, 33, 512, "n-1", "n", ">n"])
@pytest.mark.parametrize("n", [20, 97, 1024])
@pytest.mark.parametrize("bits", [4, 16, 127, 1024])
def test_segmented_passes_equal_one_segment(bits, n, case):
    """n = 20 is below a round of 32 items, 97 is a multiple of no L but 1
    and itself, 1024 a multiple of 1, 32 and 512."""
    seg_len = _seg_len(case, n)
    words = _words(6, n, bits, seed=bits + n)
    assert words.dtype == packed_dtype(bits)
    seg_hist, seg_rhist = map_hist_plain(words, bits, seg_len)
    s = -(-n // seg_len)
    assert seg_hist.shape == seg_rhist.shape == (6, s, bits + 1)
    assert seg_hist.dtype == seg_rhist.dtype == torch.int32
    # each segment's counts against numpy, exactly
    d, rel = (words.numpy().astype(np.int64) >> 1), (words.numpy().astype(np.int64) & 1)
    for i in range(s):
        cut = slice(i * seg_len, (i + 1) * seg_len)
        for q in range(6):
            np.testing.assert_array_equal(seg_hist[q, i].numpy(),
                                          np.bincount(d[q, cut], minlength=bits + 1))
            np.testing.assert_array_equal(
                seg_rhist[q, i].numpy(),
                np.bincount(d[q, cut], weights=rel[q, cut], minlength=bits + 1))
    one_hist, one_rhist = map_hist_plain(words, bits, n)
    assert torch.equal(seg_hist.sum(1, dtype=torch.int32), one_hist[:, 0])
    assert torch.equal(seg_rhist.sum(1, dtype=torch.int32), one_rhist[:, 0])
    for k in (None, 3):
        start, start_r, total = rank_counts(seg_hist, seg_rhist, k)
        one_start, one_start_r, one_total = rank_counts(one_hist, one_rhist, k)
        assert torch.equal(total, one_total)
        # a segment starts where the one before it ends
        assert torch.equal(start[:, 0], one_start[:, 0])
        assert torch.equal(start[:, 1:], (start + seg_hist)[:, :-1])
        assert torch.equal(start_r[:, 1:], (start_r + seg_rhist)[:, :-1])
        ap = map_ap_plain(words, start, start_r, total, seg_len)
        want = map_ap_plain(words, one_start, one_start_r, one_total, n)
        assert ap.dtype == torch.float64 and ap.shape == (6,)
        torch.testing.assert_close(ap, want, rtol=0, atol=AP_TOL)
        assert float(ap[0]) == 0.0


@pytest.mark.parametrize("bits,seg_len", [(16, 33), (16, 512), (64, 32), (127, 100),
                                          (1024, 7)])
def test_4dir_through_segments_matches_pallas(monkeypatch, bits, seg_len):
    """``calc_map_k_4dir`` with the segment length forced small, so that its
    150 (60 at 1024 bits) items take several segments, against cmh_tpu's
    Pallas kernels in interpret mode and its XLA counting rank."""
    monkeypatch.setattr(map_kernel, "segment_len", lambda b: seg_len)
    nr = 150 if bits <= 128 else 60
    rng = np.random.RandomState(bits + seg_len)
    qi, qt = (rng.choice([-1.0, 1.0], (13, bits)).astype(np.float32) for _ in range(2))
    ri, rt = (rng.choice([-1.0, 1.0], (nr, bits)).astype(np.float32) for _ in range(2))
    ql = (rng.rand(13, 5) > 0.6).astype(np.float32)
    rl = (rng.rand(nr, 5) > 0.6).astype(np.float32)
    ql[:2] = 0
    data = (qi, qt, ri, rt, ql, rl)
    got = calc_map_k_4dir(*data, k=None, chunk=5)
    tq, tn, _ = jax_bucketed._pallas_tiles(bits)
    pal = calc_map_k_4dir_pallas(*data, None, chunk=8, interpret=True,
                                 tq=min(tq, 8), tn=min(tn, 64))
    np.testing.assert_allclose(got, pal, rtol=0, atol=PALLAS_TOL)
    monkeypatch.undo()
    np.testing.assert_allclose(got, calc_map_k_4dir(*data, k=None, chunk=5),
                               rtol=0, atol=AP_TOL)


@pytest.mark.parametrize("bits", [1, 4, 16, 32, 64, 126, 127, 128, 255, 256, 1022,
                                  1023, 1024, 2048, 4094])
def test_segment_len_is_whole_tiles_within_the_counter_budget(bits):
    """Whole 512-byte tiles, at least MIN_SEGMENT items and at least 4·V
    (V = bits + 1: one counter of the 2·V a pass handles for every two
    items), the shortest such length, and below K3-hist's 2^16 items."""
    seg_len = segment_len(bits)
    tile = TILE_BYTES // (torch.iinfo(packed_dtype(bits)).bits // 8)
    v = bits + 1
    assert seg_len % tile == 0
    assert seg_len >= MIN_SEGMENT and 2 * v <= seg_len / 2
    shorter = seg_len - tile
    assert shorter < MIN_SEGMENT or 2 * v > shorter / 2
    assert seg_len < 1 << 16


def test_segment_len_at_the_main_path_widths():
    assert [segment_len(b) for b in (16, 64, 126, 127, 1023, 1024, 2048, 4094)] == \
        [4096, 4096, 4096, 4096, 4096, 4352, 8448, 16384]


def test_segment_length_below_one_raises():
    words = _words(2, 10, 4, seed=0)
    with pytest.raises(ValueError, match="at least 1"):
        map_hist(words, 4, 0)
    start, start_r, total = rank_counts(*map_hist(words, 4), None)
    with pytest.raises(ValueError, match="at least 1"):
        map_ap(words, start, start_r, total, 0)
