"""K4's launch geometry and output realignment, checked on the CPU.

``csrc/hamming.cu`` gives each thread R consecutive gallery rows (16 for
uint8, 4 for int32) and stores a warp's 512 bytes of an output row as
16-byte chunks, whatever the row's alignment: each lane funnel-shifts its
left neighbour's 16 bytes and its own by s = (row start) mod 16, and the
partial chunks at the ends go out as single bytes. The card is not here, so
``store_row`` and ``realign`` below repeat the kernel's arithmetic step for
step in numpy, and the tests hold them, and the kernel's tiling, to the
plain distances at every alignment. The wrapper's own arithmetic
(``query_tile``) is tested directly.
"""

import numpy as np
import pytest
import torch_threads  # noqa: F401  (before any torch work)
import torch

from cmh_torch.ops import hamming as H

THREADS = 128   # csrc/hamming.cu kThreads, mirrored by the wrapper
LANES = 32


def funnelshift_r(lo, hi, sh):
    return ((int(hi) << 32 | int(lo)) >> (sh & 31)) & 0xFFFFFFFF


def realign(x, d, s):
    """csrc/hamming.cu realign: 16-byte values as four little-endian words."""
    if s == 0:
        return list(d)
    o = 16 - s
    sh = 8 * (o & 3)
    y = list(x) + list(d)
    a, b, c, e, f = y[(o >> 2):(o >> 2) + 5]
    return [funnelshift_r(a, b, sh), funnelshift_r(b, c, sh),
            funnelshift_r(c, e, sh), funnelshift_r(e, f, sh)]


def words(b):
    return [int(v) for v in np.frombuffer(bytes(b), dtype="<u4")]


def as_bytes(w):
    return np.array(w, dtype="<u4").view(np.uint8)


def store_row(mem, p, data, valid):
    """csrc/hamming.cu store_row for one warp: ``data`` (32, 16) uint8, lane
    t's bytes belonging at mem[p + 16 t ...]; writes only the first
    ``valid`` bytes of the warp's span."""
    s = p & 15
    base = p - s
    d = [words(data[lane]) for lane in range(LANES)]
    c = [realign(d[(lane + 31) & 31], d[lane], s) for lane in range(LANES)]
    if valid <= 0:
        return
    end = s + valid
    for lane in range(LANES):
        if (lane > 0 or s == 0) and end >= 16 * lane + 16:
            mem[base + 16 * lane: base + 16 * lane + 16] = as_bytes(c[lane])
    head = s > 0 or end < 16
    last = (end - 1) >> 4
    tail = last > 0 and (end & 15) != 0
    if head or tail:
        for lane in range(LANES):
            v = c[0 if lane < 16 else last & 31]
            j = lane & 15
            byte = (v[j >> 2] >> (8 * (j & 3))) & 0xFF
            if (head and s <= j < end) if lane < 16 else (tail and j < (end & 15)):
                mem[base + (j if lane < 16 else 16 * last + j)] = byte


@pytest.mark.parametrize("s", range(16))
def test_realign_is_the_byte_window(s):
    rng = np.random.RandomState(s)
    for _ in range(20):
        x, d = rng.randint(0, 256, 16).astype(np.uint8), rng.randint(0, 256, 16).astype(np.uint8)
        want = np.concatenate([x, d])[16 - s:32 - s]
        np.testing.assert_array_equal(as_bytes(realign(words(x), words(d), s)), want)


@pytest.mark.parametrize("s", range(16))
def test_store_row_writes_exactly_the_valid_span(s):
    """Every start alignment, full and short warps, and uint8 or int32 spans
    (int32 rows start on 4-byte boundaries and end on whole words)."""
    rng = np.random.RandomState(100 + s)
    for valid in (1, 2, 3, 15, 16, 17, 31, 32, 33, 100, 496, 497, 500, 511, 512):
        if s % 4 and valid % 4 == 0:
            continue
        data = rng.randint(0, 256, (LANES, 16)).astype(np.uint8)
        mem = np.full(512 + 96, 0xA5, dtype=np.uint8)
        p = 32 + s
        store_row(mem, p, data, valid)
        want = np.full_like(mem, 0xA5)
        want[p:p + valid] = data.reshape(-1)[:valid]
        np.testing.assert_array_equal(mem, want, err_msg=f"s={s} valid={valid}")


def kernel_emulation(qp, gp, bits, out_offset):
    """The kernel's tiling and stores in numpy: blocks of THREADS threads, R
    rows a thread, warps of 32 lanes, each (warp, query) through
    ``store_row``, into memory whose output starts ``out_offset`` bytes past a
    16-byte boundary. Returns the output bytes and whether the bytes around
    it were left alone."""
    dist = H.hamming_plain(qp, gp, bits).numpy()
    nq, ng = dist.shape
    esz = dist.dtype.itemsize
    r = 16 // esz
    tile_rows = r * THREADS
    rng = np.random.RandomState(0)
    mem = np.full(nq * ng * esz + 64 + out_offset, 0x5A, dtype=np.uint8)
    out = 32 + out_offset
    for n0 in range(0, ng, tile_rows):
        for warp in range(THREADS // LANES):
            nw0 = n0 + warp * LANES * r
            valid = max(0, min(LANES * r, ng - nw0)) * esz
            for qi in range(nq):
                row = np.zeros(LANES * r, dtype=dist.dtype)
                take = dist[qi, nw0:nw0 + LANES * r]
                row[:len(take)] = take
                data = row.view(np.uint8).reshape(LANES, 16).copy()
                if len(take) < LANES * r:   # rows past the gallery hold junk
                    junk = rng.randint(0, 256, (LANES * 16 - len(take) * esz,))
                    data.reshape(-1)[len(take) * esz:] = junk
                store_row(mem, out + (qi * ng + nw0) * esz, data, valid)
    body = mem[out:out + nq * ng * esz].view(dist.dtype).reshape(nq, ng)
    untouched = bool((mem[:out] == 0x5A).all() and (mem[out + nq * ng * esz:] == 0x5A).all())
    return dist, body, untouched


@pytest.mark.parametrize("bits,nq,ng,offset", [
    (16, 3, 17, 0), (16, 5, 4873, 0), (16, 17, 4105, 7), (16, 1, 1, 3),
    (64, 4, 2063, 0), (225, 2, 33, 5), (256, 5, 530, 0), (1024, 3, 1029, 4)])
def test_kernel_tiling_writes_the_plain_distances(bits, nq, ng, offset):
    """Rows starting at every alignment (N odd), a last tile and a last warp
    cut short, warps past the gallery's end, and an output that itself
    starts off a 16-byte boundary (int32 outputs on a 4-byte one)."""
    from cmh_torch.ops.hashing import pack_bits

    rng = np.random.RandomState(bits + ng)
    qp = pack_bits(torch.from_numpy(rng.choice([-1.0, 1.0], (nq, bits)).astype(np.float32)))
    gp = pack_bits(torch.from_numpy(rng.choice([-1.0, 1.0], (ng, bits)).astype(np.float32)))
    dist, body, untouched = kernel_emulation(qp, gp, bits, offset)
    np.testing.assert_array_equal(body, dist)
    assert untouched


def test_query_tile_for_the_main_path_shapes():
    # (rows a block, blocks resident on the card) as an H100 reports them:
    # uint8 over one word, 2,048 rows and 9 blocks an SM (132 SMs); two
    # words, 6 an SM; int32 over 32 words, 512 rows and 3 an SM
    one, two, wide = (2048, 1188), (2048, 792), (512, 396)
    # Q=64 at 16 bits: 513 gallery tiles, queries split to 16 a block so
    # that 2,052 blocks fill the 1,188 slots; at 64 bits 1,026 fill 792
    assert H.query_tile(64, 1_049_353, 1, *one) == 16
    assert H.query_tile(64, 1_049_353, 2, *two) == 32
    assert H.query_tile(4, 1 << 20, 1, *one) == 4            # a request: one tile
    assert H.query_tile(64, 1 << 18, 32, *wide) == 64        # 512 blocks already
    # a small gallery block: queries split, not below 8 a tile
    assert H.query_tile(64, 4096, 1, *one) == 8
    assert H.query_tile(4, 4096, 1, *one) == 4
    assert H.query_tile(1024, 4096, 1, *one) == 8
    assert H.query_tile(512, 20_000, 1, 2048, 264) == 16     # 10 blocks x 32 tiles >= 264
    # wide codes: the query tile's words stay within 64 KB
    assert H.query_tile(1000, 1 << 20, 384, 512, 132) == 40
    # more resident waves asked for: more, smaller query tiles
    saved = H._WAVES
    try:
        H._WAVES = 0.5
        assert H.query_tile(64, 1_049_353, 1, *one) == 32
    finally:
        H._WAVES = saved


@pytest.mark.parametrize("words", [1, 2, 8, 32, 64, 100, 384])
def test_query_tile_keeps_the_grid_and_shared_memory_in_range(words):
    for nq in (1, 7, 8, 9, 63, 64, 65, 1000, H._MAX_QUERIES):
        for ng in (1, 2048, 2049, 1 << 20):
            for rows in (512, 2048):
                for resident in (132, 132 * 16):
                    tile = H.query_tile(nq, ng, words, rows, resident)
                    assert 1 <= tile <= min(nq, H._MAX_TILE_Q)
                    assert tile == nq or tile >= H._SUB_Q
                    assert -(-nq // tile) <= 65535                  # grid.y
                    assert -(-tile // 8) * 8 * words <= H._TILE_Q_WORDS or tile == H._SUB_Q
