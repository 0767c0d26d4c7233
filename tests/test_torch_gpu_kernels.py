"""cmh_torch's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test skips inside itself when no CUDA device is
present (never at import or collection time). The repository's
``tests/conftest.py`` imports jax, which a machine that only has the card
and PyTorch may lack, so run these there with:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_kernels.py
"""

import numpy as np
import pytest
import torch_threads  # noqa: F401  (before any torch work)
import torch

from cmh_torch.ops.attention import fused_attention, kpm_bias

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def assert_within_one_bf16_step(got, want):
    """At most 1% of the elements (at least one) differ, each by one bf16
    step or by 1e-6: two fp32 results a last bit apart round to neighbouring
    bf16 values, and near 0, where bf16 steps are tiny, fp32 summation noise
    (up to 2.4e-7 at these shapes against an fp64 sum) spans several. A
    kernel that rounds W to bf16 before dV moves about 40% of dV."""
    assert got.dtype == want.dtype == torch.bfloat16

    def ordinal(t):   # bf16 bit patterns in value order, +0 and -0 alike
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -32768 - i, i)

    steps = (ordinal(got) - ordinal(want)).abs()
    far = (steps > 1) & ((got.float() - want.float()).abs() > 1e-6)
    assert not bool(far.any())
    assert int((steps > 0).sum()) <= max(1, steps.numel() // 100)


@pytest.mark.parametrize("rows,d", [(1, 64), (37, 512), (1000, 768), (5, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layernorm_kernel_matches_plain(cuda, rows, d, dtype):
    from cmh_torch.ops.layernorm import fused_layernorm, layernorm_plain

    g = torch.Generator().manual_seed(rows * d)
    x = (torch.randn(rows, d, generator=g) * 3 + 1).to(dtype).to(cuda)
    gamma = torch.randn(d, generator=g).to(cuda)
    beta = torch.randn(d, generator=g).to(cuda)
    before = fused_layernorm.launches
    out = fused_layernorm(x, gamma, beta)
    torch.cuda.synchronize()
    assert fused_layernorm.launches == before + 1
    ref = layernorm_plain(x, gamma, beta)
    # fp32: summation order only; bf16: fp32 in both, rounded once
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    else:
        assert_within_one_bf16_step(out, ref)


def _grid_rows(x, bwd):
    """Rows one pass of the persistent grid covers: one a warp."""
    import cmh_torch.ops.layernorm as L

    lib = L._lib()
    return L._grid(lib, x, bwd) * lib.cmh_layernorm_warps_per_block(int(bwd))


@pytest.mark.parametrize("d", [64, 512, 768, 1024])
@pytest.mark.parametrize("rows", [1, 7, "grid+1", 12800])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layernorm_kernels_at_the_persistent_loop_edges(cuda, rows, d, dtype):
    """Forward and backward at row counts below one warp a block, one past a
    full pass of the persistent grid (one warp takes a second row) and the
    image tower's at the serving batch; the forward is deterministic."""
    from cmh_torch.ops.layernorm import (fused_layernorm, layernorm_bwd, layernorm_bwd_plain,
                                         layernorm_plain)

    probe = torch.zeros(1, d, dtype=dtype, device=cuda)
    n = {"grid+1": max(_grid_rows(probe, False), _grid_rows(probe, True)) + 1}.get(rows, rows)
    g = torch.Generator().manual_seed(n + d)
    x = (torch.randn(n, d, generator=g) * 3 + 1).to(dtype).to(cuda)
    dout = torch.randn(n, d, generator=g).to(dtype).to(cuda)
    gamma, beta = (torch.randn(d, generator=g).to(cuda) for _ in range(2))
    out = fused_layernorm(x, gamma, beta)
    got = layernorm_bwd(x, gamma, dout)
    torch.cuda.synchronize()
    want, want_b = layernorm_plain(x, gamma, beta), layernorm_bwd_plain(x, gamma, dout)
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got[0], want_b[0], rtol=1e-4, atol=1e-4)
    else:
        assert_within_one_bf16_step(out, want)
        assert_within_one_bf16_step(got[0], want_b[0])
    for a, w in zip(got[1:], want_b[1:]):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-3)
    assert torch.equal(fused_layernorm(x, gamma, beta), out)


def test_layernorm_kernels_at_the_widest_bf16_row(cuda):
    """d = 2048 in bf16, 8 vectors a lane: the backward's block partial needs
    more than 48 KB of shared memory, which its launch opts into."""
    from cmh_torch.ops.layernorm import (fused_layernorm, layernorm_bwd, layernorm_bwd_plain,
                                         layernorm_plain)

    g = torch.Generator().manual_seed(2048)
    x = (torch.randn(300, 2048, generator=g) * 3 + 1).bfloat16().to(cuda)
    dout = torch.randn(300, 2048, generator=g).bfloat16().to(cuda)
    gamma, beta = (torch.randn(2048, generator=g).to(cuda) for _ in range(2))
    assert_within_one_bf16_step(fused_layernorm(x, gamma, beta), layernorm_plain(x, gamma, beta))
    got, want = layernorm_bwd(x, gamma, dout), layernorm_bwd_plain(x, gamma, dout)
    assert_within_one_bf16_step(got[0], want[0])
    for a, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-3)


def test_layernorm_bwd_barrier_resets_between_calls(cuda):
    """The backward's grid barrier counts blocks in a word that each launch
    leaves at zero: calls of different row counts (so different grids) in a
    row give the plain version's sums, and a rerun gives the same bits."""
    from cmh_torch.ops.layernorm import layernorm_bwd, layernorm_bwd_plain

    g = torch.Generator().manual_seed(4)
    gamma = torch.randn(768, generator=g).to(cuda)
    cases = {}
    for n in (5000, 3, 37, 1):
        x = (torch.randn(n, 768, generator=g) * 3 + 1).bfloat16().to(cuda)
        cases[n] = (x, torch.randn(n, 768, generator=g).bfloat16().to(cuda))
    order = (5000, 3, 37, 5000, 1, 5000)
    results = [layernorm_bwd(cases[n][0], gamma, cases[n][1]) for n in order]
    torch.cuda.synchronize()
    for n, got in zip(order, results):
        want = layernorm_bwd_plain(cases[n][0], gamma, cases[n][1])
        assert_within_one_bf16_step(got[0], want[0])
        for a, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-3)
    for rerun in (results[3], results[5]):
        assert all(torch.equal(a, b) for a, b in zip(rerun, results[0]))


@pytest.mark.parametrize("b,h,s,hd", [(3, 12, 50, 64), (5, 8, 32, 64),
                                      (2, 2, 77, 32)])
@pytest.mark.parametrize("masks", ["none", "mask", "kpm", "both"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_matches_plain(cuda, b, h, s, hd, masks, dtype):
    from cmh_torch.ops.attention import attention_plain, fused_attention, kpm_bias

    g = torch.Generator().manual_seed(b * s + hd)
    q, k, v = (torch.randn(b, h, s, hd, generator=g).to(dtype).to(cuda)
               for _ in range(3))
    mask = (torch.full((s, s), float("-inf")).triu(1).to(cuda)
            if masks in ("mask", "both") else None)
    kpm = None
    if masks in ("kpm", "both"):
        kpm = torch.rand(b, s, generator=g) > 0.7
        kpm[:, 0] = False
        kpm = kpm.to(cuda)
    scale = hd**-0.5
    out = fused_attention(q, k, v, scale, mask, kpm)
    torch.cuda.synchronize()
    ref = attention_plain(q, k, v, scale, mask,
                          kpm_bias(kpm) if kpm is not None else None)
    # fp32: summation order; bf16: P and the output round to bf16 in both,
    # a last-bit logit difference can move a rounding step
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    else:
        assert_within_one_bf16_step(out, ref)


def _packed(rng, n, bits, cuda):
    from cmh_torch.ops.hashing import pack_bits

    codes = rng.choice([-1.0, 1.0], (n, bits)).astype(np.float32)
    return pack_bits(torch.from_numpy(codes)).to(cuda)


def _hamming_checked(q, gal, bits):
    """K4 on the card, bit-equal to the plain version, one launch."""
    from cmh_torch.ops.hamming import hamming_packed, hamming_plain

    before = hamming_packed.launches
    out = hamming_packed(q, gal, bits=bits)
    torch.cuda.synchronize()
    assert hamming_packed.launches == before + 1
    ref = hamming_plain(q, gal, bits=bits)
    assert out.dtype == ref.dtype and out.is_contiguous()
    assert torch.equal(out, ref)
    return out


# 16, 32: one word (uint8, words in registers); 64: two; 96, 225: uint8 words
# walked from shared memory; 256: eight words to int32 (registers); 1024 and
# 2048: int32 walked from shared memory, 2048 in two chunks
@pytest.mark.parametrize("bits", [16, 32, 64, 96, 225, 256, 1024, 2048])
def test_hamming_kernel_matches_plain(cuda, bits):
    rng = np.random.RandomState(bits)
    out = _hamming_checked(_packed(rng, 45, bits, cuda), _packed(rng, 1000, bits, cuda), bits)
    assert out.dtype == (torch.uint8 if bits <= 255 else torch.int32)


@pytest.mark.parametrize("bits", [16, 64, 96, 256, 1024])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 4873])
@pytest.mark.parametrize("nq", [1, 3, 4, 33, 64, 65])
def test_hamming_kernel_at_query_and_gallery_edges(cuda, nq, n, bits):
    """Fewer rows than one thread's 16 (or 4), one warp cut short, a last
    tile cut short; one query, a query tile of 64 and one past it, and
    galleries so small that the wrapper splits the queries."""
    rng = np.random.RandomState(nq * 7919 + n + bits)
    _hamming_checked(_packed(rng, nq, bits, cuda), _packed(rng, n, bits, cuda), bits)


@pytest.mark.parametrize("bits", [16, 256])
@pytest.mark.parametrize("n_mod", range(16))
def test_hamming_kernel_at_every_output_row_alignment(cuda, n_mod, bits):
    """N mod 16 = 0..15: output row q starts q·N·size bytes in, so with 19
    queries the rows start at many alignments mod 16 (every one for odd N)."""
    rng = np.random.RandomState(n_mod + bits)
    n = 4096 + 512 + n_mod
    _hamming_checked(_packed(rng, 19, bits, cuda), _packed(rng, n, bits, cuda), bits)


@pytest.mark.parametrize("bits", [16, 64, 96, 256, 1024])
@pytest.mark.parametrize("start", [1, 3, 7])
def test_hamming_kernel_reads_gallery_views_in_place(cuda, start, bits):
    """A row slice of the gallery (as the blocked search makes) starts
    4·W·start bytes into its allocation, off a 16-byte boundary for W = 1, 2
    and 3; the kernel reads it as it is, as it does a sliced query block."""
    rng = np.random.RandomState(start + bits)
    gal, q = _packed(rng, 3000 + start, bits, cuda), _packed(rng, 9 + start, bits, cuda)
    gv, qv = gal[start:], q[start:]
    assert gv.data_ptr() == gal.data_ptr() + 4 * gal.shape[1] * start
    _hamming_checked(qv, gv, bits)


def test_hamming_kernel_words_limits(cuda):
    """384 words (12,288 bits) is the widest code; wider raises. A uint8
    output over 9 words (a code of 100 bits in a wider word array) walks its
    words in two chunks of shared memory."""
    from cmh_torch.ops.hamming import hamming_packed

    rng = np.random.RandomState(384)
    _hamming_checked(_packed(rng, 70, 384 * 32, cuda), _packed(rng, 600, 384 * 32, cuda), 0)
    q = torch.zeros((3, 9), dtype=torch.int32)
    gal = torch.zeros((700, 9), dtype=torch.int32)
    q[:, :4] = torch.from_numpy(rng.randint(-2**31, 2**31, (3, 4)).astype(np.int32))
    gal[:, :4] = torch.from_numpy(rng.randint(-2**31, 2**31, (700, 4)).astype(np.int32))
    q[:, 3] &= 0xF
    gal[:, 3] &= 0xF
    out = _hamming_checked(q.to(cuda), gal.to(cuda), 100)
    assert out.dtype == torch.uint8
    with pytest.raises(ValueError, match="at most 384 words"):
        hamming_packed(torch.zeros((1, 385), dtype=torch.int32, device=cuda),
                       torch.zeros((1, 385), dtype=torch.int32, device=cuda))


def test_retrieval_search_on_the_card_equals_a_cpu_copy(cuda):
    """Blocks of 777 rows: every block but the first starts off a 16-byte
    boundary, and the last is short."""
    from cmh_torch.serving import RetrievalIndex

    rng = np.random.RandomState(777)
    gallery = rng.choice([-1.0, 1.0], (5000, 16)).astype(np.float32)
    queries = rng.choice([-1.0, 1.0], (6, 16)).astype(np.float32)
    queries[0] = gallery[4321]
    on_card, on_cpu = RetrievalIndex(16, device="cuda"), RetrievalIndex(16, device="cpu")
    for index in (on_card, on_cpu):
        index.add(gallery[:1234])
        index.add(gallery[1234:])
    got = on_card.search(queries, topk=25, block=777)
    want = on_cpu.search(queries, topk=25, block=777)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[0][0, 0] == 0 and got[1][0, 0] == 4321


@pytest.mark.parametrize("rows,d", [(1, 64), (37, 512), (5000, 768), (3200, 512),
                                    (700, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layernorm_bwd_kernel_matches_plain(cuda, rows, d, dtype):
    from cmh_torch.ops.layernorm import layernorm_bwd, layernorm_bwd_plain

    g = torch.Generator().manual_seed(rows + d)
    x = (torch.randn(rows, d, generator=g) * 3 + 1).to(dtype).to(cuda)
    dout = torch.randn(rows, d, generator=g).to(dtype).to(cuda)
    gamma = torch.randn(d, generator=g).to(cuda)
    before = layernorm_bwd.launches
    dx, dg, db = layernorm_bwd(x, gamma, dout)
    torch.cuda.synchronize()
    assert layernorm_bwd.launches == before + 1
    rdx, rdg, rdb = layernorm_bwd_plain(x, gamma, dout)
    # dx: fp32 summation order, then in bf16 one rounding of the fp32 result;
    # dγ/dβ: fp32 sums over up to 5000 rows in another order
    if dtype == torch.float32:
        torch.testing.assert_close(dx, rdx, rtol=1e-4, atol=1e-4)
    else:
        assert_within_one_bf16_step(dx, rdx)
    torch.testing.assert_close(dg, rdg, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(db, rdb, rtol=1e-4, atol=1e-3)
    again = layernorm_bwd(x, gamma, dout)    # fixed-order sums: deterministic
    assert all(torch.equal(a, b) for a, b in zip(again, (dx, dg, db)))


@pytest.mark.parametrize("b,h,s,hd", [(3, 12, 50, 64), (5, 8, 32, 64),
                                      (2, 2, 77, 64)])
@pytest.mark.parametrize("masks", ["none", "both"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_bwd_kernel_matches_plain(cuda, b, h, s, hd, masks, dtype):
    from cmh_torch.ops.attention import attention_bwd, attention_bwd_plain, kpm_bias

    g = torch.Generator().manual_seed(b * s + hd + 1)
    q, k, v, do = (torch.randn(b, h, s, hd, generator=g).to(dtype).to(cuda)
                   for _ in range(4))
    mask = bias = None
    if masks == "both":
        mask = torch.full((s, s), float("-inf")).triu(1).to(cuda)
        kpm = torch.rand(b, s, generator=g) > 0.7
        kpm[:, 0] = False
        bias = kpm_bias(kpm.to(cuda))
    scale = hd**-0.5
    before = attention_bwd.launches
    got = attention_bwd(q, k, v, scale, mask, bias, do)
    torch.cuda.synchronize()
    assert attention_bwd.launches == before + 1
    want = attention_bwd_plain(q, k, v, scale, mask, bias, do)
    # fp32: summation order over S and hd; bf16: one rounding of the fp32
    # result (both keep W unrounded)
    for a, r in zip(got, want):
        if dtype == torch.float32:
            torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-5)
        else:
            assert_within_one_bf16_step(a, r)


def _bf16_case(b, h, s, hd, seed, masks=True, packed=True):
    """bf16 q, k, v, dout and fp32 mask/bias; with ``packed``, q/k/v are the
    head views of one (B, S, 3·H·hd) projection and dout a head view of a
    (B, S, H·hd) gradient, as MultiHeadAttention and autograd hand them to
    the kernels."""
    g = torch.Generator().manual_seed(seed)
    if packed:
        qkv = torch.randn(b, s, 3 * h * hd, generator=g).bfloat16().cuda()
        q, k, v = (t.reshape(b, s, h, hd).transpose(1, 2) for t in qkv.split(h * hd, -1))
        do = torch.randn(b, s, h * hd, generator=g).bfloat16().cuda()
        do = do.reshape(b, s, h, hd).transpose(1, 2)
    else:
        q, k, v, do = (torch.randn(b, h, s, hd, generator=g).bfloat16().cuda()
                       for _ in range(4))
    mask = bias = None
    if masks:
        mask = torch.full((s, s), float("-inf")).triu(1).cuda()
        kpm = torch.rand(b, s, generator=g) > 0.7
        kpm[:, 0] = False
        bias = kpm_bias(kpm.cuda())
    return q, k, v, do, mask, bias


def _check_bf16_pair(q, k, v, do, mask, bias, scale):
    """Both bf16 kernels against their plain versions (one bf16 step), and
    their outputs in (B, S, H, hd) memory."""
    from cmh_torch.ops.attention import (_launch, attention_bwd, attention_bwd_plain,
                                         attention_plain)

    b, h, s, hd = q.shape
    before = (fused_attention.launches, attention_bwd.launches)
    out = _launch(q, k, v, scale, mask, bias)
    got = attention_bwd(q, k, v, scale, mask, bias, do)
    torch.cuda.synchronize()
    assert (fused_attention.launches, attention_bwd.launches) == (before[0] + 1,
                                                                  before[1] + 1)
    assert_within_one_bf16_step(out, attention_plain(q, k, v, scale, mask, bias))
    for a, r in zip(got, attention_bwd_plain(q, k, v, scale, mask, bias, do)):
        assert_within_one_bf16_step(a, r)
    for t in (out, *got):
        assert t.shape == (b, h, s, hd) and t.stride() == (s * h * hd, hd, h * hd, 1)


@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("tower", ["vision", "text"])
def test_attention_bf16_kernels_read_packed_head_views(cuda, tower, masks):
    from cmh_torch.ops.attention import kernel_strides

    h, s = (12, 50) if tower == "vision" else (8, 32)
    q, k, v, do, mask, bias = _bf16_case(6, h, s, 64, seed=s + int(masks), masks=masks)
    assert all(kernel_strides(t)[0] is t for t in (q, k, v, do))     # read in place
    _check_bf16_pair(q, k, v, do, mask, bias, 64**-0.5)


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("s", [1, 17, 50, 77, "max-bwd", "max-fwd"])
def test_attention_bf16_kernels_at_every_row_tile_count(cuda, s, hd):
    """S from one row to the largest each kernel is built for, padded to 16
    rows and partly filled: the backward up to its limit, the forward alone
    beyond it."""
    from cmh_torch.ops.attention import (BF16_MAX_S, attention_plain, fused_attention,
                                         kpm_bias)

    s = {"max-bwd": BF16_MAX_S["bwd"][hd], "max-fwd": BF16_MAX_S["fwd"][hd]}.get(s, s)
    q, k, v, do, mask, bias = _bf16_case(2, 3, s, hd, seed=s * hd, masks=s > 1)
    if s <= BF16_MAX_S["bwd"][hd]:
        _check_bf16_pair(q, k, v, do, mask, bias, hd**-0.5)
    else:
        out = fused_attention(q, k, v, hd**-0.5, mask, None)
        assert_within_one_bf16_step(out, attention_plain(q, k, v, hd**-0.5, mask, None))


def test_attention_bf16_all_masked_row_gives_nan(cuda):
    """A query row with every key masked is NaN in the kernels' results
    exactly where the plain versions (and jax.nn.softmax) give NaN; the
    rest holds to one bf16 step."""
    from cmh_torch.ops.attention import (_launch, attention_bwd, attention_bwd_plain,
                                         attention_plain)

    q, k, v, do, mask, bias = _bf16_case(3, 4, 50, 64, seed=11)
    mask[7] = float("-inf")
    got = (_launch(q, k, v, 0.125, mask, bias), *attention_bwd(q, k, v, 0.125, mask, bias, do))
    want = (attention_plain(q, k, v, 0.125, mask, bias),
            *attention_bwd_plain(q, k, v, 0.125, mask, bias, do))
    torch.cuda.synchronize()
    assert bool(torch.isnan(want[0][:, :, 7]).all())
    for a, r in zip(got, want):
        nan = torch.isnan(r)
        assert torch.equal(torch.isnan(a), nan)
        assert_within_one_bf16_step(a[~nan], r[~nan])


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_attention_bf16_past_the_s_limit_raises(cuda, which):
    """One row past the one-block kernels' limit no longer raises: the
    wrapper routes it to the row-tiled kernels, which match the plain
    version to one bf16 step."""
    from cmh_torch.ops.attention import (BF16_MAX_S, attention_bwd, attention_bwd_plain,
                                         attention_plain, route)

    s = BF16_MAX_S[which][64] + 1
    assert route(torch.bfloat16, which, s, 64) == "tiled"
    q, k, v, do, mask, bias = _bf16_case(2, 2, s, 64, seed=s)
    before = (fused_attention.launches_tiled, attention_bwd.launches_tiled)
    if which == "fwd":
        got = (fused_attention(q, k, v, 0.125, mask, None),)
        want = (attention_plain(q, k, v, 0.125, mask, None),)
    else:
        got = attention_bwd(q, k, v, 0.125, mask, bias, do)
        want = attention_bwd_plain(q, k, v, 0.125, mask, bias, do)
    torch.cuda.synchronize()
    assert (fused_attention.launches_tiled - before[0],
            attention_bwd.launches_tiled - before[1]) == ((1, 0) if which == "fwd" else (0, 1))
    for a, r in zip(got, want):
        assert_within_one_bf16_step(a, r)


def test_attention_bf16_bwd_is_deterministic(cuda):
    from cmh_torch.ops.attention import attention_bwd

    q, k, v, do, mask, bias = _bf16_case(16, 12, 50, 64, seed=3)
    first = attention_bwd(q, k, v, 0.125, mask, bias, do)
    again = attention_bwd(q, k, v, 0.125, mask, bias, do)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def _limit(dtype, which, hd):
    """The longest S the one-block kernel takes at ``hd``."""
    from cmh_torch.ops.attention import _MAX_SMEM, BF16_MAX_S, one_block_smem

    if dtype == torch.bfloat16:
        return BF16_MAX_S[which][hd]
    return max(s for s in range(1, 400) if one_block_smem(which, s, hd) <= _MAX_SMEM)


def _long_case(dtype, b, h, s, hd, masks, seed):
    """q, k, v, dout of one dtype (bf16: the head views of a packed
    projection) and the fp32 masks: "none", "causal" or "causal+kpm"."""
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bfloat16:
        q, k, v, do, _, _ = _bf16_case(b, h, s, hd, seed, masks=False)
    else:
        q, k, v, do = (torch.randn(b, h, s, hd, generator=g).cuda() for _ in range(4))
    mask = bias = None
    if masks != "none":
        mask = torch.full((s, s), float("-inf")).triu(1).cuda()
    if masks == "causal+kpm":
        kpm = torch.rand(b, s, generator=g) > 0.7
        kpm[:, 0] = False
        bias = kpm_bias(kpm.cuda())
    return q, k, v, do, mask, bias


def _rows_limit(hd):
    """The longest S the bf16 tensor-core row-tiled forward takes at ``hd``
    (one tile's logit rows in 227 KB of shared memory)."""
    from cmh_torch.ops.attention import tiled_fwd_tiles

    return max(s for s in range(1, 4000) if tiled_fwd_tiles(s, hd) > 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masks", ["none", "causal", "causal+kpm"])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("s", ["limit", "limit+1", 197, 257, 300, 577, "rows-limit",
                               "rows-limit+1"])
@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_attention_row_tiled_kernels_match_plain(cuda, which, s, hd, masks, dtype):
    """Each direction at its one-block limit (the one-block kernel), one row
    past it (at hd 32 in bf16: S 209 forward, 145 backward), at ViT-B/16's,
    ViT-L/14's, a longer S and a ViT-L/14 at 336 px (577 tokens), and at the
    bf16 forward's logit-row limit and one past it (there the bf16 forward's
    logit rows live in device memory): fp32 (3xTF32 on the tensor cores)
    within 1e-5, bf16 within one bf16 step (P and the outputs round to bf16
    in both)."""
    from cmh_torch.ops.attention import (attention_bwd, attention_bwd_plain,
                                         attention_plain, route)

    limit = _limit(dtype, which, hd)
    rows = _rows_limit(hd)
    s = {"limit": limit, "limit+1": limit + 1, "rows-limit": rows,
         "rows-limit+1": rows + 1}.get(s, s)
    way = route(dtype, which, s, hd)
    assert way == ("one_block" if s <= limit else "tiled")
    q, k, v, do, mask, bias = _long_case(dtype, 2, 3, s, hd, masks, seed=s * hd + len(masks))
    scale = hd**-0.5
    counts = lambda: (fused_attention.launches_tiled, attention_bwd.launches_tiled,
                      fused_attention.launches_tiled_tf32, attention_bwd.launches_tiled_tf32)
    before = counts()
    if which == "fwd":
        got = (fused_attention(q, k, v, scale, mask, None if bias is None else bias < 0),)
        want = (attention_plain(q, k, v, scale, mask, bias),)
    else:
        got = attention_bwd(q, k, v, scale, mask, bias, do)
        want = attention_bwd_plain(q, k, v, scale, mask, bias, do)
    torch.cuda.synchronize()
    tiled = int(way != "one_block")
    tf32 = tiled * int(dtype == torch.float32)   # of the row-tiled launches, the fp32 ones
    assert tuple(a - b for a, b in zip(counts(), before)) == \
        ((tiled, 0, tf32, 0) if which == "fwd" else (0, tiled, 0, tf32))
    for a, r in zip(got, want):
        assert a.shape == r.shape == q.shape
        if dtype == torch.float32:
            torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)
        else:
            assert_within_one_bf16_step(a, r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_row_tiled_bwd_is_deterministic(cuda, dtype):
    """Three launches and no atomics: a rerun gives the same bits."""
    from cmh_torch.ops.attention import attention_bwd, route

    assert route(dtype, "bwd", 257, 64) == "tiled"
    q, k, v, do, mask, bias = _long_case(dtype, 8, 4, 257, 64, "causal+kpm", seed=5)
    first = attention_bwd(q, k, v, 0.125, mask, bias, do)
    again = attention_bwd(q, k, v, 0.125, mask, bias, do)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_row_tiled_all_masked_row_gives_nan(cuda, dtype):
    """An all-masked query row is NaN where the plain versions give NaN; a
    wholly masked key block (keys 32..63 of every row, by the key-padding
    bias) is not."""
    from cmh_torch.ops.attention import (_launch, attention_bwd, attention_bwd_plain,
                                         attention_plain)

    q, k, v, do, mask, bias = _long_case(dtype, 3, 2, 257, 64, "causal+kpm", seed=13)
    bias[:, 32:64] = float("-inf")
    mask[40] = float("-inf")
    got = (_launch(q, k, v, 0.125, mask, bias), *attention_bwd(q, k, v, 0.125, mask, bias, do))
    want = (attention_plain(q, k, v, 0.125, mask, bias),
            *attention_bwd_plain(q, k, v, 0.125, mask, bias, do))
    torch.cuda.synchronize()
    assert bool(torch.isnan(want[0][:, :, 40]).all())
    assert not bool(torch.isnan(want[0][:, :, 100]).any())
    for a, r in zip(got, want):
        nan = torch.isnan(r)
        assert torch.equal(torch.isnan(a), nan)
        if dtype == torch.float32:
            torch.testing.assert_close(a[~nan], r[~nan], rtol=1e-5, atol=1e-5)
        else:
            assert_within_one_bf16_step(a[~nan], r[~nan])


@pytest.mark.parametrize("hd", [16, 48, 80, 128])
def test_attention_row_tiled_fp32_head_dims(cuda, hd):
    """fp32 at S = 300 (the row tiles both ways at every head dim) with head
    dims padded to the kernels' 32, 64 and 128 columns, on head views of a
    packed projection: within 1e-5 of the plain versions."""
    from cmh_torch.ops.attention import (attention_bwd, attention_bwd_plain,
                                         attention_plain, route)

    s = 300
    assert route(torch.float32, "fwd", s, hd) == route(torch.float32, "bwd", s, hd) == "tiled"
    g = torch.Generator().manual_seed(hd)
    qkv = torch.randn(2, s, 3 * 2 * hd, generator=g).cuda()
    q, k, v = (t.reshape(2, s, 2, hd).transpose(1, 2) for t in qkv.split(2 * hd, -1))
    do = torch.randn(2, 2, s, hd, generator=g).cuda()
    mask = torch.full((s, s), float("-inf")).triu(1).cuda()
    scale = hd**-0.5
    torch.testing.assert_close(fused_attention(q, k, v, scale, mask),
                               attention_plain(q, k, v, scale, mask), rtol=1e-5, atol=1e-5)
    for a, r in zip(attention_bwd(q, k, v, scale, mask, None, do),
                    attention_bwd_plain(q, k, v, scale, mask, None, do)):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)


def test_attention_route_agrees_with_the_one_block_smem_sizes(cuda):
    """``one_block_smem`` (which routes fp32 by S on the host) gives the
    bytes the one-block kernels ask for."""
    from cmh_torch.ops.attention import _lib, one_block_smem

    lib = _lib()
    for s in (1, 50, 117, 118, 162, 163, 257):
        for hd in (32, 64, 128):
            assert one_block_smem("fwd", s, hd) == lib.cmh_attention_smem_bytes(s, hd)
            assert one_block_smem("bwd", s, hd) == lib.cmh_attention_bwd_smem_bytes(s, hd)


def test_attention_route_agrees_with_the_row_tiled_smem_sizes(cuda):
    """``tiled_fwd_tiles`` and ``tiled_fwd_smem`` (which route the bf16
    forward by S on the host) give the tiles and bytes the tensor-core
    row-tiled forward takes, up to its logit-row limit and past it."""
    from cmh_torch.ops.attention import _tiled_lib, tiled_fwd_smem, tiled_fwd_tiles

    lib = _tiled_lib()
    for hd in (32, 64):
        rows = _rows_limit(hd)
        for s in (177, 197, 209, 257, 300, 304, 305, 577, 1000, 1329, rows, rows + 1):
            tiles = tiled_fwd_tiles(s, hd)
            assert lib.cmh_attention_tiled_fwd_tiles(s, hd) == tiles, (s, hd)
            assert lib.cmh_attention_tiled_fwd_smem(s, hd) == tiled_fwd_smem(s, hd, max(tiles, 1))
        assert tiled_fwd_tiles(rows + 1, hd) == 0 < tiled_fwd_tiles(rows, hd)


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("s", [257, "rows-limit"])
def test_attention_rows_in_device_memory_equal_shared_memory(cuda, s, hd):
    """The bf16 row-tiled forward with its logit rows in device memory (a
    persistent grid, one slot of rows a resident block; the route past the
    rows' shared-memory limit) runs the same code as with its rows in shared
    memory: at S where both run, the same bits, with more items than slots
    at S = 257; its scratch does not grow with B·H."""
    from cmh_torch.ops.attention import _launch, _launch_rows, _tiled_lib

    s = _rows_limit(hd) if s == "rows-limit" else s
    n = 64 if s == 257 else 2
    q, k, v, _, mask, bias = _long_case(torch.bfloat16, n, 4, s, hd, "causal+kpm", seed=s + hd)
    before = fused_attention.launches
    shared = _launch(q, k, v, hd**-0.5, mask, bias)
    assert fused_attention.launches == before + 1
    rows = _launch_rows(q, k, v, hd**-0.5, mask, bias)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1   # counted by _launch alone
    assert torch.equal(torch.isnan(rows), torch.isnan(shared))
    assert torch.equal(rows.nan_to_num(), shared.nan_to_num())
    # whole tiles of 16 rows of 16 ceil(S / 16) + 8 floats, the same count
    # on every SM, whatever B and H
    nbytes = _tiled_lib().cmh_attention_tiled_fwd_rows_bytes(s, 0)
    tile = 16 * (16 * -(-s // 16) + 8) * 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert nbytes > 0 and nbytes % (tile * sms) == 0


def test_autograd_reaches_the_kernels(cuda):
    """On the card the LayerNorm and attention outputs carry a gradient,
    and backward launches the backward kernels."""
    from cmh_torch.ops.attention import attention_bwd, fused_attention
    from cmh_torch.ops.layernorm import fused_layernorm, layernorm_bwd

    x = torch.randn(4, 10, 64, device=cuda, requires_grad=True)
    gamma = torch.ones(64, device=cuda, requires_grad=True)
    beta = torch.zeros(64, device=cuda, requires_grad=True)
    y = fused_layernorm(x, gamma, beta)
    q = y.reshape(4, 10, 2, 32).transpose(1, 2)
    out = fused_attention(q, q, q, 32**-0.5)
    assert y.requires_grad and out.requires_grad
    before = (layernorm_bwd.launches, attention_bwd.launches)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert (layernorm_bwd.launches, attention_bwd.launches) == (before[0] + 1,
                                                                before[1] + 1)
    for t in (x, gamma, beta):
        assert t.grad is not None and torch.isfinite(t.grad).all()


@pytest.mark.parametrize("bits,n,k,rows,seg_len", [
    (4, 3000, None, 70, None),      # rows start 8 bytes off a 16-byte boundary; n < L
    (4, 300, None, 70, 1),          # one item a segment
    (16, 5000, None, 70, None),     # two segments, the second ragged; rows unaligned
    (16, 8192, None, 70, None),     # n an exact multiple of L = 4096
    (16, 3000, None, 70, 33),       # odd L: every segment starts unaligned
    (16, 20000, None, 4096, None),  # a 4,096-row chunk, five segments
    (64, 4097, 50, 70, None),       # L = 4096: the second segment holds one item
    (64, 3000, 50, 70, 512),        # one tile a segment
    (127, 1000, None, 70, None),
    (1024, 700, None, 70, None),
    (1024, 700, None, 70, 256),
    (4094, 257, 5, 70, None),
    (4094, 70000, None, 16, None),  # five segments of 16,384
    (4, 140000, None, 16, 65535),   # three segments, two of the longest length
])
def test_map_kernels_match_plain(cuda, bits, n, k, rows, seg_len):
    from cmh_torch.ops.map_kernel import (map_ap, map_ap_plain, map_hist,
                                          map_hist_plain, pack_words, rank_counts)
    from cmh_torch.ops.metrics import calc_label_sim

    rng = np.random.RandomState(bits + n)
    q = torch.from_numpy(rng.choice([-1.0, 1.0], (rows, bits)).astype(np.float32)).to(cuda)
    r = torch.from_numpy(rng.choice([-1.0, 1.0], (n, bits)).astype(np.float32)).to(cuda)
    ql = torch.from_numpy((rng.rand(rows, 6) > 0.7).astype(np.float32)).to(cuda)
    rl = torch.from_numpy((rng.rand(n, 6) > 0.7).astype(np.float32)).to(cuda)
    ql[:3] = 0                      # queries with no relevant item
    words = pack_words(q, r, calc_label_sim(ql, rl), bits)
    before = (map_hist.launches, map_ap.launches)
    hist, rhist = map_hist(words, bits, seg_len)
    torch.cuda.synchronize()
    ph, prh = map_hist_plain(words, bits, seg_len)
    assert hist.shape == ph.shape
    assert torch.equal(hist, ph) and torch.equal(rhist, prh)      # exact
    start, start_r, total = rank_counts(hist, rhist, k)
    ap = map_ap(words, start, start_r, total, seg_len)
    torch.cuda.synchronize()
    assert (map_hist.launches, map_ap.launches) == (before[0] + 1, before[1] + 1)
    # identical fp32 quotients, fp64 sums in another order
    torch.testing.assert_close(ap, map_ap_plain(words, start, start_r, total, seg_len),
                               rtol=1e-12, atol=1e-12)
    assert float(ap[:3].abs().sum()) == 0.0
    # no float atomics, partial sums added in a fixed order: the same bits again
    assert torch.equal(map_ap(words, start, start_r, total, seg_len), ap)


def test_map_hist_counts_a_full_segment_of_one_bucket(cuda):
    """K3-hist keeps a segment's counts of all and of relevant items in the
    two 16-bit halves of one counter: 65,535 relevant items in one bucket
    fill both halves, and a longer segment is refused."""
    from cmh_torch.ops.map_kernel import map_hist

    words = torch.full((3, 2 * 65535 + 5), 2 * 7 + 1, dtype=torch.uint8, device=cuda)
    hist, rhist = map_hist(words, 16, 65535)
    torch.cuda.synchronize()
    want = torch.zeros((3, 3, 17), dtype=torch.int32, device=cuda)
    want[:, :, 7] = torch.tensor([65535, 65535, 5], dtype=torch.int32, device=cuda)
    assert torch.equal(hist, want) and torch.equal(rhist, want)
    with pytest.raises(ValueError, match="segments of 1 to 65535"):
        map_hist(words, 16, 65536)


def test_map_4dir_kernel_matches_numpy(cuda):
    from cmh_torch.ops.map_bucketed import calc_map_k_4dir_auto
    from cmh_torch.ops.map_kernel import map_ap
    from cmh_torch.ops.metrics import calc_map_k_numpy

    rng = np.random.RandomState(3)
    nq, n, bits = 300, 1200, 16
    qi, qt = (rng.choice([-1.0, 1.0], (nq, bits)).astype(np.float32) for _ in range(2))
    ri, rt = (rng.choice([-1.0, 1.0], (n, bits)).astype(np.float32) for _ in range(2))
    ql = (rng.rand(nq, 8) > 0.8).astype(np.float32)
    rl = (rng.rand(n, 8) > 0.8).astype(np.float32)
    before = map_ap.launches
    got = calc_map_k_4dir_auto(*(torch.from_numpy(a).to(cuda)
                                 for a in (qi, qt, ri, rt, ql, rl)))
    assert map_ap.launches == before + 1
    want = [calc_map_k_numpy(a, b, ql, rl)
            for a, b in ((qi, rt), (qt, ri), (qi, ri), (qt, rt))]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("n,offset", [(1, 0), (255, 0), (257, 7), (4098, 0), (100_003, 0),
                                      (4096, 2**32 - 1000), (4099, 2**32 - 1001),
                                      (33, 3 * 2**32 - 6)])
def test_threefry_bits_kernel_matches_plain(cuda, n, offset):
    """Bit for bit, with one launch a hi word of the counters (two where
    the offset takes them across 2^32, the second off a 16-byte boundary)."""
    from cmh_torch.ops.random import random_bits
    from cmh_torch.utils import prng

    key = prng.fold_in(prng.PRNGKey(1814), n)
    before = random_bits.launches
    got = random_bits(key, (n,), cuda, offset=offset)
    torch.cuda.synchronize()
    assert random_bits.launches == before + 1 + ((offset + n - 1) >> 32) - (offset >> 32)
    assert torch.equal(got.cpu(), prng.random_bits(key, (n,), offset))


@pytest.mark.parametrize("shape,part", [((3, 7), None), ((4, 6, 5, 9), None),
                                        ((4, 3, 5, 9), (1, 3, 6)), ((2, 6, 33), (0, 5, 9))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_kernels_match_plain(cuda, shape, part, dtype):
    """Forward and backward, whole or a part of a larger array (a head shard,
    a block of rows), bit for bit against the plain dropout on the CPU."""
    from cmh_torch.ops.random import dropout, dropout_bwd, dropout_plain
    from cmh_torch.utils import prng

    key = prng.flax_key(prng.PRNGKey(5), "hash_img", "drop", 1)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(2)).to(dtype)
    xc = x.to(cuda).requires_grad_(True)
    fwd, bwd = dropout.launches, dropout_bwd.launches
    y = dropout(xc, key, 0.3, part)
    y.backward(torch.ones_like(y))
    torch.cuda.synchronize()
    assert (dropout.launches, dropout_bwd.launches) == (fwd + 1, bwd + 1)
    assert torch.equal(y.detach().cpu(), dropout_plain(x, key, 0.3, part))
    assert torch.equal(xc.grad.cpu(), dropout_plain(torch.ones_like(x), key, 0.3, part))


def _dropout_both_ways(cuda, x, key, part=None):
    """The kernels' forward and backward on ``x`` (a CUDA tensor, maybe a
    view), each bit for bit against the plain dropout on the CPU."""
    from cmh_torch.ops.random import dropout, dropout_bwd, dropout_plain

    fwd, bwd = dropout.launches, dropout_bwd.launches
    y, g = dropout(x, key, 0.3, part), dropout_bwd(x, key, 0.3, part)
    torch.cuda.synchronize()
    assert (dropout.launches, dropout_bwd.launches) == (fwd + 1, bwd + 1)
    want = dropout_plain(x.cpu(), key, 0.3, part)
    assert torch.equal(y.cpu(), want) and torch.equal(g.cpu(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("extra", [1, 2, 3, 5, 7])
def test_dropout_vectors_with_a_ragged_tail(cuda, dtype, extra):
    """n = 1, 2, 3 … past a whole number of 16-byte vectors (4 fp32, 8 bf16)."""
    from cmh_torch.utils import prng

    n = 8 * 1000 + extra
    x = torch.randn(n, generator=torch.Generator().manual_seed(extra)).to(dtype).to(cuda)
    _dropout_both_ways(cuda, x, prng.PRNGKey(extra))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("skew", [1, 2, 3, 5])
def test_dropout_of_a_view_off_a_16_byte_boundary(cuda, dtype, skew):
    """A contiguous view at an odd storage offset: the head elements one a
    thread, then vectors (the output aligned as the input)."""
    from cmh_torch.utils import prng

    buf = torch.randn(5000, generator=torch.Generator().manual_seed(skew)).to(dtype).to(cuda)
    x = buf[skew:skew + 4321]
    assert x.is_contiguous() and x.data_ptr() % 16
    _dropout_both_ways(cuda, x, prng.PRNGKey(skew))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_part_whose_inner_is_not_a_vector(cuda, dtype):
    """Rank 1's heads of UMoED's attention probabilities at tp=2: a last dim
    of 82, so the part map's jumps fall inside the threads' vectors."""
    from cmh_torch.ops.random import dropout_plain
    from cmh_torch.utils import prng

    key = prng.flax_key(prng.PRNGKey(5), "hash_module", "layer_0", "drop1", 1)
    whole = torch.rand((10, 8, 7, 82), generator=torch.Generator().manual_seed(3)).to(dtype)
    _dropout_both_ways(cuda, whole[:, 4:].contiguous().to(cuda), key, (1, 4, 8))
    y = dropout_plain(whole, key, 0.3)[:, 4:]
    assert torch.equal(y, dropout_plain(whole[:, 4:].contiguous(), key, 0.3, (1, 4, 8)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.1, 0.2, 0.3])
def test_dropout_quotients_at_extreme_inputs(cuda, dtype, rate):
    """The reciprocal quotient where the proof allows it and IEEE division
    elsewhere: the largest finite values, subnormals, zeros and infinities
    divide as the plain version divides them, bit for bit (signed zeros too)."""
    from cmh_torch.ops import random as R
    from cmh_torch.utils import prng

    info = torch.finfo(dtype)
    special = torch.tensor([info.max, -info.max, info.max / 2, info.tiny, info.tiny / 4,
                            -info.tiny / 8, 0.0, -0.0, float("inf"), float("-inf"), 1.0, -3.5],
                           dtype=torch.float32)
    x = torch.cat([special.repeat(200), torch.randn(4000, generator=torch.Generator().manual_seed(1))
                   * 2.0 ** torch.randint(-140, 125, (4000,), generator=torch.Generator().manual_seed(2))])
    x = x.to(dtype)
    key = prng.PRNGKey(int(rate * 10))
    got = R.dropout(x.to(cuda), key, rate).cpu()
    want = R.dropout_plain(x, key, rate)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))
