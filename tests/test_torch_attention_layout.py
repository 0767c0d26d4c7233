"""The attention kernels' layout, routing and arithmetic, on the CPU.

The tensor-core kernels in ``cmh_torch/csrc/attention.cu`` read q, k, v and
dout where they lie (the strided head views ``MultiHeadAttention`` makes of
its packed projection) and write (B, S, H, hd) memory. Their stride and
layout arithmetic is plain Python (``kernel_strides``, ``kernel_output``),
tested here. Their backward splits the fp32 operands W and dlog into bf16
pieces for the tensor cores; a plain-torch emulation of those products,
kept in this file, is held against cmh_tpu's Pallas backward (interpret
mode) with the same one-bf16-step check the card's tests use. The
row-tiled kernels (``csrc/attention_tiled.cu``, every S past the one-block
limits) walk the keys once in bf16, form each logit as an fp32 FMA chain,
take the row sum in ``torch.softmax``'s lane order from the logit rows they
keep, and run the backward's products on the tensor cores with W and dlog
in bf16 pieces; in fp32 every product runs on the tensor cores as 3xTF32
(each operand split into two TF32 pieces) with an online softmax over
64-key chunks. An emulation of that arithmetic, with each mma's sum
truncated toward zero, is held against the Pallas kernel at MITH-128's
S = 128, ViT-B/16's 197, ViT-L/14's 257 and at 600 the same way, and the
host's mirror of the forward's shared memory, which decides where the
logit rows live, against the source.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (before any torch work)
import torch

from cmh_torch.ops import _build
from cmh_torch.ops.attention import (_MAX_SMEM, BF16_MAX_S, _prepare, _softmax,
                                     fused_attention, kernel_output, kernel_strides,
                                     kpm_bias, one_block_smem, route, tiled_fwd_smem,
                                     tiled_fwd_tiles)
from cmh_tpu.ops.attention_pallas import fused_attention as jax_attention
from test_torch_gpu_kernels import assert_within_one_bf16_step

ROOT = Path(__file__).resolve().parents[1]
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(autouse=True)
def fused(monkeypatch):
    monkeypatch.setenv("CMH_TPU_FUSED", "1")


def _packed_heads(b, s, h, hd, dtype, seed):
    """q, k, v as MultiHeadAttention makes them: head views of one packed
    (B, S, 3·H·hd) projection."""
    rng = np.random.RandomState(seed)
    qkv = torch.from_numpy(rng.randn(b, s, 3 * h * hd).astype(np.float32)).to(dtype)
    return qkv, [t.reshape(b, s, h, hd).transpose(1, 2) for t in qkv.split(h * hd, -1)]


@pytest.mark.parametrize("which", [0, 1, 2])
def test_kernel_strides_read_the_packed_head_views_in_place(which):
    b, s, h, hd = 3, 50, 12, 64
    qkv, views = _packed_heads(b, s, h, hd, torch.bfloat16, seed=which)
    t, strides = kernel_strides(views[which])
    assert t.data_ptr() == qkv.data_ptr() + which * h * hd * 2    # no copy
    assert strides == (s * 3 * h * hd, hd, 3 * h * hd)
    # the element the kernel addresses as (b, h, s, c) is the view's
    flat = qkv.reshape(-1)
    i, j, r, c = 2, 7, 41, 5
    off = (t.data_ptr() - qkv.data_ptr()) // 2 + i * strides[0] + j * strides[1] \
        + r * strides[2] + c
    assert torch.equal(flat[off], views[which][i, j, r, c])


@pytest.mark.parametrize("case", ["hd-strided", "row-off-16-bytes", "dout-expanded"])
def test_kernel_strides_copy_what_the_kernels_cannot_read(case):
    b, s, h, hd = 2, 17, 4, 32
    base = torch.randn(b, h, s, hd + 1).bfloat16()
    t = {"hd-strided": torch.randn(b, h, hd, s).bfloat16().transpose(2, 3),
         "row-off-16-bytes": base[..., 1:],                  # 66-byte rows, odd start
         "dout-expanded": torch.ones(()).bfloat16().expand(b, h, s, hd)}[case]
    got, strides = kernel_strides(t)
    assert got.is_contiguous() and got.data_ptr() != t.data_ptr()
    assert strides == (h * s * hd, s * hd, hd)
    assert torch.equal(got, t)


def test_kernel_output_merges_heads_as_a_view():
    b, h, s, hd = 3, 8, 32, 64
    out = kernel_output(torch.empty(b, h, s, hd, dtype=torch.bfloat16))
    assert out.shape == (b, h, s, hd) and out.dtype == torch.bfloat16
    assert out.stride() == (s * h * hd, hd, h * hd, 1)
    merged = out.transpose(1, 2).reshape(b, s, h * hd)    # model.py's merge
    assert merged.data_ptr() == out.data_ptr() and merged.is_contiguous()


@pytest.mark.parametrize("which,s,hd", [("fwd", 177, 64), ("fwd", 209, 32),
                                        ("bwd", 129, 64), ("bwd", 145, 32),
                                        ("fwd", 50, 128)])
def test_bf16_limits_raise_before_any_build(which, s, hd):
    """Past the one-block kernels' S limits the wrapper picks the row-tiled
    kernels; a head dim the bf16 kernels do not take raises. Neither loads
    a library."""
    q = torch.zeros(1, 2, s, hd, dtype=torch.bfloat16)
    loaded = set(_build._loaded)
    if hd not in (32, 64):
        with pytest.raises(ValueError, match="hd 32 or 64"):
            _prepare(q, q, q, None, None, which)
    else:
        assert _prepare(q, q, q, None, None, which)[0] == "tiled"
    assert set(_build._loaded) == loaded


@pytest.mark.parametrize("dtype,which,hd,limit", [
    (torch.bfloat16, "fwd", 64, 176), (torch.bfloat16, "bwd", 64, 128),
    (torch.bfloat16, "fwd", 32, 208), (torch.bfloat16, "bwd", 32, 144),
    (torch.float32, "fwd", 64, 162), (torch.float32, "bwd", 64, 117)])
def test_route_by_s_alone(dtype, which, hd, limit):
    """The one-block kernels up to their limit (bf16: ``BF16_MAX_S``; fp32:
    one (batch, head) in 227 KB of shared memory), the row tiles past it:
    ViT-B/16's 197 and ViT-L/14's 257 at hd 64 in both directions, MITH's
    128 concept tokens in the fp32 backward."""
    assert route(dtype, which, limit, hd) == "one_block"
    assert route(dtype, which, limit + 1, hd) == "tiled"
    if dtype == torch.float32:
        assert one_block_smem(which, limit, hd) <= _MAX_SMEM < one_block_smem(which, limit + 1, hd)
    for s in (197, 257):
        assert route(dtype, which, s, hd) == ("tiled" if s > limit else "one_block")
    assert route(torch.float32, "bwd", 128, 64) == "tiled"
    assert route(torch.bfloat16, "fwd", 50, 64) == route(torch.float32, "bwd", 16, 64) \
        == "one_block"


def test_bf16_limits_are_the_kernels_instantiations():
    """``BF16_MAX_S`` is 16 × the largest row-tile count each kernel is
    built for in csrc/attention.cu."""
    src = (ROOT / "cmh_torch" / "csrc" / "attention.cu").read_text()
    for which in ("fwd", "bwd"):
        m = re.search(rf"max_kc_{which}\(\) {{ return HD == 32 \? (\d+) : (\d+); }}", src)
        assert m, which
        assert BF16_MAX_S[which] == {32: 16 * int(m[1]), 64: 16 * int(m[2])}


def test_key_padding_bias_must_be_b_by_s():
    q = torch.zeros(2, 3, 10, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="key-padding bias must be"):
        _prepare(q, q, q, None, torch.zeros(10, 2), "fwd")
    with pytest.raises(ValueError, match="mask must be"):
        _prepare(q, q, q, torch.zeros(10, 9), None, "bwd")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masks", [False, True])
def test_fused_attention_on_strided_views_matches_pallas(dtype, masks):
    """Forward and gradients of fused_attention on the packed head views, as
    the CLIP blocks call it, against cmh_tpu's fused_attention (Pallas in
    interpret mode) on the same values."""
    b, s, h, hd = 2, 12, 3, 32
    qkv, _ = _packed_heads(b, s, h, hd, dtype, seed=5 + int(masks))
    leaf = qkv.clone().requires_grad_()
    q, k, v = (t.reshape(b, s, h, hd).transpose(1, 2) for t in leaf.split(h * hd, -1))
    rng = np.random.RandomState(9)
    m = p = None
    if masks:
        m = np.triu(np.full((s, s), -np.inf, np.float32), 1)
        p = rng.rand(b, s) > 0.6
        p[:, 0] = False
    scale = hd**-0.5
    out = fused_attention(q, k, v, scale, None if m is None else torch.from_numpy(m),
                          None if p is None else torch.from_numpy(p))
    do = torch.from_numpy(rng.randn(b, h, s, hd).astype(np.float32)).to(dtype)
    out.backward(do)

    def jx(t):
        return jnp.asarray(t.detach().float().numpy(), JDT[dtype])

    want, vjp = jax.vjp(
        lambda a, c, e: jax_attention(a, c, e, scale, None if m is None else jnp.asarray(m),
                                      None if p is None else jnp.asarray(p)),
        jx(q), jx(k), jx(v))
    dq, dk, dv = vjp(jx(do))
    want_grad = torch.cat([torch.from_numpy(np.array(jnp.asarray(g, jnp.float32)))
                           .transpose(1, 2).reshape(b, s, h * hd) for g in (dq, dk, dv)], -1)
    want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    assert out.dtype == leaf.grad.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(leaf.grad, want_grad, rtol=1e-5, atol=1e-5)
    else:
        assert_within_one_bf16_step(out, want.bfloat16())
        assert_within_one_bf16_step(leaf.grad, want_grad.bfloat16())


def _pieces(x: torch.Tensor, n: int):
    """x (fp32) as n bf16-valued pieces, largest first: each the bf16
    rounding of what the earlier ones left (csrc/attention.cu:split_pair)."""
    out, rest = [], x
    for _ in range(n):
        p = rest.bfloat16().float()
        out.append(p)
        rest = rest - p
    return out


def split_piece_bwd(q, k, v, scale, mask, bias, dout, n):
    """The bf16 backward kernel's products in plain torch: W and dlog fp32
    as in the Pallas backward, then dV = Σ Wₚᵀ dO, dQ = Σ dlogₚ K · scale and
    dK = Σ dlogₚᵀ Q · scale over n bf16 pieces, smallest first (every
    product exact in fp32, sums fp32), each result rounded once to bf16."""
    w = _softmax(q, k, scale, mask, bias)
    do = dout.float()
    dw = torch.matmul(do, v.float().transpose(-1, -2))
    dlog = w * (dw - (dw * w).sum(-1, keepdim=True))
    pw, pl = _pieces(w, n)[::-1], _pieces(dlog, n)[::-1]
    dv = sum(torch.matmul(p.transpose(-1, -2), do) for p in pw)
    dq = sum(torch.matmul(p, k.float()) for p in pl) * scale
    dk = sum(torch.matmul(p.transpose(-1, -2), q.float()) for p in pl) * scale
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


@pytest.mark.parametrize("tower", ["vision", "text"])
def test_split_piece_products_match_pallas_backward(tower):
    """Three bf16 pieces of W and dlog reproduce cmh_tpu's backward to the
    one-bf16-step check at both tower shapes; one piece (W rounded to bf16,
    the fault the check exists to catch) fails it, and so does two."""
    h, s = (12, 50) if tower == "vision" else (8, 32)
    b, hd = 4, 64
    rng = np.random.RandomState(h + s)
    q, k, v, do = (torch.from_numpy(rng.randn(b, h, s, hd).astype(np.float32)).bfloat16()
                   for _ in range(4))
    m = p = None
    if tower == "text":
        m = np.triu(np.full((s, s), -np.inf, np.float32), 1)
        p = rng.rand(b, s) > 0.6
        p[:, 0] = False
    scale = hd**-0.5

    def jx(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)

    _, vjp = jax.vjp(
        lambda a, c, e: jax_attention(a, c, e, scale, None if m is None else jnp.asarray(m),
                                      None if p is None else jnp.asarray(p)),
        jx(q), jx(k), jx(v))
    want = [torch.from_numpy(np.array(jnp.asarray(g, jnp.float32))).bfloat16()
            for g in vjp(jx(do))]
    mask = None if m is None else torch.from_numpy(m)
    bias = None if p is None else kpm_bias(torch.from_numpy(p))

    for a, w in zip(split_piece_bwd(q, k, v, scale, mask, bias, do, 3), want):
        assert_within_one_bf16_step(a, w)
    for n in (1, 2):
        got = split_piece_bwd(q, k, v, scale, mask, bias, do, n)
        failed = 0
        for a, w in zip(got, want):
            try:
                assert_within_one_bf16_step(a, w)
            except AssertionError:
                failed += 1
        assert failed >= 1, n


def test_attention_variant_edits_still_apply():
    """The variant-timing tool edits csrc/attention.cu, with the headers it
    includes written in place, by string replacement; every edit must still
    find its target."""
    from cmh_torch.tools._variants import source
    from cmh_torch.tools.attention_variants import VARIANTS

    src = source("attention")
    assert "#include \"attention_mma.cuh\"" not in src and "logits_fma" in src
    for name, edits in VARIANTS.items():
        for old, _ in edits:
            assert src.count(old) == 1, (name, old)


def test_attention_tiled_variant_edits_still_apply():
    """The row-tiled ablation tool edits csrc/attention_tiled.cu, with its
    header written in place, by string replacement; every edit must still
    find its target exactly once."""
    from cmh_torch.tools._variants import source
    from cmh_torch.tools.attention_tiled_variants import VARIANTS

    from cmh_torch.tools._variants import edited

    src = source("attention_tiled")
    assert "#include \"attention_mma.cuh\"" not in src and "split_pair" in src
    for name, edits in VARIANTS.items():
        for old, _ in edits:
            assert src.count(old) == 1, (name, old)
        assert (edited(src, edits, name) == src) == (name == "base"), name


def test_row_tiles_take_fp32_head_dims_up_to_128():
    """Past the fp32 one-block limit the row tiles take hd <= 128 and refuse
    wider heads by their hd, before any library is loaded."""
    loaded = set(_build._loaded)
    q = torch.zeros(1, 1, 300, 128)
    assert _prepare(q, q, q, None, None, "bwd")[0] == "tiled"
    wide = torch.zeros(1, 1, 300, 160)
    with pytest.raises(ValueError, match="hd <= 128, got 160"):
        _prepare(wide, wide, wide, None, None, "fwd")
    assert _prepare(wide[:, :, :20], wide[:, :, :20], wide[:, :, :20], None, None,
                    "fwd")[0] == "one_block"
    assert set(_build._loaded) == loaded


def _fma_logits(q, k):
    """Q Kᵀ as the row-tiled forward forms it: each logit one fp32 FMA chain
    over hd in order from 0 (each step in fp64, then rounded once to fp32,
    which is the FMA wherever fp64 holds the step exactly)."""
    qd, kd = q.double(), k.double()
    x = torch.zeros(q.shape[:-1] + (k.shape[-2],), dtype=torch.float64)
    for d in range(q.shape[-1]):
        x = (x + qd[..., d, None] * kd[..., None, :, d]).float().double()
    return x.float()


def _lane_order_softmax(x):
    """torch.softmax over the last axis in its CUDA lane order, as the
    row-tiled forward takes it from its logit rows: the max, per lane
    L = c mod 32 a sequential fp32 sum of exp(x − max) over c = L, L + 32,
    …, a butterfly over the lanes with offsets 16, 8, 4, 2, 1, then the
    division."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    lanes = torch.nn.functional.pad(e, (0, -e.shape[-1] % 32)).unflatten(-1, (-1, 32))
    part = torch.zeros(lanes.shape[:-2] + (32,))
    for i in range(lanes.shape[-2]):
        part = part + lanes[..., i, :]
    for o in (16, 8, 4, 2, 1):
        part = part + part[..., torch.arange(32) ^ o]
    return e / part[..., :1]


def _tiled_pieces_product(x, b, n, tile=16):
    """x @ b with the contraction in tiles of ``tile`` in order, x (fp32) in
    n bf16 pieces, smallest first, each piece's tile product exact and added
    to the fp32 sum (csrc/attention_tiled.cu:pieces_product)."""
    acc = torch.zeros(x.shape[:-1] + b.shape[-1:])
    for t0 in range(0, x.shape[-1], tile):
        for p in _pieces(x[..., t0:t0 + tile], n)[::-1]:
            acc = acc + torch.matmul(p, b[..., t0:t0 + tile, :])
    return acc


def _tf32(x):
    """cvt.rna.tf32.f32 on the int32 view: (bits + 0x1000) with the low 13
    bits cleared, i.e. 10 explicit mantissa bits, ties away from zero."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_terms(a, b, passes=3):
    """The products of a 3xTF32 step (csrc/attention_tiled.cu:mma3), in its
    order: a_lo b_hi, a_hi b_lo, a_hi b_hi; with ``passes`` 1, a_hi b_hi
    alone (one TF32 pass)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return [(al, bh), (ah, bl), (ah, bh)][3 - passes:]


def _mma_rz(c, a, b):
    """One mma.sync with k = 8: c + a·b summed exactly (TF32 products are
    exact in fp64) and rounded toward zero to fp32, as the tensor cores
    truncate their sums."""
    x = c.double() + torch.matmul(a.double(), b.double())
    f = x.float()
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def _pad8(a, dim):
    """a zero-padded along ``dim`` to a multiple of 8 (the kernels' k steps)."""
    pad = [0, 0] * (a.dim() - 1 - dim % a.dim()) + [0, -a.shape[dim] % 8]
    return torch.nn.functional.pad(a, pad)


def _tf32_dot(a, b, passes=3):
    """a @ b as rows_dot_tf32 forms S and dW: over k in 8-deep steps from 0,
    each step's products one mma each, chained from zero."""
    a, b = _pad8(a, -1), _pad8(b, -2)
    c = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], 8):
        for x, y in _tf32_terms(a[..., k0:k0 + 8], b[..., k0:k0 + 8, :], passes):
            c = _mma_rz(c, x, y)
    return c


def _tf32_product(a, b, acc=None, passes=3):
    """acc + a @ b as acc_product_tf32 forms P·V, dV, dK and dQ: per 8-deep
    step of k the mma sums chained from zero, then added to acc in rounded
    fp32."""
    a, b = _pad8(a, -1), _pad8(b, -2)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:]) if acc is None else acc
    for k0 in range(0, a.shape[-1], 8):
        p = torch.zeros_like(acc)
        for x, y in _tf32_terms(a[..., k0:k0 + 8], b[..., k0:k0 + 8, :], passes):
            p = _mma_rz(p, x, y)
        acc = acc + p
    return acc


def tf32_emulation(q, k, v, scale, mask, bias, dout, passes=3, chunk=64):
    """The fp32 row-tiled kernels' arithmetic in plain torch; returns (out,
    dq, dk, dv). Logits: S by ``_tf32_dot``, then scale, mask and bias each
    rounded on its own. The forward (tiled_fwd_tf32) walks the keys once in
    ``chunk``-key chunks with an online softmax: the running row max m
    (0 stands in while it is −inf), the row sum l and the output rescaled by
    exp(m_old − m) as it grows, the unnormalised P·V added by
    ``_tf32_product``, the output times 1 / l at the end. The backward:
    launch 1 takes m, l and d = Σ exp(logit − m)·dW the same way in one
    walk (dW = dO Vᵀ by ``_tf32_dot``), D = d / l; launches 2 and 3
    w = exp(logit − m) / l and dlog = w (dW − D), and dV = Wᵀ dO,
    dK = dlogᵀ Q · scale and dQ = dlog K · scale by ``_tf32_product``."""
    qf, kf, vf, do = q.float(), k.float(), v.float(), dout.float()
    s = q.shape[-2]
    inf = float("inf")

    def logits(k0, k1):
        x = _tf32_dot(qf, kf[..., k0:k1, :].transpose(-1, -2), passes) * scale
        if mask is not None:
            x = x + mask[:, k0:k1]
        if bias is not None:
            x = x + bias[:, None, None, k0:k1]
        return x

    rows = q.shape[:-1] + (1,)
    m, l, d = torch.full(rows, -inf), torch.zeros(rows), torch.zeros(rows)
    o = torch.zeros(q.shape)
    for k0 in range(0, s, chunk):
        x = logits(k0, k0 + chunk)
        y = _tf32_dot(do, vf[..., k0:k0 + chunk, :].transpose(-1, -2), passes)
        mx = torch.maximum(m, x.amax(-1, keepdim=True))
        mu = torch.where(mx == -inf, torch.zeros_like(mx), mx)
        rs = torch.exp(m - mu)
        l, d, o, m = l * rs, d * rs, o * rs, mx
        e = torch.exp(x - mu)
        l = l + e.sum(-1, keepdim=True)
        d = d + (e * y).sum(-1, keepdim=True)
        o = _tf32_product(e, vf[..., k0:k0 + chunk, :], o, passes)
    out = o * (1 / l)
    w = torch.exp(logits(0, s) - m) / l
    dlog = w * (_tf32_dot(do, vf.transpose(-1, -2), passes) - d / l)
    dv = _tf32_product(w.transpose(-1, -2), do, passes=passes)
    dk = _tf32_product(dlog.transpose(-1, -2), qf, passes=passes) * scale
    dq = _tf32_product(dlog, kf, passes=passes) * scale
    return out, dq, dk, dv


def tiled_emulation(q, k, v, scale, mask, bias, dout):
    """The row-tiled kernels' arithmetic in plain torch; returns (out, dq,
    dk, dv). fp32: ``tf32_emulation``. bf16: the forward's logits as FMA
    chains (the CUDA cores), scale, mask and bias each rounded on its own,
    ``torch.softmax``'s lane order, P rounded to bf16, P·V with fp32 sums;
    the backward's row max m, l = Σ exp(logit − m) and D = Σ exp(logit −
    m)·dW / l from fp32 sums (the kernel takes them in one walk, rescaling
    as the max grows), w = exp(logit − m) / l unrounded and dlog = w (dW −
    D), the logits and dW bf16 products with fp32 sums (the tensor cores),
    and dV = Wᵀ dO, dK = scale dlogᵀ Q and dQ = scale dlog K with W and dlog
    in three bf16 pieces over 16-row tiles."""
    if q.dtype == torch.float32:
        return tf32_emulation(q, k, v, scale, mask, bias, dout)

    def masked(x):
        x = x * scale
        if mask is not None:
            x = x + mask
        if bias is not None:
            x = x + bias[:, None, None, :]
        return x

    w = _lane_order_softmax(masked(_fma_logits(q.float(), k.float())))
    out = torch.matmul(w.to(q.dtype).float(), v.float()).to(q.dtype)
    x = masked(torch.matmul(q.float(), k.float().transpose(-1, -2)))
    do = dout.float()
    dw = torch.matmul(do, v.float().transpose(-1, -2))
    e = torch.exp(x - x.amax(-1, keepdim=True))
    l = e.sum(-1, keepdim=True)
    w = e / l
    dlog = w * (dw - (e * dw).sum(-1, keepdim=True) / l)
    dv = _tiled_pieces_product(w.transpose(-1, -2), do, 3)
    dk = _tiled_pieces_product(dlog.transpose(-1, -2), q.float(), 3) * scale
    dq = _tiled_pieces_product(dlog, k.float(), 3) * scale
    return out, dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _tiled_walk_against_pallas(dtype, s, masked_keys, emulation=tiled_emulation,
                               all_masked_row=True):
    """``emulation`` (default tiled_emulation) at (2, 2, s, 64) against
    cmh_tpu's fused attention in interpret mode, forward and gradients: fp32
    within 1e-5, bf16 within one bf16 step. The keys ``masked_keys`` are
    padding in every row (a wholly masked key block) and, with
    ``all_masked_row``, query row 5 has every key masked: NaN exactly where
    Pallas gives NaN (which is every element of dK and dV; without that row
    they are compared as values)."""
    b, h, hd = 2, 2, 64
    rng = np.random.RandomState(s)
    q, k, v, do = (torch.from_numpy(rng.randn(b, h, s, hd).astype(np.float32)).to(dtype)
                   for _ in range(4))
    m = np.triu(np.full((s, s), -np.inf, np.float32), 1)
    m[:, 0] = 0.0        # key 0 visible to every row but 5, so no other row is all masked
    if all_masked_row:
        m[5] = -np.inf
    p = rng.rand(b, s) > 0.7
    p[:, masked_keys] = True
    p[:, 0] = False
    scale = hd**-0.5

    def jx(t):
        return jnp.asarray(t.float().numpy(), JDT[dtype])

    out, vjp = jax.vjp(lambda a, c, e: jax_attention(a, c, e, scale, jnp.asarray(m),
                                                     jnp.asarray(p)), jx(q), jx(k), jx(v))
    want = [torch.from_numpy(np.array(jnp.asarray(t, jnp.float32))).to(dtype)
            for t in (out, *vjp(jx(do)))]
    got = emulation(q, k, v, scale, torch.from_numpy(m), kpm_bias(torch.from_numpy(p)), do)
    assert bool(torch.isnan(want[0][:, :, 5]).all()) == all_masked_row
    assert not bool(torch.isnan(want[0][:, :, 6]).any())
    for a, r in zip(got, want):
        nan = torch.isnan(r)
        assert torch.equal(torch.isnan(a), nan)
        if dtype == torch.float32:
            torch.testing.assert_close(a[~nan], r[~nan], rtol=1e-5, atol=1e-5)
        else:
            assert_within_one_bf16_step(a[~nan], r[~nan])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_tiled_walk_matches_pallas_at_vit_b16_length(dtype):
    """The row-tiled arithmetic at S = 197 (four 64-key chunks, the last
    one ragged; keys 32..63 wholly masked) against Pallas."""
    _tiled_walk_against_pallas(dtype, 197, slice(32, 64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_tiled_walk_matches_pallas_at_vit_l14_length(dtype):
    """The row-tiled arithmetic at S = 257 (four 64-key chunks and one key;
    the second chunk, keys 64..127, wholly masked) against Pallas."""
    _tiled_walk_against_pallas(dtype, 257, slice(64, 128))


@pytest.mark.parametrize("all_masked_row", [True, False])
@pytest.mark.parametrize("s,masked_keys", [(128, slice(64, 128)), (257, slice(64, 128)),
                                           (600, slice(128, 192))])
def test_row_tiled_tf32_arithmetic_matches_pallas(s, masked_keys, all_masked_row):
    """The fp32 row tiles' 3xTF32 products and online softmax over 64-key
    chunks, both directions, at MITH-128's S = 128, ViT-L/14's 257 and 600,
    each with a wholly masked key chunk, with and without an all-masked row,
    against Pallas within 1e-5."""
    _tiled_walk_against_pallas(torch.float32, s, masked_keys, tf32_emulation, all_masked_row)


@pytest.mark.parametrize("which", ["forward", "gradients"])
def test_one_tf32_pass_fails_the_fp32_check(which):
    """One TF32 pass (a_hi b_hi alone), the fault the three-pass split
    exists to avoid, misses Pallas by far more than 1e-5 at S = 128, in the
    forward and in the gradients alike."""
    b, h, s, hd = 2, 2, 128, 64
    rng = np.random.RandomState(s)
    q, k, v, do = (torch.from_numpy(rng.randn(b, h, s, hd).astype(np.float32))
                   for _ in range(4))
    scale = hd**-0.5
    out, vjp = jax.vjp(lambda a, c, e: jax_attention(a, c, e, scale, None, None),
                       *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = [torch.from_numpy(np.array(t)) for t in (out, *vjp(jnp.asarray(do.numpy())))]
    pick = slice(0, 1) if which == "forward" else slice(1, 4)
    for passes, ok in ((3, True), (1, False)):
        got = tf32_emulation(q, k, v, scale, None, None, do, passes=passes)
        close = all(torch.allclose(a, r, rtol=1e-5, atol=1e-5)
                    for a, r in zip(got[pick], want[pick]))
        assert close == ok, passes


@pytest.mark.parametrize("hd,limit", [(64, 3152), (32, 3376)])
def test_bf16_forward_routes_past_the_logit_rows_limit(hd, limit):
    """The bf16 row-tiled forward holds each tile's 16 × S fp32 logit rows
    in shared memory up to the S at which one tile's rows no longer fit in
    227 KB (``tiled_fwd_tiles`` 1 there, 0 past it: the rows then live in
    device memory); the route stays "tiled", the tensor-core row tiles, at
    every S, decided before any library is loaded. The backward keeps no row
    of S and takes every S."""
    loaded = set(_build._loaded)
    assert tiled_fwd_smem(limit, hd, 1) <= _MAX_SMEM < tiled_fwd_smem(limit + 1, hd, 1)
    assert tiled_fwd_tiles(limit, hd) == 1 and tiled_fwd_tiles(limit + 1, hd) == 0
    for s in (limit, limit + 1, 10_000):
        assert route(torch.bfloat16, "fwd", s, hd) == route(torch.bfloat16, "bwd", s, hd) \
            == "tiled"
        assert route(torch.float32, "fwd", s, hd) == route(torch.float32, "bwd", s, hd) == "tiled"
    q = torch.zeros(1, 1, limit + 1, hd, dtype=torch.bfloat16)
    assert _prepare(q, q, q, None, None, "fwd")[0] == "tiled"
    assert _prepare(q, q, q, None, None, "bwd")[0] == "tiled"
    assert set(_build._loaded) == loaded


@pytest.mark.parametrize("hd", [32, 64])
def test_tiled_forward_blocks_leave_room_for_a_second(hd):
    """Up to the S at which one tile's rows outgrow half the SM, a forward
    block takes the most 16-row tiles (at most 4, two warps each) that let
    two blocks share an SM (228 KB, 1 KB a block kept); ViT-B/16's and
    ViT-L/14's vision towers get 4 tiles, a ViT-L/14 at 336 px (S = 577) 2."""
    assert tiled_fwd_tiles(197, hd) == tiled_fwd_tiles(257, hd) == 4
    assert tiled_fwd_tiles(577, hd) == 2
    for s in range(BF16_MAX_S["fwd"][hd] + 1, 1400):
        n = tiled_fwd_tiles(s, hd)
        if tiled_fwd_smem(s, hd, 1) <= 113 * 1024:
            assert 2 * (tiled_fwd_smem(s, hd, n) + 1024) <= 228 * 1024
            assert n == 4 or tiled_fwd_smem(s, hd, n + 1) > 113 * 1024
        else:
            assert n == 1


@pytest.mark.parametrize("which,dtype,s", [("fwd", torch.bfloat16, 3153),
                                             ("fwd", torch.float32, 257),
                                             ("bwd", torch.float32, 257)])
def test_cpu_tensors_count_no_row_tiled_launch(which, dtype, s):
    """A CPU tensor on a row-tiled route (the bf16 forward past the logit
    rows' shared-memory limit, fp32 on 3xTF32) takes the plain version and
    counts no launch, row-tiled or fp32 row-tiled."""
    from cmh_torch.ops.attention import attention_bwd, attention_bwd_plain, attention_plain

    way = route(dtype, which, s, 64)
    assert way == "tiled"
    gen = torch.Generator().manual_seed(s)
    q, k, v, do = (torch.randn(1, 2, s, 64, generator=gen).to(dtype) for _ in range(4))
    fn = fused_attention if which == "fwd" else attention_bwd
    before = (fn.launches, fn.launches_tiled, fn.launches_tiled_tf32)
    if which == "fwd":
        assert torch.equal(fused_attention(q, k, v, 0.125), attention_plain(q, k, v, 0.125))
    else:
        got = attention_bwd(q, k, v, 0.125, None, None, do)
        want = attention_bwd_plain(q, k, v, 0.125, None, None, do)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (fn.launches, fn.launches_tiled, fn.launches_tiled_tf32) == before
