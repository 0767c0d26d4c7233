"""Gradients through cmh_torch's LayerNorm and attention against cmh_tpu's
Pallas backwards.

On the CPU the port's autograd Functions run the plain versions of the
backward kernels (``layernorm_bwd_plain``, ``attention_bwd_plain``); cmh_tpu
runs its ``custom_vjp`` Pallas kernels in interpret mode
(``CMH_TPU_FUSED=1``, ``jax.vjp``). Inputs come from numpy with a seed and
go to both packages as the same values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (before any torch work)
import torch

from cmh_torch.ops.attention import (_AttentionFn, attention_bwd_plain, fused_attention,
                                     kpm_bias)
from cmh_torch.ops.layernorm import _LayerNormFn, fused_layernorm, layernorm_bwd_plain
from cmh_tpu.ops.attention_pallas import fused_attention as jax_attention
from cmh_tpu.ops.layernorm_pallas import fused_layernorm as jax_layernorm

# fp32: the same formulas, summation order only. bf16 (inputs and cotangent
# bf16, arithmetic fp32): the results are rounded once to bf16, so they agree
# to one bf16 step (2^-7 relative) and almost always exactly.
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2**-7, atol=1e-2)}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _pair(a: np.ndarray, dtype):
    t = torch.from_numpy(a).to(dtype)
    return t, jnp.asarray(t.float().numpy(), JDT[dtype])


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(autouse=True)
def fused(monkeypatch):
    monkeypatch.setenv("CMH_TPU_FUSED", "1")


def _layernorm_grads(rows, d, dtype, seed, block=None, monkeypatch=None):
    rng = np.random.RandomState(seed)
    x, xj = _pair((rng.randn(rows, d) * 2 + 1).astype(np.float32), dtype)
    do, doj = _pair(rng.randn(rows, d).astype(np.float32), dtype)
    g = rng.randn(d).astype(np.float32)
    b = rng.randn(d).astype(np.float32)
    xt = x.clone().requires_grad_()
    gt, bt = torch.from_numpy(g).requires_grad_(), torch.from_numpy(b).requires_grad_()
    fused_layernorm(xt, gt, bt).backward(do)
    _, vjp = jax.vjp(jax_layernorm, xj, jnp.asarray(g), jnp.asarray(b))
    return (xt.grad, gt.grad, bt.grad), vjp(doj)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(37, 64), (600, 96), (1, 512)])
def test_layernorm_grads_match_pallas_backward(dtype, rows, d, monkeypatch):
    from cmh_tpu.ops import layernorm_pallas as lp

    monkeypatch.setattr(lp, "_BLOCK", 128)   # ragged final row block in Pallas
    got, want = _layernorm_grads(rows, d, dtype, seed=rows + d)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    np.testing.assert_allclose(got[0].float().numpy(), _np(want[0]), **TOL[dtype])
    # dγ, dβ: fp32 sums over the rows in another order
    for a, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), _np(w), rtol=1e-5, atol=1e-4)


def _attention_grads(dtype, mask, kpm, seed, shape=(3, 2, 10, 16)):
    b, h, s, hd = shape
    rng = np.random.RandomState(seed)
    qkv = [_pair(rng.randn(*shape).astype(np.float32), dtype) for _ in range(3)]
    do, doj = _pair(rng.randn(*shape).astype(np.float32), dtype)
    m = np.triu(np.full((s, s), -np.inf, np.float32), 1) if mask else None
    p = None
    if kpm:
        p = rng.rand(b, s) > 0.6
        p[:, 0] = False   # the SOT slot is never padded
    ts = [t.clone().requires_grad_() for t, _ in qkv]
    scale = hd**-0.5
    out = fused_attention(*ts, scale, None if m is None else torch.from_numpy(m),
                          None if p is None else torch.from_numpy(p))
    out.backward(do)
    _, vjp = jax.vjp(
        lambda q, k, v: jax_attention(q, k, v, scale,
                                      None if m is None else jnp.asarray(m),
                                      None if p is None else jnp.asarray(p)),
        *(j for _, j in qkv))
    return [t.grad for t in ts], vjp(doj), (ts, scale, m, p, do)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("kpm", [False, True])
def test_attention_grads_match_pallas_backward(dtype, mask, kpm):
    got, want, _ = _attention_grads(dtype, mask, kpm, seed=2 * int(mask) + int(kpm))
    for a, w in zip(got, want):
        assert a.dtype == dtype
        np.testing.assert_allclose(a.float().numpy(), _np(w), **TOL[dtype])


def test_bf16_grads_follow_the_pallas_backward_not_autograd():
    """In bf16 the Pallas backward takes dV from the UNROUNDED fp32
    probabilities and never rounds dW; autograd of the forward (which rounds
    P to bf16 before PV) does both. The port's gradients must be the
    former: equal in bf16 to cmh_tpu's except for rare last-step ties (at
    most 1% of elements, one bf16 step), where autograd of the forward
    differs in about a quarter of them. Likewise the LayerNorm backward
    recomputes the statistics and never rounds in between."""
    got, want, (ts, scale, m, p, do) = _attention_grads(
        torch.bfloat16, True, True, seed=7, shape=(4, 2, 24, 32))
    for a, w in zip(got, want):
        a, w = a.float().numpy(), _np(w)
        assert np.mean(a != w) <= 0.01
        np.testing.assert_allclose(a, w, rtol=2**-7, atol=1e-2)
    # the gradients autograd of the plain forward gives are further away
    from cmh_torch.ops.attention import attention_plain

    ts2 = [t.detach().clone().requires_grad_() for t in ts]
    attention_plain(*ts2, scale, torch.from_numpy(m),
                    kpm_bias(torch.from_numpy(p))).backward(do)
    assert np.mean([np.mean(t.grad.float().numpy() != _np(w))
                    for t, w in zip(ts2, want)]) > 0.05
    lg, lw = _layernorm_grads(300, 128, torch.bfloat16, seed=8)
    assert np.mean(lg[0].float().numpy() != _np(lw[0])) <= 0.01


def test_autograd_functions_pass_gradcheck_in_float64():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(5, 8)).requires_grad_()
    g = torch.from_numpy(rng.randn(8)).requires_grad_()
    b = torch.from_numpy(rng.randn(8)).requires_grad_()
    assert torch.autograd.gradcheck(_LayerNormFn.apply, (x, g, b))
    q, k, v = (torch.from_numpy(rng.randn(2, 2, 5, 4)).requires_grad_() for _ in range(3))
    mask = torch.from_numpy(np.triu(np.full((5, 5), -np.inf), 1))
    kpm = torch.tensor([[False, False, False, True, True], [False] * 5])
    assert torch.autograd.gradcheck(
        lambda a, c, e: _AttentionFn.apply(a, c, e, 0.5, mask, kpm_bias(kpm)),
        (q, k, v))


def test_no_grad_saves_nothing_and_masks_get_no_gradient():
    x = torch.randn(3, 4, 8, requires_grad=True)
    with torch.no_grad():
        assert fused_layernorm(x, torch.ones(8), torch.zeros(8)).grad_fn is None
        assert fused_attention(x[:, None], x[:, None], x[:, None], 0.5).grad_fn is None
    mask = torch.zeros(4, 4, requires_grad=True)
    out = fused_attention(x[:, None], x[:, None], x[:, None], 0.5, mask)
    assert out.grad_fn is not None
    out.sum().backward()
    assert mask.grad is None and x.grad is not None


def test_plain_backwards_are_the_autograd_backward_in_fp32():
    """In fp32 the Pallas backwards are the exact derivatives of the
    forwards, so they agree with autograd of the plain forwards."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(6, 16).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.randn(16).astype(np.float32)).requires_grad_()
    b = torch.zeros(16, requires_grad=True)
    do = torch.from_numpy(rng.randn(6, 16).astype(np.float32))
    from cmh_torch.ops.layernorm import layernorm_plain

    layernorm_plain(x, g, b).backward(do)
    for a, w in zip(layernorm_bwd_plain(x.detach(), g.detach(), do), (x.grad, g.grad, b.grad)):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
    q, k, v, dout = (torch.from_numpy(rng.randn(2, 2, 6, 8).astype(np.float32))
                     for _ in range(4))
    qs = [t.clone().requires_grad_() for t in (q, k, v)]
    from cmh_torch.ops.attention import attention_plain

    attention_plain(*qs, 0.3).backward(dout)
    for a, t in zip(attention_bwd_plain(q, k, v, 0.3, None, None, dout), qs):
        torch.testing.assert_close(a, t.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tower", ["vision", "text"])
def test_bf16_step_check_tells_rounded_w_from_summation_order(tower):
    """The bf16 check that the GPU tests and ``chip_smoke.py`` hold K1-bwd
    and K2-bwd to: the same functions summed in fp64 instead of fp32 pass it
    (a last-bit difference, rounded once to bf16), while a dV from W
    rounded to bf16, the fault the check exists to catch, fails it."""
    import chip_smoke
    from test_torch_gpu_kernels import assert_within_one_bf16_step

    from cmh_torch.ops.attention import _softmax

    def rejects(check, got, want):
        try:
            check(got, want)
        except AssertionError:
            return True
        return False

    checks = (assert_within_one_bf16_step,
              lambda a, b: chip_smoke.bf16_steps_checked(a, b, tower))
    h, s = (12, 50) if tower == "vision" else (8, 32)
    rng = np.random.RandomState(h)
    q, k, v, do = (torch.from_numpy(rng.randn(4, h, s, 64).astype(np.float32)).bfloat16()
                   for _ in range(4))
    mask = bias = None
    if tower == "text":
        mask = torch.full((s, s), float("-inf")).triu(1)
        kpm = torch.from_numpy(rng.rand(4, s) > 0.6)
        kpm[:, 0] = False
        bias = kpm_bias(kpm)
    scale = 64**-0.5
    want = attention_bwd_plain(q, k, v, scale, mask, bias, do)
    f64 = attention_bwd_plain(q.double(), k.double(), v.double(), scale,
                              None if mask is None else mask.double(),
                              None if bias is None else bias.double(), do.double())
    w_bf16 = _softmax(q, k, scale, mask, bias).bfloat16().float()
    dv_rounded_w = torch.matmul(w_bf16.transpose(-1, -2), do.float()).bfloat16()
    x, dy = (torch.from_numpy(rng.randn(300, 768).astype(np.float32) * c).bfloat16()
             for c in (3, 1))
    g = torch.from_numpy(rng.randn(768))
    dx_want = layernorm_bwd_plain(x, g.float(), dy)[0]
    dx_f64 = layernorm_bwd_plain(x.double(), g, dy.double())[0].bfloat16()
    for check in checks:
        for a, b in zip(f64, want):
            check(a.bfloat16(), b)
        check(dx_f64, dx_want)
        assert rejects(check, dv_rounded_w, want[2])
