"""cmh_torch's kernel plain versions against cmh_tpu's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions (the tensors
lie on the CPU); cmh_tpu's kernels run in Pallas interpret mode. Inputs are
made with numpy from a seed and handed to both as the same arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (before any torch work)
import torch

from cmh_torch.ops.attention import fused_attention
from cmh_torch.ops.hamming import hamming_packed
from cmh_torch.ops.hashing import from_uint32
from cmh_torch.ops.layernorm import fused_layernorm
from cmh_tpu.ops.attention_pallas import fused_attention as jax_attention
from cmh_tpu.ops.hamming_pallas import hamming_packed as jax_hamming
from cmh_tpu.ops.hashing import pack_bits as jax_pack_bits
from cmh_tpu.ops.layernorm_pallas import fused_layernorm as jax_layernorm

# fp32: both compute the same fp32 formula; only the summation order of the
# row means differs. bf16: identical bf16 inputs and fp32 arithmetic, so the
# outputs differ by at most one bf16 rounding step (2^-7 relative).
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2**-7, atol=1e-2)}


def _pair(a: np.ndarray, dtype):
    """The same values as a torch tensor and a jax array of ``dtype``."""
    t = torch.from_numpy(a).to(dtype)
    j = jnp.asarray(t.float().numpy(),
                    jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    return t, j


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(7, 33, 96), (5, 64), (1, 512)])
def test_layernorm_plain_matches_pallas(dtype, shape, monkeypatch):
    from cmh_tpu.ops import layernorm_pallas as lp

    monkeypatch.setattr(lp, "_BLOCK", 16)   # ragged final row block in Pallas
    rng = np.random.RandomState(sum(shape))
    d = shape[-1]
    x, xj = _pair((rng.randn(*shape) * 2 + 1).astype(np.float32), dtype)
    g = rng.randn(d).astype(np.float32)
    b = rng.randn(d).astype(np.float32)
    out = fused_layernorm(x, torch.from_numpy(g), torch.from_numpy(b))
    ref = jax_layernorm(xj, jnp.asarray(g), jnp.asarray(b))
    assert out.dtype == dtype and out.shape == x.shape
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("kpm", [False, True])
def test_attention_plain_matches_pallas(dtype, mask, kpm):
    b, h, s, hd = 3, 2, 10, 16
    rng = np.random.RandomState(int(mask) * 2 + int(kpm))
    q, qj = _pair(rng.randn(b, h, s, hd).astype(np.float32), dtype)
    k, kj = _pair(rng.randn(b, h, s, hd).astype(np.float32), dtype)
    v, vj = _pair(rng.randn(b, h, s, hd).astype(np.float32), dtype)
    m = np.triu(np.full((s, s), -np.inf, np.float32), 1) if mask else None
    p = None
    if kpm:
        p = rng.rand(b, s) > 0.6
        p[:, 0] = False   # the SOT slot is never padded
    scale = hd**-0.5
    out = fused_attention(q, k, v, scale,
                          None if m is None else torch.from_numpy(m),
                          None if p is None else torch.from_numpy(p))
    ref = jax_attention(qj, kj, vj, scale,
                        None if m is None else jnp.asarray(m),
                        None if p is None else jnp.asarray(p))
    assert out.dtype == dtype
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               **TOL[dtype])


@pytest.mark.parametrize("bits", [16, 64, 225, 255, 256, 1024])
def test_hamming_plain_matches_pallas(bits):
    rng = np.random.RandomState(bits)
    qc = rng.choice([-1.0, 1.0], (13, bits)).astype(np.float32)
    gc = rng.choice([-1.0, 1.0], (301, bits)).astype(np.float32)
    qp = np.asarray(jax_pack_bits(jnp.asarray(qc)))
    gp = np.asarray(jax_pack_bits(jnp.asarray(gc)))
    out = hamming_packed(from_uint32(qp), from_uint32(gp), bits=bits)
    ref = np.asarray(jax_hamming(jnp.asarray(qp), jnp.asarray(gp),
                                 interpret=True, bits=bits))
    np.testing.assert_array_equal(out.numpy(), ref)
    # uint8 up to 255 bits (225–255 bits pad to 8 words and stay uint8);
    # int32 above, where cmh_tpu picks uint16
    assert out.dtype == (torch.uint8 if bits <= 255 else torch.int32)
    assert (ref.dtype == np.uint8) == (bits <= 255)


def test_hamming_rejects_mismatched_inputs():
    q = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="word-width"):
        hamming_packed(q, torch.zeros((3, 1), dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        hamming_packed(q, torch.zeros((3, 2), dtype=torch.int64))
