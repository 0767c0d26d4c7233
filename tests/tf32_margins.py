"""How close the fp32 row tiles' arithmetic comes to the 1e-5 check.

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/tf32_margins.py [S ...]

Holds ``tf32_emulation`` (tests/test_torch_attention_layout.py: 3xTF32
products, each mma's sum truncated toward zero, an online softmax over
64-key chunks) against cmh_tpu's Pallas K2 in interpret mode at (2, 2, S,
64) with a causal mask and key padding, and prints, for the output and
each gradient, the largest |error| / (1e-5 + 1e-5 |reference|): the check
passes below 1. Two forms of the long products (P·V, dV, dK, dQ): "fold",
the kernels' (each 8-deep step's three mma sums formed from zero, then
added in rounded fp32), and "chain", one running mma sum over all of S.
Default S: 128, 257, 600 and 1500.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import test_torch_attention_layout as T
from cmh_torch.ops.attention import kpm_bias
from cmh_tpu.ops.attention_pallas import fused_attention as jax_attention


def chain_product(a, b, acc=None, passes=3):
    """acc + a @ b with every mma chained onto one running sum."""
    a, b = T._pad8(a, -1), T._pad8(b, -2)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:]) if acc is None else acc
    for k0 in range(0, a.shape[-1], 8):
        for x, y in T._tf32_terms(a[..., k0:k0 + 8], b[..., k0:k0 + 8, :], passes):
            acc = T._mma_rz(acc, x, y)
    return acc


def margins(s: int) -> None:
    b, h, hd = 2, 2, 64
    rng = np.random.RandomState(s)
    q, k, v, do = (torch.from_numpy(rng.randn(b, h, s, hd).astype(np.float32))
                   for _ in range(4))
    m = np.triu(np.full((s, s), -np.inf, np.float32), 1)
    m[:, 0] = 0.0
    p = rng.rand(b, s) > 0.7
    p[:, 0] = False
    scale = hd**-0.5
    out, vjp = jax.vjp(lambda a, c, e: jax_attention(a, c, e, scale, jnp.asarray(m),
                                                     jnp.asarray(p)),
                       *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = [torch.from_numpy(np.array(t)) for t in (out, *vjp(jnp.asarray(do.numpy())))]
    fold = T._tf32_product
    for name, product in (("fold", fold), ("chain", chain_product)):
        T._tf32_product = product
        try:
            got = T.tf32_emulation(q, k, v, scale, torch.from_numpy(m),
                                   kpm_bias(torch.from_numpy(p)), do)
        finally:
            T._tf32_product = fold
        ratios = [float(((a - r).abs() / (1e-5 + 1e-5 * r.abs())).max())
                  for a, r in zip(got, want)]
        print(f"S {s} {name}: error / tolerance, out dq dk dv: "
              + " ".join(f"{x:.3f}" for x in ratios), flush=True)


if __name__ == "__main__":
    for s in [int(a) for a in sys.argv[1:]] or [128, 257, 600, 1500]:
        margins(s)
