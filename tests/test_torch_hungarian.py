"""DNPH's noise assignment in cmh_torch against cmh_tpu's on the CPU.

Permutations are exact: given the same cost matrix the port's solve equals
cmh_tpu's ``_solve_host``; on random tanh codes ``assign_noise`` equals
cmh_tpu's ``assign_noise(method="hungarian")``. The noise vectors are a pure
function of (seed, step).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (before any torch work)
import torch

from cmh_torch.models.dnph import noise_vectors
from cmh_torch.ops.hungarian import assign_noise, noise_cost, rand_unit_rect, solve_assignment
from cmh_torch.utils import prng
from cmh_tpu.ops import hungarian as jax_hungarian


@pytest.mark.parametrize("n,seed", [(4, 0), (16, 1), (100, 2)])
def test_solve_equals_cmh_tpus(n, seed):
    cost = np.random.RandomState(seed).rand(n, n)
    col = solve_assignment(cost)
    np.testing.assert_array_equal(col, jax_hungarian._solve_host(cost))
    assert sorted(col.tolist()) == list(range(n))


@pytest.mark.parametrize("b,k,seed", [(16, 8, 3), (100, 16, 4)])
def test_assign_noise_equals_cmh_tpus(b, k, seed):
    """The same codes and noise: the same reordered noise. The two packages'
    fp32 cost matrices may round apart (a sum of K squares in another
    order), and a near tie can then pick another permutation; the
    comparison is of the solver and the reordering, so both sides get the
    cost in fp64, as the host solve sees it, and are checked on it."""
    rng = np.random.RandomState(seed)
    codes = np.tanh(rng.randn(b, k) * 2).astype(np.float32)
    noise = rng.choice([-1.0, 1.0], (b, k)).astype(np.float32)
    cost32 = noise_cost(torch.from_numpy(codes), torch.from_numpy(noise)).numpy()
    diff = codes[:, None, :].astype(np.float64) - noise[None, :, :]
    cost64 = np.sqrt((diff * diff).sum(-1))
    np.testing.assert_allclose(cost32, cost64, rtol=1e-6)
    want = np.asarray(jnp.take(jnp.asarray(noise), jax_hungarian._solve_host(cost64), axis=0))
    np.testing.assert_array_equal(noise[solve_assignment(cost64)], want)
    # and end to end, through each package's own fp32 cost
    got = assign_noise(torch.from_numpy(codes), torch.from_numpy(noise)).numpy()
    ref = np.asarray(jax_hungarian.assign_noise(jnp.asarray(codes), jnp.asarray(noise),
                                                method="hungarian"))
    np.testing.assert_array_equal(got, ref)


def test_assign_noise_counts_its_host_solves():
    calls, secs = assign_noise.calls, assign_noise.host_seconds
    x = torch.randn(5, 4)
    out = assign_noise(x, rand_unit_rect(prng.PRNGKey(0), 5, 4))
    assert assign_noise.calls == calls + 1 and assign_noise.host_seconds > secs
    assert out.shape == (5, 4) and not out.requires_grad


def test_noise_is_a_pure_function_of_seed_and_step():
    a = noise_vectors(3, 7, 16, 8, "cpu")
    torch.randn(100)                              # the global generator moves
    assert torch.equal(a, noise_vectors(3, 7, 16, 8, "cpu"))
    assert not torch.equal(a, noise_vectors(3, 8, 16, 8, "cpu"))
    assert not torch.equal(a, noise_vectors(4, 7, 16, 8, "cpu"))
    assert set(a.unique().tolist()) == {-1.0, 1.0}
    assert abs(float(noise_vectors(0, 0, 1000, 16, "cpu").mean())) < 0.05
