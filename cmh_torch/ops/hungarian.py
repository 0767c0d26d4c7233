"""The assignment of DNPH's noise regularizer (counterpart of
``cmh_tpu/ops/hungarian.py``).

Every step DNPH matches the batch's codes to random ±1 vectors by a linear
sum assignment (reference ``models/DNPH/loss/b_reg.py:5-41``). The L2 cost
matrix is computed on the codes' device; the exact solve runs on the host,
scipy's ``linear_sum_assignment`` in float64 as cmh_tpu's ``_solve_host``,
and only the (B,) permutation goes back. cmh_tpu also has on-device
``auction`` and ``greedy`` solvers for backends that cannot call back to the
host; every device this port runs on can, so they are not ported.

``assign_noise.calls`` counts the solves; ``assign_noise.host_seconds``
adds the host time they took, the device→host copy of the cost included
(which waits for the work queued before it), and
``assign_noise.solve_seconds`` the solves alone.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..utils import prng


def solve_assignment(cost: np.ndarray) -> np.ndarray:
    """Column assigned to each row minimizing the total cost, (B, B) → (B,)."""
    from scipy.optimize import linear_sum_assignment

    _, col_ind = linear_sum_assignment(np.asarray(cost, dtype=np.float64))
    return col_ind


def noise_cost(codes: torch.Tensor, noises: torch.Tensor) -> torch.Tensor:
    """(B, B) euclidean distances between codes and noise vectors, fp32."""
    diff = codes.float()[:, None, :] - noises.float()[None, :, :]
    return torch.sqrt(torch.clamp((diff * diff).sum(-1), min=0.0))


@torch.no_grad()
def assign_noise(codes: torch.Tensor, noises: torch.Tensor) -> torch.Tensor:
    """``noises`` reordered to minimize the total L2 distance to ``codes``
    (reference ``gene_noise``); no gradient flows through the choice."""
    cost = noise_cost(codes, noises)
    t0 = time.perf_counter()
    host = cost.cpu().numpy()
    t1 = time.perf_counter()
    col = solve_assignment(host)
    t2 = time.perf_counter()
    assign_noise.host_seconds += t2 - t0
    assign_noise.solve_seconds += t2 - t1
    assign_noise.calls += 1
    return noises.index_select(0, torch.as_tensor(col, device=noises.device))


assign_noise.calls = 0
assign_noise.host_seconds = 0.0
assign_noise.solve_seconds = 0.0


def rand_unit_rect(key, npoints: int, ndim: int, device=None) -> torch.Tensor:
    """Random ±1 (Rademacher) vectors (reference ``rand_unit_rect``, which
    despite its name draws corners, not unit-norm points): cmh_tpu's
    ``bernoulli(key, 0.5, (npoints, ndim))``, fp32 on ``device``."""
    return prng.bernoulli(key, 0.5, (npoints, ndim), device).float() * 2.0 - 1.0
