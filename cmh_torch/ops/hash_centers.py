"""Hash centers and TwDH's targets (counterpart of ``cmh_tpu/ops/hash_centers.py``).

- ``hadamard_matrix`` and ``generate_hash_centers``: CSQ centers, Hadamard
  rows (and their negations) when they suffice, seeded Bernoulli ±1 rows
  otherwise; numpy with cmh_tpu's seeds, so the centers are bit-equal.
- ``load_center_file``: the reference's torch-pickled center and transform
  tensors, when their paths exist.
- ``hash_center_multilabels``: a sample's target is the sign of the sum of
  its classes' centers; an exact zero takes the bit of one ±1 ``tie``
  vector, shared by the batch, drawn by ``tie_vector`` from cmh_tpu's key
  ``fold_in(PRNGKey(center_seed), step)``, so a resumed run draws it again.
- ``hash_convert``: ±1 codes → softmax-pair one-hot targets.
- ``bce_probs``: ``torch.nn.BCELoss`` on probabilities with cmh_tpu's
  custom VJP: the forward clamps each log at −100, the backward is aten's
  fused quotient ``(p − y) / max(p(1 − p), 1e-12)``, finite where a softmax
  pair saturates to exactly 0 or 1 (plain autograd of the clamped forward
  gives ``0 · inf = NaN`` there).
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from ..utils import prng


def hadamard_matrix(n: int) -> np.ndarray:
    """Sylvester construction; n must be a power of two."""
    if n <= 0 or n & (n - 1):
        raise ValueError(f"{n} is not a power of two")
    h = np.ones((1, 1), dtype=np.float32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def generate_hash_centers(n_class: int, n_bits: int, seed: int = 0) -> np.ndarray:
    """(n_class, n_bits) ±1 float32 centers."""
    rng = np.random.RandomState(seed)
    if n_bits > 0 and not n_bits & (n_bits - 1):
        ha = hadamard_matrix(n_bits)
        rows = np.concatenate([ha, -ha], axis=0)
        if n_class <= rows.shape[0]:
            return rows[:n_class].astype(np.float32)
    return (rng.randint(0, 2, size=(n_class, n_bits)) * 2 - 1).astype(np.float32)


def load_center_file(path: str) -> np.ndarray:
    """A torch-pickled center or transform tensor as float32 numpy."""
    try:
        t = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        warnings.warn(f"{path} is not a weights-only pickle; falling back to unsafe "
                      "torch.load(weights_only=False)")
        t = torch.load(path, map_location="cpu", weights_only=False)
    return np.asarray(t.float().numpy(), dtype=np.float32)


def tie_vector(key: Optional[prng.Key], n_bits: int, device=None) -> torch.Tensor:
    """The (n_bits,) ±1 float32 tie vector of cmh_tpu's
    ``hash_center_multilabels``: ``randint(key, (n_bits,), 0, 2)``, with
    ``PRNGKey(0)`` when no key is given, drawn on ``device``."""
    key = prng.PRNGKey(0) if key is None else key
    return prng.randint(key, (n_bits,), 0, 2, device).float() * 2.0 - 1.0


def hash_center_multilabels(labels: torch.Tensor, centers: torch.Tensor,
                            tie: torch.Tensor) -> torch.Tensor:
    """(B, C) labels and (C, K) centers → (B, K) ±1 targets: the sign of
    ``labels @ centers``, ``tie`` where it is exactly 0 (sums of ±1 are
    exact in fp32)."""
    s = labels.float() @ centers.float()
    one = torch.ones((), dtype=s.dtype, device=s.device)
    return torch.where(s > 0, one, torch.where(s < 0, -one, tie.to(s.device)[None, :]))


def hash_convert(hash_label: torch.Tensor) -> torch.Tensor:
    """±1 codes (B, K) → (B, 2K) pair targets: −1 → (1, 0), +1 → (0, 1)."""
    h = (hash_label > 0).float()
    return torch.stack([1.0 - h, h], dim=-1).reshape(hash_label.shape[0], -1)


def _clamped_logs(probs: torch.Tensor):
    log_p = torch.clamp(torch.log(torch.clamp(probs, min=0.0)), min=-100.0)
    log_1mp = torch.clamp(torch.log(torch.clamp(1.0 - probs, min=0.0)), min=-100.0)
    return log_p, log_1mp


class _BCEProbs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, probs, targets):
        ctx.save_for_backward(probs, targets)
        log_p, log_1mp = _clamped_logs(probs)
        return -torch.mean(targets * log_p + (1.0 - targets) * log_1mp)

    @staticmethod
    def backward(ctx, g):
        probs, targets = ctx.saved_tensors
        n = probs.numel()
        denom = torch.clamp(probs * (1.0 - probs), min=1e-12)
        grad_p = g * (probs - targets) / denom / n
        # the target side, as autodiff of the clamped forward gives it
        log_p, log_1mp = _clamped_logs(probs)
        grad_t = g * (log_1mp - log_p) / n
        return grad_p, grad_t


def bce_probs(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy of probabilities against targets, with the
    fused backward (see the module docstring)."""
    return _BCEProbs.apply(probs, targets)
