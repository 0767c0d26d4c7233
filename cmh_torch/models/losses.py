"""Loss terms shared by several methods (cmh_tpu keeps ``bayesian_loss`` in
``models/mith.py:300``, ``tanh_hash_loss`` in ``models/dimch.py:141`` and a
``_norm`` in each of ``models/{dsph,dnph}.py``; Baseline, DSPH, DNPH and
MITH and DIMCH take them from here)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.metrics import matmul_fp32


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / max(‖x‖, 1e-12) over the last axis."""
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-12)


def bayesian_loss(a: torch.Tensor, b: torch.Tensor, label_sim: torch.Tensor) -> torch.Tensor:
    """−mean(S·s − log(1 + eˢ)) with s = ½·a·bᵀ clamped to ±64."""
    s = torch.clamp(0.5 * matmul_fp32(a, b.t()), -64.0, 64.0)
    return -torch.mean(label_sim * s - F.softplus(s))


def tanh_hash_loss(code: torch.Tensor) -> torch.Tensor:
    """Mean squared distance to the detached sign (0 at 0, as ``jnp.sign``)."""
    return torch.mean((code - torch.sign(code.detach())) ** 2)
