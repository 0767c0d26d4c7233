"""Head building blocks (counterpart of ``cmh_tpu/models/common.py``)."""

from __future__ import annotations

import torch
from torch import nn


class SingleTokenAttention(nn.Module):
    """Self-attention over a single token (the DCMHT head front-end).

    With one token the softmax over one key is identically 1, so the layer
    is exactly ``out_proj(v_proj(x))``. The packed-QKV parameters keep the
    reference torch layout (``in_proj_weight`` (3d, d), ``out_proj``); only
    the value rows are used."""

    def __init__(self, width: int):
        super().__init__()
        self.width = width
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.width
        v = torch.matmul(x, self.in_proj_weight[2 * d:].t()) + self.in_proj_bias[2 * d:]
        return torch.matmul(v, self.out_proj.weight.t()) + self.out_proj.bias

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """xavier-uniform kernels, zero biases (cmh_tpu's initializers)."""
        d = self.width
        for w, fan in ((self.in_proj_weight, d + 3 * d), (self.out_proj.weight, 2 * d)):
            bound = (6.0 / fan) ** 0.5
            w.copy_((torch.rand(w.shape, generator=generator) * 2 - 1) * bound)
        self.in_proj_bias.zero_()
        self.out_proj.bias.zero_()


class BatchNorm1d(nn.Module):
    """torch BatchNorm1d semantics (eps 1e-5, momentum 0.1, affine) in fp32,
    as cmh_tpu's ``_TorchBatchNorm`` (``cmh_tpu/models/common.py:78-129``).

    Training (``module.train()``): normalise with the batch mean and the
    *biased* batch variance, and move the running variance toward the
    *unbiased* one. Eval (``module.eval()``): normalise with the running
    statistics. Every row of the batch counts, padded rows included."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training:
            mean = x.mean(0)
            var = (x - mean).square().mean(0)
            with torch.no_grad():
                n = x.shape[0]
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var * (n / max(n - 1, 1)),
                                                    alpha=m)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias
