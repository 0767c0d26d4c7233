"""Head building blocks (counterpart of ``cmh_tpu/models/common.py``)."""

from __future__ import annotations

import contextlib
import threading
import time

import torch
from torch import nn

from ..ops.layernorm import layernorm_plain
from ..utils.seed import derived_seed


class FlaxLayerNorm(nn.Module):
    """flax's ``nn.LayerNorm`` (fast variance, eps 1e-5, fp32), as the DCMHT
    text head and MITH's residual MLPs use it. It sits outside any kernel in
    cmh_tpu, so it is plain PyTorch here."""

    def __init__(self, width: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm_plain(x.float(), self.weight, self.bias)


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


def kaiming_uniform_fan_out_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """The reference heads' ``kaiming_uniform_(mode='fan_out')``: uniform
    ±√2·√(3 / out_features) (cmh_tpu ``ops/hashing.py:kaiming_uniform_fan_out``)."""
    bound = (2.0**0.5) * (3.0 / weight.shape[0]) ** 0.5
    weight.copy_((torch.rand(weight.shape, generator=generator) * 2 - 1) * bound)


def torch_default_linear_(lin: nn.Linear, generator: torch.Generator) -> None:
    """``nn.Linear``'s default init, weight and bias uniform ±1/√in_features
    (cmh_tpu ``models/common.py:torch_default_dense``)."""
    bound = 1.0 / lin.in_features**0.5
    for t in (lin.weight, lin.bias):
        t.copy_((torch.rand(t.shape, generator=generator) * 2 - 1) * bound)


class LinearHash(nn.Module):
    """Linear → dropout → tanh in fp32, the DSPH and DNPH heads (reference
    ``hash/hash.py`` of each; their inits differ and live in the models)."""

    def __init__(self, width: int, output_dim: int, dropout: float = 0.2):
        super().__init__()
        self.fc = nn.Linear(width, output_dim)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.drop(self.fc(x.float())))


class _Scope(threading.local):
    seed = None
    step = 0
    position = 0


_SCOPE = _Scope()


@contextlib.contextmanager
def dropout_rng(seed: int, step: int):
    """Inside the block, the n-th ``Dropout`` call in train mode draws its
    mask from a generator seeded by (``seed``, ``step``, n), the role of
    cmh_tpu's ``fold_in(dropout_key, step)``: a step draws the same masks when
    it is run again, after a resume or in ``run.remat``'s recompute."""
    saved = (_SCOPE.seed, _SCOPE.step, _SCOPE.position)
    _SCOPE.seed, _SCOPE.step, _SCOPE.position = int(seed), int(step), 0
    try:
        yield
    finally:
        _SCOPE.seed, _SCOPE.step, _SCOPE.position = saved


class Dropout(nn.Module):
    """Inverted dropout (flax ``nn.Dropout``: keep with probability 1 − p,
    scale the kept by 1/(1 − p)) whose masks come from ``dropout_rng``, never
    from the global RNG. The mask is drawn on the CPU, so it is the same
    whatever the device. Identity in eval mode or at p = 0; in train mode
    outside ``dropout_rng`` it raises.

    ``Dropout.masks``, ``Dropout.mask_elements`` and ``Dropout.host_seconds``
    count the masks drawn, their elements and the host seconds spent drawing
    them and copying them to the tensor's device.

    ``shard``, ``(dim, rank, size)``, says that ``x`` is rank ``rank``'s
    part of ``size`` equal parts along ``dim`` (heads under tensor
    parallelism): the mask is drawn at the whole shape and its part taken,
    so every rank's masks and position counter are one process's."""

    masks = mask_elements = 0
    host_seconds = 0.0
    shard = None

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if _SCOPE.seed is None:
            raise RuntimeError("Dropout in train mode needs a dropout_rng(seed, step) block")
        t0 = time.perf_counter()
        gen = torch.Generator().manual_seed(
            derived_seed(_SCOPE.seed, _SCOPE.step, _SCOPE.position))
        _SCOPE.position += 1
        if self.shard is None:
            keep = torch.rand(x.shape, generator=gen) >= self.p
        else:
            dim, rank, size = self.shard
            whole = list(x.shape)
            whole[dim] *= size
            keep = (torch.rand(whole, generator=gen) >= self.p).chunk(size, dim)[rank]
        keep = keep.to(x.device)
        Dropout.host_seconds += time.perf_counter() - t0
        Dropout.masks += 1
        Dropout.mask_elements += keep.numel() * (self.shard[2] if self.shard else 1)
        return torch.where(keep, x / (1.0 - self.p), torch.zeros((), dtype=x.dtype,
                                                                  device=x.device))
