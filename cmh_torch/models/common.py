"""Head building blocks (counterpart of ``cmh_tpu/models/common.py``)."""

from __future__ import annotations

import contextlib
import threading
import time

import torch
from torch import nn

from ..ops import random
from ..ops.layernorm import layernorm_plain
from ..utils import prng


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


class LinearHash(nn.Module):
    """Linear → dropout → tanh in fp32, the DSPH and DNPH heads (reference
    ``hash/hash.py`` of each; their inits are in ``models/flax_init.py``)."""

    def __init__(self, width: int, output_dim: int, dropout: float = 0.2):
        super().__init__()
        self.fc = nn.Linear(width, output_dim)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.drop(self.fc(x.float())))


class _Scope(threading.local):
    key = None
    counts = None


_SCOPE = _Scope()


@contextlib.contextmanager
def dropout_rng(key: prng.Key):
    """Inside the block, train-mode ``Dropout``s draw flax's masks under the
    step's dropout key ``key`` (cmh_tpu's ``fold_in(dropout_base, step)``):
    the n-th call of a site in the block takes ``flax_key(key, *path, n)``,
    flax's ``make_rng('dropout')`` in that module's scope. A step run again,
    after a resume or in ``run.remat``'s recompute, draws the same masks."""
    saved = (_SCOPE.key, _SCOPE.counts)
    _SCOPE.key, _SCOPE.counts = tuple(key), {}
    try:
        yield
    finally:
        _SCOPE.key, _SCOPE.counts = saved


class Dropout(nn.Module):
    """flax's ``nn.Dropout`` (keep with probability 1 − p, the kept scaled
    by 1/(1 − p) in x's dtype) with cmh_tpu's masks: ``path`` is the site's
    scope path in cmh_tpu's module tree (``models/convert.py``'s
    ``DROPOUT_SITES``), and the mask key comes from ``dropout_rng``. The
    mask is drawn where it is used, by ``ops/random.dropout`` (a kernel on
    the card, never stored). Identity in eval mode or at p = 0; in train
    mode outside ``dropout_rng`` or without a path it raises.

    ``Dropout.masks`` and ``Dropout.mask_elements`` count the masks and
    their elements (at the whole shape); ``Dropout.host_seconds`` the host
    seconds spent drawing masks, which only a CPU tensor's plain version
    takes (0 on the card).

    ``shard``, ``(dim, rank, size)``, says that ``x`` is rank ``rank``'s
    part of ``size`` equal parts along ``dim`` (heads under tensor
    parallelism): each rank draws its part of the whole mask."""

    masks = mask_elements = 0
    host_seconds = 0.0
    path = None
    shard = None

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if _SCOPE.key is None:
            raise RuntimeError("Dropout in train mode needs a dropout_rng(key) block")
        if self.path is None:
            raise RuntimeError("this Dropout has no flax path (models/convert.py DROPOUT_SITES)")
        n = _SCOPE.counts.get(self.path, 0) + 1
        _SCOPE.counts[self.path] = n
        key = prng.flax_key(_SCOPE.key, *self.path, n)
        part, size = None, 1
        if self.shard is not None:
            dim, rank, size = self.shard
            part = (dim, rank * x.shape[dim], size * x.shape[dim])
        Dropout.masks += 1
        Dropout.mask_elements += x.numel() * size
        if x.device.type != "cpu":
            return random.dropout(x, key, self.p, part)
        t0 = time.perf_counter()
        out = random.dropout(x, key, self.p, part)
        Dropout.host_seconds += time.perf_counter() - t0
        return out
