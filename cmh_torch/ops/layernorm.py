"""LayerNorm over the last axis with fp32 statistics (kernels K1-fwd, K1-bwd).

Counterpart of ``cmh_tpu/ops/layernorm_pallas.py:fused_layernorm`` and its
``custom_vjp``. A CUDA tensor launches the hand-written kernels in
``csrc/layernorm.cu``; a CPU tensor takes ``layernorm_plain`` and
``layernorm_bwd_plain``, the same functions in plain PyTorch. Gradients go
through ``_LayerNormFn``, whose backward is the Pallas backward's formula
(statistics recomputed, per-row dx, dγ/dβ summed over rows), not autograd of
the forward.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

EPS = 1e-5
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_VEC_PER_LANE = 8   # kernel instantiations, csrc/layernorm.cu


def _acc(x: torch.Tensor) -> torch.Tensor:
    """fp32 working copy (fp64 stays fp64, for gradcheck)."""
    return x.double() if x.dtype == torch.float64 else x.float()


def layernorm_plain(x: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor) -> torch.Tensor:
    """flax's fast-variance LayerNorm: fp32 stats, max(E[x²]−E[x]², 0),
    eps inside rsqrt, output in x's dtype."""
    xf = _acc(x)
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    out = (xf - mu) * torch.rsqrt(var + EPS) * gamma.to(xf.dtype) + beta.to(xf.dtype)
    return out.to(x.dtype)


def layernorm_bwd_plain(x2d: torch.Tensor, gamma: torch.Tensor,
                        dout: torch.Tensor):
    """The backward kernel's function: (dx in x's dtype, dγ, dβ in γ's
    dtype) for (rows, d) inputs."""
    xf, do = _acc(x2d), _acc(dout)
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    inv = torch.rsqrt(var + EPS)
    xhat = (xf - mu) * inv
    dy = do * gamma.to(xf.dtype)
    m1 = dy.mean(-1, keepdim=True)
    m2 = (dy * xhat).mean(-1, keepdim=True)
    dx = inv * (dy - m1 - xhat * m2)
    dgamma = (do * xhat).sum(0)
    dbeta = do.sum(0)
    return dx.to(x2d.dtype), dgamma.to(gamma.dtype), dbeta.to(gamma.dtype)


def _lib():
    lib = _build.load("layernorm")
    if lib.cmh_layernorm_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.cmh_layernorm_blocks_per_sm, lib.cmh_layernorm_warps_per_block):
            fn.argtypes, fn.restype = [i], i
        lib.cmh_layernorm_fwd.argtypes = [p, p, p, p, i, i, i, i, i, p]
        lib.cmh_layernorm_fwd.restype = i
        lib.cmh_layernorm_bwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, p]
        lib.cmh_layernorm_bwd.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _grid(lib, t: torch.Tensor, bwd: bool) -> int:
    """The persistent grid: the blocks each SM keeps resident, times the
    SM count (the kernels launch no more warps than rows)."""
    return lib.cmh_layernorm_blocks_per_sm(int(bwd)) * _sm_count(t.device.index or 0)


_SYNC: dict = {}


def _sync_word(t: torch.Tensor) -> torch.Tensor:
    """The backward's grid-barrier word for t's device and current stream:
    zeroed once, and left at zero by every launch."""
    key = (t.device.index or 0, _stream(t))
    if key not in _SYNC:
        _SYNC[key] = torch.zeros(1, dtype=torch.int32, device=t.device)
    return _SYNC[key]


def _check(x2d: torch.Tensor, gamma: torch.Tensor, *others: torch.Tensor) -> None:
    rows, d = x2d.shape
    if x2d.dtype not in _DTYPES:
        raise TypeError(f"layernorm kernel takes float32 or bfloat16, "
                        f"got {x2d.dtype}")
    vec = 16 // x2d.element_size()
    if d % vec or d // vec > 32 * _MAX_VEC_PER_LANE:
        raise ValueError(f"layernorm kernel needs d % {vec} == 0 and "
                         f"d <= {32 * vec * _MAX_VEC_PER_LANE}, got d={d}")
    for t in (gamma, *others):
        if t.dtype != torch.float32 or t.shape != (d,) or t.device != x2d.device:
            raise ValueError("gamma and beta must be float32 (d,) on x's device")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(x2d: torch.Tensor, gamma: torch.Tensor,
            beta: torch.Tensor) -> torch.Tensor:
    _check(x2d, gamma, beta)
    rows, d = x2d.shape
    x2d, gamma, beta = _aligned(x2d), _aligned(gamma), _aligned(beta)
    out = torch.empty_like(x2d)
    lib = _lib()
    rc = lib.cmh_layernorm_fwd(
        x2d.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
        rows, d, _grid(lib, x2d, False), _DTYPES[x2d.dtype], x2d.device.index or 0,
        _stream(x2d))
    _build.check(rc, "layernorm_fwd")
    fused_layernorm.launches += 1
    fused_layernorm.launches_fp32 += x2d.dtype == torch.float32
    return out


def _launch_bwd(x2d: torch.Tensor, gamma: torch.Tensor, dout: torch.Tensor):
    _check(x2d, gamma)
    if dout.shape != x2d.shape or dout.dtype != x2d.dtype:
        raise ValueError("dout must have x's shape and dtype")
    rows, d = x2d.shape
    x2d, dout, gamma = _aligned(x2d), _aligned(dout), _aligned(gamma)
    lib = _lib()
    blocks = _grid(lib, x2d, True)
    dx = torch.empty_like(x2d)
    part = torch.empty((blocks, 2, d), dtype=torch.float32, device=x2d.device)
    dgb = torch.empty((2, d), dtype=torch.float32, device=x2d.device)
    rc = lib.cmh_layernorm_bwd(
        x2d.data_ptr(), gamma.data_ptr(), dout.data_ptr(), dx.data_ptr(),
        part.data_ptr(), _sync_word(x2d).data_ptr(), dgb[0].data_ptr(),
        dgb[1].data_ptr(), rows, d, blocks, _DTYPES[x2d.dtype],
        x2d.device.index or 0, _stream(x2d))
    _build.check(rc, "layernorm_bwd")
    layernorm_bwd.launches += 1
    layernorm_bwd.launches_fp32 += x2d.dtype == torch.float32
    return dx, dgb[0], dgb[1]


def _forward(x2d, gamma, beta):
    if x2d.device.type == "cpu":
        return layernorm_plain(x2d, gamma, beta)
    return _launch(x2d, gamma, beta)


def layernorm_bwd(x2d: torch.Tensor, gamma: torch.Tensor, dout: torch.Tensor):
    """(dx, dγ, dβ) of the LayerNorm at (rows, d) ``x2d``. On a CUDA tensor
    this launches the backward kernel, one cooperative launch that also sums
    dγ/dβ over the card (counted in ``layernorm_bwd.launches``); on a CPU
    tensor it runs ``layernorm_bwd_plain``."""
    if x2d.device.type == "cpu":
        return layernorm_bwd_plain(x2d, gamma, dout)
    return _launch_bwd(x2d, gamma, dout)


class _LayerNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, gamma, beta):
        ctx.save_for_backward(x2d, gamma)
        return _forward(x2d, gamma, beta)

    @staticmethod
    def backward(ctx, dout):
        x2d, gamma = ctx.saved_tensors
        return layernorm_bwd(x2d, gamma, dout.contiguous())


def fused_layernorm(x: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis, fp32 stats, output in x's dtype.

    Any leading shape; differentiable in all three arguments. On a CUDA
    tensor this launches the kernel (and counts the launch in
    ``fused_layernorm.launches``, an fp32 one also in ``launches_fp32``);
    on a CPU tensor it runs ``layernorm_plain``. Outside autograd (no input needs a gradient, or
    ``torch.no_grad()``) nothing is saved for a backward."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no layernorm kernel for device {x.device}")
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, gamma, beta)):
        out = _LayerNormFn.apply(x2d, gamma, beta)
    else:
        out = _forward(x2d, gamma, beta)
    return out.reshape(shape)


# launches, and of them those of the fp32 kernels
fused_layernorm.launches = fused_layernorm.launches_fp32 = 0
layernorm_bwd.launches = layernorm_bwd.launches_fp32 = 0
