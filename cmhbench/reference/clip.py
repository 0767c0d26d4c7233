"""OpenAI CLIP's towers (ViT image tower, causal text tower) in plain
PyTorch, and the products they run through.

Parameters are a dict of tensors under the names of OpenAI's checkpoints
(``visual.conv1.weight``, ``transformer.resblocks.{i}.attn.in_proj_weight``,
...). Every product of the towers goes through ``mm``: ``fp32_matmul`` for
the reference, ``fp8_matmul`` for the control. The text input is as many
positions long as the caption tensor (the first rows of the 77 positional
embeddings).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@contextlib.contextmanager
def exact_fp32():
    """float32 products without TF32 for the block's duration."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def fp32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def _fp8(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` rounded to an fp8 format under one scale that maps its largest
    magnitude to the format's largest finite value."""
    top = torch.finfo(dtype).max
    scale = t.detach().abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Fp8Matmul(torch.autograd.Function):
    """a @ b with both operands in e4m3 and, backward, the output's
    gradient in e5m2, each under a per-tensor scale; products accumulate
    in float32 (the recipe of fp8 training)."""

    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = _fp8(a, torch.float8_e4m3fn), _fp8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(a8, b8)
        return torch.matmul(a8, b8)

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = _fp8(g, torch.float8_e5m2)
        return torch.matmul(g8, b8.transpose(-1, -2)), torch.matmul(a8.transpose(-1, -2), g8)


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Fp8Matmul.apply(a, b)


def _linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], mm: Matmul):
    y = mm(x.reshape(-1, x.shape[-1]), w.t()).reshape(*x.shape[:-1], w.shape[0])
    return y if b is None else y + b


def layer_norm(x, P: Params, name: str) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), P[name + ".weight"], P[name + ".bias"], 1e-5)


def _block(x, P: Params, pre: str, heads: int, bias: Optional[torch.Tensor], mm: Matmul):
    """A residual attention block: x + attn(ln_1 x), then + mlp(ln_2 x)."""
    b, s, w = x.shape
    hd = w // heads
    qkv = _linear(layer_norm(x, P, pre + "ln_1"), P[pre + "attn.in_proj_weight"],
                  P[pre + "attn.in_proj_bias"], mm)
    q, k, v = (t.reshape(b, s, heads, hd).transpose(1, 2) for t in qkv.split(w, dim=-1))
    logits = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    if bias is not None:
        logits = logits + bias
    att = mm(torch.softmax(logits, dim=-1), v).transpose(1, 2).reshape(b, s, w)
    x = x + _linear(att, P[pre + "attn.out_proj.weight"], P[pre + "attn.out_proj.bias"], mm)
    h = _linear(layer_norm(x, P, pre + "ln_2"), P[pre + "mlp.c_fc.weight"],
                P[pre + "mlp.c_fc.bias"], mm)
    h = h * torch.sigmoid(1.702 * h)
    return x + _linear(h, P[pre + "mlp.c_proj.weight"], P[pre + "mlp.c_proj.bias"], mm)


def _layers(P: Params, pre: str) -> int:
    return len({k[len(pre):].split(".")[0] for k in P if k.startswith(pre)})


def encode_image(P: Params, image: torch.Tensor, mm: Matmul = fp32_matmul) -> torch.Tensor:
    """(B, H, W, 3) images → (B, embed) class-token embeddings."""
    w, _, p, _ = P["visual.conv1.weight"].shape
    patches = F.unfold(image.permute(0, 3, 1, 2), kernel_size=p, stride=p)   # (B, 3pp, L)
    x = _linear(patches.transpose(1, 2), P["visual.conv1.weight"].reshape(w, -1), None, mm)
    cls = P["visual.class_embedding"].expand(x.shape[0], 1, w)
    x = torch.cat([cls, x], dim=1) + P["visual.positional_embedding"]
    x = layer_norm(x, P, "visual.ln_pre")
    pre = "visual.transformer.resblocks."
    for i in range(_layers(P, pre)):
        x = _block(x, P, f"{pre}{i}.", w // 64, None, mm)
    x = layer_norm(x[:, 0], P, "visual.ln_post")
    return mm(x, P["visual.proj"])


def encode_text(P: Params, text: torch.Tensor, mm: Matmul = fp32_matmul) -> torch.Tensor:
    """(B, L) token ids, 0 after the end-of-text id → (B, embed) embeddings
    at the end-of-text position (the largest id), under a causal mask and
    with the padding keys masked."""
    b, n = text.shape
    width = P["ln_final.weight"].shape[0]
    x = P["token_embedding.weight"][text.long()] + P["positional_embedding"][:n]
    causal = torch.full((n, n), float("-inf"), device=x.device).triu(1)
    pad = torch.zeros((b, n), device=x.device).masked_fill(text == 0, float("-inf"))
    bias = causal[None, None] + pad[:, None, None, :]
    pre = "transformer.resblocks."
    for i in range(_layers(P, pre)):
        x = _block(x, P, f"{pre}{i}.", width // 64, bias, mm)
    eos = x[torch.arange(b, device=x.device), text.long().argmax(dim=-1)]
    return mm(layer_norm(eos, P, "ln_final"), P["text_projection"])
