"""Weights made from the seed on the card: OpenAI CLIP's tensors under its
checkpoint names and the method's heads (``methods/<method>.py``) under the
port's state-dict names.

One normal draw of every value at once, each leaf then scaled as CLIP's
own initialisation scales it (and LayerNorm and BatchNorm weights about
1), and every value rounded to fp16, the type OpenAI's checkpoints hold.
The same seed gives the same tensors bit for bit, so the reference makes
them again instead of reading anything the port made.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import spec
from .common import WEIGHTS, generator

# (name, shape, how): how is ("normal", mean, std) or ("lognormal", std)
Leaf = Tuple[str, Tuple[int, ...], tuple]


def _blocks(pre: str, width: int, layers: int) -> List[Leaf]:
    proj = width ** -0.5 * (2 * layers) ** -0.5
    out = []
    for i in range(layers):
        p = f"{pre}{i}."
        out += [
            (p + "attn.in_proj_weight", (3 * width, width), ("normal", 0.0, width ** -0.5)),
            (p + "attn.in_proj_bias", (3 * width,), ("normal", 0.0, 0.02)),
            (p + "attn.out_proj.weight", (width, width), ("normal", 0.0, proj)),
            (p + "attn.out_proj.bias", (width,), ("normal", 0.0, 0.02)),
            (p + "ln_1.weight", (width,), ("normal", 1.0, 0.02)),
            (p + "ln_1.bias", (width,), ("normal", 0.0, 0.02)),
            (p + "mlp.c_fc.weight", (4 * width, width), ("normal", 0.0, (2 * width) ** -0.5)),
            (p + "mlp.c_fc.bias", (4 * width,), ("normal", 0.0, 0.02)),
            (p + "mlp.c_proj.weight", (width, 4 * width), ("normal", 0.0, proj)),
            (p + "mlp.c_proj.bias", (width,), ("normal", 0.0, 0.02)),
            (p + "ln_2.weight", (width,), ("normal", 1.0, 0.02)),
            (p + "ln_2.bias", (width,), ("normal", 0.0, 0.02)),
        ]
    return out


def clip_leaves(clip: dict) -> List[Leaf]:
    """OpenAI CLIP's ViT checkpoint tensors (``build_model``'s names)."""
    w, p = clip["vision_width"], clip["vision_patch_size"]
    g = clip["image_resolution"] // p
    tw, e = clip["transformer_width"], clip["embed_dim"]
    ln = lambda n, d: [(n + ".weight", (d,), ("normal", 1.0, 0.02)),   # noqa: E731
                       (n + ".bias", (d,), ("normal", 0.0, 0.02))]
    return ([("visual.class_embedding", (w,), ("normal", 0.0, w ** -0.5)),
             ("visual.positional_embedding", (g * g + 1, w), ("normal", 0.0, w ** -0.5)),
             ("visual.proj", (w, e), ("normal", 0.0, w ** -0.5)),
             ("visual.conv1.weight", (w, 3, p, p), ("normal", 0.0, (3 * p * p) ** -0.5))]
            + ln("visual.ln_pre", w) + ln("visual.ln_post", w)
            + _blocks("visual.transformer.resblocks.", w, clip["vision_layers"])
            + _blocks("transformer.resblocks.", tw, clip["transformer_layers"])
            + [("token_embedding.weight", (clip["vocab_size"], tw), ("normal", 0.0, 0.02)),
               ("positional_embedding", (clip["context_length"], tw), ("normal", 0.0, 0.01))]
            + ln("ln_final", tw)
            + [("text_projection", (tw, e), ("normal", 0.0, tw ** -0.5)),
               ("logit_scale", (), ("normal", 2.6592600, 0.0))])


def make(cfg: dict, seed: int, device) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                                                 Dict[str, torch.Tensor]]:
    """(the fp16 buffer that holds every value, the CLIP tensors, the head
    tensors): fp16 views into that one buffer, under the names above."""
    towers = clip_leaves(cfg["clip"])
    leaves = towers + spec.method(cfg).head_leaves(cfg)
    sizes = [int(torch.Size(shape).numel()) for _, shape, _ in leaves]
    flat = torch.randn(sum(sizes), generator=generator(seed, WEIGHTS, device), device=device)
    out, start = {}, 0
    for (name, shape, how), n in zip(leaves, sizes):
        v = flat[start:start + n]
        if how[0] == "normal":
            v.mul_(how[2]).add_(how[1])
        else:
            v.mul_(how[1]).exp_()
        start += n
    half = flat.half()
    del flat
    start = 0
    for (name, shape, _), n in zip(leaves, sizes):
        out[name] = half[start:start + n].view(shape)
        start += n
    clip = {name: out[name] for name, _, _ in towers}
    heads = {k: v for k, v in out.items() if k not in clip}
    return half, clip, heads


def reference_params(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The same tensors in float32 as the reference trains them: the towers
    under ``backbone.``, the heads under their own names
    (``reference.training.bare`` takes the prefix off)."""
    _, clip, heads = make(cfg, seed, device)
    out = {"backbone." + k: v.float() for k, v in clip.items()}
    out.update({k: v.float() for k, v in heads.items()})
    return out
