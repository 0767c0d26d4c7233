"""Pretrained CLIP checkpoints (counterpart of the ViT half of
``cmh_tpu/models/clip/loader.py:30-103``).

``read_torch_state_dict`` reads a TorchScript archive (OpenAI's
``ViT-B-32.pt``) or a plain state-dict file and returns fp32 CPU tensors;
``infer_config`` gives the ViT geometry from the tensors' shapes, by the
reference's rules; ``load_backbone_state`` turns the file's entries into
the ``backbone.*`` entries of a method model. The port's CLIP keeps the
reference names, so no key is renamed: only OpenAI's three integer entries
(``input_resolution``, ``context_length``, ``vocab_size``), which are no
parameters, are dropped.

ResNet (``RN*``) checkpoints raise ``NotImplementedError``: the port has no
ResNet tower yet (ROADMAP.md Queue 1, 'The other seven methods').
"""

from __future__ import annotations

import warnings
from typing import Dict

import torch
from torch import nn

from .model import CLIPConfig

# entries of OpenAI's archives that describe the model and hold no weights
NON_PARAMETER_KEYS = ("input_resolution", "context_length", "vocab_size")


def _t(x) -> torch.Tensor:
    """A checkpoint entry as an fp32 CPU tensor (OpenAI's archives hold fp16)."""
    return torch.as_tensor(x).detach().to("cpu", torch.float32)


def read_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a TorchScript archive or a plain state-dict file, in
    fp32. A file that is neither is loaded with ``weights_only=False`` after
    a warning, as cmh_tpu does: that runs the file's pickled code."""
    try:
        state_dict = torch.jit.load(path, map_location="cpu").eval().state_dict()
    except RuntimeError:
        try:
            state_dict = torch.load(path, map_location="cpu", weights_only=True)
        except Exception:
            warnings.warn(f"{path} is not a plain state_dict; falling back to "
                          "unsafe torch.load(weights_only=False)")
            state_dict = torch.load(path, map_location="cpu", weights_only=False)
        if hasattr(state_dict, "state_dict"):
            state_dict = state_dict.state_dict()
    return {k: _t(v) for k, v in state_dict.items()}


def _require_vit(sd: Dict[str, torch.Tensor]) -> None:
    if "visual.proj" not in sd:
        raise NotImplementedError(
            "this is a ResNet (RN) CLIP checkpoint; the ResNet tower is not ported to "
            "cmh_torch yet (ROADMAP.md Queue 1, 'The other seven methods': the ResNet tower)")


def infer_config(sd: Dict[str, torch.Tensor], dtype=torch.bfloat16) -> CLIPConfig:
    """``CLIPConfig`` from the tensors' shapes (reference ``build_model``,
    cmh_tpu ``infer_config``); the text tower has width // 64 heads."""
    _require_vit(sd)
    vision_width, _, patch, _ = sd["visual.conv1.weight"].shape
    vision_layers = sum(1 for k in sd if k.startswith("visual.")
                        and k.endswith(".attn.in_proj_weight"))
    grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
    width = sd["ln_final.weight"].shape[0]
    return CLIPConfig(
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=patch * grid,
        vision_layers=vision_layers,
        vision_width=vision_width,
        vision_patch_size=patch,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=width,
        transformer_heads=width // 64,
        transformer_layers=len({k.split(".")[2] for k in sd
                                if k.startswith("transformer.resblocks")}),
        dtype=dtype,
    )


def load_backbone_state(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The file's weights as ``backbone.*`` entries of a method model's
    state dict (OpenAI's integer entries dropped)."""
    _require_vit(sd)
    return {"backbone." + k: v for k, v in sd.items() if k not in NON_PARAMETER_KEYS}


def save_torchscript_archive(sd: Dict[str, torch.Tensor], path: str) -> None:
    """Write ``sd`` as a TorchScript archive whose ``state_dict()`` is ``sd``,
    OpenAI's file layout: a scripted module tree with a parameter (or, for
    integer tensors, a buffer) at each dotted name. Used to make test and
    smoke-run checkpoints from seeded weights."""
    root = nn.Module()
    for name, value in sd.items():
        *path_parts, leaf = name.split(".")
        node = root
        for part in path_parts:
            if not hasattr(node, part):
                node.add_module(part, nn.Module())
            node = getattr(node, part)
        if value.is_floating_point():
            node.register_parameter(leaf, nn.Parameter(value.clone(), requires_grad=False))
        else:
            node.register_buffer(leaf, value.clone())
    torch.jit.save(torch.jit.script(root), path)
