"""Pretrained CLIP checkpoints (counterpart of
``cmh_tpu/models/clip/loader.py``).

``read_torch_state_dict`` reads a TorchScript archive (OpenAI's
``ViT-B-32.pt``) or a plain state-dict file and returns fp32 CPU tensors;
``infer_config`` gives the ViT geometry from the tensors' shapes, by the
reference's rules; ``load_backbone_state`` turns the file's entries into
the ``backbone.*`` entries of a method model. The port's CLIP keeps the
reference names, so no key is renamed: only OpenAI's three integer entries
(``input_resolution``, ``context_length``, ``vocab_size``), which are no
parameters, are dropped.

ResNet (``RN*``) checkpoints hold a ``ModifiedResNet`` image tower
(``resnet.py``), which no hashing method uses: the ViT entry points refuse
them, as cmh_tpu's ``infer_config`` does, and ``resnet_state_dict``,
``resnet_config_from_state_dict`` and ``load_resnet`` read their tower.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Tuple, Union

import torch
from torch import nn

from .model import CLIPConfig
from .resnet import ModifiedResNet

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
        raise ValueError(
            "this is an RN checkpoint: read its tower with resnet_config_from_state_dict "
            "and models.clip.resnet.ModifiedResNet (load_resnet); no hashing method uses "
            "the ResNet tower")


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


# --------------------------------------------------------------- ResNet tower
def resnet_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An RN checkpoint's ``visual.*`` entries, prefix stripped, without
    torch's ``num_batches_tracked`` counters: ``ModifiedResNet``'s state."""
    return {k[len("visual."):]: v for k, v in sd.items()
            if k.startswith("visual.") and not k.endswith(".num_batches_tracked")}


def resnet_config_from_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """``ModifiedResNet``'s geometry from a prefix-stripped visual state dict
    (reference ``build_model``, cmh_tpu ``resnet_config_from_state_dict``):
    blocks a stage, width, input resolution, output dim, heads = width·32 // 64."""
    counts = tuple(len({k.split(".")[1] for k in sd if k.startswith(f"layer{b}.")})
                   for b in (1, 2, 3, 4))
    width = sd["layer1.0.conv1.weight"].shape[0]
    output_width = round((sd["attnpool.positional_embedding"].shape[0] - 1) ** 0.5)
    return dict(layers=counts, width=width, input_resolution=output_width * 32,
                output_dim=sd["attnpool.c_proj.weight"].shape[0], heads=width * 32 // 64)


def load_resnet(source: Union[str, Dict[str, torch.Tensor]], dtype=torch.bfloat16
                ) -> Tuple[ModifiedResNet, Dict[str, Any]]:
    """(tower, geometry) of an RN CLIP checkpoint (a path, or the tensors
    ``read_torch_state_dict`` gives), on the CPU in eval mode."""
    sd = read_torch_state_dict(source) if isinstance(source, str) else source
    if "visual.proj" in sd:
        raise ValueError("this is a ViT checkpoint: load it with infer_config and "
                         "load_backbone_state")
    state = resnet_state_dict(sd)
    cfg = resnet_config_from_state_dict(state)
    tower = ModifiedResNet(dtype=dtype, **cfg)
    tower.load_state_dict(state, strict=True)
    return tower.eval(), cfg
