"""The method contract (counterpart of ``cmh_tpu/models/base.py``).

A hashing method is a ``Method``: its ``model`` (an ``nn.Module`` whose
parameters sit under ``backbone.`` for CLIP and under the method's head
names), its ``loss``, and how codes are binarized at eval.

- ``method.model(image, text, key_padding_mask)`` gives the outputs the loss
  takes; ``model.encode_image`` / ``model.encode_text`` give the continuous
  codes that eval binarizes.
- ``method.loss(outputs, batch, method_state, step)`` returns ``(scalar loss,
  nested loss dict, new method_state)``, cmh_tpu's contract
  (``cmh_tpu/runners/base.py:642``). ``batch`` holds the device tensors of
  one loader batch (``label``, ``index``, …) and ``step`` is the optimizer
  step count; ``method_state`` carries training state outside the model,
  empty for the methods ported so far.
- ``method.make_hash_code`` binarizes (``sign`` or ``pair_argmax``).
- ``method.extra_param_groups(cfg_optimizer)``: parameters that leave
  BertAdam for an optimizer of their own (cmh_tpu's runner hook
  ``extra_optimizers``), as ``torch.optim.SGD`` param groups.

``resolve_clip_cfg`` picks the CLIP geometry: an explicit config, then
``clip_variant: tiny``, then the shapes of the checkpoint at ``clip_path``,
then ViT-B/32. ``load_pretrained_backbone`` overwrites the backbone only.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from ..ops.hashing import pair_argmax_code, sign_code
from .clip.loader import infer_config, load_backbone_state, read_torch_state_dict
from .clip.model import CLIPConfig

# the matmul dtypes the kernels take (cmh_tpu also allows float16)
DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
          "float32": torch.float32, "fp32": torch.float32}


def existing_clip_path(cfg_model) -> Optional[str]:
    """``model.clip_path`` (default ``./ViT-B-32.pt``) when that file exists."""
    path = (cfg_model or {}).get("clip_path", "./ViT-B-32.pt")
    return path if path and os.path.exists(path) else None


def resolve_clip_cfg(cfg_model, clip_cfg: Optional[CLIPConfig] = None,
                     state_dict: Optional[Dict[str, torch.Tensor]] = None) -> CLIPConfig:
    """The CLIP geometry: ``clip_cfg`` if given; else ``clip_variant: tiny``
    (fp32 unless ``clip_dtype`` says otherwise); else the shapes of the
    checkpoint (``state_dict``, or the file at ``clip_path``), bf16 by
    default; else ViT-B/32 with ``clip_dtype`` matmuls (default bf16)."""
    if clip_cfg is not None:
        return clip_cfg
    m = cfg_model or {}
    name = m.get("clip_dtype", None)
    dtype = None if name is None else DTYPES[str(name)]
    if m.get("clip_variant", None) == "tiny":
        return CLIPConfig.tiny(dtype=dtype or torch.float32)
    if state_dict is None and existing_clip_path(m):
        state_dict = read_torch_state_dict(existing_clip_path(m))
    if state_dict is not None:
        return infer_config(state_dict, dtype=dtype or torch.bfloat16)
    return CLIPConfig(dtype=dtype or torch.bfloat16)


class Method:
    """Everything the trainer needs of one hashing method."""

    #: registry arch name, e.g. "DCMHT"
    arch: str = "base"
    #: eval binarization: "sign" (tanh heads) or "pair_argmax" (softmax pairs)
    code_mode: str = "sign"

    def __init__(self, model: nn.Module, loss: Callable, cfg_model=None,
                 train_num: int = 10000) -> None:
        self.model = model
        self.loss = loss
        self.cfg_model = cfg_model
        self.train_num = train_num

    @property
    def output_dim(self) -> int:
        return self.model.output_dim

    def init_method_state(self) -> Dict:
        return {}

    def make_hash_code(self, code: torch.Tensor) -> torch.Tensor:
        if self.code_mode == "pair_argmax":
            return pair_argmax_code(code)
        return sign_code(code)

    def eval_code_dims(self) -> int:
        """Width of the binarized eval codes."""
        return self.output_dim

    def extra_param_groups(self, cfg_optimizer) -> List[Dict]:
        """``torch.optim.SGD`` param groups (``name``, ``params``, ``lr``, …)
        of the parameters that BertAdam does not train; default none."""
        return []

    def load_pretrained_backbone(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Overwrite the backbone with a checkpoint's weights (from
        ``read_torch_state_dict``); the heads keep their init. Every backbone
        tensor must be in the file, and nothing else."""
        backbone = {k[len("backbone."):]: v for k, v in load_backbone_state(state_dict).items()}
        self.model.backbone.load_state_dict(backbone, strict=True)

    @classmethod
    def from_config(cls, cfg_model, output_dim: int = 16, train_num: int = 10000,
                    clip_cfg: Optional[CLIPConfig] = None) -> "Method":
        raise NotImplementedError()
