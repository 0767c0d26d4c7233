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
  step count; ``method_state`` carries training state outside the model
  (MITH's memory banks, TwDH's centers and transforms), made by
  ``init_method_state()`` after the trainer has set
  ``method.train_labels``.
- ``method.make_hash_code`` binarizes (``sign`` or ``pair_argmax``);
  ``method.encode_image`` / ``encode_text`` give the eval path's continuous
  codes, one matrix or, for TwDH, a tree (the long code and one code per
  short width) whose leaves ``make_codes`` binarizes.
- ``method.read_model_file(path)``: a ``model-N.pt`` of the port or a
  cmh_tpu ``model-N.msgpack`` (through ``utils/flax_msgpack.py`` and the
  method's ``state_from_jax``) as the model's ``state_dict``.
- ``method.state_to_jax(state_dict)``, the inverse, and
  ``method.jax_extra_opt_state``: the layouts cmh_tpu's full-state
  checkpoint holds (``runners/jax_checkpoint.py``).
- ``method.extra_param_groups(cfg_optimizer)``: parameters that leave
  BertAdam for an optimizer of their own (cmh_tpu's runner hook
  ``extra_optimizers``), as ``torch.optim.SGD`` param groups.

``resolve_clip_cfg`` picks the CLIP geometry: an explicit config, then
``clip_variant: tiny``, then the shapes of the checkpoint at ``clip_path``,
then ViT-B/32. ``load_pretrained_backbone`` overwrites the backbone only.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn

from ..ops.hashing import pair_argmax_code, sign_code
from ..utils import flax_msgpack
from . import convert
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
        convert.name_dropouts(model)

    @property
    def output_dim(self) -> int:
        return self.model.output_dim

    #: the train set's label matrix, set by the trainer before
    #: ``init_method_state`` (MITH's bank similarity)
    train_labels: Any = None

    def init_method_state(self) -> Dict:
        """Training state outside the model, a nested dict of tensors on the
        CPU (the trainer moves it)."""
        return {}

    def make_hash_code(self, code: torch.Tensor) -> torch.Tensor:
        if self.code_mode == "pair_argmax":
            return pair_argmax_code(code)
        return sign_code(code)

    def make_codes(self, tree):
        """``make_hash_code`` over every matrix of an eval output tree."""
        if isinstance(tree, dict):
            return {k: self.make_codes(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(self.make_codes(v) for v in tree)
        return self.make_hash_code(tree)

    def encode_image(self, image: torch.Tensor):
        """The eval path's continuous image codes."""
        return self.model.encode_image(image)

    def encode_text(self, text: torch.Tensor, key_padding_mask=None):
        return self.model.encode_text(text, key_padding_mask)

    def eval_method_state(self) -> Dict:
        """Constants the eval path folds into its codes, carried by encoder
        files (TwDH's ``trans``); default none."""
        return {}

    def load_eval_state(self, state: Dict) -> None:
        """Take the constants of ``eval_method_state`` from an encoder file."""

    def state_from_jax(self, params: Dict, model_state: Dict) -> Dict[str, torch.Tensor]:
        """cmh_tpu's ``params`` and ``model_state`` trees (a
        ``model-N.msgpack``) → this model's ``state_dict``."""
        raise NotImplementedError(f"{self.arch} has no cmh_tpu weight converter")

    def state_to_jax(self, state_dict: Dict[str, torch.Tensor]):
        """The inverse of ``state_from_jax``: a ``state_dict`` (or any dict
        of tensors under its names) → cmh_tpu's ``(params, model_state)``."""
        raise NotImplementedError(f"{self.arch} has no cmh_tpu weight converter")

    def jax_extra_opt_state(self, name: str, trace) -> Dict:
        """cmh_tpu's serialized optax state of the extra optimizer ``name``
        around its momentum ``trace`` (None without momentum): ``optax.sgd``
        is ``chain(trace or identity, scale_by_learning_rate)``."""
        return {"0": {} if trace is None else {"trace": trace}, "1": {}}

    def read_model_file(self, path: str) -> Dict[str, torch.Tensor]:
        """The weights of a ``model-N.pt`` (the port's) or a
        ``model-N.msgpack`` (cmh_tpu's ``save_model``) as a ``state_dict``."""
        if path.endswith(".msgpack"):
            tree = flax_msgpack.load(path)
            if not isinstance(tree, dict) or "params" not in tree:
                raise ValueError(f"{path!r} holds no 'params' tree: not a cmh_tpu model file")
            return self.state_from_jax(tree["params"], tree.get("model_state") or {})
        return torch.load(path, map_location="cpu", weights_only=True)

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
