"""Encoder files for serving (counterpart of ``cmh_tpu/export.py``).

cmh_tpu serializes its encode paths as StableHLO; that has no counterpart
here. An encoder file is a ``torch.save`` of the config tree, the method's
arch, the CLIP geometry, the model's ``state_dict`` and the constants the
method folds into its eval codes (TwDH's ``trans``, from
``Method.eval_method_state``); ``load_encoders`` rebuilds the model of any
registered method (``model.arch``: DCMHT, Baseline, DSPH, DNPH, MITH, TwDH,
DIMCH, UMoED)
on the asked device and wraps its eval path (the method's encode → its
``make_hash_code`` → ±1 codes):

    save_encoders(model, cfg, "enc.pt", method.eval_method_state())
    enc = load_encoders("enc.pt", device="cuda")
    img_codes = enc.encode_image(images)          # (B, H, W, 3) → (B, K) ±1
    txt_codes = enc.encode_text(tokens, kpm)

TwDH's encoders return, as cmh_tpu's exported ones do, the tree (long codes,
{short width: codes}); an index is built over the long codes.

CLI, writing the encoders of a config: the weights of ``--model`` (a
``model-N.pt`` of the port or a cmh_tpu ``model-N.msgpack``), or else a
random init (cmh_tpu's, from ``PRNGKey(--seed)``) whose backbone is read from the CLIP checkpoint that
``--clip-path`` (or the config's ``model.clip_path``) names, when that file
exists:

    python -m cmh_torch.export --config-file configs/DSPH/config.yaml \
        --out enc.pt [--model model-9.msgpack] [--seed 0] [--device cuda|cpu] \
        [--clip-path ViT-B-32.pt]
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .config import ConfigNode, config_from_dict
from .models.base import DTYPES, Method, existing_clip_path, resolve_clip_cfg
from .models.clip.model import CLIPConfig
from .registry import load_components
from .utils import prng

_MAGIC = "cmh-torch-encoders-v1"
_DTYPE_NAMES = {v: k for k, v in DTYPES.items() if k in ("bfloat16", "float32")}


def _method(cfg, clip_cfg: Optional[CLIPConfig] = None, state_dict=None) -> Method:
    """The method that ``cfg`` (a config tree) names, with its model built."""
    m = cfg.get("model") or {}
    run = cfg.get("run") or {}
    max_word = (cfg.get("dataset") or {}).get("max_word", None)
    if max_word is not None and "txt_token_size" not in m:
        # the text token set of DIMCH and UMoED, as their trainers size it
        m = dict(m.to_dict() if isinstance(m, ConfigNode) else m, txt_token_size=max_word)
    return load_components().require_model_class(m.get("arch", "DCMHT")).from_config(
        m, output_dim=int(run.get("output_dim", 16)),
        clip_cfg=resolve_clip_cfg(m, clip_cfg, state_dict))


def save_encoders(model: torch.nn.Module, cfg, path: str,
                  eval_state: Optional[dict] = None) -> None:
    """Write the config tree, the CLIP geometry, ``model``'s weights (the
    model of the method ``cfg.model.arch`` names) and the method's
    ``eval_state`` (``Method.eval_method_state()``) to ``path``."""
    cfg_dict = cfg.to_dict() if isinstance(cfg, ConfigNode) else dict(cfg)
    clip = dataclasses.asdict(model.backbone.cfg)
    clip["dtype"] = _DTYPE_NAMES[clip["dtype"]]
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"magic": _MAGIC, "config": cfg_dict, "clip": clip, "state_dict": state,
                "eval_state": eval_state or {}}, path)


class LoadedEncoders:
    """The eval-time encode paths of a method's model, returning ±1 codes
    (a tree of them for TwDH)."""

    def __init__(self, method: Method, device: torch.device):
        self.method = method
        self.model = method.model.eval()
        self.device = device

    def _tensor(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    @torch.no_grad()
    def encode_image(self, image):
        """(B, H, W, 3) float32 NHWC → (B, K) ±1 float32 codes."""
        h = self.method.encode_image(self._tensor(image, torch.float32))
        return _numpy(self.method.make_codes(h))

    @torch.no_grad()
    def encode_text(self, text, key_padding_mask):
        """(B, W) int token ids and (B, W) bool pad mask → (B, K) ±1 codes."""
        h = self.method.encode_text(self._tensor(text, torch.int64),
                                    self._tensor(key_padding_mask, torch.bool))
        return _numpy(self.method.make_codes(h))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_numpy(v) for v in tree)
    return tree.cpu().numpy()


def load_encoders(path: str, device="cuda") -> LoadedEncoders:
    dev = resolve_device(device)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    magic = blob.get("magic", "<missing>") if isinstance(blob, dict) else "<missing>"
    if magic != _MAGIC:
        raise ValueError(f"{path!r} is not a cmh_torch encoder file "
                         f"(magic {magic!r}, expected {_MAGIC!r})")
    clip = dict(blob["clip"])
    clip["dtype"] = DTYPES[clip["dtype"]]
    method = _method(config_from_dict(blob["config"]), CLIPConfig(**clip))
    method.model.load_state_dict(blob["state_dict"])
    method.load_eval_state(blob.get("eval_state") or {})
    method.model.to(dev)
    return LoadedEncoders(method, dev)


def main(argv: Optional[list] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="write the encoder file of a method config: trained weights "
                    "(--model) or a seeded random init")
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--model", default=None,
                    help="weights: a model-N.pt of cmh_torch or a cmh_tpu model-N.msgpack")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device the model is built on")
    ap.add_argument("--clip-path", default=None,
                    help="CLIP checkpoint (TorchScript archive or state dict) "
                         "that fills the backbone")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from .config import load_config
    from .models.clip.loader import read_torch_state_dict

    cfg = load_config(args.config_file)
    if args.clip_path:
        cfg.model.update({"clip_path": args.clip_path})
    # as the trainer: the backbone from model.clip_path when that file exists
    clip_path = existing_clip_path(cfg.model)
    sd = read_torch_state_dict(clip_path) if clip_path else None
    method = _method(cfg, state_dict=sd)
    if args.model:
        method.model.load_state_dict(method.read_model_file(args.model))
        source = f" (weights from {args.model})"
    else:
        method.model.init_weights(prng.PRNGKey(args.seed), dev)
        if sd is not None:
            method.load_pretrained_backbone(sd)
        source = f" (backbone from {clip_path})" if sd is not None else ""
    method.model.to(dev)
    save_encoders(method.model, cfg, args.out, method.eval_method_state())
    print(f"wrote {cfg.model.get('arch', 'DCMHT')} encoders to {args.out}{source}")


if __name__ == "__main__":
    main()
