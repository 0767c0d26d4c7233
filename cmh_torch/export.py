"""Encoder files for serving (counterpart of ``cmh_tpu/export.py``).

cmh_tpu serializes its encode paths as StableHLO; that has no counterpart
here. An encoder file is a ``torch.save`` of the config tree, the method's
arch, the CLIP geometry and the model's ``state_dict``; ``load_encoders``
rebuilds the model of any registered method (``model.arch``: DCMHT,
Baseline, DSPH, DNPH) on the asked device and wraps its eval path (encode →
the method's ``make_hash_code`` → ±1 codes):

    save_encoders(model, cfg, "enc.pt")
    enc = load_encoders("enc.pt", device="cuda")
    img_codes = enc.encode_image(images)          # (B, H, W, 3) → (B, K) ±1
    txt_codes = enc.encode_text(tokens, kpm)

CLI, writing a seeded random-init model of a config, its backbone read from
the CLIP checkpoint that ``--clip-path`` (or the config's ``model.clip_path``)
names, when that file exists:

    python -m cmh_torch.export --config-file configs/DSPH/config.yaml \
        --out enc.pt [--seed 0] [--device cuda|cpu] [--clip-path ViT-B-32.pt]
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

_MAGIC = "cmh-torch-encoders-v1"
_DTYPE_NAMES = {v: k for k, v in DTYPES.items() if k in ("bfloat16", "float32")}


def _method(cfg, clip_cfg: Optional[CLIPConfig] = None, state_dict=None) -> Method:
    """The method that ``cfg`` (a config tree) names, with its model built."""
    m = cfg.get("model") or {}
    run = cfg.get("run") or {}
    return load_components().require_model_class(m.get("arch", "DCMHT")).from_config(
        m, output_dim=int(run.get("output_dim", 16)),
        clip_cfg=resolve_clip_cfg(m, clip_cfg, state_dict))


def save_encoders(model: torch.nn.Module, cfg, path: str) -> None:
    """Write the config tree, the CLIP geometry and ``model``'s weights (the
    model of the method ``cfg.model.arch`` names) to ``path``."""
    cfg_dict = cfg.to_dict() if isinstance(cfg, ConfigNode) else dict(cfg)
    clip = dataclasses.asdict(model.backbone.cfg)
    clip["dtype"] = _DTYPE_NAMES[clip["dtype"]]
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"magic": _MAGIC, "config": cfg_dict, "clip": clip, "state_dict": state},
               path)


class LoadedEncoders:
    """The eval-time encode paths of a method's model, returning ±1 codes."""

    def __init__(self, method: Method, device: torch.device):
        self.method = method
        self.model = method.model.eval()
        self.device = device

    def _tensor(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    @torch.no_grad()
    def encode_image(self, image) -> np.ndarray:
        """(B, H, W, 3) float32 NHWC → (B, K) ±1 float32 codes."""
        h = self.model.encode_image(self._tensor(image, torch.float32))
        return self.method.make_hash_code(h).cpu().numpy()

    @torch.no_grad()
    def encode_text(self, text, key_padding_mask) -> np.ndarray:
        """(B, W) int token ids and (B, W) bool pad mask → (B, K) ±1 codes."""
        h = self.model.encode_text(self._tensor(text, torch.int64),
                                   self._tensor(key_padding_mask, torch.bool))
        return self.method.make_hash_code(h).cpu().numpy()


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
    method.model.to(dev)
    return LoadedEncoders(method, dev)


def main(argv: Optional[list] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="write a seeded random-init encoder file of a method config")
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--out", required=True)
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
    method.model.init_weights(torch.Generator().manual_seed(args.seed))
    if sd is not None:
        method.load_pretrained_backbone(sd)
    method.model.to(dev)
    save_encoders(method.model, cfg, args.out)
    print(f"wrote {cfg.model.get('arch', 'DCMHT')} encoders to {args.out}"
          + (f" (backbone from {clip_path})" if sd is not None else ""))


if __name__ == "__main__":
    main()
