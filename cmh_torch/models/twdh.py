"""TwDH: two-step discrete hashing (counterpart of ``cmh_tpu/models/twdh.py``).

The model is DCMHT's (``ModalityHash`` with the image BatchNorm, softmax
pairs) at ``long_dim`` bits, so the long code has ``long_dim`` bits. Each
short width k comes from a fixed transform in the pair-probability space:
``short[k] = softmax_hash(long_hash @ trans[k])``. The loss is the BCE of
the pair probabilities against hash-center targets (a sample's sign of the
sum of its classes' centers, ties broken by ``ops/hash_centers.tie_vector``
under cmh_tpu's key ``fold_in(PRNGKey(center_seed), step)``) for the long
code and each short one, plus the soft-argmax quantization terms, weighted
by ``quan_alpha`` and ``low_rate``.

Centers and transforms are read from the reference's torch pickles when
the paths exist; otherwise the centers are CSQ Hadamard rows (seeds 13 and
14) and each transform is ``RandomState(17)`` normals over √(2·long_dim),
bit-equal to cmh_tpu's. They live in the method state; the eval path and
encoder files carry the transforms (``eval_method_state``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.hash_centers import (bce_probs, generate_hash_centers, hash_center_multilabels,
                                hash_convert, load_center_file, tie_vector)
from ..ops.hashing import softmax_hash, tanh_hash
from ..registry import registry
from ..utils import prng
from . import convert
from .base import Method, resolve_clip_cfg
from .clip.model import CLIPConfig
from .dcmht import DCMHTModel, soft_argmax_hash_loss


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(a).to(torch.float32, copy=True)


def short_activation(hash_func: str):
    """The short codes' activation is the long head's (softmax or tanh)."""
    try:
        return {"softmax": softmax_hash, "tanh": tanh_hash}[hash_func]
    except KeyError:
        raise ValueError(f"TwDH hash_func {hash_func!r} has no short-code activation "
                         "(softmax or tanh)") from None


class TwDHModel(DCMHTModel):
    """DCMHT's model at ``long_dim`` bits, with the short codes."""

    def __init__(self, clip_cfg: CLIPConfig, long_dim: int = 512, hash_func: str = "softmax"):
        super().__init__(clip_cfg, output_dim=long_dim, hash_func=hash_func)

    def short(self, long_hash: torch.Tensor, trans: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        act = short_activation(self.hash_func)
        return {k: act(long_hash @ v.to(long_hash.device).float()) for k, v in trans.items()}


def twdh_loss_fn(*, quan_alpha: float, low_rate: float, center_seed: int,
                 hash_func: str = "softmax"):
    act = short_activation(hash_func)

    def loss(outputs, batch, method_state, step):
        img_long, txt_long = outputs
        labels = batch["label"]
        long_center = method_state["long_center"]
        short_centers, trans = method_state["short_centers"], method_state["trans"]

        key = prng.fold_in(prng.PRNGKey(center_seed), int(step))

        def target(centers):
            tie = tie_vector(key, centers.shape[1], labels.device)
            return hash_convert(hash_center_multilabels(labels, centers, tie))

        t_long = target(long_center)
        long_img_loss = bce_probs(img_long, t_long)
        long_txt_loss = bce_probs(txt_long, t_long)
        long_nce = (long_img_loss + long_txt_loss) / 2.0
        quan_img = soft_argmax_hash_loss(img_long)
        quan_txt = soft_argmax_hash_loss(txt_long)
        total = long_nce + quan_alpha * ((quan_img + quan_txt) / 2.0)
        short_dict = {}
        for k in sorted(short_centers):
            s_img, s_txt = act(img_long @ trans[k]), act(txt_long @ trans[k])
            s_target = target(short_centers[k])
            s_nce = (bce_probs(s_img, s_target) + bce_probs(s_txt, s_target)) / 2.0
            s_quan = (soft_argmax_hash_loss(s_img) + soft_argmax_hash_loss(s_txt)) / 2.0
            total = total + low_rate * s_nce + low_rate * s_quan
            short_dict[k] = {"NCE": s_nce, "Quan": s_quan}
        loss_dict = {
            "All loss": total,
            "Long": {"NCE": {"image": long_img_loss, "text": long_txt_loss},
                     "Quan": {"image": quan_img, "text": quan_txt}},
            "Short": short_dict,
        }
        return total, loss_dict, method_state

    return loss


@registry.register_model("TwDH")
class TwDHMethod(Method):
    arch = "TwDH"
    code_mode = "pair_argmax"

    def __init__(self, model, loss, cfg_model=None, train_num: int = 10000,
                 long_center=None, short_centers=None, trans=None):
        super().__init__(model, loss, cfg_model, train_num)
        self._long_center = long_center
        self._short_centers = short_centers or {}
        # float32, as jnp.asarray makes cmh_tpu's (float64 under numpy 2)
        self._trans = {k: _f32(v) for k, v in (trans or {}).items()}

    @property
    def short_dims(self):
        return sorted(int(k) for k in self._short_centers)

    def init_method_state(self):
        return {"long_center": _f32(self._long_center),
                "short_centers": {k: _f32(v) for k, v in self._short_centers.items()},
                "trans": {k: v.clone() for k, v in self._trans.items()}}

    def eval_method_state(self):
        """The transforms the eval path folds into the short codes; raises
        rather than let an encoder file ship long codes only."""
        if not self._trans:
            raise ValueError("TwDH has no trans matrices loaded — every short-code head "
                             "would be missing from eval/export")
        return {"trans": {k: v.clone() for k, v in self._trans.items()}}

    def load_eval_state(self, state):
        if not (state or {}).get("trans"):
            raise ValueError("the TwDH encoder file carries no trans matrices")
        self._trans = {k: _f32(v) for k, v in state["trans"].items()}

    def encode_image(self, image):
        """(long code, {width: short code}) before binarization."""
        long_hash = self.model.encode_image(image)
        return long_hash, self.model.short(long_hash, self._trans)

    def encode_text(self, text, key_padding_mask=None):
        long_hash = self.model.encode_text(text, key_padding_mask)
        return long_hash, self.model.short(long_hash, self._trans)

    def state_from_jax(self, params, model_state):
        return convert.twdh_state_from_jax(params, model_state["batch_stats"])

    def state_to_jax(self, state_dict):
        return convert.twdh_state_to_jax(state_dict)

    @classmethod
    def from_config(cls, cfg_model, output_dim: int = 16, train_num: int = 10000,
                    clip_cfg: Optional[CLIPConfig] = None) -> "TwDHMethod":
        m = cfg_model or {}
        long_dim = int(m.get("long_dim", 512))
        numclass = m.get("numclass", 80)
        short_dims = [int(s) for s in m.get("short_dims", [output_dim])]
        long_dir = m.get("long_center", "./data/transformer/TwDH/center/long")
        short_dir = m.get("short_center", "./data/transformer/TwDH/center/short")
        trans_dir = m.get("trans_matrix", "./data/transformer/TwDH/center/trans")

        long_path = os.path.join(str(long_dir), f"{long_dim}.pkl")
        long_center = (load_center_file(long_path) if os.path.isfile(long_path)
                       else generate_hash_centers(numclass, long_dim, seed=13))
        short_centers, trans = {}, {}
        rng = np.random.RandomState(17)
        for sd in short_dims:
            sp = os.path.join(str(short_dir), f"{sd}.pkl")
            tp = os.path.join(str(trans_dir), str(long_dim), f"{sd}.pkl")
            short_centers[str(sd)] = (load_center_file(sp) if os.path.isfile(sp)
                                      else generate_hash_centers(numclass, sd, seed=14))
            trans[str(sd)] = (load_center_file(tp) if os.path.isfile(tp) else
                              rng.randn(2 * long_dim, 2 * sd).astype(np.float32)
                              / np.sqrt(2 * long_dim))
        hash_func = m.get("hash_func", "softmax")
        model = TwDHModel(resolve_clip_cfg(m, clip_cfg), long_dim=long_dim, hash_func=hash_func)
        loss = twdh_loss_fn(quan_alpha=m.get("quan_alpha", 0.5), low_rate=m.get("low_rate", 0),
                            center_seed=m.get("center_seed", 0), hash_func=hash_func)
        return cls(model, loss, cfg_model, train_num, long_center=long_center,
                   short_centers=short_centers, trans=trans)
