"""DNPH: deep noise-robust proxy hashing (counterpart of
``cmh_tpu/models/dnph.py``).

Per-modality head = Linear (kaiming-uniform fan_out, zero bias) → dropout
(0.2) → tanh under ``hash.{image,text}_hash.fc``, plus a classification
Linear per modality (``hash.{image,text}_pre.fc``) pinned at 80 classes, as
in the reference, which never forwards ``numclass`` to it. The loss is

- the proxy loss over the concatenated (image, text) codes: squared
  distances to the L2-normalized proxies (``loss.proxies``, normal/8), plus
  ``mrg`` on positive classes, as a softmax over classes;
- the cross-entropy of each modality's class logits against argmax(label);
- minus ``noise_alpha`` times the mean dot product between the codes and
  random ±1 vectors matched to them by a Hungarian assignment
  (``ops/hungarian.py``, solved on the host). The vectors are cmh_tpu's,
  ``bernoulli(fold_in(PRNGKey(noise_seed), step), 0.5)``: a resumed run
  draws the same noise.

The proxies are trained by plain SGD at ``optimizer.loss.lr``.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.hungarian import assign_noise, rand_unit_rect
from ..registry import registry
from ..utils import prng
from . import convert, flax_init
from .base import Method, resolve_clip_cfg
from .clip.model import CLIP, CLIPConfig
from .common import LinearHash
from .losses import l2_normalize

PRE_CLASSES = 80


class PreLayer(nn.Module):
    def __init__(self, width: int, classes: int):
        super().__init__()
        self.fc = nn.Linear(width, classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x)


class DNPHModel(nn.Module):
    def __init__(self, clip_cfg: CLIPConfig, output_dim: int = 16, numclass: int = 80,
                 dropout: float = 0.2):
        super().__init__()
        self.output_dim = output_dim
        self.backbone = CLIP(clip_cfg)
        width = clip_cfg.embed_dim
        self.hash = nn.ModuleDict({"image_hash": LinearHash(width, output_dim, dropout),
                                   "text_hash": LinearHash(width, output_dim, dropout),
                                   "image_pre": PreLayer(width, PRE_CLASSES),
                                   "text_pre": PreLayer(width, PRE_CLASSES)})
        self.loss = nn.ParameterDict({"proxies": nn.Parameter(torch.empty(numclass, output_dim))})

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        cls_token, _, _ = self.backbone.encode_image(image)
        return self.hash.image_hash(cls_token)

    def encode_text(self, text: torch.Tensor, key_padding_mask=None) -> torch.Tensor:
        eos_token, _, _, _ = self.backbone.encode_text(text, key_padding_mask)
        return self.hash.text_hash(eos_token)

    def forward(self, image, text, key_padding_mask=None):
        cls_token = self.backbone.encode_image(image)[0].float()
        eos_token = self.backbone.encode_text(text, key_padding_mask)[0].float()
        return (self.hash.image_hash(cls_token), self.hash.text_hash(eos_token),
                self.hash.image_pre(cls_token), self.hash.text_pre(eos_token),
                self.loss.proxies)

    def init_weights(self, key, device=None) -> "DNPHModel":
        """cmh_tpu's init from ``key`` (``models/flax_init.py``)."""
        return flax_init.init_(self, key, "DNPH", device)


def dnph_proxy_loss(img_hash, txt_hash, img_pre, txt_pre, proxies, labels, mrg: float = 1.0):
    """Reference Loss.forward (loss/loss.py:12-29) and the two
    cross-entropies of the class heads."""
    feats = l2_normalize(torch.cat([img_hash, txt_hash], dim=0))
    label_all = torch.cat([labels, labels], dim=0)
    diff = feats[:, None, :] - l2_normalize(proxies)[None, :, :]
    d = (diff * diff).sum(-1) + mrg * (label_all == 1).float()
    p_loss = torch.mean(torch.sum(-label_all * F.log_softmax(-d, dim=1), dim=-1))
    target = torch.argmax(labels, dim=-1)
    return p_loss + F.cross_entropy(img_pre, target) + F.cross_entropy(txt_pre, target)


def noise_vectors(noise_seed: int, step: int, b: int, k: int, device) -> torch.Tensor:
    """The step's (b, k) ±1 vectors from ``fold_in(PRNGKey(noise_seed), step)``
    (cmh_tpu ``models/dnph.py:129``), drawn on ``device``."""
    return rand_unit_rect(prng.fold_in(prng.PRNGKey(noise_seed), step), b, k, device)


def dnph_loss_fn(*, mrg: float, noise_alpha: float, noise_seed: int):
    def loss(outputs, batch, method_state, step):
        img_hash, txt_hash, img_pre, txt_pre, proxies = outputs
        loss1 = dnph_proxy_loss(img_hash, txt_hash, img_pre, txt_pre, proxies,
                                batch["label"], mrg=mrg)
        b, k = img_hash.shape
        s_vector = noise_vectors(noise_seed, int(step), b, k, img_hash.device)
        # the assignment sees detached codes; the gradient flows through the products
        i_noise_loss = torch.mean(torch.sum(img_hash * assign_noise(img_hash, s_vector), -1))
        t_noise_loss = torch.mean(torch.sum(txt_hash * assign_noise(txt_hash, s_vector), -1))
        total = loss1 - noise_alpha * (i_noise_loss + t_noise_loss)
        loss_dict = {"All loss": total,
                     "Noise": {"image": i_noise_loss, "text": t_noise_loss}}
        return total, loss_dict, method_state

    return loss


@registry.register_model("DNPH")
class DNPHMethod(Method):
    arch = "DNPH"
    code_mode = "sign"

    def state_from_jax(self, params, model_state):
        return convert.dnph_state_from_jax(params)

    def state_to_jax(self, state_dict):
        return convert.dnph_state_to_jax(state_dict)

    def extra_param_groups(self, cfg_optimizer) -> List[dict]:
        """The proxies on plain SGD at ``optimizer.loss.lr`` (cmh_tpu
        ``runners/dnph.py:22-25``)."""
        loss_cfg = cfg_optimizer.get("loss", None) or {}
        return [{"name": "proxies", "params": [self.model.loss.proxies],
                 "lr": loss_cfg.get("lr", 0.0001)}]

    @classmethod
    def from_config(cls, cfg_model, output_dim: int = 16, train_num: int = 10000,
                    clip_cfg: Optional[CLIPConfig] = None) -> "DNPHMethod":
        m = cfg_model or {}
        numclass = m.get("numclass", 80)
        # the class heads stay at 80 classes (reference DNPH.py:27): a larger
        # numclass has targets past their width, which must fail loudly
        if numclass > PRE_CLASSES:
            raise ValueError(
                f"DNPH numclass={numclass} exceeds the reference's fixed "
                f"pre_classes={PRE_CLASSES} head width (the reference crashes in "
                "F.cross_entropy here)")
        model = DNPHModel(resolve_clip_cfg(m, clip_cfg), output_dim=output_dim,
                          numclass=numclass, dropout=m.get("dropout", 0.2))
        loss = dnph_loss_fn(mrg=m.get("mrg", 1.0), noise_alpha=m.get("noise_alpha", 1.0),
                            noise_seed=m.get("noise_seed", 0))
        return cls(model, loss, cfg_model, train_num)
