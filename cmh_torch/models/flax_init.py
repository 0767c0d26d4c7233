"""cmh_tpu's parameter init from a key, without flax.

cmh_tpu initialises a method with ``module.init(init_key, ...)``: flax gives
each parameter the key ``flax_key(init_key, *scope_path, n)``, where n is the
order of that ``self.param`` call in its scope (``nn.Dense``: kernel 1, bias
2), and draws it with the initializer the module names. ``init_(model, key,
arch)`` does the same for a port model: the flax tree of its parameters
comes from ``models/convert.py`` (``*_state_to_jax`` of the model's own state
dict, which gives every leaf's path and shape in flax's layout), each leaf
is drawn from its key by the rule below that matches its path, and the tree
goes back through ``*_state_from_jax`` (Dense kernels transposed, the packed
QKV, ...). So the names live in ``convert.py`` alone; this module adds the
counters and initializers.

Uniform, zero, one and constant leaves equal cmh_tpu's bit for bit; normal
and truncated-normal leaves agree to a few float32 ulps (``utils/prng.erfinv``).
On a CUDA ``device`` the bits come from the ``threefry_bits`` kernel.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..utils import prng
from . import convert

# (path regex, make_rng count or None for the leaf's usual one, initializer
# factory of (shape, the leaf's scope dict))
Rule = Tuple[str, Optional[int], Callable[[Sequence[int], Dict[str, Any]], Callable]]

# a leaf's count in its scope: the order of cmh_tpu's ``self.param`` calls
COUNTERS = {"kernel": 1, "bias": 2, "scale": 1, "embedding": 1, "in_proj_kernel": 1,
            "in_proj_bias": 2, "out_proj_kernel": 3, "out_proj_bias": 4, "phi": 1,
            "expert_kernel": 2, "expert_bias": 3, "proxies": 1, "slots": 1}
DEFAULTS = {"kernel": prng.lecun_normal, "bias": prng.zeros, "scale": prng.ones,
            "in_proj_bias": prng.zeros, "out_proj_bias": prng.zeros}


def _normal(std_of_shape):
    return lambda s, _: prng.normal_init(std_of_shape(s))


def _uniform(bound_of):
    return lambda s, scope: prng.uniform_init(bound_of(s, scope))


def _kaiming_fan_out(s, _):
    """``ops/hashing.py:kaiming_uniform_fan_out``: ±√2·√(3 / fan_out)."""
    return prng.uniform_init(math.sqrt(2.0) * math.sqrt(3.0 / s[-1]))


# CLIP (``cmh_tpu/models/clip/model.py``): normal(width^-½) attention and
# vision embeddings, lecun-normal Dense and patch kernels (the defaults)
CLIP_RULES: List[Rule] = [
    (r"visual/class_embedding$", 1, _normal(lambda s: s[0] ** -0.5)),
    (r"visual/positional_embedding$", 2, _normal(lambda s: s[1] ** -0.5)),
    (r"visual/proj$", 3, _normal(lambda s: s[0] ** -0.5)),
    (r"(^|/)attn/(in|out)_proj_kernel$", None, _normal(lambda s: s[0] ** -0.5)),
    (r"token_embedding/embedding$", None, _normal(lambda s: 0.02)),
    (r"^(backbone/)?positional_embedding$", 1, _normal(lambda s: 0.01)),
    (r"^(backbone/)?text_projection$", 2, _normal(lambda s: s[0] ** -0.5)),
    (r"^(backbone/)?logit_scale$", 3, lambda s, _: prng.constant(math.log(1.0 / 0.07))),
]

# each method's head (``cmh_tpu/models/<method>.py``)
HEAD_RULES: Dict[str, List[Rule]] = {
    "DCMHT": [(r"^hash_(img|txt)/atten/(in|out)_proj_kernel$", None,
               lambda s, _: prng.xavier_uniform),
              (r"^hash_(img|txt)/fc2/kernel$", None, _kaiming_fan_out)],
    "Baseline": [(r"^hash_(img|txt)/fc[12]/kernel$", None, _kaiming_fan_out)],
    # torch_default_dense: kernel and bias ±1/√in (common.py:57)
    "DSPH": [(r"^hash_(img|txt)/fc/(kernel|bias)$", None,
              _uniform(lambda s, scope: 1.0 / (scope["kernel"].shape[0] ** 0.5))),
             (r"^proxies$", None, lambda s, _: lambda key, shape, device=None: (
                 prng.normal(key, shape, device) * (2.0 / shape[0]) ** 0.5))],
    "DNPH": [(r"^(hash_(img|txt)/fc|pre_(img|txt))/kernel$", None, _kaiming_fan_out),
             (r"^proxies$", None, lambda s, _: lambda key, shape, device=None: (
                 prng.normal(key, shape, device) / 8.0))],
    "MITH": [(r"^lct_[it]/hashing/(kernel|bias)$", None,
              _uniform(lambda s, scope: 1.0 / math.sqrt(scope["kernel"].shape[1])))],
    "DIMCH": [(r"^hash_(img|txt)/fc[12]/kernel$", None, _kaiming_fan_out),
              (r"^hash_(img|txt)/token_layer/kernel$", None,
               _normal(lambda s: (2.0 / math.prod(s[:-1])) ** 0.5))],
    # torch_init attention (clip/model.py:158-166) and _kaiming_a5 (umoed.py:62)
    "UMoED": [(r"/(self_attn|cross_attn)/in_proj_kernel$", None,
               _uniform(lambda s, _: (6.0 / (s[0] + 3 * s[0])) ** 0.5)),
              (r"/(self_attn|cross_attn)/out_proj_kernel$", None,
               _uniform(lambda s, _: (1.0 / s[0]) ** 0.5)),
              (r"(^|/)(phi|expert_kernel)$", None,
               _uniform(lambda s, _: 1.0 / math.sqrt(s[1] * s[2]))),
              (r"(^|/)expert_bias$", None, _uniform(lambda s, scope: 1.0 / math.sqrt(
                  scope["expert_kernel"].shape[1] * scope["expert_kernel"].shape[2]))),
              (r"(^|/)slots$", None, _normal(lambda s: 1.0))],
}
HEAD_RULES["TwDH"] = HEAD_RULES["DCMHT"]


def _dcmht_from(params, model_state):
    return convert.dcmht_state_from_jax(params, model_state["batch_stats"])


# arch → (state dict → (params, model_state), (params, model_state) → state dict)
CONVERTERS = {
    "DCMHT": (convert.dcmht_state_to_jax, _dcmht_from),
    "TwDH": (convert.twdh_state_to_jax, _dcmht_from),
    "Baseline": (convert.baseline_state_to_jax, lambda p, _: convert.baseline_state_from_jax(p)),
    "DSPH": (convert.dsph_state_to_jax, lambda p, _: convert.dsph_state_from_jax(p)),
    "DNPH": (convert.dnph_state_to_jax, lambda p, _: convert.dnph_state_from_jax(p)),
    "MITH": (convert.mith_state_to_jax, lambda p, _: convert.mith_state_from_jax(p)),
    "DIMCH": (convert.dimch_state_to_jax, lambda p, _: convert.dimch_state_from_jax(p)),
    "UMoED": (convert.umoed_state_to_jax, lambda p, _: convert.umoed_state_from_jax(p)),
}


def _rule(rules: List[Rule], path: Tuple[str, ...], shape, scope) -> Tuple[int, Callable]:
    joined, leaf = "/".join(path), path[-1]
    for pattern, counter, factory in rules:
        if re.search(pattern, joined):
            return counter or COUNTERS[leaf], factory(shape, scope)
    if leaf not in DEFAULTS:
        raise KeyError(f"no init rule for cmh_tpu's parameter {joined}")
    return COUNTERS[leaf], DEFAULTS[leaf]


def draw(key: prng.Key, tree: Dict[str, Any], rules: List[Rule], device=None,
         path: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """Every leaf of ``tree`` (a nested dict of arrays in flax's layout; only
    their shapes are read) drawn as cmh_tpu's ``init`` draws it under
    ``key``, as float32 CPU tensors."""
    out = {}
    for name, v in tree.items():
        p = path + (name,)
        if isinstance(v, dict):
            out[name] = draw(key, v, rules, device, p)
            continue
        shape = tuple(v.shape)
        counter, init = _rule(rules, p, shape, tree)
        out[name] = init(prng.flax_key(key, *p[:-1], counter), shape, device).float().cpu()
    return out


@torch.no_grad()
def init_(model: torch.nn.Module, key: prng.Key, arch: str, device=None) -> torch.nn.Module:
    """``model`` (a method's whole model, not sharded) set to cmh_tpu's
    ``init_variables(key, ...)``; BatchNorm statistics stay at 0 and 1."""
    to_jax, from_jax = CONVERTERS[arch]
    params, model_state = to_jax(model.state_dict())
    drawn = draw(key, params, CLIP_RULES + HEAD_RULES[arch], device)
    model.load_state_dict(from_jax(drawn, model_state), strict=True)
    return model


@torch.no_grad()
def init_clip_(clip: torch.nn.Module, key: prng.Key, device=None) -> torch.nn.Module:
    """A bare CLIP set to cmh_tpu's ``CLIP(cfg).init(key, ...)``
    (``clip/loader.py:187``): the same rules at the root scope."""
    sd = {f"backbone.{k}": v for k, v in clip.state_dict().items()}
    drawn = draw(key, convert.clip_state_to_jax(sd), CLIP_RULES, device)
    clip.load_state_dict({k[len("backbone."):]: v
                          for k, v in convert.clip_state_from_jax(drawn).items()}, strict=True)
    return clip
