"""Carry cmh_tpu method weights into the port.

``dcmht_state_from_jax(params, batch_stats)``, ``baseline_state_from_jax``,
``dsph_state_from_jax``, ``dnph_state_from_jax``, ``mith_state_from_jax``,
``twdh_state_from_jax``, ``dimch_state_from_jax`` and
``umoed_state_from_jax`` (``params``, and TwDH's ``batch_stats``) turn
cmh_tpu's flax trees (nested dicts of numpy arrays, as ``utils/flax_msgpack``
reads them from a ``model-N.msgpack``) into the port's ``state_dict``, which
uses the reference torch names. Each is the exact inverse of its cmh_tpu
``models/torch_import.py:*_from_torch_state`` (and, for the backbone,
``models/clip/loader.py:params_from_state_dict``): flax Dense kernels (in,
out) become torch weights (out, in), the patch kernel HWIO becomes (out, in,
kh, kw), DIMCH's Conv kernel (k, in, out) becomes (out, in, k), and
LayerNorm/BatchNorm scale becomes ``weight``.

``dcmht_state_to_jax`` (= ``twdh_state_to_jax``), ``baseline_state_to_jax``,
``dsph_state_to_jax``, ``dnph_state_to_jax``, ``mith_state_to_jax``,
``dimch_state_to_jax`` and ``umoed_state_to_jax`` go the other way, for the
writer of cmh_tpu's full-state checkpoints (``runners/jax_checkpoint.py``),
the tests and ``chip_smoke.py``, which write cmh_tpu's file layout from the
port's weights on a machine without flax. Every converter only moves,
transposes and renames leaves, so the same functions carry any tree of the
parameters' layout: the optimizer's moments too.

``resnet_state_from_jax`` and ``resnet_state_to_jax`` carry cmh_tpu's
``ModifiedResNet`` variables (``{'params', 'batch_stats'}``, conv kernels
HWIO) to and from the port's ``models/clip/resnet.py`` state dict (OIHW,
BatchNorm ``running_mean``/``running_var``), as cmh_tpu's
``resnet_variables_from_state_dict`` names them.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    if torch.is_tensor(a):          # a bfloat16 array of flax_msgpack
        return a.detach().float().clone()
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _linear(p: Dict[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(np.asarray(p["kernel"]).T),
            f"{prefix}.bias": _t(p["bias"])}


def _norm(p: Dict[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(p["scale"]), f"{prefix}.bias": _t(p["bias"])}


def _attention(p: Dict[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    return {
        f"{prefix}.in_proj_weight": _t(np.asarray(p["in_proj_kernel"]).T),
        f"{prefix}.in_proj_bias": _t(p["in_proj_bias"]),
        f"{prefix}.out_proj.weight": _t(np.asarray(p["out_proj_kernel"]).T),
        f"{prefix}.out_proj.bias": _t(p["out_proj_bias"]),
    }


def _tower(p: Dict[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    layers = sorted(int(k.split("_")[1]) for k in p if k.startswith("resblocks_"))
    for i in layers:
        blk, pre = p[f"resblocks_{i}"], f"{prefix}.resblocks.{i}"
        sd.update(_attention(blk["attn"], f"{pre}.attn"))
        sd.update(_norm(blk["ln_1"]["ln"], f"{pre}.ln_1"))
        sd.update(_norm(blk["ln_2"]["ln"], f"{pre}.ln_2"))
        sd.update(_linear(blk["c_fc"], f"{pre}.mlp.c_fc"))
        sd.update(_linear(blk["c_proj"], f"{pre}.mlp.c_proj"))
    return sd


def clip_state_from_jax(p: Dict[str, Any], prefix: str = "backbone"
                        ) -> Dict[str, torch.Tensor]:
    """cmh_tpu CLIP param tree → torch CLIP state-dict entries."""
    v = p["visual"]
    sd = {
        # flax HWIO (kh, kw, in, out) → torch (out, in, kh, kw)
        f"{prefix}.visual.conv1.weight": _t(
            np.asarray(v["conv1"]["kernel"]).transpose(3, 2, 0, 1)),
        f"{prefix}.visual.class_embedding": _t(v["class_embedding"]),
        f"{prefix}.visual.positional_embedding": _t(v["positional_embedding"]),
        f"{prefix}.visual.proj": _t(v["proj"]),
        f"{prefix}.token_embedding.weight": _t(p["token_embedding"]["embedding"]),
        f"{prefix}.positional_embedding": _t(p["positional_embedding"]),
        f"{prefix}.text_projection": _t(p["text_projection"]),
        f"{prefix}.logit_scale": _t(p["logit_scale"]),
    }
    sd.update(_norm(v["ln_pre"]["ln"], f"{prefix}.visual.ln_pre"))
    sd.update(_norm(v["ln_post"]["ln"], f"{prefix}.visual.ln_post"))
    sd.update(_norm(p["ln_final"]["ln"], f"{prefix}.ln_final"))
    sd.update(_tower(v["transformer"], f"{prefix}.visual.transformer"))
    sd.update(_tower(p["transformer"], f"{prefix}.transformer"))
    return sd


def dcmht_state_from_jax(params: Dict[str, Any], batch_stats: Dict[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """cmh_tpu DCMHT ``params`` and its ``batch_stats`` collection → the
    port's ``DCMHTModel`` state_dict (fp32 CPU tensors)."""
    sd = clip_state_from_jax(params["backbone"])
    img, txt = params["hash_img"], params["hash_txt"]
    sd.update(_attention(img["atten"], "hash.img_hash.atten"))
    sd.update(_norm(img["norm"]["bn"], "hash.img_hash.norm"))
    stats = batch_stats["hash_img"]["norm"]["bn"]
    sd["hash.img_hash.norm.running_mean"] = _t(stats["mean"])
    sd["hash.img_hash.norm.running_var"] = _t(stats["var"])
    sd.update(_linear(img["fc2"], "hash.img_hash.fc2"))
    sd.update(_attention(txt["atten"], "hash.txt_hash.atten"))
    sd.update(_norm(txt["norm"], "hash.txt_hash.norm"))
    sd.update(_linear(txt["fc2"], "hash.txt_hash.fc2"))
    return sd


def baseline_state_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """cmh_tpu Baseline ``params`` → the port's ``BaselineModel`` state_dict
    (inverse of ``baseline_from_torch_state``)."""
    sd = clip_state_from_jax(params["backbone"])
    for side in ("img", "txt"):
        head = params[f"hash_{side}"]
        sd.update(_linear(head["fc1"], f"hash.{side}_hash.0"))
        sd.update(_linear(head["fc2"], f"hash.{side}_hash.3"))
    return sd


def dsph_state_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """cmh_tpu DSPH ``params`` → the port's ``DSPHModel`` state_dict
    (inverse of ``dsph_from_torch_state``)."""
    sd = clip_state_from_jax(params["backbone"])
    sd.update(_linear(params["hash_img"]["fc"], "hash.img_hash.fc"))
    sd.update(_linear(params["hash_txt"]["fc"], "hash.txt_hash.fc"))
    sd["hyp.proxies"] = _t(params["proxies"])
    return sd


def dnph_state_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """cmh_tpu DNPH ``params`` → the port's ``DNPHModel`` state_dict
    (inverse of ``dnph_from_torch_state``)."""
    sd = clip_state_from_jax(params["backbone"])
    sd.update(_linear(params["hash_img"]["fc"], "hash.image_hash.fc"))
    sd.update(_linear(params["hash_txt"]["fc"], "hash.text_hash.fc"))
    sd.update(_linear(params["pre_img"], "hash.image_pre.fc"))
    sd.update(_linear(params["pre_txt"], "hash.text_pre.fc"))
    sd["loss.proxies"] = _t(params["proxies"])
    return sd


def mith_state_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """cmh_tpu MITH ``params`` → the port's ``MITHModel`` state_dict
    (inverse of ``mith_from_torch_state``). The global concept learner is one
    module under two names, ``hash.gcl_i`` and ``hash.gcl_t``, as in the
    reference; the per-bit heads are K ``Linear(d, 1)`` rows."""
    sd = clip_state_from_jax(params["backbone"])
    gcl = params["gcl"]
    for name in ("gcl_i", "gcl_t"):
        pre = f"hash.{name}"
        mlp = gcl.get("mlp", {})
        for i in sorted(int(k.split("_")[1]) for k in mlp if k.startswith("fc1_")):
            sd.update(_linear(mlp[f"fc1_{i}"], f"{pre}.mlp.mlps.{i}.0"))
            sd.update(_linear(mlp[f"fc2_{i}"], f"{pre}.mlp.mlps.{i}.3"))
            sd.update(_norm(mlp[f"ln_{i}"], f"{pre}.mlp.lns.{i}"))
        sd[f"{pre}.common_concept_embedding.weight"] = _t(np.asarray(gcl["concept"]["kernel"]).T)
    for side in ("lct_i", "lct_t"):
        lct = params[side]
        sd.update(_tower(lct["transformer"], f"hash.{side}.transformer"))
        kernel, bias = np.asarray(lct["hashing"]["kernel"]), np.asarray(lct["hashing"]["bias"])
        for k in range(kernel.shape[0]):
            sd[f"hash.{side}.hashing.fc_list.{k}.weight"] = _t(kernel[k:k + 1])
            sd[f"hash.{side}.hashing.fc_list.{k}.bias"] = _t(bias[k:k + 1])
    sd.update(_linear(params["img_concept_proj"], "hash.img_concept_proj"))
    sd.update(_linear(params["txt_concept_proj"], "hash.txt_concept_proj"))
    return sd


# TwDH's model is DCMHT's heads at long_dim (cmh_tpu torch_import.py:348)
twdh_state_from_jax = dcmht_state_from_jax


def dimch_state_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """cmh_tpu DIMCH ``params`` → the port's ``DIMCHModel`` state_dict
    (inverse of ``dimch_from_torch_state``)."""
    sd = clip_state_from_jax(params["backbone"])
    for side in ("img", "txt"):
        head, pre = params[f"hash_{side}"], f"hash.{side}_token_hash"
        sd[f"{pre}.token_layer.weight"] = _t(
            np.asarray(head["token_layer"]["kernel"]).transpose(2, 1, 0))
        sd[f"{pre}.token_layer.bias"] = _t(head["token_layer"]["bias"])
        sd.update(_linear(head["fc1"], f"{pre}.hash_layer.0"))
        sd.update(_linear(head["fc2"], f"{pre}.hash_layer.3"))
    return sd


def _umoed_head(head: Dict[str, Any], pre: str) -> Dict[str, torch.Tensor]:
    """One UMoED token hash: slots, the decoder layers (Soft-MoE ones name
    their first FFN linear ``linear``, plain ones ``linear1``, as the
    reference; cmh_tpu calls both ``linear1``), the classifier."""
    sd = {f"{pre}.decoder_learned_parameters": _t(head["slots"])}
    sd.update(_linear(head["classifier"], f"{pre}.classifier"))
    if "first_layer" in head:
        sd.update(_linear(head["first_layer"], f"{pre}.first_layer"))
    for i in sorted(int(k.split("_")[1]) for k in head if k.startswith("layer_")):
        layer, lp = head[f"layer_{i}"], f"{pre}.decoder.layers.{i}"
        sd.update(_attention(layer["self_attn"], f"{lp}.self_attn"))
        sd.update(_attention(layer["cross_attn"], f"{lp}.multihead_attn"))
        for n in ("norm1", "norm2", "norm3"):
            sd.update(_norm(layer[n]["ln"], f"{lp}.{n}"))
        if "moe" in layer:
            sd.update(_linear(layer["linear1"], f"{lp}.linear"))
            sd[f"{lp}.moe.phi"] = _t(layer["moe"]["phi"])
            sd[f"{lp}.moe.experts.weight"] = _t(layer["moe"]["expert_kernel"])
            sd[f"{lp}.moe.experts.bias"] = _t(layer["moe"]["expert_bias"])
        else:
            sd.update(_linear(layer["linear1"], f"{lp}.linear1"))
            sd.update(_linear(layer["linear2"], f"{lp}.linear2"))
    return sd


def umoed_state_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """cmh_tpu UMoED ``params`` → the port's ``UMoEDModel`` state_dict
    (inverse of ``umoed_from_torch_state``): one shared head under fusion,
    else the image and the text heads."""
    sd = clip_state_from_jax(params["backbone"])
    if "hash_module" in params:
        sd.update(_umoed_head(params["hash_module"], "hash.hash_module"))
    else:
        sd.update(_umoed_head(params["hash_img"], "hash.img_token_hash"))
        sd.update(_umoed_head(params["hash_txt"], "hash.txt_token_hash"))
    return sd


def _a(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().float().numpy().copy()


def _linear_to(sd, prefix: str) -> Dict[str, np.ndarray]:
    return {"kernel": _a(sd[f"{prefix}.weight"]).T.copy(), "bias": _a(sd[f"{prefix}.bias"])}


def _norm_to(sd, prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _a(sd[f"{prefix}.weight"]), "bias": _a(sd[f"{prefix}.bias"])}


def _attention_to(sd, prefix: str) -> Dict[str, np.ndarray]:
    return {"in_proj_kernel": _a(sd[f"{prefix}.in_proj_weight"]).T.copy(),
            "in_proj_bias": _a(sd[f"{prefix}.in_proj_bias"]),
            "out_proj_kernel": _a(sd[f"{prefix}.out_proj.weight"]).T.copy(),
            "out_proj_bias": _a(sd[f"{prefix}.out_proj.bias"])}


def _tower_to(sd, prefix: str) -> Dict[str, Any]:
    layers = sorted({int(k[len(prefix) + 11:].split(".")[0]) for k in sd
                     if k.startswith(f"{prefix}.resblocks.")})
    return {f"resblocks_{i}": {
        "attn": _attention_to(sd, f"{prefix}.resblocks.{i}.attn"),
        "ln_1": {"ln": _norm_to(sd, f"{prefix}.resblocks.{i}.ln_1")},
        "ln_2": {"ln": _norm_to(sd, f"{prefix}.resblocks.{i}.ln_2")},
        "c_fc": _linear_to(sd, f"{prefix}.resblocks.{i}.mlp.c_fc"),
        "c_proj": _linear_to(sd, f"{prefix}.resblocks.{i}.mlp.c_proj")} for i in layers}


def clip_state_to_jax(sd: Dict[str, torch.Tensor], prefix: str = "backbone") -> Dict[str, Any]:
    """The inverse of ``clip_state_from_jax``."""
    v = f"{prefix}.visual"
    return {
        "visual": {
            "conv1": {"kernel": _a(sd[f"{v}.conv1.weight"]).transpose(2, 3, 1, 0).copy()},
            "class_embedding": _a(sd[f"{v}.class_embedding"]),
            "positional_embedding": _a(sd[f"{v}.positional_embedding"]),
            "proj": _a(sd[f"{v}.proj"]),
            "ln_pre": {"ln": _norm_to(sd, f"{v}.ln_pre")},
            "ln_post": {"ln": _norm_to(sd, f"{v}.ln_post")},
            "transformer": _tower_to(sd, f"{v}.transformer"),
        },
        "token_embedding": {"embedding": _a(sd[f"{prefix}.token_embedding.weight"])},
        "positional_embedding": _a(sd[f"{prefix}.positional_embedding"]),
        "text_projection": _a(sd[f"{prefix}.text_projection"]),
        "logit_scale": _a(sd[f"{prefix}.logit_scale"]),
        "ln_final": {"ln": _norm_to(sd, f"{prefix}.ln_final")},
        "transformer": _tower_to(sd, f"{prefix}.transformer"),
    }


def dcmht_state_to_jax(sd: Dict[str, torch.Tensor]):
    """The port's DCMHT (or TwDH) ``state_dict`` → cmh_tpu's ``(params,
    model_state)``, the tree ``save_model`` writes: the inverse of
    ``dcmht_state_from_jax``."""
    params = {"backbone": clip_state_to_jax(sd)}
    for side in ("img", "txt"):
        pre = f"hash.{side}_hash"
        head = {"atten": _attention_to(sd, f"{pre}.atten"),
                "fc2": _linear_to(sd, f"{pre}.fc2")}
        head["norm"] = ({"bn": _norm_to(sd, f"{pre}.norm")} if side == "img"
                        else _norm_to(sd, f"{pre}.norm"))
        params[f"hash_{side}"] = head
    stats = {"mean": _a(sd["hash.img_hash.norm.running_mean"]),
             "var": _a(sd["hash.img_hash.norm.running_var"])}
    return params, {"batch_stats": {"hash_img": {"norm": {"bn": stats}}}}


twdh_state_to_jax = dcmht_state_to_jax


def baseline_state_to_jax(sd: Dict[str, torch.Tensor]):
    """The port's Baseline ``state_dict`` → cmh_tpu's ``(params,
    model_state)``: the inverse of ``baseline_state_from_jax``."""
    params = {"backbone": clip_state_to_jax(sd)}
    for side in ("img", "txt"):
        params[f"hash_{side}"] = {"fc1": _linear_to(sd, f"hash.{side}_hash.0"),
                                  "fc2": _linear_to(sd, f"hash.{side}_hash.3")}
    return params, {}


def dsph_state_to_jax(sd: Dict[str, torch.Tensor]):
    """The inverse of ``dsph_state_from_jax``."""
    return {"proxies": _a(sd["hyp.proxies"]), "backbone": clip_state_to_jax(sd),
            "hash_img": {"fc": _linear_to(sd, "hash.img_hash.fc")},
            "hash_txt": {"fc": _linear_to(sd, "hash.txt_hash.fc")}}, {}


def dnph_state_to_jax(sd: Dict[str, torch.Tensor]):
    """The inverse of ``dnph_state_from_jax``."""
    return {"proxies": _a(sd["loss.proxies"]), "backbone": clip_state_to_jax(sd),
            "hash_img": {"fc": _linear_to(sd, "hash.image_hash.fc")},
            "hash_txt": {"fc": _linear_to(sd, "hash.text_hash.fc")},
            "pre_img": _linear_to(sd, "hash.image_pre.fc"),
            "pre_txt": _linear_to(sd, "hash.text_pre.fc")}, {}


def mith_state_to_jax(sd: Dict[str, torch.Tensor]):
    """The inverse of ``mith_state_from_jax``: the concept learner is read
    from ``hash.gcl_i`` (``hash.gcl_t`` is the same module), the per-bit
    rows are stacked back into one (K, d) kernel."""
    pre = "hash.gcl_i"
    mlp = {}
    for i in sorted({int(k[len(pre) + 10:].split(".")[0]) for k in sd
                     if k.startswith(f"{pre}.mlp.mlps.")}):
        mlp[f"fc1_{i}"] = _linear_to(sd, f"{pre}.mlp.mlps.{i}.0")
        mlp[f"fc2_{i}"] = _linear_to(sd, f"{pre}.mlp.mlps.{i}.3")
        mlp[f"ln_{i}"] = _norm_to(sd, f"{pre}.mlp.lns.{i}")
    params = {"backbone": clip_state_to_jax(sd),
              "gcl": {"mlp": mlp, "concept": {
                  "kernel": _a(sd[f"{pre}.common_concept_embedding.weight"]).T.copy()}}}
    for side in ("lct_i", "lct_t"):
        h = f"hash.{side}.hashing.fc_list"
        bits = len({k for k in sd if k.startswith(f"{h}.") and k.endswith(".weight")})
        params[side] = {
            "transformer": _tower_to(sd, f"hash.{side}.transformer"),
            "hashing": {"kernel": np.concatenate([_a(sd[f"{h}.{k}.weight"]) for k in range(bits)]),
                        "bias": np.concatenate([_a(sd[f"{h}.{k}.bias"]) for k in range(bits)])}}
    params["img_concept_proj"] = _linear_to(sd, "hash.img_concept_proj")
    params["txt_concept_proj"] = _linear_to(sd, "hash.txt_concept_proj")
    return params, {}


def dimch_state_to_jax(sd: Dict[str, torch.Tensor]):
    """The port's DIMCH ``state_dict`` → cmh_tpu's ``(params, model_state)``."""
    params = {"backbone": clip_state_to_jax(sd)}
    for side in ("img", "txt"):
        pre = f"hash.{side}_token_hash"
        params[f"hash_{side}"] = {
            "token_layer": {"kernel": _a(sd[f"{pre}.token_layer.weight"]).transpose(2, 1, 0).copy(),
                            "bias": _a(sd[f"{pre}.token_layer.bias"])},
            "fc1": _linear_to(sd, f"{pre}.hash_layer.0"),
            "fc2": _linear_to(sd, f"{pre}.hash_layer.3")}
    return params, {}


def _umoed_head_to(sd, pre: str) -> Dict[str, Any]:
    head = {"slots": _a(sd[f"{pre}.decoder_learned_parameters"]),
            "classifier": _linear_to(sd, f"{pre}.classifier")}
    if f"{pre}.first_layer.weight" in sd:
        head["first_layer"] = _linear_to(sd, f"{pre}.first_layer")
    layers = sorted({int(k[len(pre) + 16:].split(".")[0]) for k in sd
                     if k.startswith(f"{pre}.decoder.layers.")})
    for i in layers:
        lp = f"{pre}.decoder.layers.{i}"
        layer = {"self_attn": _attention_to(sd, f"{lp}.self_attn"),
                 "cross_attn": _attention_to(sd, f"{lp}.multihead_attn"),
                 **{n: {"ln": _norm_to(sd, f"{lp}.{n}")} for n in ("norm1", "norm2", "norm3")}}
        if f"{lp}.moe.phi" in sd:
            layer["linear1"] = _linear_to(sd, f"{lp}.linear")
            layer["moe"] = {"phi": _a(sd[f"{lp}.moe.phi"]),
                            "expert_kernel": _a(sd[f"{lp}.moe.experts.weight"]),
                            "expert_bias": _a(sd[f"{lp}.moe.experts.bias"])}
        else:
            layer["linear1"] = _linear_to(sd, f"{lp}.linear1")
            layer["linear2"] = _linear_to(sd, f"{lp}.linear2")
        head[f"layer_{i}"] = layer
    return head


def umoed_state_to_jax(sd: Dict[str, torch.Tensor]):
    """The port's UMoED ``state_dict`` → cmh_tpu's ``(params, model_state)``."""
    params = {"backbone": clip_state_to_jax(sd)}
    if "hash.hash_module.decoder_learned_parameters" in sd:
        params["hash_module"] = _umoed_head_to(sd, "hash.hash_module")
    else:
        params["hash_img"] = _umoed_head_to(sd, "hash.img_token_hash")
        params["hash_txt"] = _umoed_head_to(sd, "hash.txt_token_hash")
    return params, {}


# ---------------------------------------------------------------- dropout sites
_UMOED_HEADS = {"hash_module": "hash_module", "img_token_hash": "hash_img",
                "txt_token_hash": "hash_txt"}

# the port's module name → the site's scope path in cmh_tpu's module tree,
# which flax hashes into the mask key (``models/common.Dropout``). Only sites
# that can be active are listed: CLIP's towers and MITH's concept
# transformers drop nothing.
DROPOUT_SITES = (
    (r"hash\.(img|txt)_hash\.2", lambda m: ("hash_" + m[1], "drop")),             # Baseline
    (r"hash\.(img|txt)_hash\.drop", lambda m: ("hash_" + m[1], "drop")),          # DSPH
    (r"hash\.(image|text)_hash\.drop",                                            # DNPH
     lambda m: ("hash_" + {"image": "img", "text": "txt"}[m[1]], "drop")),
    (r"hash\.(img|txt)_token_hash\.hash_layer\.2", lambda m: ("hash_" + m[1], "drop")),  # DIMCH
    (r"hash\.gcl_[it]\.mlp\.mlps\.(\d+)\.2", lambda m: ("gcl", "mlp", f"drop_{m[1]}")),  # MITH
    (r"hash\.(lct_[it])\.pe_drop", lambda m: (m[1], "pe_drop")),
    (r"hash\.(\w+)\.decoder\.layers\.(\d+)\.(self_attn|multihead_attn)\.attn_drop",  # UMoED
     lambda m: (_UMOED_HEADS[m[1]], f"layer_{m[2]}",
                "cross_attn" if m[3] == "multihead_attn" else "self_attn", "attn_drop")),
    (r"hash\.(\w+)\.decoder\.layers\.(\d+)\.(drop1|drop2|drop3|drop_ff)",
     lambda m: (_UMOED_HEADS[m[1]], f"layer_{m[2]}", m[3])),
)


def name_dropouts(model: torch.nn.Module) -> None:
    """Give each of ``model``'s dropout sites its cmh_tpu scope path
    (``Dropout.path``) from ``DROPOUT_SITES``."""
    from .common import Dropout

    for name, mod in model.named_modules():
        if not isinstance(mod, Dropout):
            continue
        for pattern, path in DROPOUT_SITES:
            m = re.fullmatch(pattern, name)
            if m:
                mod.path = path(m)
                break


# ---------------------------------------------------------------- ResNet tower
_RESNET_BLOCK = (("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3"),
                 ("downsample_conv", "downsample_bn"))


def _resnet_units(names):
    """(flax conv, flax BatchNorm, torch conv prefix, torch BatchNorm prefix,
    flax block or None) for the stem and every block named in ``names`` (the
    flax ``layer{s}_{i}`` keys)."""
    units = [(f"conv{i}", f"bn{i}", f"conv{i}", f"bn{i}", None) for i in (1, 2, 3)]
    for blk in sorted(n for n in names if n.startswith("layer")):
        pre = "layer" + blk[len("layer"):].replace("_", ".")
        for conv, bn in _RESNET_BLOCK:
            tconv, tbn = ((f"{pre}.downsample.0", f"{pre}.downsample.1") if conv.startswith("down")
                          else (f"{pre}.{conv}", f"{pre}.{bn}"))
            units.append((conv, bn, tconv, tbn, blk))
    return units


def resnet_state_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """cmh_tpu's ``ModifiedResNet`` variables → the port tower's
    ``state_dict``."""
    p, st = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for conv, bn, tconv, tbn, blk in _resnet_units(p):
        pp, ss = (p, st) if blk is None else (p[blk], st[blk])
        if conv not in pp:            # a block without a downsample
            continue
        # flax HWIO (kh, kw, in, out) → torch (out, in, kh, kw)
        sd[f"{tconv}.weight"] = _t(np.asarray(pp[conv]["kernel"]).transpose(3, 2, 0, 1))
        sd.update(_norm(pp[bn], tbn))
        sd[f"{tbn}.running_mean"] = _t(ss[bn]["mean"])
        sd[f"{tbn}.running_var"] = _t(ss[bn]["var"])
    a = p["attnpool"]
    sd["attnpool.positional_embedding"] = _t(a["positional_embedding"])
    for proj in ("q_proj", "k_proj", "v_proj", "c_proj"):
        sd.update(_linear(a[proj], f"attnpool.{proj}"))
    return sd


def resnet_state_to_jax(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of ``resnet_state_from_jax``: the port tower's
    ``state_dict`` → ``{'params', 'batch_stats'}`` numpy trees."""
    blocks = {"{}_{}".format(*k.split(".")[:2]) for k in sd if k.startswith("layer")}
    params: Dict[str, Any] = {b: {} for b in blocks}
    stats: Dict[str, Any] = {b: {} for b in blocks}
    for conv, bn, tconv, tbn, blk in _resnet_units(blocks):
        if f"{tconv}.weight" not in sd:
            continue
        pp, ss = (params, stats) if blk is None else (params[blk], stats[blk])
        pp[conv] = {"kernel": _a(sd[f"{tconv}.weight"]).transpose(2, 3, 1, 0).copy()}
        pp[bn] = _norm_to(sd, tbn)
        ss[bn] = {"mean": _a(sd[f"{tbn}.running_mean"]), "var": _a(sd[f"{tbn}.running_var"])}
    params["attnpool"] = {"positional_embedding": _a(sd["attnpool.positional_embedding"]),
                          **{proj: _linear_to(sd, f"attnpool.{proj}")
                             for proj in ("q_proj", "k_proj", "v_proj", "c_proj")}}
    return {"params": params, "batch_stats": stats}
