"""cmh_tpu's full-state checkpoint, read into a trainer of the port and
written from one (counterpart of ``cmh_tpu/runners/base.py:1069-1167``).

cmh_tpu's ``save_checkpoint`` writes ``flax.serialization.to_bytes({"state":
TrainState._asdict(), "meta": meta})`` beside a ``<file>.meta.json`` sidecar
(``{"epoch", "fingerprint"}``, the same as the port's). The state holds:

- ``params`` and ``model_state`` (the BatchNorm ``batch_stats``): flax trees
  that the method's ``state_from_jax`` / ``state_to_jax`` carry to and from
  the port's ``state_dict``;
- ``opt_state``, one entry per top-level key of ``params``
  (``optim/partition.py``): BertAdam's ``{"step", "m", "v"}`` with ``m`` and
  ``v`` as trees of the parameters' layout (on a mesh) or, with
  ``chunk_leaf``, as one fp32 vector each (off one), every leaf in
  ``jax.tree_util`` order (sorted keys) zero-padded to a multiple of 512
  (``_FlatSpec``, ``cmh_tpu/optim/bert_adam.py:75-117``); and optax's SGD
  state for the keys a method trains apart (DSPH's and DNPH's ``proxies``),
  whose momentum is a ``trace`` of the parameters' layout;
- ``method_state`` (MITH's banks, TwDH's centers and transforms) under the
  port's names, and ``step``.

A moment or a trace is a tree of the parameters' layout, so the weight
converters carry it: each flat vector is unflattened by cmh_tpu's spec,
passed through the same transposes and renames as the weights into a
``state_dict`` of the port's names, and loaded through the model's own
``load_state_dict`` into one tensor per parameter (``_per_parameter``; a
module may keep other tensors than its state dict names, as MITH's per-bit
heads do); ``blob_to_jax`` and ``write`` run the reverse through
``state_dict``. The meta is the port's, key for key.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..optim.bert_adam import moment_list
from ..utils import flax_msgpack
from . import checkpoint

CHUNK = 512   # cmh_tpu/optim/bert_adam.py _CHUNK


def jax_leaves(tree) -> List[Any]:
    """The leaves of a nested dict in ``jax.tree_util`` order (sorted keys)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in jax_leaves(tree[k])]
    return [tree]


def unflatten(flat, like):
    """cmh_tpu's flat BertAdam vector → a tree of ``like``'s layout."""
    flat = np.asarray(flat)
    pos = 0

    def walk(t):
        nonlocal pos
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        shape = tuple(np.shape(t))
        size = int(np.prod(shape))
        out = flat[pos:pos + size].reshape(shape)
        pos += -(-size // CHUNK) * CHUNK
        return out

    tree = walk(like)
    if pos != flat.shape[0]:
        raise ValueError(f"flat optimizer vector of {flat.shape[0]} elements, the "
                         f"parameters' layout needs {pos}")
    return tree


def flatten(tree) -> Tuple[np.ndarray, np.ndarray]:
    """The inverse of ``unflatten``: (the fp32 vector, ``chunk_leaf``)."""
    parts, counts = [], []
    for leaf in jax_leaves(tree):
        a = np.asarray(leaf, np.float32).reshape(-1)
        parts += [a, np.zeros(-a.size % CHUNK, np.float32)]
        counts.append(-(-a.size // CHUNK))
    vec = np.concatenate(parts) if parts else np.zeros(0, np.float32)
    return vec, np.repeat(np.arange(len(counts), dtype=np.int32), counts)


def _is_bert_adam(sub) -> bool:
    return isinstance(sub, dict) and {"step", "m", "v"} <= set(sub)


def _find(tree, key):
    """The value under ``key`` anywhere in a nested dict, or None."""
    if not isinstance(tree, dict):
        return None
    if key in tree:
        return tree[key]
    for v in tree.values():
        found = _find(v, key)
        if found is not None:
            return found
    return None


def _tensors(tree):
    """numpy leaves → torch tensors (copies; bfloat16 ones already are)."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return tree.clone() if torch.is_tensor(tree) else torch.from_numpy(np.array(tree))


def _arrays(tree):
    """torch leaves → numpy arrays on the host (bfloat16 stays a tensor,
    which ``flax_msgpack`` writes as flax does)."""
    if isinstance(tree, dict):
        return {k: _arrays(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy().copy()


@contextlib.contextmanager
def _holding(model: torch.nn.Module, tensors: Dict[int, torch.Tensor]):
    """Inside the block each parameter of ``model`` holds
    ``tensors[id(parameter)]`` (its data swapped, not copied) and the
    buffers are restored afterwards."""
    params = {id(p): p for p in model.parameters()}
    saved = {k: p.data for k, p in params.items()}
    buffers = [(b, b.clone()) for b in model.buffers()]
    try:
        for k, p in params.items():
            p.data = tensors[k]
        yield
    finally:
        for k, p in params.items():
            p.data = saved[k]
        with torch.no_grad():
            for b, kept in buffers:
                b.copy_(kept)


def _per_parameter(model: torch.nn.Module, state_dict: Dict, likes: Dict[int, torch.Tensor]
                   ) -> Dict[int, torch.Tensor]:
    """A ``state_dict`` of ``model``'s names → one tensor per parameter, as
    ``load_state_dict`` would place it, each of the shape of
    ``likes[id(parameter)]`` (the single-process one)."""
    held = {id(p): torch.empty(likes[id(p)].shape, dtype=p.dtype, device=p.device)
            for p in model.parameters()}
    with _holding(model, held):
        model.load_state_dict(state_dict)
    return held


def _state_dict_of(model: torch.nn.Module, tensors: Dict[int, torch.Tensor],
                   likes: Dict[int, torch.Tensor]) -> Dict:
    """The inverse of ``_per_parameter``: the ``state_dict`` the model would
    have if its parameters held ``tensors`` (the others keep theirs, or
    zeros where they hold a shard)."""
    def other(p):
        like = likes[id(p)]
        return p.data if like.shape == p.shape else torch.zeros(like.shape, dtype=p.dtype,
                                                                  device=p.device)

    held = {id(p): tensors[id(p)] if id(p) in tensors else other(p)
            for p in model.parameters()}
    with _holding(model, held):
        return dict(model.state_dict())


def blob_from_jax(tree: Dict, trainer) -> Dict:
    """A decoded cmh_tpu checkpoint → the trainer's ``_state_blob``, in the
    single-process layout (under tensor parallelism too)."""
    if not isinstance(tree, dict) or set(tree) != {"state", "meta"}:
        raise ValueError("not a cmh_tpu full-state checkpoint (no 'state' and 'meta')")
    state, meta = tree["state"], tree["meta"]
    method, model, likes = trainer.method, trainer.model, trainer.whole_likes()
    params, model_state = state["params"], state.get("model_state") or {}
    opt = state["opt_state"]
    apart = {k for k, sub in opt.items() if not _is_bert_adam(sub)}
    if apart != set(trainer.extra_optimizers):
        raise ValueError(f"optimizer partitions outside BertAdam {sorted(apart)} != "
                         f"this trainer's {sorted(trainer.extra_optimizers)}")
    steps = {int(np.asarray(sub["step"])) for k, sub in opt.items() if k not in apart}
    if steps != {int(np.asarray(state["step"]))}:
        raise ValueError(f"BertAdam step counts {sorted(steps)} != the state's "
                         f"{int(np.asarray(state['step']))}")
    # the moments and the SGD traces, each a tree of the parameters' layout
    # (partitions without one keep the parameters as filler)
    slots = {"m": {}, "v": {}, "trace": {}}
    for key, sub in opt.items():
        if key in apart:
            trace = _find(sub, "trace")
            if trace is not None:
                slots["trace"][key] = trace
            continue
        for slot in ("m", "v"):
            slots[slot][key] = (unflatten(sub[slot], params[key]) if "chunk_leaf" in sub
                                else sub[slot])
    by_id = {slot: _per_parameter(model, method.state_from_jax(
                 {k: parts.get(k, params[k]) for k in params}, model_state), likes)
             for slot, parts in slots.items() if parts}
    groups = [{slot: [by_id[slot][id(p)] for p in g["params"]] for slot in ("m", "v")}
              for g in trainer.optimizer.param_groups]
    extra = {}
    for name, sgd in trainer.extra_optimizers.items():
        ps = sgd.param_groups[0]["params"]
        momentum = ({i: {"momentum_buffer": by_id["trace"][id(p)]}
                     for i, p in enumerate(ps)} if name in slots["trace"] else {})
        extra[name] = {"state": momentum, "param_groups": sgd.state_dict()["param_groups"]}
    return {"model": method.state_from_jax(params, model_state),
            "optimizer": {"step_count": steps.pop(), "groups": groups},
            "extra_optimizers": extra,
            "method_state": _tensors(state.get("method_state") or {}),
            "meta": meta}


def blob_to_jax(trainer, epoch: int, flat: bool) -> Dict:
    """The trainer's state → cmh_tpu's ``{"state", "meta"}`` tree, its
    BertAdam partitions flat (as off a mesh) or trees (as on one). Under
    tensor parallelism every rank of the group must call it: it gathers the
    state into the single-process layout."""
    blob = trainer._state_blob(epoch)
    method, model, likes = trainer.method, trainer.model, trainer.whole_likes()
    params, model_state = method.state_to_jax(dict(blob["model"]))
    opt = blob["optimizer"]
    by_id = {"m": {}, "v": {}, "trace": {}}
    for group, saved in zip(trainer.optimizer.param_groups, opt["groups"]):
        for slot in ("m", "v"):
            ts = moment_list(saved[slot], [likes[id(p)] for p in group["params"]], slot)
            by_id[slot].update({id(p): t for p, t in zip(group["params"], ts)})
    for sgd in trainer.extra_optimizers.values():
        group = sgd.param_groups[0]
        for p in group["params"]:
            buf = sgd.state.get(p, {}).get("momentum_buffer")
            if group["momentum"]:   # optax keeps a zero trace before the first step
                by_id["trace"][id(p)] = torch.zeros_like(p) if buf is None else buf
    trees = {slot: method.state_to_jax(_state_dict_of(model, tensors, likes))[0]
             for slot, tensors in by_id.items() if tensors}
    step = np.asarray(opt["step_count"], np.int32)
    opt_state = {}
    for key in params:
        if key in trainer.extra_optimizers:
            opt_state[key] = method.jax_extra_opt_state(
                key, trees["trace"][key] if "trace" in trees else None)
        elif flat:
            m, chunk_leaf = flatten(trees["m"][key])
            opt_state[key] = {"step": step, "m": m, "v": flatten(trees["v"][key])[0],
                              "chunk_leaf": chunk_leaf}
        else:
            opt_state[key] = {"step": step, "m": trees["m"][key], "v": trees["v"][key]}
    return {"state": {"params": params, "model_state": model_state, "opt_state": opt_state,
                      "method_state": _arrays(blob["method_state"]), "step": step},
            "meta": blob["meta"]}


def decode(path: str) -> Dict:
    """The cmh_tpu checkpoint at ``path`` as a tree of numpy arrays."""
    return flax_msgpack.load(path)


def write(path: str, trainer, epoch: int, flat: bool) -> int:
    """Write the trainer's state to ``path`` in cmh_tpu's layout, then the
    sidecar, each atomically; returns the file's bytes. Under tensor
    parallelism the ranks of the writer's group gather with it and write
    nothing (0)."""
    blob = blob_to_jax(trainer, epoch, flat)
    if not trainer.is_writer:
        return 0
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        nbytes = f.write(flax_msgpack.dumps(blob))
    os.replace(tmp, path)
    checkpoint.write_sidecar(path, blob["meta"])
    return nbytes
