"""Tensor parallelism: Megatron column/row splits of every attention and MLP,
and UMoED's Soft-MoE experts split over the ranks of a tensor-parallel group
(counterpart of ``cmh_tpu/parallel/tp.py`` and the ``tp`` axis of
``cmh_tpu/parallel/mesh.py``).

cmh_tpu hands GSPMD a ``PartitionSpec`` tree and XLA places every
collective. Here each rank holds its shards as the module's parameters and
runs the kernels (K1, K2) on its own heads; the collectives are placed by
hand, in autograd:

- a **column** split (the attention's in-projection, ``c_fc``) keeps the
  rank's output features; its input is replicated, so the input's gradient
  is the sum of the ranks' partial products (``column_product``: its
  backward adds the ranks' fp32 partials, then rounds once);
- a **row** split (the attention's out-projection, ``c_proj``) keeps the
  rank's input features; its fp32 partial products are summed over the
  group, rounded once to the compute dtype, and the bias, which every rank
  holds whole, is added once after the sum (``row_product``); one process
  rounds the whole product once and adds the bias after it, and so does
  this;
- ``copy_to_shards`` is the identity with an all-reduce backward: the
  Soft-MoE's replicated input to its sharded experts, and the ResNet
  tower's pooled features, whose columns feed its ``c_proj`` row split;
- ``sum_shards`` is an all-reduce whose backward is the identity (what is
  downstream of it is replicated): the head-averaged attention weights,
  the Soft-MoE combine's numerator and denominator.

The packed QKV in-projection splits **by heads**: rank t keeps rows
``[t·d/tp, (t+1)·d/tp)`` of each of the q, k and v blocks, and the same
columns of the out-projection, so every attention runs whole heads on each
rank. cmh_tpu splits the packed 3d axis contiguously (``tp.py:31-35``); only
the values are held against it. So every sharded attention's head count
must divide by tp (``ValueError`` otherwise).

``RULES`` is cmh_tpu's ``_TP_RULES`` in the port's state-dict names, and
the one record of what is split and how. ``shard_model_`` cuts a model's
parameters by it and calls ``shard_`` on each module that computes on the
shards; a split parameter under no such module raises.
``shard_state_dict`` and ``gather_state_dict`` carry a state dict between
the single-process layout and a rank's shards; ``shard_moments`` and
``gather_moments`` do the same for BertAdam's moments, which take their
parameters' layout (cmh_tpu ``state_shardings``). Every file a run writes is
in the single-process layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional

import torch
import torch.distributed as dist

from ..optim.bert_adam import moment_list, moment_vector

# all-reduces issued by this module and their bytes, since the last reset
traffic = {"all_reduces": 0, "bytes": 0}


@dataclass(frozen=True)
class Split:
    """A sharded tensor: ``dim`` cut into ``blocks`` equal blocks, each of
    which splits evenly over the ranks (the packed QKV has 3)."""

    dim: int
    blocks: int = 1


# (name suffix, split), first match wins; a suffix element starting with "*"
# matches any name component ending in the rest ("attn", "self_attn",
# "multihead_attn"), as cmh_tpu's does
RULES = (
    (("*attn", "in_proj_weight"), Split(0, 3)),       # QKV output features, by heads
    (("*attn", "in_proj_bias"), Split(0, 3)),
    (("*attn", "out_proj", "weight"), Split(1)),      # input features; its bias whole
    (("c_fc", "weight"), Split(0)),                   # MLP up: output features
    (("c_fc", "bias"), Split(0)),
    (("c_proj", "weight"), Split(1)),                 # MLP down: input features
    # UMoED's Soft-MoE: the expert axis (cmh_tpu phi, expert_kernel, expert_bias)
    (("phi",), Split(1)),                             # (d, n_exp, p)
    (("experts", "weight"), Split(0)),                # (n_exp, d, e)
    (("experts", "bias"), Split(0)),                  # (n_exp, e)
)


def _match(name: str, pat: str) -> bool:
    return name.endswith(pat[1:]) if pat.startswith("*") else name == pat


def split_for(name: str) -> Optional[Split]:
    """The split of the parameter (or state-dict entry) ``name``, or None
    when it stays whole on every rank."""
    parts = name.split(".")
    for suffix, split in RULES:
        if len(parts) >= len(suffix) and all(
                _match(n, p) for n, p in zip(parts[-len(suffix):], suffix)):
            return split
    return None


@dataclass(frozen=True)
class Shards:
    """This rank's place in its tensor-parallel group."""

    rank: int
    size: int
    group: Any = None     # the process group (None: the default group)


def check_world(world: int, tp: int) -> None:
    """cmh_tpu's error for a tp that does not divide the processes
    (``mesh.py:43-44``)."""
    if tp < 1 or world % tp != 0:
        raise ValueError(f"{world} devices not divisible by tp={tp}")


def shard(t: torch.Tensor, split: Split, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s part of the whole tensor ``t`` (a copy)."""
    dim = split.dim
    if t.shape[dim] % (split.blocks * size):
        raise ValueError(f"a dimension of {t.shape[dim]} in {split.blocks} block(s) does not "
                         f"split over tp={size}")
    parts = [b.chunk(size, dim)[rank] for b in t.chunk(split.blocks, dim)]
    return torch.cat(parts, dim).clone()


def unshard(parts: List[torch.Tensor], split: Split) -> torch.Tensor:
    """The whole tensor from the ranks' parts, in rank order."""
    dim = split.dim
    blocks = [p.chunk(split.blocks, dim) for p in parts]
    return torch.cat([blocks[r][b] for b in range(split.blocks) for r in range(len(parts))],
                     dim)


def _count(t: torch.Tensor) -> None:
    traffic["all_reduces"] += 1
    traffic["bytes"] += t.numel() * t.element_size()


def all_reduce_(t: torch.Tensor, shards: Shards, op=dist.ReduceOp.SUM) -> torch.Tensor:
    _count(t)
    dist.all_reduce(t, op=op, group=shards.group)
    return t


def gather(t: torch.Tensor, split: Split, shards: Shards) -> torch.Tensor:
    """The whole tensor from every rank's shard ``t``."""
    parts = [torch.empty_like(t) for _ in range(shards.size)]
    dist.all_gather(parts, t.contiguous(), group=shards.group)
    return unshard(parts, split)


# --------------------------------------------------------------- autograd
class _SumShards(torch.autograd.Function):
    """All-reduce forward, identity backward (Megatron's g): the sum's
    consumers are replicated, so every rank already holds its gradient."""

    @staticmethod
    def forward(ctx, x, shards):
        return all_reduce_(x.contiguous().clone(), shards)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToShards(torch.autograd.Function):
    """Identity forward, all-reduce backward (Megatron's f): a replicated
    input whose consumers are this rank's shards."""

    @staticmethod
    def forward(ctx, x, shards):
        ctx.shards = shards
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.shards), None


class _ColumnProduct(torch.autograd.Function):
    """``x @ wᵀ`` of a replicated ``x`` and this rank's output features
    (Megatron's f fused with the product): the forward is the product in
    the operands' dtype, as one process computes it; the backward sums the
    ranks' fp32 partial input gradients over the group and rounds once."""

    @staticmethod
    def forward(ctx, x, w, shards):
        ctx.save_for_backward(x, w)
        ctx.shards = shards
        return torch.matmul(x, w.t())

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        dx = all_reduce_(fp32_product(grad, w), ctx.shards).to(x.dtype)
        dw = torch.matmul(grad.reshape(-1, grad.shape[-1]).t(), x.reshape(-1, x.shape[-1]))
        return dx, dw, None


class _RowProduct(torch.autograd.Function):
    """``x @ wᵀ`` over this rank's input features, summed over the group in
    fp32 (the caller rounds once); the backward is the product's own, in
    the operands' dtype, since every rank holds all output features."""

    @staticmethod
    def forward(ctx, x, w, shards):
        ctx.save_for_backward(x, w)
        return all_reduce_(fp32_product(x, w.t()), shards)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g = grad.to(x.dtype)
        dx = torch.matmul(g, w)
        dw = torch.matmul(g.reshape(-1, g.shape[-1]).t(), x.reshape(-1, x.shape[-1]))
        return dx, dw, None


def fp32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated and returned in fp32. Operands of a 16-bit
    dtype are exact in TF32, so on the card their product runs on the TF32
    tensor cores and is the fp32 product of the same values."""
    low = a.dtype in (torch.bfloat16, torch.float16)
    a, b = a.float(), b.float()
    if not (low and a.is_cuda):
        return torch.matmul(a, b)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def sum_shards(x: torch.Tensor, shards: Shards) -> torch.Tensor:
    """The sum of ``x`` over the group, on every rank (identity backward)."""
    return _SumShards.apply(x, shards)


def copy_to_shards(x: torch.Tensor, shards: Shards) -> torch.Tensor:
    """``x`` itself, whose gradient is summed over the group."""
    return _CopyToShards.apply(x, shards)


def column_product(x: torch.Tensor, w: torch.Tensor, shards: Shards) -> torch.Tensor:
    """A column split's ``x @ wᵀ`` (``x`` replicated, ``w`` this rank's
    rows), in ``x``'s dtype."""
    return _ColumnProduct.apply(x, w, shards)


def row_product(x: torch.Tensor, w: torch.Tensor, shards: Shards) -> torch.Tensor:
    """A row split's ``x @ wᵀ`` summed over the group, in fp32."""
    return _RowProduct.apply(x, w, shards)


# --------------------------------------------------------------- layouts
def shard_state_dict(full_sd: Dict[str, torch.Tensor], tp_rank: int, tp: int
                     ) -> Dict[str, torch.Tensor]:
    """A single-process state dict → rank ``tp_rank``'s of ``tp``."""
    out = {}
    for k, v in full_sd.items():
        split = split_for(k)
        out[k] = v if split is None else shard(v, split, tp_rank, tp)
    return out


def gather_state_dict(local_sd: Dict[str, torch.Tensor], shards: Shards
                      ) -> Dict[str, torch.Tensor]:
    """The inverse of ``shard_state_dict``, on every rank of the group."""
    out = {}
    for k, v in local_sd.items():
        split = split_for(k)
        out[k] = v if split is None else gather(v, split, shards)
    return out


def gather_moments(opt_sd: dict, param_groups, names: Dict[int, str], shards: Shards,
                   full_params) -> dict:
    """BertAdam's ``state_dict`` of this rank → the single-process one, in
    the same format (flat vectors laid out over the whole parameters, or
    per-parameter lists). ``names`` maps ``id(parameter)`` to its name;
    ``full_params`` gives, per group, tensors of the whole parameters'
    shapes."""
    groups = []
    for group, saved, full in zip(param_groups, opt_sd["groups"], full_params):
        out = {}
        for slot in ("m", "v"):
            local = moment_list(saved[slot], group["params"], slot)
            whole = [t if split_for(names[id(p)]) is None
                     else gather(t, split_for(names[id(p)]), shards)
                     for p, t in zip(group["params"], local)]
            out[slot] = (moment_vector(whole, full, whole[0].device if whole else "cpu")
                         if torch.is_tensor(saved[slot]) else whole)
        groups.append(out)
    return {"step_count": opt_sd["step_count"], "groups": groups}


def shard_moments(opt_sd: dict, param_groups, names: Dict[int, str], shards: Shards,
                  full_params) -> dict:
    """The inverse of ``gather_moments``: a single-process BertAdam state
    (either format) → this rank's, as per-parameter lists (``load_state_dict``
    takes them into either path)."""
    if len(opt_sd["groups"]) != len(param_groups):
        raise ValueError(f"optimizer state has {len(opt_sd['groups'])} param groups, "
                         f"this optimizer {len(param_groups)}")
    groups = []
    for group, saved, full in zip(param_groups, opt_sd["groups"], full_params):
        out = {}
        for slot in ("m", "v"):
            out[slot] = [t if split_for(names[id(p)]) is None
                         else shard(t, split_for(names[id(p)]), shards.rank, shards.size)
                         for p, t in zip(group["params"], moment_list(saved[slot], full, slot))]
        groups.append(out)
    return {"step_count": opt_sd["step_count"], "groups": groups}


# --------------------------------------------------------------- modules
def sharded_names(model: torch.nn.Module) -> List[str]:
    """The parameters of ``model`` that the rules split."""
    return [n for n, _ in model.named_parameters() if split_for(n) is not None]


def shard_model_(model: torch.nn.Module, shards: Shards) -> List[str]:
    """Keep this rank's shards of ``model``'s parameters (new ``Parameter``s
    in place of the whole ones, cut by ``RULES``) and turn on the modules
    that compute on them; returns the sharded parameters' names. Call it
    before an optimizer is built over the parameters.

    The module that computes on a sharded parameter is the nearest one
    above it with a ``shard_(shards)`` method (an attention, a block's MLP,
    the ResNet tower's attention pool, the Soft-MoE): ``shard_`` checks what
    its forward needs (an attention's heads) and sets what it reads. A
    parameter the rules
    split under no such module raises ``ValueError``: its module would
    compute on a shard as if it were whole."""
    modules = dict(model.named_modules())
    names = sharded_names(model)
    owners: Dict[str, None] = {}
    for name in names:
        owner = name.rpartition(".")[0]
        while not hasattr(modules[owner], "shard_"):
            if not owner:
                raise ValueError(f"{name}: the tensor-parallel rules split it, but no "
                                 f"module above it computes on shards "
                                 f"({type(modules[name.rpartition('.')[0]]).__name__} "
                                 "has no shard_)")
            owner = owner.rpartition(".")[0]
        owners[owner] = None
    for owner in owners:
        try:
            modules[owner].shard_(shards)
        except ValueError as e:
            raise ValueError(f"{owner}: {e}") from None
    for name in names:
        mod_name, _, leaf = name.rpartition(".")
        mod = modules[mod_name]
        p = mod._parameters[leaf]
        mod._parameters[leaf] = torch.nn.Parameter(
            shard(p.detach(), split_for(name), shards.rank, shards.size),
            requires_grad=p.requires_grad)
    return names


def whole_likes(params: Iterable[torch.nn.Parameter], names: Dict[int, str], tp: int):
    """Meta tensors of the single-process shapes of ``params`` (the sharded
    ones grown back): a flat layout's spec."""
    out = []
    for p in params:
        split = split_for(names[id(p)])
        shape = list(p.shape)
        if split is not None:
            shape[split.dim] *= tp
        out.append(torch.empty(shape, dtype=p.dtype, device="meta"))
    return out
