"""Data parallelism across cards, one process per card (counterpart of
``cmh_tpu/parallel/mesh.py``).

cmh_tpu shards the *global* batch over the ``dp`` axis of one jitted
program, so its loss is the single-device loss at the global batch. The port
keeps that meaning with one process per card in a ``torch.distributed``
group (NCCL between cards, gloo on the CPU):

- every rank draws the same shuffled global batch (one seed) and takes its
  rows ``[r·b/W, (r+1)·b/W)`` (``local_rows``) through the CLIP towers;
- the towers' outputs are gathered (``gathered_towers``) into the global
  batch, so the heads, BatchNorm, head dropout, the method state and
  DNPH's assignment see what a single process sees, and every rank computes
  the same global loss (no dropout site sees a rank's rows alone, so each
  draws the whole batch's mask on its card, at row offset 0);
- the gather's backward hands each rank the gradient of its own rows, times
  W, and ``average_gradients`` averages every gradient over the ranks: the
  towers' gradients become the sum of the ranks' parts, the heads' (the
  same on every rank) stay what they were, and every rank steps the same
  parameters by the same gradients.

``check_batch_divisible`` is cmh_tpu's named error for a batch that does
not split evenly (``mesh.py:45-59``). ``broadcast_tree`` hands rank 0's
whole training state to the other ranks (a resume reads its file on rank 0
alone), and ``agree`` makes a host-side flag such as a SIGTERM the same on
every rank, over gloo, so it costs no wait for the card.

With tensor parallelism (``init(..., tp=T)``, ``parallel/tp.py``) the
processes form cmh_tpu's (dp, tp) mesh, ``reshape(n // tp, tp)``
(``mesh.py:45``): process r has data-parallel index r // T and
tensor-parallel index r % T. A ``Group``'s ``rank`` and ``world`` are then
its place in its data-parallel group (its column of the mesh), and
every collective above runs over that group (``pg``): the ranks of a
tensor-parallel group hold different shards of the same parameters and see
the same rows. ``shards`` is the tensor-parallel group.

NCCL refuses two ranks on one card, so ``init`` exchanges each rank's card
before it opens an NCCL group and raises when two share one; ranks that
share a card ask for ``backend="gloo"``.
"""

from __future__ import annotations

import contextlib
import os
import socket
from dataclasses import dataclass
from typing import Any, Iterable, List, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.constants import default_pg_nccl_timeout, default_pg_timeout

from . import tp as tp_mod

ROW_KEYS = ("image", "text", "key_padding_mask")   # a batch's tower inputs


@dataclass(frozen=True)
class Group:
    """This process's place in the (dp, tp) mesh: ``rank`` of ``world`` in
    its data-parallel group ``pg`` (None: the default group), and its
    tensor-parallel group ``shards`` (None without tensor parallelism)."""

    rank: int
    world: int
    device: torch.device
    pg: Any = None
    shards: Optional[tp_mod.Shards] = None

    @property
    def tp(self) -> int:
        return self.shards.size if self.shards else 1

    @property
    def global_rank(self) -> int:
        return self.rank * self.tp + (self.shards.rank if self.shards else 0)


_CURRENT: Optional[Group] = None
_HOST = None   # a gloo group over every rank, for host-side flags
# the gradient all-reduces of ``average_gradients`` and their bytes
traffic = {"all_reduces": 0, "bytes": 0}


def card_id(device: torch.device) -> str:
    """Which card ``device`` is, across the processes of a host: the host
    name and the card's UUID (its index where the UUID is not given)."""
    props = torch.cuda.get_device_properties(device)
    which = getattr(props, "uuid", None) or (
        f"{os.environ.get('CUDA_VISIBLE_DEVICES', '')}:{device.index}")
    return f"{socket.gethostname()}/{which}"


def check_distinct_cards(cards: List[str]) -> None:
    """NCCL's group needs a card a rank: name the first two ranks that
    share one."""
    seen = {}
    for r, c in enumerate(cards):
        if c in seen:
            raise ValueError(
                f"NCCL ranks {seen[c]} and {r} share the card {c}: NCCL refuses two ranks "
                "on one device; give each rank its own card, or open the group with "
                "backend='gloo'")
        seen[c] = r


def _exchange(store, rank: int, world: int, value: str) -> List[str]:
    """Every rank's ``value``, in rank order, through the rendezvous store."""
    store.set(f"cmh_card/{rank}", value)
    return [store.get(f"cmh_card/{r}").decode() for r in range(world)]


def init(addr: str, port: int, world: int, rank: int, device: torch.device,
         tp: int = 1, backend: Optional[str] = None) -> Group:
    """Join the mesh at ``tcp://addr:port`` as ``rank`` of ``world``, in
    data-parallel groups of ``world // tp`` and tensor-parallel groups of
    ``tp``. ``backend`` defaults to NCCL for a card (which becomes the
    current device) and gloo for the CPU; with a card also a gloo group over
    every rank for ``agree``."""
    global _CURRENT, _HOST
    if _CURRENT is not None:
        raise RuntimeError("the data-parallel group is already initialised")
    world, rank, tp = int(world), int(rank), int(tp)
    tp_mod.check_world(world, tp)
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    # torch's default timeout of the backend's group, as ``init_method``'s
    # rendezvous store takes it; the store keeps it for every exchange
    # through it after the rendezvous too
    timeout = (default_pg_nccl_timeout if backend == "nccl" and default_pg_nccl_timeout
               else default_pg_timeout)
    store = dist.TCPStore(addr, int(port), world, is_master=rank == 0, timeout=timeout)
    if backend == "nccl":
        check_distinct_cards(_exchange(store, rank, world, card_id(device)))
    dist.init_process_group(backend, store=store, world_size=world, rank=rank,
                            timeout=timeout)
    _HOST = dist.new_group(backend="gloo") if backend != "gloo" else dist.group.WORLD
    pg, shards = None, None
    if tp > 1:
        # every rank makes every group, in the same order
        for t in range(tp):
            g = dist.new_group(list(range(t, world, tp)))
            if rank % tp == t:
                pg = g
        for d in range(world // tp):
            g = dist.new_group(list(range(d * tp, (d + 1) * tp)))
            if rank // tp == d:
                shards = tp_mod.Shards(rank % tp, tp, g)
    _CURRENT = Group(rank // tp, world // tp, device, pg, shards)
    return _CURRENT


def current() -> Optional[Group]:
    """The group this process joined, or None."""
    return _CURRENT


def shutdown() -> None:
    global _CURRENT, _HOST
    if _CURRENT is not None:
        dist.destroy_process_group()
        _CURRENT = _HOST = None


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_batch_divisible(batch_size: int, world: int, what: str = "batch_size") -> None:
    """Fail with a named error when ``batch_size`` rows do not split evenly
    over ``world`` data-parallel ranks (cmh_tpu ``check_batch_divisible``,
    which divides by the mesh's dp axis)."""
    if batch_size % world != 0:
        raise ValueError(
            f"{what}={batch_size} is not divisible by the data-parallel world "
            f"({world} processes) — choose a multiple (e.g. "
            f"{-(-batch_size // world) * world})")


def local_rows(n: int, group: Group) -> slice:
    """This rank's rows of a global batch of ``n`` rows."""
    per = n // group.world
    return slice(group.rank * per, (group.rank + 1) * per)


def shard_batch(batch: dict, group: Group, keys: Iterable[str] = ROW_KEYS) -> dict:
    """The host batch with ``keys`` cut to this rank's rows."""
    return {k: v[local_rows(len(v), group)] if k in keys else v for k, v in batch.items()}


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rank, world, pg):
        ctx.rows = slice(rank * x.shape[0], (rank + 1) * x.shape[0])
        ctx.world = world
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous(), group=pg)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        # every rank computes the same loss, so the gradient of the gathered
        # rows is the same everywhere: keep this rank's rows, times W for
        # the average in ``average_gradients``
        return grad[ctx.rows] * ctx.world, None, None, None


def gather_rows(x, group: Group):
    """The ranks' ``x`` (equal shapes) concatenated on dim 0 in rank order;
    differentiable for floating tensors. None stays None."""
    if x is None:
        return None
    if x.is_floating_point():
        return _GatherRows.apply(x, group.rank, group.world, group.pg)
    src = x.to(torch.uint8) if x.dtype == torch.bool else x
    parts = [torch.empty_like(src) for _ in range(group.world)]
    dist.all_gather(parts, src.contiguous(), group=group.pg)
    out = torch.cat(parts)
    return out.bool() if x.dtype == torch.bool else out


@contextlib.contextmanager
def gathered_towers(backbone: torch.nn.Module, group: Group):
    """Inside the block, ``backbone.encode_image`` and ``encode_text`` return
    their outputs (tuples of batch-first tensors) gathered over the ranks:
    whatever the model computes after its towers sees the global batch."""
    enc_i, enc_t = backbone.encode_image, backbone.encode_text

    def gathered(fn):
        return lambda *a, **k: tuple(gather_rows(t, group) for t in fn(*a, **k))

    backbone.encode_image, backbone.encode_text = gathered(enc_i), gathered(enc_t)
    try:
        yield
    finally:
        del backbone.encode_image, backbone.encode_text


def average_gradients(params: Iterable[torch.nn.Parameter], group: Group) -> None:
    """Average the parameters' gradients over the ranks, one all-reduce a
    dtype; every rank gets the same bytes. Parameters without a gradient
    (the same on every rank) are left alone."""
    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        traffic["all_reduces"] += 1
        traffic["bytes"] += flat.numel() * flat.element_size()
        dist.all_reduce(flat, group=group.pg)
        flat.div_(group.world)
        torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(
            flat.split([g.numel() for g in grads]), grads)])


def all_reduce_sum_(tensors: Iterable[torch.Tensor], group: Group) -> None:
    """Sum each tensor over the data-parallel group in place."""
    for t in tensors:
        dist.all_reduce(t, group=group.pg)


def broadcast_(tensors: Iterable[torch.Tensor], group: Group) -> None:
    """Overwrite each tensor with that of the data-parallel group's rank 0,
    in place."""
    src = 0 if group.pg is None else dist.get_global_rank(group.pg, 0)
    for t in tensors:
        dist.broadcast(t, src, group=group.pg)


def agree(value: int) -> int:
    """The largest of the ranks' ``value`` (a host integer), on every rank;
    a host-side all-reduce that waits for no card."""
    t = torch.tensor([int(value)], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_HOST)
    return int(t.item())


class _Leaf(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def broadcast_tree(tree, group: Group, src: int = 0):
    """Process ``src``'s ``tree`` (nested dicts, lists and tuples of tensors
    and plain values) on every process of the mesh: its layout goes as one
    pickled object, then each tensor as one broadcast. The other processes
    get new tensors on the group's device; ``src`` gets its own ``tree``
    back."""
    leaves = []

    def layout(t):
        if isinstance(t, dict):
            return {k: layout(v) for k, v in t.items()}
        if type(t) in (list, tuple):
            return type(t)(layout(v) for v in t)
        if torch.is_tensor(t):
            leaves.append(t)
            return _Leaf(tuple(t.shape), t.dtype)
        return t

    def build(t):
        if isinstance(t, _Leaf):
            leaves.append(torch.empty(t.shape, dtype=t.dtype, device=group.device))
            return leaves[-1]
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if type(t) in (list, tuple):
            return type(t)(build(v) for v in t)
        return t

    me = group.global_rank
    obj = [layout(tree) if me == src else None]
    dist.broadcast_object_list(obj, src)
    out = tree if me == src else build(obj[0])
    for t in leaves:
        buf = t.to(group.device).contiguous()   # the tensor itself on other ranks
        dist.broadcast(buf, src)
    return out
