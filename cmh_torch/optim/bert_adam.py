"""BertAdam as a ``torch.optim.Optimizer`` (counterpart of
``cmh_tpu/optim/bert_adam.py``: the tree path at ``:120-214``, the flat path
at ``:58-117`` and ``:217-261``, the state conversion at ``:264-301``).

- each parameter's gradient is clipped by its own norm before the moments,
  ``coef = min(max_grad_norm / (‖g‖ + 1e-6), 1)`` (not a global clip);
- Adam moments without bias correction;
- weight decay is added to the update of every parameter;
- the learning rate is the group's ``lr`` times ``scheduled_lr_factor`` at
  the step count before this step (warmup_cosine / warmup_constant /
  warmup_linear over ``t_total``; ``t_total = -1`` means factor 1, and
  ``warmup`` passes through raw).

A parameter whose gradient is ``None`` (one no loss term reaches, such as
CLIP's ``logit_scale``) is updated as with a zero gradient, as cmh_tpu's
functional update does for every leaf: its weight decay still applies.
The update runs under ``torch.no_grad()`` with in-place tensor ops on the
parameters' device and never reads a value back to the host.

Two paths compute the same function:

- the tree path (``flat=False``) loops over the parameters, about a dozen
  ops each;
- the flat path (``flat=True``) keeps one fp32 vector for ``m`` and one
  for ``v`` in each param group, every tensor zero-padded to a multiple of
  ``_CHUNK``. The gradients are gathered into a padded vector and the
  updates written back with multi-tensor ops on views made once, and the
  per-tensor clip norms come from fp32 chunk sums of squares and one
  segmented fp64 sum over the chunks of each tensor, so a step issues the
  same few dozen ops whatever the number of tensors. Only the association
  of the norms' sums differs from the tree path, as in cmh_tpu. The
  segmented sum runs in a fixed order (no atomics), so a step is
  bit-reproducible on the card.

Under tensor parallelism (``shard_norms``) a parameter split over the ranks
is one logical tensor: its clip norm is that of the whole tensor, so the
sum of squares of each sharded leaf is all-reduced over the group (one
all-reduce a group a step), and a replicated leaf's is not (it would be
counted once a rank).

``state_dict()`` holds ``step_count`` and, per group, ``m`` and ``v``: one
vector each on the flat path, a list of per-parameter tensors on the tree
path. ``load_state_dict`` takes either form into either path.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence

import torch

_CHUNK = 512


def warmup_cosine(x: float, warmup: float = 0.002) -> float:
    return x / warmup if x < warmup else 0.5 * (1.0 + math.cos(math.pi * x))


def warmup_constant(x: float, warmup: float = 0.002) -> float:
    return x / warmup if x < warmup else 1.0


def warmup_linear(x: float, warmup: float = 0.002) -> float:
    return x / warmup if x < warmup else max((x - 1.0) / (warmup - 1.0), 0.0)


SCHEDULES = {
    "warmup_cosine": warmup_cosine,
    "warmup_constant": warmup_constant,
    "warmup_linear": warmup_linear,
}


def scheduled_lr_factor(step: int, t_total: int, schedule: str = "warmup_linear",
                        warmup: float = -1.0) -> float:
    """The multiplicative schedule factor at ``step``."""
    if t_total == -1:
        return 1.0
    return SCHEDULES[schedule](step / t_total, warmup)


class _FlatSpec:
    """Layout of a list of tensors inside one zero-padded flat vector."""

    def __init__(self, tensors: Sequence[torch.Tensor]) -> None:
        self.shapes = [tuple(t.shape) for t in tensors]
        self.sizes = [t.numel() for t in tensors]
        self.padded = [-(-s // _CHUNK) * _CHUNK for s in self.sizes]
        self.offsets = [0]
        for p in self.padded:
            self.offsets.append(self.offsets[-1] + p)
        self.total = self.offsets[-1]

    def chunk_counts(self, device) -> torch.Tensor:
        """Chunks of each tensor, the segment lengths of the norm sums."""
        return torch.tensor([p // _CHUNK for p in self.padded], dtype=torch.int64,
                            device=device)

    def views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        return [flat[o:o + s].view(shape)
                for o, s, shape in zip(self.offsets, self.sizes, self.shapes)]

    def flatten(self, tensors: Sequence[torch.Tensor], device) -> torch.Tensor:
        flat = torch.zeros(self.total, dtype=torch.float32, device=device)
        if tensors:
            torch._foreach_copy_(self.views(flat), [t.to(device) for t in tensors])
        return flat

    def check(self, flat: torch.Tensor, what: str) -> None:
        if tuple(flat.shape) != (self.total,):
            raise ValueError(f"{what}: flat vector of shape {tuple(flat.shape)}, "
                             f"expected ({self.total},)")


def moment_list(saved, like: Sequence[torch.Tensor], what: str = "moment"
                ) -> List[torch.Tensor]:
    """A group's saved moment as per-parameter tensors: the views of a flat
    vector laid out over tensors of ``like``'s shapes (checked), or the
    per-parameter list as it is."""
    if not torch.is_tensor(saved):
        return list(saved)
    spec = _FlatSpec(like)
    spec.check(saved, what)
    return spec.views(saved)


def moment_vector(tensors: Sequence[torch.Tensor], like: Sequence[torch.Tensor],
                  device) -> torch.Tensor:
    """The inverse of ``moment_list``: ``tensors`` in one flat vector laid
    out over tensors of ``like``'s shapes."""
    return _FlatSpec(like).flatten(tensors, device)


class BertAdam(torch.optim.Optimizer):
    def __init__(self, params: Iterable, lr: float, warmup: float = -1.0,
                 t_total: int = -1, schedule: str = "warmup_linear",
                 b1: float = 0.9, b2: float = 0.999, e: float = 1e-6,
                 weight_decay: float = 0.01, max_grad_norm: float = 1.0,
                 flat: bool = False) -> None:
        if schedule not in SCHEDULES:
            raise ValueError(f"Invalid schedule parameter: {schedule}")
        defaults = dict(lr=lr, warmup=warmup, t_total=t_total, schedule=schedule,
                        b1=b1, b2=b2, e=e, weight_decay=weight_decay,
                        max_grad_norm=max_grad_norm)
        super().__init__(params, defaults)
        self.flat = flat
        self.step_count = 0     # steps taken; the schedule reads it before the step
        # flat path: per group, its vectors and the views into them, made on
        # the first use and again if the parameters move to another device
        self._groups = [None] * len(self.param_groups)
        self._shards = None      # (ids of the sharded parameters, tp.Shards)

    def shard_norms(self, sharded: Iterable[torch.nn.Parameter], shards) -> None:
        """Clip the parameters ``sharded`` (this rank's shards of tensors
        split over the ``shards`` group, ``parallel/tp.py``) by the norms of
        the whole tensors."""
        self._shards = ({id(p) for p in sharded}, shards)

    def lr_factor(self, group=None) -> float:
        g = group or self.param_groups[0]
        return scheduled_lr_factor(self.step_count, g["t_total"], g["schedule"],
                                   g["warmup"])

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for i, group in enumerate(self.param_groups):
            if self.flat:
                self._flat_step(self._flat_group(i), group)
            else:
                self._tree_step(group)
        self.step_count += 1
        return loss

    # ------------------------------------------------------------ tree path
    def _tree_state(self, p):
        state = self.state[p]
        if not state:
            state["m"] = torch.zeros_like(p)
            state["v"] = torch.zeros_like(p)
        return state

    def _tree_step(self, group):
        b1, b2, e = group["b1"], group["b2"], group["e"]
        wd, max_norm = group["weight_decay"], group["max_grad_norm"]
        lr = group["lr"] * self.lr_factor(group)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in group["params"]]
        norms = self._sharded_norms(group["params"], grads) if max_norm > 0 else {}
        for p, g in zip(group["params"], grads):
            if max_norm > 0:
                norm = norms.get(id(p))
                if norm is None:
                    norm = torch.linalg.vector_norm(g.float())
                g = g * torch.clamp(max_norm / (norm + 1e-6), max=1.0)
            state = self._tree_state(p)
            m, v = state["m"], state["v"]
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            upd = m / (v.sqrt() + e)
            if wd > 0.0:
                upd.add_(p, alpha=wd)
            p.add_(upd, alpha=-lr)

    def _sharded_norms(self, params, grads) -> dict:
        """The whole tensors' norms of this group's sharded leaves, by
        ``id(parameter)``: each rank's sums of squares, one all-reduce."""
        if self._shards is None:
            return {}
        ids, shards = self._shards
        mine = [(p, g) for p, g in zip(params, grads) if id(p) in ids]
        if not mine:
            return {}
        from ..parallel import tp

        ss = torch.stack([torch.linalg.vector_norm(g.float()) ** 2 for _, g in mine])
        norms = tp.all_reduce_(ss, shards).sqrt()
        return {id(p): n for (p, _), n in zip(mine, norms)}

    # ------------------------------------------------------------ flat path
    def _flat_group(self, i: int) -> dict:
        params = self.param_groups[i]["params"]
        device = params[0].device if params else torch.device("cpu")
        fg = self._groups[i]
        if fg is not None and fg["m"].device == device:
            return fg
        spec = _FlatSpec(params)
        new = lambda: torch.zeros(spec.total, dtype=torch.float32, device=device)
        fg = {"spec": spec,
              "m": new() if fg is None else fg["m"].to(device),
              "v": new() if fg is None else fg["v"].to(device),
              "grad": new(), "upd": new(), "denom": new(),
              "lengths": spec.chunk_counts(device)}
        fg["chunk_leaf"] = torch.repeat_interleave(
            torch.arange(len(params), device=device), fg["lengths"])
        fg["grad_views"] = spec.views(fg["grad"])
        fg["upd_views"] = spec.views(fg["upd"])
        self._groups[i] = fg
        return fg

    def _flat_step(self, fg: dict, group) -> None:
        params = group["params"]
        if not params:
            return
        b1, b2, e = group["b1"], group["b2"], group["e"]
        wd, max_norm = group["weight_decay"], group["max_grad_norm"]
        lr = group["lr"] * self.lr_factor(group)
        # gather: a missing gradient counts as zeros (its padding stays 0)
        have = [i for i, p in enumerate(params) if p.grad is not None]
        if have:
            torch._foreach_copy_([fg["grad_views"][i] for i in have],
                                 [params[i].grad for i in have])
        if len(have) < len(params):
            torch._foreach_zero_([fg["grad_views"][i] for i in range(len(params))
                                  if params[i].grad is None])
        g = fg["grad"]
        if max_norm > 0:
            gc = g.view(-1, _CHUNK)
            # the chunks' fp32 sums of squares added in fp64: a tensor of 25 M
            # elements has 49,408 chunks, whose fp32 sum would lose 1e-6
            leaf_ss = torch.segment_reduce((gc * gc).sum(1).double(), "sum",
                                           lengths=fg["lengths"], unsafe=True)
            if self._shards is not None:
                leaf_ss = self._flat_sharded_ss(fg, params, leaf_ss)
            coef = torch.clamp(max_norm / (leaf_ss.sqrt() + 1e-6), max=1.0).float()
            gc.mul_(coef[fg["chunk_leaf"]].unsqueeze(1))
        m, v, upd, denom = fg["m"], fg["v"], fg["upd"], fg["denom"]
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        torch.sqrt(v, out=denom).add_(e)
        torch.div(m, denom, out=upd)
        if wd > 0.0:
            torch._foreach_add_(fg["upd_views"], params, alpha=wd)
        torch._foreach_add_(params, fg["upd_views"], alpha=-lr)

    def _flat_sharded_ss(self, fg: dict, params, leaf_ss: torch.Tensor) -> torch.Tensor:
        """``leaf_ss`` with the sharded leaves' sums of squares summed over
        the group (one all-reduce), the replicated ones as they were."""
        ids, shards = self._shards
        if "sharded" not in fg:
            mask = [id(p) in ids for p in params]
            fg["sharded"] = torch.tensor(mask, device=leaf_ss.device) if any(mask) else None
        if fg["sharded"] is None:
            return leaf_ss
        from ..parallel import tp

        summed = tp.all_reduce_(torch.where(fg["sharded"], leaf_ss, 0.0), shards)
        return torch.where(fg["sharded"], summed, leaf_ss)

    # ---------------------------------------------------------------- state
    def state_dict(self) -> dict:
        """``step_count`` and, per group, ``m`` and ``v`` (one padded fp32
        vector each on the flat path, lists of per-parameter tensors on the
        tree path). The tensors are the live ones, not copies."""
        groups = []
        for i, group in enumerate(self.param_groups):
            if self.flat:
                fg = self._flat_group(i)
                groups.append({"m": fg["m"], "v": fg["v"]})
            else:
                states = [self._tree_state(p) for p in group["params"]]
                groups.append({"m": [s["m"] for s in states],
                               "v": [s["v"] for s in states]})
        return {"step_count": self.step_count, "groups": groups}

    def load_state_dict(self, state_dict: dict) -> bool:
        """Restore a ``state_dict()`` of either path; returns whether its
        format was converted (flat↔tree). Raises ``ValueError`` when the
        groups or the tensors' shapes do not match these parameters."""
        groups = state_dict["groups"]
        if len(groups) != len(self.param_groups):
            raise ValueError(f"optimizer state has {len(groups)} param groups, "
                             f"this optimizer {len(self.param_groups)}")
        loaded = []
        for i, (group, saved) in enumerate(zip(self.param_groups, groups)):
            params = group["params"]
            spec = _FlatSpec(params)
            device = params[0].device if params else torch.device("cpu")
            m, v = saved["m"], saved["v"]
            if torch.is_tensor(m) != torch.is_tensor(v):
                raise ValueError(f"group {i}: m and v are in different formats")
            if not torch.is_tensor(m):          # per-parameter lists
                for name, ts in (("m", m), ("v", v)):
                    shapes = [tuple(t.shape) for t in ts]
                    if shapes != spec.shapes:
                        raise ValueError(f"group {i}: {name} shapes {shapes} != "
                                         f"parameter shapes {spec.shapes}")
                if self.flat:
                    m, v = spec.flatten(m, device), spec.flatten(v, device)
            else:
                spec.check(m, f"group {i} m")
                spec.check(v, f"group {i} v")
                if not self.flat:
                    m, v = spec.views(m), spec.views(v)
            loaded.append((m, v))
        # nothing is changed until every group has been checked
        for i, (group, (m, v)) in enumerate(zip(self.param_groups, loaded)):
            if self.flat:
                fg = self._flat_group(i)
                fg["m"].copy_(m)
                fg["v"].copy_(v)
            else:
                for p, mi, vi in zip(group["params"], m, v):
                    self.state[p] = {"m": mi.to(p).clone(), "v": vi.to(p).clone()}
        self.step_count = int(state_dict["step_count"])
        return any(torch.is_tensor(g["m"]) != self.flat for g in groups)
