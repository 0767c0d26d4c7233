"""cmh_torch's BertAdam against cmh_tpu's partitioned BertAdam.

A small two-group parameter tree (a ``backbone`` subtree and a head) takes
five steps from the same values and gradients in both packages:
cmh_tpu ``partitioned_optimizer({"backbone": bert_adam(...)},
default=bert_adam(...))`` and the port's ``BertAdam`` over
``param_groups``, on the tree path and on the flat path (``flat=True`` in
both). Tolerance: fp32 arithmetic in another order, and the schedule factor
in Python doubles against cmh_tpu's fp32 (1e-6 relative). The port's flat
path is also held to its tree path (1e-6: only the norms' sums associate
differently), its state converts flat→tree→flat exactly, and a flat step
issues the same aten ops whatever the number of tensors.
"""

import collections
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (before any torch work)
import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from cmh_torch.optim.bert_adam import BertAdam, scheduled_lr_factor
from cmh_torch.optim.partition import param_groups
from cmh_tpu.optim.bert_adam import bert_adam
from cmh_tpu.optim.bert_adam import scheduled_lr_factor as jax_factor
from cmh_tpu.optim.partition import partitioned_optimizer

STEPS = 5
SHAPES = {"backbone.w": (6, 4), "backbone.b": (4,), "hash.w": (4, 3), "hash.unused": (3,)}


def _model():
    m = nn.Module()
    m.backbone = nn.Module()
    m.hash = nn.Module()
    for name, shape in SHAPES.items():
        sub, leaf = name.split(".")
        setattr(getattr(m, sub), leaf, nn.Parameter(torch.zeros(shape)))
    return m


CASES = [("warmup_cosine", 8, 0.05), ("warmup_constant", 8, 0.05),
         ("warmup_linear", 8, 0.05), ("warmup_cosine", -1, 0.05),
         ("warmup_linear", 10, 50.0)]           # gradient norms > 1: the clip is active


@pytest.mark.parametrize("schedule,t_total,scale", CASES)
def test_five_step_trajectory_matches_cmh_tpu(schedule, t_total, scale):
    _five_steps_against_cmh_tpu(schedule, t_total, scale, flat=False)


@pytest.mark.parametrize("schedule,t_total,scale", CASES)
def test_flat_five_step_trajectory_matches_cmh_tpu_flat(schedule, t_total, scale):
    _five_steps_against_cmh_tpu(schedule, t_total, scale, flat=True)


def _five_steps_against_cmh_tpu(schedule, t_total, scale, flat):
    rng = np.random.RandomState(len(schedule) + t_total)
    init = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.randn(*s) * scale).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    kw = dict(warmup=0.25, t_total=t_total, schedule=schedule, b1=0.9, b2=0.98,
              e=1e-6, weight_decay=0.2, max_grad_norm=1.0)

    tree = lambda d: {"backbone": {"w": d["backbone.w"], "b": d["backbone.b"]},
                      "hash": {"w": d["hash.w"], "unused": d["hash.unused"]}}
    tx = partitioned_optimizer({"backbone": bert_adam(lr=0.003, flat=flat, **kw)},
                               default=bert_adam(lr=0.01, flat=flat, **kw))
    params = jax.tree_util.tree_map(jnp.asarray, tree(init))
    state = tx.init(params)

    model = _model()
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(init[name]))
    opt = BertAdam(param_groups(model, lr=0.01, backbone_lr=0.003), lr=0.01, flat=flat, **kw)

    clipped = False
    for g in grads:
        jg = jax.tree_util.tree_map(jnp.asarray, tree(g))
        jg["hash"]["unused"] = jnp.zeros(SHAPES["hash.unused"])   # no gradient reaches it
        upd, state = tx.update(jg, state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, upd)
        for name, p in model.named_parameters():
            p.grad = None if name == "hash.unused" else torch.from_numpy(g[name])
            clipped |= float(np.linalg.norm(g[name])) > 1.0
        opt.step()
        want = {"backbone.w": params["backbone"]["w"], "backbone.b": params["backbone"]["b"],
                "hash.w": params["hash"]["w"], "hash.unused": params["hash"]["unused"]}
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[name]),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
    assert clipped == (scale > 1.0)
    # weight decay moved the parameter no gradient reached
    assert not np.allclose(model.hash.unused.detach().numpy(), init["hash.unused"])
    assert opt.step_count == STEPS


@pytest.mark.parametrize("schedule", ["warmup_cosine", "warmup_constant", "warmup_linear"])
def test_schedule_factor_matches(schedule):
    for step in range(12):
        for warmup in (0.1, -1.0):
            assert scheduled_lr_factor(step, 10, schedule, warmup) == pytest.approx(
                float(jax_factor(step, 10, schedule, warmup)), abs=1e-6)
    assert scheduled_lr_factor(3, -1, schedule, 0.1) == 1.0


def test_param_groups_split_on_backbone():
    groups = param_groups(_model(), lr=0.01, backbone_lr=0.003)
    assert [(g["name"], g["lr"], len(g["params"])) for g in groups] == [
        ("backbone", 0.003, 2), ("default", 0.01, 2)]
    with pytest.raises(ValueError, match="Invalid schedule"):
        BertAdam(_model().parameters(), lr=0.1, schedule="cosine")


KW = dict(lr=0.01, warmup=0.25, t_total=8, schedule="warmup_cosine", b1=0.9, b2=0.98,
          e=1e-6, weight_decay=0.2, max_grad_norm=1.0)


def _wide_model(n_tensors, seed=0):
    """``n_tensors`` parameters of assorted shapes, half in the backbone,
    sizes on and off multiples of the 512-element chunk."""
    gen = torch.Generator().manual_seed(seed)
    shapes = [(3, 5), (600,), (512,), (2, 2, 7), (1,), (40, 30)]
    m = nn.Module()
    m.backbone, m.hash = nn.ParameterList(), nn.ParameterList()
    for i in range(n_tensors):
        (m.backbone if i % 2 == 0 else m.hash).append(
            nn.Parameter(torch.randn(shapes[i % len(shapes)], generator=gen)))
    return m


def _set_grads(model, step, scale, gen):
    for i, p in enumerate(model.parameters()):
        # the last tensor never gets a gradient (as CLIP's logit_scale)
        p.grad = (None if i == len(list(model.parameters())) - 1
                  else torch.randn(p.shape, generator=gen) * scale * (1 + step))


@pytest.mark.parametrize("scale", [0.05, 50.0])
def test_flat_path_matches_the_tree_path(scale):
    """Same trajectory from both paths over five steps; between steps 2 and
    3 both models take new values by ``load_state_dict`` and drop their
    gradients with ``zero_grad(set_to_none=True)``, which the flat path's
    views must follow."""
    tree_m = _wide_model(12)
    flat_m = copy.deepcopy(tree_m)
    tree = BertAdam(param_groups(tree_m, 0.01, 0.003), flat=False, **KW)
    flat = BertAdam(param_groups(flat_m, 0.01, 0.003), flat=True, **KW)
    other = _wide_model(12, seed=1).state_dict()
    for step in range(5):
        if step == 2:
            for m, opt in ((tree_m, tree), (flat_m, flat)):
                m.load_state_dict(other)
                opt.zero_grad(set_to_none=True)
        for m, opt in ((tree_m, tree), (flat_m, flat)):
            _set_grads(m, step, scale, torch.Generator().manual_seed(step))
            opt.step()
        for (name, a), b in zip(tree_m.named_parameters(), flat_m.parameters()):
            np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=f"{name} step {step}")
    groups = zip(tree.state_dict()["groups"], flat.state_dict()["groups"])
    for i, (g_tree, g_flat) in enumerate(groups):
        views = flat._flat_group(i)["spec"].views
        for key in ("m", "v"):
            for want, got in zip(g_tree[key], views(g_flat[key])):
                # where m cancels towards 0, 1e-6 of the tensor's largest moment
                np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                           atol=1e-6 * float(want.abs().max()))
    assert tree.step_count == flat.step_count == 5


def test_flat_tree_flat_state_conversion_is_exact():
    model = _wide_model(9)
    flat = BertAdam(param_groups(model, 0.01, 0.003), flat=True, **KW)
    for step in range(3):
        _set_grads(model, step, 5.0, torch.Generator().manual_seed(step))
        flat.step()
    saved = copy.deepcopy(flat.state_dict())
    tree = BertAdam(param_groups(model, 0.01, 0.003), flat=False, **KW)
    assert tree.load_state_dict(copy.deepcopy(saved)) is True         # converted
    back = BertAdam(param_groups(model, 0.01, 0.003), flat=True, **KW)
    assert back.load_state_dict(tree.state_dict()) is True
    assert back.step_count == tree.step_count == 3
    for a, b in zip(saved["groups"], back.state_dict()["groups"]):
        assert torch.equal(a["m"], b["m"]) and torch.equal(a["v"], b["v"])
    # the same format loads without conversion; a wrong shape is refused
    assert flat.load_state_dict(saved) is False
    bad = copy.deepcopy(saved)
    bad["groups"][0]["m"] = bad["groups"][0]["m"][:-512]
    with pytest.raises(ValueError, match="flat vector"):
        back.load_state_dict(bad)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _ops_of_one_flat_step(n_tensors):
    model = _wide_model(n_tensors)
    opt = BertAdam(param_groups(model, 0.01, 0.003), flat=True, **KW)
    _set_grads(model, 0, 5.0, torch.Generator().manual_seed(0))
    opt.step()                     # the first step lays out the vectors
    _set_grads(model, 1, 5.0, torch.Generator().manual_seed(1))
    with _CountOps() as count:
        opt.step()
    return count.ops


def test_flat_step_issues_the_same_ops_for_4_and_400_tensors():
    small, large = _ops_of_one_flat_step(4), _ops_of_one_flat_step(400)
    assert small == large, (small, large)
    assert sum(small.values()) < 60, small
    assert small["aten._foreach_copy_.default"] == 2      # one gather a group
