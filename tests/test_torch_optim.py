"""cmh_torch's BertAdam against cmh_tpu's partitioned BertAdam.

A small two-group parameter tree (a ``backbone`` subtree and a head) takes
five steps from the same values and gradients in both packages:
cmh_tpu ``partitioned_optimizer({"backbone": bert_adam(...)},
default=bert_adam(...))`` (the tree path) and the port's ``BertAdam`` over
``param_groups``. Tolerance: fp32 arithmetic in another order, and the
schedule factor in Python doubles against cmh_tpu's fp32 (1e-6 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

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


@pytest.mark.parametrize("schedule,t_total,scale", [
    ("warmup_cosine", 8, 0.05), ("warmup_constant", 8, 0.05),
    ("warmup_linear", 8, 0.05), ("warmup_cosine", -1, 0.05),
    ("warmup_linear", 10, 50.0)])           # gradient norms > 1: the clip is active
def test_five_step_trajectory_matches_cmh_tpu(schedule, t_total, scale):
    rng = np.random.RandomState(len(schedule) + t_total)
    init = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.randn(*s) * scale).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    kw = dict(warmup=0.25, t_total=t_total, schedule=schedule, b1=0.9, b2=0.98,
              e=1e-6, weight_decay=0.2, max_grad_norm=1.0)

    tree = lambda d: {"backbone": {"w": d["backbone.w"], "b": d["backbone.b"]},
                      "hash": {"w": d["hash.w"], "unused": d["hash.unused"]}}
    tx = partitioned_optimizer({"backbone": bert_adam(lr=0.003, **kw)},
                               default=bert_adam(lr=0.01, **kw))
    params = jax.tree_util.tree_map(jnp.asarray, tree(init))
    state = tx.init(params)

    model = _model()
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(init[name]))
    opt = BertAdam(param_groups(model, lr=0.01, backbone_lr=0.003), lr=0.01, **kw)

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
