"""cmh_torch's ModifiedResNet tower against cmh_tpu's, on the CPU.

At ``tests/test_resnet_tower.py``'s tiny geometry (layers (1, 1, 1, 1),
width 8, 2 heads, 32 px, output 16), seeded numpy weights (random
BatchNorm statistics included) and images go to both packages through
``cmh_torch.models.convert``; fp32 on both sides, so only the order of
fp32 sums differs: outputs within 1e-5 relative to their largest value,
running statistics within 1e-5. The converters are exact both ways and
agree with cmh_tpu's ``resnet_variables_from_state_dict``;
``resnet_config_from_state_dict`` gives cmh_tpu's geometry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (before any torch work)
import torch

from cmh_torch.models.clip.loader import resnet_config_from_state_dict
from cmh_torch.models.clip.resnet import ModifiedResNet
from cmh_torch.models.convert import resnet_state_from_jax, resnet_state_to_jax
from cmh_tpu.models.clip import loader as jax_loader
from cmh_tpu.models.clip.resnet import ModifiedResNet as JaxResNet

TINY = dict(layers=(1, 1, 1, 1), width=8, heads=2, input_resolution=32, output_dim=16)
REL = 1e-5


def _seeded_variables(seed):
    """cmh_tpu variables with the tree of ``JaxResNet(**TINY)``, every leaf
    drawn from numpy: kernels at lecun scale, BatchNorm scales about 1,
    shifts, means and biases about 0, variances in [0.5, 1.5]."""
    shapes = jax.eval_shape(JaxResNet(**TINY).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        shape = x.shape
        if "kernel" in name:
            return (rng.randn(*shape) * np.prod(shape[:-1]) ** -0.5).astype(np.float32)
        if "'var'" in name:
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if "'scale'" in name:
            return (1 + 0.1 * rng.randn(*shape)).astype(np.float32)
        if "positional_embedding" in name:
            return (rng.randn(*shape) * shape[-1] ** -0.5).astype(np.float32)
        return (0.1 * rng.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _images(seed, n=3):
    return np.random.RandomState(seed).randn(n, 32, 32, 3).astype(np.float32)


def _port(variables):
    tower = ModifiedResNet(**TINY)
    tower.load_state_dict(resnet_state_from_jax(variables), strict=True)
    return tower


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=REL * np.abs(want).max())


def test_resnet_eval_matches_cmh_tpu():
    v = _seeded_variables(1)
    img = _images(2)
    want = jax.jit(lambda v, x: JaxResNet(**TINY).apply(v, x, train=False))(v, img)
    with torch.no_grad():
        got = _port(v).eval()(torch.from_numpy(img))
    assert got.shape == (3, 16) and got.dtype == torch.float32
    _close(got.numpy(), want)


def test_resnet_train_step_matches_cmh_tpu_with_running_statistics():
    """Train mode: batch statistics with the biased variance, and the
    running statistics moved as 0.9·old + 0.1·batch (the variance biased
    too), against flax's ``mutable=['batch_stats']``."""
    v = _seeded_variables(3)
    img = _images(4, n=4)
    want, updates = jax.jit(lambda v, x: JaxResNet(**TINY).apply(
        v, x, train=True, mutable=["batch_stats"]))(v, img)
    tower = _port(v).train()
    with torch.no_grad():
        got = tower(torch.from_numpy(img))
    _close(got.numpy(), want)
    after = resnet_state_to_jax(tower.state_dict())["batch_stats"]
    flat_got = jax.tree_util.tree_leaves_with_path(after)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, updates["batch_stats"])))
    assert len(flat_got) == len(flat_want) == 2 * 19    # stem 3, blocks 4 × (3 + downsample)
    moved = 0
    for path, x in flat_got:
        np.testing.assert_allclose(x, flat_want[path], rtol=REL, atol=REL)
        before = dict(jax.tree_util.tree_leaves_with_path(v["batch_stats"]))[path]
        moved += not np.array_equal(x, before)
    assert moved == len(flat_got)
    # torch's own BatchNorm2d would move running_var toward the unbiased variance
    x = torch.from_numpy(img).permute(0, 3, 1, 2)
    conv = tower.conv1
    y = torch.nn.functional.conv2d(x, conv.weight, None, conv.stride, conv.padding)
    ref = torch.nn.BatchNorm2d(y.shape[1], momentum=0.1).train()
    with torch.no_grad():
        ref.running_var.copy_(torch.from_numpy(v["batch_stats"]["bn1"]["var"]))
        ref(y)
    assert not np.allclose(ref.running_var.numpy(), after["bn1"]["var"], rtol=1e-7, atol=0)


def test_resnet_state_crosses_both_ways():
    """cmh_tpu → port → cmh_tpu is exact, and the port's state dict (with the
    ``num_batches_tracked`` counters torch writes) gives, through cmh_tpu's
    own ``resnet_variables_from_state_dict``, the same numbers."""
    v = _seeded_variables(5)
    sd = _port(v).state_dict()
    back = resnet_state_to_jax(sd)
    same = jax.tree_util.tree_map(np.array_equal, back, v)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(v)
    assert all(jax.tree_util.tree_leaves(same))
    torch_sd = {k: t.numpy() for k, t in sd.items()}
    torch_sd.update({k.replace("running_mean", "num_batches_tracked"): np.int64(1)
                     for k in sd if k.endswith("running_mean")})
    tower = ModifiedResNet(**TINY)
    tower.load_state_dict({k: torch.as_tensor(a) for k, a in torch_sd.items()}, strict=True)
    theirs = jax_loader.resnet_variables_from_state_dict(
        {k: a for k, a in torch_sd.items() if "num_batches" not in k}, TINY["layers"])
    same = jax.tree_util.tree_map(lambda a, b: np.array_equal(np.asarray(a), b), theirs, v)
    assert all(jax.tree_util.tree_leaves(same))


@pytest.mark.parametrize("layers,width,out,res", [((1, 1, 1, 1), 8, 16, 32),
                                                  ((3, 4, 6, 3), 64, 1024, 224),
                                                  ((3, 4, 23, 3), 64, 512, 224)])
def test_resnet_config_from_state_dict_matches_cmh_tpu(layers, width, out, res):
    """The tiny geometry, RN50 and RN101 (shapes only: the tower is built on
    the meta device)."""
    with torch.device("meta"):
        tower = ModifiedResNet(layers=layers, width=width, output_dim=out,
                               input_resolution=res, heads=width * 32 // 64)
    sd = tower.state_dict()
    got = resnet_config_from_state_dict(sd)
    want = jax_loader.resnet_config_from_state_dict({k: _Shape(t.shape) for k, t in sd.items()})
    assert got == want == dict(layers=layers, width=width, input_resolution=res,
                               output_dim=out, heads=width * 32 // 64)


class _Shape:
    """A stand-in array with a shape alone (cmh_tpu's rules read shapes)."""

    def __init__(self, shape):
        self.shape = tuple(shape)
