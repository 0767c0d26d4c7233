"""The port's random draws from a seed against cmh_tpu's, on the CPU.

- Every method's ``init_weights(init_key)`` at ``CLIPConfig.tiny()`` against
  cmh_tpu's ``init_variables(init_key, sample)``, leaf by leaf through
  ``models/convert.py``'s names: uniform, zero, one and constant leaves
  equal; normal and truncated-normal leaves (the port's erf_inv, see
  ``tests/test_torch_prng.py``) within 1e-6 of the leaf's scale (its
  standard deviation) and equal on most elements.
- DNPH's noise and TwDH's tie vectors bit for bit, MITH's four banks (unit
  normals from ``PRNGKey(20)``) within 1e-6.
- One train step of DCMHT, DIMCH and UMoED (dropout 0.3 in the two that
  have dropout sites; DCMHT has none) with each trainer's own init and
  keys from ``run.seed``: the loss within 1e-5 relative and every tensor's
  update within 1e-4 of cmh_tpu's largest update of that tensor (the
  existing one-step parity tolerance of ``test_torch_train_dimch_umoed.py``)
  plus 1e-5 of the model's largest update and two ulps of the weight: the
  normal leaves start a few ulps apart, and a tensor whose gradient is near
  zero (DCMHT's ``ln_post.bias``) carries that difference at a larger share
  of its own update. The same loss computed with the next step's masks
  must miss cmh_tpu's by more than 100 × 1e-5. The optimizer's step count
  is cmh_tpu's ``state.step`` before and after the step.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (before any torch work)
import torch

import cmh_tpu.models.baseline  # noqa: F401  (registers cmh_tpu's methods and trainers)
import cmh_tpu.models.dnph  # noqa: F401
import cmh_tpu.models.dsph  # noqa: F401
import cmh_tpu.models.mith  # noqa: F401
import cmh_tpu.models.twdh  # noqa: F401
import cmh_tpu.runners.dcmht  # noqa: F401
import cmh_tpu.runners.dimch  # noqa: F401
import cmh_tpu.runners.umoed  # noqa: F401
from cmh_torch.config import config_from_dict as port_config
from cmh_torch.models.common import dropout_rng
from cmh_torch.models.dnph import noise_vectors
from cmh_torch.ops.hash_centers import tie_vector
from cmh_torch.registry import load_components
from cmh_torch.utils import prng
from cmh_tpu.config import config_from_dict
from cmh_tpu.ops.hash_centers import hash_center_multilabels
from cmh_tpu.ops.hungarian import rand_unit_rect
from cmh_tpu.registry import registry as jax_registry
from tests.test_torch_dimch import model_cfg as dimch_cfg
from tests.test_torch_umoed import FUSION
from tests.util_methods import tiny_trainer

port_registry = load_components()
W = 12
MODELS = {
    "DCMHT": {}, "Baseline": {}, "DSPH": {"numclass": 4}, "DNPH": {"numclass": 4},
    "MITH": {"top_k_label": 4}, "TwDH": {"numclass": 4, "long_dim": 64, "short_dims": [8, 16]},
    "DIMCH": {"setDim": 4, "txt_token_size": W},
    "UMoED": {"hash_func": "linear_subspace", "merge_func": "concatenate", "setDim": 4,
              "MoE": True, "num_experts": 2, "slots_per_expert": 2, "decoder_heads": 2,
              "decoder_layers": 2, "hidden_dim": 32, "txt_token_size": W}}
# cmh_tpu's normal and truncated-normal (lecun) leaves; every other leaf is
# uniform, zero, one or constant
NORMAL = re.compile(r"(embedding|class_embedding|positional_embedding|visual/proj|"
                    r"text_projection|(^|/)attn/(in|out)_proj_kernel|c_fc/kernel|c_proj/kernel|"
                    r"conv1/kernel|proxies|slots|token_layer/kernel|concept/kernel|"
                    r"fc[12]_\d+/kernel|concept_proj/kernel|classifier/kernel|"
                    r"linear[12]/kernel|first_layer/kernel)$")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _sample(b=4):
    rng = np.random.RandomState(0)
    txt = rng.randint(1, 49405, (b, W)).astype(np.int32)
    txt[:, -1] = 49407
    return {"image": jnp.asarray(rng.randn(b, 32, 32, 3).astype(np.float32)),
            "text": jnp.asarray(txt), "key_padding_mask": jnp.zeros((b, W), bool)}


@pytest.mark.parametrize("arch", list(MODELS))
def test_init_weights_are_cmh_tpus(arch):
    model = dict({"arch": arch, "clip_variant": "tiny"}, **MODELS[arch])
    jmethod = jax_registry.get_model_class(arch).from_config(
        config_from_dict({"model": model}).model, output_dim=8, train_num=16)
    init_key = jax.random.split(jax.random.PRNGKey(1814))[1]
    want = jmethod.init_variables(init_key, _sample())["params"]
    pmethod = port_registry.require_model_class(arch).from_config(
        port_config({"model": model}).model, output_dim=8, train_num=16)
    pmethod.model.init_weights(prng.split(prng.PRNGKey(1814))[1])
    got, _ = pmethod.state_to_jax(pmethod.model.state_dict())
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(leaves) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in leaves:
        name = "/".join(k.key for k in path)
        node = got
        for k in path:
            node = node[k.key]
        a, b = np.asarray(node), np.asarray(leaf)
        assert a.shape == b.shape, name
        if NORMAL.search(name):
            scale = float(b.std()) if b.size > 1 else 1.0
            assert np.abs(a - b).max() <= 1e-6 * scale, name
            assert (a != b).mean() < 0.05, name
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (5, 123)])
def test_dnph_noise_and_twdh_ties_are_cmh_tpus(seed, step):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    np.testing.assert_array_equal(noise_vectors(seed, step, 16, 8, "cpu").numpy(),
                                  np.asarray(rand_unit_rect(key, 16, 8)))
    for bits in (16, 64):
        centers = jnp.ones((3, bits))
        ties = hash_center_multilabels(jnp.zeros((2, 3)), centers, key)[0]
        got = tie_vector(prng.fold_in(prng.PRNGKey(seed), step), bits)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ties))
    default = hash_center_multilabels(jnp.zeros((1, 3)), jnp.ones((3, 8)))[0]
    np.testing.assert_array_equal(tie_vector(None, 8).numpy(), np.asarray(default))


def test_mith_banks_are_cmh_tpus():
    model = {"arch": "MITH", "clip_variant": "tiny", "top_k_label": 4}
    labels = np.eye(4, dtype=np.float32)[np.arange(24) % 4]
    jmethod = jax_registry.get_model_class("MITH").from_config(
        config_from_dict({"model": model}).model, output_dim=8, train_num=24)
    pmethod = port_registry.require_model_class("MITH").from_config(
        port_config({"model": model}).model, output_dim=8, train_num=24)
    jmethod.train_labels = pmethod.train_labels = labels
    want, got = jmethod.init_method_state(), pmethod.init_method_state()
    for name in ("img_cls", "txt_cls", "img_tokens", "txt_tokens"):
        a, b = got[name].numpy(), np.asarray(want[name])
        assert a.shape == b.shape and np.abs(a - b).max() <= 1e-6, name
        assert (a != b).mean() < 0.05, name


STEP_MODELS = {"DCMHT": {"arch": "DCMHT"}, "DIMCH": dimch_cfg(dropout=0.3),
               "UMoED": dict(FUSION, decoder_layers=1, dropout=0.3)}


@pytest.mark.parametrize("arch", list(STEP_MODELS))
def test_one_train_step_from_one_seed(tmp_path, arch):
    extra = {k: v for k, v in STEP_MODELS[arch].items() if k not in ("arch", "clip_variant")}
    jtr = tiny_trainer(tmp_path / "jax", arch, arch + "Trainer", model_extra=extra,
                       optimizer_extra={"schedule": "warmup_constant", "warmup_proportion": 0.0,
                                        "e": 1e-3})
    cfg = jtr.cfg.to_dict()
    cfg["run"].update(save_dir=str(tmp_path / "port"), log_dir=str(tmp_path / "port_log"))
    ptr = port_registry.require_runner_class(arch + "Trainer").from_config(
        cfg=port_config(cfg), device="cpu", auto_run=False)

    def port_state(state):
        params = jax.tree_util.tree_map(np.asarray, state.params)
        return ptr.method.state_from_jax(
            params, jax.tree_util.tree_map(np.asarray, dict(state.model_state)))

    start, own = port_state(jtr.state), {k: v.clone() for k, v in ptr.model.state_dict().items()}
    batch = next(iter(jtr.train_loader))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jtr.state, jloss, _ = jtr._train_step(jtr.state, jbatch)

    # the loss of the same forward with the next step's masks (no update)
    b = ptr._to_device(batch)
    ptr.model.train()
    with torch.no_grad(), dropout_rng(prng.fold_in(ptr.dropout_base, 1)):
        outputs = ptr.model(b["image"], b["text"], b["key_padding_mask"])
        next_loss = float(ptr.method.loss(outputs, b, ptr.method_state, 0)[0])
    ptr.model.load_state_dict(own)                 # undo BatchNorm's statistics update
    assert ptr.optimizer.step_count == int(jtr.state.step) - 1 == 0
    ploss, _ = ptr.train_step(batch)
    assert ptr.optimizer.step_count == int(jtr.state.step) == 1
    assert _rel(float(ploss), float(jloss)) <= 1e-5
    if arch != "DCMHT":
        assert _rel(next_loss, float(jloss)) > 100 * 1e-5
    after, got = port_state(jtr.state), ptr.model.state_dict()
    top = max(float((after[k] - v).abs().max()) for k, v in start.items())
    for k, v in start.items():
        want_upd = (after[k] - v).numpy()
        diff = np.abs(((got[k] - own[k]) - (after[k] - v)).numpy())
        ulp = np.spacing(np.abs(after[k].numpy()))
        assert np.all(diff <= 1e-4 * np.abs(want_upd).max() + 1e-5 * top + 2 * ulp), k
