"""Three DCMHT train steps and one ``valid`` of cmh_torch against cmh_tpu's
``DCMHTTrainer`` with ``CMH_TPU_FUSED=1``: cmh_tpu runs its Pallas kernels
(LayerNorm and attention forward and backward) in interpret mode, whose
formulas the port's kernels and their plain versions follow.

Both trainers start from the same tiny-CLIP weights (cmh_tpu's init carried
into the port by ``models/convert.py``) and take the same host batches. The
loss, every parameter and the BatchNorm running statistics are compared
after each step; the codes and the four mAPs after ``valid``. The
trajectory is built once per file (interpret-mode compiles are slow);
``tests/test_torch_train_xla.py`` reuses ``run_pair`` with the flag at 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (before any torch work)
import torch

from cmh_torch.config import config_from_dict as port_config
from cmh_torch.models.convert import dcmht_state_from_jax
from cmh_torch.runners.dcmht import DCMHTTrainer as PortTrainer
from tests.util_methods import tiny_trainer

FLAG = "1"
STEPS = 3
# Absolute tolerance on fp32 parameters and relative on the loss after up to
# three steps. Flag 1: the same formulas, only fp32 summation order differs;
# BertAdam's m / (sqrt(v) + 1e-6) normalises each element's step, so for an
# element whose gradient is near 0 a last-bit gradient difference moves its
# step by a few percent of lr (0.002 here): 5e-5 is 2.5% of one step. Flag 0:
# cmh_tpu scales q in the compute dtype, uses nn.Conv and differentiates its
# LayerNorm by autograd, which moves more last bits.
FUSED_TOL = {"1": {"loss": 1e-5, "param": 5e-5},
             "0": {"loss": 1e-4, "param": 1e-4}}
# Parameters that only shift the input of the image head's training-mode
# BatchNorm by a per-feature constant: BatchNorm subtracts the batch mean, so
# their true gradient is exactly 0 and both packages see rounding noise
# (about 1e-7), which BertAdam's m / (sqrt(v) + 1e-6) magnifies into steps of
# up to about 1.8 lr. For them the test checks the gradient is noise and the
# value stays within that step bound of cmh_tpu's.
BN_ABSORBED = {"backbone.visual.ln_post.bias": 0.0005,      # clip_lr of tiny_trainer
               "hash.img_hash.atten.in_proj_bias": 0.002,   # head lr
               "hash.img_hash.atten.out_proj.bias": 0.002}


def _jax_state(tr):
    params = jax.tree_util.tree_map(np.asarray, tr.state.params)
    stats = jax.tree_util.tree_map(np.asarray, tr.state.model_state["batch_stats"])
    return {k: v.numpy() for k, v in dcmht_state_from_jax(params, stats).items()}


def _port_state(tr):
    return {k: v.detach().cpu().numpy().copy() for k, v in tr.model.state_dict().items()}


def flat_dict(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_dict(v, prefix + k + "/"))
        else:
            out[prefix + k] = float(v.detach() if torch.is_tensor(v) else v)
    return out


def run_pair(tmp, flag):
    """Build both trainers under ``CMH_TPU_FUSED=flag``, step both STEPS
    times on the same batches, then run ``valid`` on both."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CMH_TPU_FUSED", flag)
        jtr = tiny_trainer(tmp / "jax", "DCMHT", "DCMHTTrainer",
                           model_extra={"hash_func": "softmax"},
                           run_extra={"epochs": 3}, batch=16)
        cfg = jtr.cfg.to_dict()
        cfg["run"].update(save_dir=str(tmp / "port"), log_dir=str(tmp / "port_log"))
        ptr = PortTrainer.from_config(cfg=port_config(cfg), device="cpu",
                                      auto_run=False)
        ptr.model.load_state_dict(
            {k: torch.from_numpy(v) for k, v in _jax_state(jtr).items()})
        batches = list(jtr.train_loader)
        out = {side: {"loss": [], "state": []} for side in ("jax", "port")}
        for i in range(STEPS):
            b = batches[i % len(batches)]
            jtr.state, loss, ld = jtr._train_step(
                jtr.state, {k: jnp.asarray(v) for k, v in b.items()})
            out["jax"]["loss"].append(float(loss))
            out["jax"]["state"].append(_jax_state(jtr))
            ploss, pld = ptr.train_step(b)
            if i == 0:
                out["port"]["grad_max"] = {
                    n: float(p.grad.abs().max()) for n, p in
                    ptr.model.named_parameters() if p.grad is not None}
            out["port"]["loss"].append(float(ploss))
            out["port"]["state"].append(_port_state(ptr))
        out["jax"]["loss_dict"] = flat_dict(jax.tree_util.tree_map(float, ld))
        out["port"]["loss_dict"] = flat_dict(pld)
        for side, tr in (("jax", jtr), ("port", ptr)):
            codes = (tr.get_code(tr.query_loader, tr.query_num)
                     + tr.get_code(tr.retrieval_loader, tr.retrieval_num))
            out[side]["codes"] = [np.asarray(c) for c in codes]
            out[side]["maps"] = tr.valid(0)
        out["port"]["maps_on_jax_codes"] = ptr.calc_map_4dir(
            *(torch.from_numpy(np.array(c)) for c in out["jax"]["codes"]), None)
    return out


def check_params(runs, step, flag):
    want, got = runs["jax"]["state"][step], runs["port"]["state"][step]
    assert set(want) == set(got)
    for name in want:
        atol = (2.0 * (step + 1) * BN_ABSORBED[name] if name in BN_ABSORBED
                else FUSED_TOL[flag]["param"])
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=atol,
                                   err_msg=name)


def check_valid(runs):
    """Codes equal; the four mAPs of ``valid`` equal cmh_tpu's, and the
    port's counting rank on cmh_tpu's own codes gives cmh_tpu's mAPs (fp32
    sums there against fp64 here)."""
    for got, want in zip(runs["port"]["codes"], runs["jax"]["codes"]):
        np.testing.assert_array_equal(got, want)
        assert set(np.unique(got)) <= {-1.0, 1.0}
    np.testing.assert_allclose(runs["port"]["maps_on_jax_codes"],
                               runs["jax"]["maps"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(runs["port"]["maps"], runs["jax"]["maps"],
                               rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_pair(tmp_path_factory.mktemp("fused"), FLAG)


@pytest.mark.parametrize("step", range(STEPS))
def test_loss_matches(runs, step):
    np.testing.assert_allclose(runs["port"]["loss"][step], runs["jax"]["loss"][step],
                               rtol=FUSED_TOL[FLAG]["loss"])


@pytest.mark.parametrize("step", range(STEPS))
def test_params_and_batchnorm_stats_match(runs, step):
    check_params(runs, step, FLAG)


def test_batchnorm_absorbed_biases_get_only_noise(runs):
    grads = runs["port"]["grad_max"]
    for name in BN_ABSORBED:
        assert grads[name] < 1e-5, (name, grads[name])
    assert min(g for n, g in grads.items() if n not in BN_ABSORBED) > 1e-3


def test_loss_dict_matches(runs):
    want, got = runs["jax"]["loss_dict"], runs["port"]["loss_dict"]
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=FUSED_TOL[FLAG]["loss"],
                                   atol=1e-6, err_msg=k)


def test_valid_codes_and_maps_match(runs):
    check_valid(runs)
