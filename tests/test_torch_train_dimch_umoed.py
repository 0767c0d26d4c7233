"""One train step of DIMCH and of UMoED in cmh_torch against cmh_tpu's, on
the CPU.

Both trainers start from the same weights (cmh_tpu's, carried over by
``models/convert.py``) and take one step on the same batch of the tiny
synthetic config (``CLIPConfig.tiny()`` in fp32, dropout 0, cmh_tpu's
Pallas kernels in interpret mode, ``CMH_TPU_FUSED=1``). The loss agrees
within 1e-5 relative and every tensor's update within 1e-4 relative (to
the largest update of cmh_tpu's, plus one ulp of the weight), BertAdam's ε
1e-3, as in ``test_torch_methods.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cmh_tpu.runners.dimch  # noqa: F401  (registers cmh_tpu's trainers)
import cmh_tpu.runners.umoed  # noqa: F401
import torch_threads  # noqa: F401  (before any torch work)
from cmh_torch.config import config_from_dict as port_config
from cmh_torch.models import convert
from cmh_torch.registry import load_components
from tests.test_torch_dimch import model_cfg as dimch_cfg
from tests.test_torch_umoed import FUSION
from tests.util_methods import tiny_trainer

port_registry = load_components()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("arch", ["DIMCH", "UMoED"])
def test_one_train_step_matches(tmp_path, monkeypatch, arch):
    monkeypatch.setenv("CMH_TPU_FUSED", "1")
    cfg = dimch_cfg() if arch == "DIMCH" else dict(FUSION, decoder_layers=1)
    extra = {k: v for k, v in cfg.items() if k not in ("arch", "clip_variant")}
    jtr = tiny_trainer(tmp_path / "jax", arch, arch + "Trainer", model_extra=extra,
                       optimizer_extra={"schedule": "warmup_constant", "warmup_proportion": 0.0,
                                        "e": 1e-3})
    cfg = jtr.cfg.to_dict()
    cfg["run"].update(save_dir=str(tmp_path / "port"), log_dir=str(tmp_path / "port_log"))
    ptr = port_registry.require_runner_class(arch + "Trainer").from_config(
        cfg=port_config(cfg), device="cpu", auto_run=False)
    to_port = {"DIMCH": convert.dimch_state_from_jax, "UMoED": convert.umoed_state_from_jax}[arch]

    def port_state(state):
        return to_port(jax.tree_util.tree_map(np.asarray, state.params))

    start = port_state(jtr.state)
    ptr.model.load_state_dict(start, strict=True)
    batch = next(iter(jtr.train_loader))
    jtr.state, jloss, _ = jtr._train_step(jtr.state, {k: jnp.asarray(v) for k, v in batch.items()})
    ploss, _ = ptr.train_step(batch)
    assert _rel(float(ploss), float(jloss)) <= 1e-5
    after = port_state(jtr.state)
    got = ptr.model.state_dict()
    for k, v in start.items():
        want_upd = (after[k] - v).numpy()
        diff = np.abs((got[k] - after[k]).numpy())
        ulp = np.spacing(np.abs(after[k].numpy()))
        assert np.all(diff <= 1e-4 * np.abs(want_upd).max() + ulp), k
