"""Three DCMHT train steps and one ``valid`` of cmh_torch against cmh_tpu's
``DCMHTTrainer`` with ``CMH_TPU_FUSED=0``: cmh_tpu takes XLA's lowering
(einsum attention with q scaled in the compute dtype, ``nn.Conv`` patch
embedding, autograd of the LayerNorm), so the last bits move more than
under ``CMH_TPU_FUSED=1`` and the tolerances are looser (``FUSED_TOL``).
Same trajectory otherwise (``tests/test_torch_train_fused.py``).
"""

import numpy as np
import pytest

import torch_threads  # noqa: F401  (before any torch work)
from tests.test_torch_train_fused import FUSED_TOL, STEPS, check_params, check_valid, run_pair

FLAG = "0"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_pair(tmp_path_factory.mktemp("xla"), FLAG)


@pytest.mark.parametrize("step", range(STEPS))
def test_loss_matches(runs, step):
    np.testing.assert_allclose(runs["port"]["loss"][step], runs["jax"]["loss"][step],
                               rtol=FUSED_TOL[FLAG]["loss"])


@pytest.mark.parametrize("step", range(STEPS))
def test_params_and_batchnorm_stats_match(runs, step):
    check_params(runs, step, FLAG)


def test_valid_codes_and_maps_match(runs):
    check_valid(runs)
