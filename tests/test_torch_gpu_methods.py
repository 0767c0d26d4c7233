"""The Baseline, DSPH and DNPH trainers on the card, tiny shapes
(``CLIPConfig.tiny()`` in fp32, TF32 off).

Marked ``gpu``; each test skips inside itself when no CUDA device is
present. Run on the card with:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_methods.py

One train step on the card equals the same step on the CPU (the kernels
against the plain versions: only the order of fp32 sums differs, 1e-4
relative on the loss, 1e-3 on each gradient tensor). ``run.remat`` on the
card launches K1-fwd and K2-fwd twice a step and gives the gradients of the
step without it (the same kernels in the same order: bit-equal).
"""

import pytest
import torch

from cmh_torch.config import config_from_dict
from cmh_torch.ops.attention import fused_attention
from cmh_torch.ops.layernorm import fused_layernorm
from cmh_torch.registry import load_components

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def trainer(tmp_path, arch, device, remat=False):
    cfg = {"model": {"arch": arch, "clip_path": "/nonexistent.pt", "clip_variant": "tiny",
                     "hash_func": "tanh", "numclass": 4, "noise_alpha": 0.1},
           "optimizer": {"arch": "BertAdam", "lr": 0.002, "hyp": {"lr": 0.02},
                         "loss": {"lr": 0.01}},
           "dataset": {"arch": "synthetic_dataset", "name": "synthetic", "num_classes": 4,
                       "image_resolution": 32, "max_word": 12},
           "run": {"arch": arch + "Trainer", "save_dir": str(tmp_path),
                   "log_dir": str(tmp_path / "log"), "output_dim": 8, "batch_size": 16,
                   "train_num": 32, "query_num": 16, "epochs": 1, "display_step": 1000,
                   "seed": 5, "remat": remat}}
    cls = load_components().require_runner_class(arch + "Trainer")
    return cls.from_config(cfg=config_from_dict(cfg), device=device, auto_run=False)


def _grads(tr):
    return {n: p.grad.detach().cpu() for n, p in tr.model.named_parameters()
            if p.grad is not None}


@pytest.mark.parametrize("arch", ["Baseline", "DSPH", "DNPH"])
def test_train_step_on_the_card_equals_the_cpu(cuda, tmp_path, arch):
    card, cpu = trainer(tmp_path / "card", arch, "cuda"), trainer(tmp_path / "cpu", arch, "cpu")
    batch = next(iter(cpu.train_loader))
    loss_card, loss_cpu = float(card.train_step(batch)[0]), float(cpu.train_step(batch)[0])
    assert abs(loss_card - loss_cpu) <= 1e-4 * abs(loss_cpu)
    gc, gp = _grads(card), _grads(cpu)
    assert gc.keys() == gp.keys()
    for n, g in gp.items():
        assert float((gc[n] - g).abs().max()) <= 1e-3 * float(g.abs().max()) + 1e-7, n


def test_remat_on_the_card_launches_the_forward_twice(cuda, tmp_path):
    runs = {}
    for remat in (False, True):
        tr = trainer(tmp_path / str(remat), "DSPH", "cuda", remat=remat)
        batch = next(iter(tr.train_loader))
        fused_layernorm.launches = fused_attention.launches = 0
        tr.train_step(batch)
        torch.cuda.synchronize()
        runs[remat] = (fused_layernorm.launches, fused_attention.launches, _grads(tr))
    assert runs[False][:2] == (11, 2) and runs[True][:2] == (22, 4)
    for n, g in runs[False][2].items():
        assert torch.equal(runs[True][2][n], g), n
