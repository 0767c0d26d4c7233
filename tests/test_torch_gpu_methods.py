"""The Baseline, DSPH, DNPH, MITH and TwDH trainers on the card, tiny shapes
(``CLIPConfig.tiny()`` in fp32, TF32 off).

Marked ``gpu``; each test skips inside itself when no CUDA device is
present. Run on the card with:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_methods.py

One train step on the card equals the same step on the CPU (the kernels
against the plain versions: only the order of fp32 sums differs, 1e-4
relative on the loss, 1e-3 on each gradient tensor). ``run.remat`` on the
card launches K1-fwd and K2-fwd twice a step and gives the gradients of the
step without it (the same kernels in the same order: bit-equal). MITH's
concept transformer launches the fp32 K1 and K2 kernels (8 and 2 a step
each way, beside the towers' 11 and 2); those kernels at its shapes equal
their plain versions (1e-5 relative, fp32 sums in another order), and the
fp32 attention backward holds K ≤ 117 concept tokens at head dim 64 in
shared memory and runs more on the row-tiled kernels. TwDH's ``valid`` at a 512-bit long code
runs K3 on int16 words and its mAPs equal the plain counting rank's
(1e-12); a 512-bit search through K4 equals ``search_cpu``. DIMCH's and
UMoED's train steps on the card equal the CPU's, UMoED's decoder launching
the fp32 K1 (3 a decoder layer, a head call, forward and backward); the
text tower without the key-padding mask (DIMCH and UMoED) runs K2 with the
causal mask alone, within one bf16 step of the plain version; K1 in fp32 at
the full-width decoder's (6400, 512) equals its plain version (1e-5); and
the server's two backends answer alike from a CUDA index.
"""

import pytest
import torch_threads  # noqa: F401  (before any torch work)
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


def trainer(tmp_path, arch, device, remat=False, **model_extra):
    cfg = {"model": {"arch": arch, "clip_path": "/nonexistent.pt", "clip_variant": "tiny",
                     "hash_func": "softmax" if arch == "TwDH" else "tanh", "numclass": 4,
                     "noise_alpha": 0.1, **model_extra},
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


@pytest.mark.parametrize("arch", ["Baseline", "DSPH", "DNPH", "MITH"])
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


def test_mith_concept_transformer_launches_the_fp32_kernels(cuda, tmp_path):
    from cmh_torch.ops.attention import attention_bwd
    from cmh_torch.ops.layernorm import layernorm_bwd

    tr = trainer(tmp_path, "MITH", "cuda")
    batch = next(iter(tr.train_loader))
    counters = (fused_layernorm, layernorm_bwd, fused_attention, attention_bwd)
    for c in counters:
        c.launches = c.launches_fp32 = 0
    tr.train_step(batch)
    torch.cuda.synchronize()
    # the tiny towers are fp32 too: 11 and 2, then MITH's 8 and 2
    assert [(c.launches, c.launches_fp32) for c in counters] == \
        [(19, 19), (19, 19), (4, 4), (4, 4)]


@pytest.mark.parametrize("k", [16, 64, 117, 128])
def test_fp32_kernels_at_mith_concept_shapes(cuda, k):
    from cmh_torch.ops.attention import attention_bwd, attention_bwd_plain, attention_plain
    from cmh_torch.ops.layernorm import layernorm_bwd, layernorm_bwd_plain, layernorm_plain

    gen = torch.Generator(device="cuda").manual_seed(k)
    x = torch.randn(8 * k, 512, generator=gen, device="cuda")
    g, b = (torch.randn(512, generator=gen, device="cuda") for _ in range(2))
    torch.testing.assert_close(fused_layernorm(x, g, b), layernorm_plain(x, g, b),
                               rtol=1e-5, atol=1e-5)
    for got, want in zip(layernorm_bwd(x, g, x), layernorm_bwd_plain(x, g, x)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    q, kk, v, do = (torch.randn(8, 8, k, 64, generator=gen, device="cuda") for _ in range(4))
    scale = 64**-0.5
    torch.testing.assert_close(fused_attention(q, kk, v, scale),
                               attention_plain(q, kk, v, scale), rtol=1e-5, atol=1e-5)
    # above 117 concept tokens the fp32 backward runs on the row-tiled kernels
    before = attention_bwd.launches_tiled
    for got, want in zip(attention_bwd(q, kk, v, scale, None, None, do),
                         attention_bwd_plain(q, kk, v, scale, None, None, do)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert attention_bwd.launches_tiled - before == int(k > 117)


def test_twdh_512_bit_valid_and_search(cuda, tmp_path):
    import numpy as np

    from cmh_torch.ops.map_bucketed import calc_map_k_4dir
    from cmh_torch.ops.map_kernel import map_hist
    from cmh_torch.serving import RetrievalIndex

    tr = trainer(tmp_path, "TwDH", "cuda", long_dim=512, short_dims=[16],
                 long_center="/nonexistent", short_center="/nonexistent",
                 trans_matrix="/nonexistent")
    q = tr.get_code(tr.query_loader, tr.query_num)
    r = tr.get_code(tr.retrieval_loader, tr.retrieval_num)
    assert q[0].shape == (16, 512) and q[2]["16"].shape == (16, 16)
    map_hist.launches = 0
    got = tr.calc_map_4dir(q[0], q[1], r[0], r[1], None)
    torch.cuda.synchronize()
    assert map_hist.launches == 1
    want = calc_map_k_4dir(*(t.cpu() for t in (q[0], q[1], r[0], r[1], tr.query_labels,
                                               tr.retrieval_labels)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    index = RetrievalIndex(512, device="cuda")
    index.add(r[0])
    for a, b in zip(index.search(q[1], topk=10), index.search_cpu(q[1].cpu(), topk=10)):
        np.testing.assert_array_equal(a, b)


UMOED = {"setDim": 4, "MoE": True, "fusion": True, "num_experts": 2, "slots_per_expert": 2,
         "decoder_heads": 2, "decoder_layers": 2, "hidden_dim": 32, "dropout": 0.0,
         "hash_func": "linear_subspace", "merge_func": "concatenate", "extreme_T": 0.3,
         "distance": {"mode": "pairwise"}}
DIMCH = {"setDim": 4, "dropout": 0.0, "distance": {"mode": "smooth_chamfer"}}


@pytest.mark.parametrize("arch", ["DIMCH", "UMoED"])
def test_dimch_umoed_train_step_on_the_card_equals_the_cpu(cuda, tmp_path, arch):
    from cmh_torch.ops.layernorm import layernorm_bwd

    extra = UMOED if arch == "UMoED" else DIMCH
    card = trainer(tmp_path / "card", arch, "cuda", **extra)
    cpu = trainer(tmp_path / "cpu", arch, "cpu", **extra)
    cpu.model.load_state_dict(card.model.state_dict())
    batch = next(iter(cpu.train_loader))
    counters = (fused_layernorm, layernorm_bwd, fused_attention)
    for c in counters:
        c.launches = c.launches_fp32 = 0
    loss_card = float(card.train_step(batch)[0])
    torch.cuda.synchronize()
    # the tiny towers: 11 K1 and 2 K2 (causal only on the text side); UMoED's
    # decoder 3 K1 a layer in each of its two head calls, its attention explicit
    k1 = 11 + (3 * 2 * 2 if arch == "UMoED" else 0)
    assert [(c.launches, c.launches_fp32) for c in counters] == [(k1, k1), (k1, k1), (2, 2)]
    loss_cpu = float(cpu.train_step(batch)[0])
    assert abs(loss_card - loss_cpu) <= 1e-4 * abs(loss_cpu)
    gc, gp = _grads(card), _grads(cpu)
    assert gc.keys() == gp.keys()
    for n, g in gp.items():
        assert float((gc[n] - g).abs().max()) <= 1e-3 * float(g.abs().max()) + 1e-7, n


def test_causal_text_attention_without_kpm_on_the_card(cuda):
    from test_torch_gpu_kernels import assert_within_one_bf16_step

    from cmh_torch.ops.attention import attention_bwd, attention_bwd_plain, attention_plain

    g = torch.Generator(device="cuda").manual_seed(32)
    b, h, s = 100, 8, 32
    qkv = torch.randn(b, s, 3 * h * 64, generator=g, device="cuda").bfloat16()
    q, k, v = (t.reshape(b, s, h, 64).transpose(1, 2) for t in qkv.split(h * 64, -1))
    do = torch.randn(b, s, h * 64, generator=g, device="cuda").bfloat16()
    do = do.reshape(b, s, h, 64).transpose(1, 2)
    mask = torch.full((s, s), float("-inf"), device="cuda").triu(1)
    scale = 64**-0.5
    assert_within_one_bf16_step(fused_attention(q, k, v, scale, mask, None),
                                attention_plain(q, k, v, scale, mask, None))
    for a, r in zip(attention_bwd(q, k, v, scale, mask, None, do),
                    attention_bwd_plain(q, k, v, scale, mask, None, do)):
        assert_within_one_bf16_step(a, r)


def test_fp32_layernorm_at_the_umoed_decoder_rows(cuda):
    from cmh_torch.ops.layernorm import layernorm_bwd, layernorm_bwd_plain, layernorm_plain

    gen = torch.Generator(device="cuda").manual_seed(64)
    x, do = (torch.randn(6400, 512, generator=gen, device="cuda") for _ in range(2))
    gamma, beta = (torch.randn(512, generator=gen, device="cuda") for _ in range(2))
    torch.testing.assert_close(fused_layernorm(x, gamma, beta), layernorm_plain(x, gamma, beta),
                               rtol=1e-5, atol=1e-5)
    got, want = layernorm_bwd(x, gamma, do), layernorm_bwd_plain(x, gamma, do)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    for a, r in zip(got[1:], want[1:]):        # sums over 6400 rows in another order
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-3)


def test_server_backends_on_the_card_agree(cuda):
    from cmh_torch.server import RetrievalApp
    from cmh_torch.serving import RetrievalIndex

    gen = torch.Generator(device="cuda").manual_seed(5)
    index = RetrievalIndex(64, device="cuda")
    index.add(torch.randint(0, 2, (5000, 64), generator=gen, device="cuda").float() * 2 - 1)
    q = (torch.randint(0, 2, (4, 64), generator=gen, device="cuda").float() * 2 - 1).tolist()
    answers = [RetrievalApp(index, backend=b).search({"codes": q, "topk": 10})
               for b in ("device", "cpu")]
    assert answers[0] == answers[1]
    assert RetrievalApp(index).healthz()["device"] == "cuda"
