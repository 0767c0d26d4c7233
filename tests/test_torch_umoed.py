"""UMoED in cmh_torch against cmh_tpu on the CPU: the model, its codes, its
loss and its trainer (the blocks are in ``test_torch_umoed_blocks.py``, one
train step in ``test_torch_train_dimch_umoed.py``).

Inputs come from numpy seeds; models use ``CLIPConfig.tiny()`` in fp32 with
dropout 0 and cmh_tpu runs its Pallas kernels in interpret mode
(``CMH_TPU_FUSED=1``), fused (one Soft-MoE head) and non-fused (plain FFNs,
a first layer, a head a modality). Weights cross both ways through
``convert.umoed_state_from_jax`` / ``umoed_state_to_jax`` and
``torch_import.umoed_from_torch_state``. Tolerances: head outputs, losses
and their gradients 1e-5 relative (to the largest magnitude of the
reference); ``linear_subspace`` codes exact, except slots whose top two
logits lie within 1e-5 (relative) of each other, which are counted and
printed; a cmh_tpu ``model-N.msgpack`` in test mode gives cmh_tpu's
``.mat`` codes exactly and its mAPs within 1e-6. The CLI run resumes
bit-equal, with the four best mAPs and their epochs carried by the
checkpoint's ``extra`` meta.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as scio
import torch_threads  # noqa: F401  (before any torch work)
import torch
import yaml

import cmh_tpu.models.umoed as jax_umoed
import cmh_tpu.runners.umoed  # noqa: F401  (registers cmh_tpu's UMoED)
from cmh_torch.config import config_from_dict as port_config
from cmh_torch.main import main as port_main
from cmh_torch.models import convert
from cmh_torch.registry import load_components
from cmh_tpu.config import config_from_dict
from cmh_tpu.models import torch_import
from tests.util_methods import tiny_trainer

port_registry = load_components()
CLASSES, BATCH, W = 4, 6, 12
LOSS = {"extreme": True, "extreme_T": 0.3, "triplet": True, "distance_mode": "cosine",
        "distance": {"mode": "pairwise"},
        "chamfer": {"unif_alpha": 0.8, "token_triplet_margin": 0.1},
        "hash_pars": {"triplet_alpha": 1}}
# fusion with the Soft-MoE FFN; non-fusion with plain FFNs and a first layer
FUSION = {"arch": "UMoED", "clip_variant": "tiny", "setDim": 4, "MoE": True, "fusion": True,
          "num_experts": 2, "slots_per_expert": 2, "decoder_heads": 2, "decoder_layers": 2,
          "hidden_dim": 32, "dropout": 0.0, "hash_func": "linear_subspace",
          "merge_func": "concatenate", **LOSS}
SPLIT = dict(FUSION, MoE=False, fusion=False, hidden_dim=16)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _inputs(seed=0, b=BATCH):
    rng = np.random.RandomState(seed)
    img = rng.randn(b, 32, 32, 3).astype(np.float32)
    txt = rng.randint(1, 49405, (b, W)).astype(np.int32)
    txt[:, 0] = 49406
    kpm = np.zeros((b, W), bool)
    for i, n in enumerate(rng.randint(3, W + 1, b)):
        txt[i, n - 1] = 49407
        txt[i, n:] = 0
        kpm[i, n:] = True
    return img, txt, kpm


def _pair(cfg, output_dim=8):
    jmethod = jax_umoed.UMoEDMethod.from_config(config_from_dict({"model": cfg}).model,
                                                output_dim=output_dim)
    img, txt, kpm = _inputs()
    variables = jmethod.init_variables(jax.random.PRNGKey(1), {
        "image": jnp.asarray(img), "text": jnp.asarray(txt), "key_padding_mask": jnp.asarray(kpm)})
    variables = jax.tree_util.tree_map(np.asarray, variables)
    pmethod = port_registry.require_model_class("UMoED").from_config(
        port_config({"model": cfg}).model, output_dim=output_dim)
    pmethod.model.load_state_dict(convert.umoed_state_from_jax(variables["params"]),
                                  strict=True)
    return jmethod, variables, pmethod


@pytest.fixture(scope="module")
def pairs():
    return {"fusion": _pair(FUSION), "split": _pair(SPLIT)}


@pytest.mark.parametrize("which", ["fusion", "split"])
def test_weights_cross_both_ways(pairs, which):
    _, variables, pmethod = pairs[which]
    sd = pmethod.model.state_dict()
    assert ("hash.hash_module.decoder.layers.0.moe.experts.weight" in sd) == (which == "fusion")
    assert ("hash.txt_token_hash.first_layer.weight" in sd) == (which == "split")
    back, model_state = torch_import.umoed_from_torch_state(sd, decoder_layers=2)
    want = dict(jax.tree_util.tree_leaves_with_path(variables["params"]))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert got.keys() == want.keys() and model_state == {}
    for path, a in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), a, err_msg=str(path))
    params, _ = convert.umoed_state_to_jax(sd)
    mine = dict(jax.tree_util.tree_leaves_with_path(params))
    assert mine.keys() == want.keys()
    for path, a in want.items():
        np.testing.assert_array_equal(mine[path], a, err_msg=str(path))


def _near_ties(logits, rtol=1e-5):
    """Slots whose top two logits lie within ``rtol`` of the largest."""
    top = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    return np.abs(top[..., 1] - top[..., 0]) <= rtol * np.abs(np.asarray(logits)).max()


def _assert_codes(pcodes, jcodes, jembeds, bits):
    """linear_subspace codes exact, but in the slots of a near tie."""
    ties = _near_ties(jembeds)
    print(f"linear_subspace slots with a near tie: {int(ties.sum())} of {ties.size}")
    keep = np.repeat(~ties, bits, axis=1)
    np.testing.assert_array_equal(np.asarray(pcodes)[keep], np.asarray(jcodes)[keep])


@pytest.mark.parametrize("which", ["fusion", "split"])
def test_forward_outputs_and_codes_match_in_eval(pairs, which, monkeypatch):
    monkeypatch.setenv("CMH_TPU_FUSED", "1")
    jmethod, variables, pmethod = pairs[which]
    img, txt, kpm = _inputs(2)
    ji = jmethod.module.apply(variables, jnp.asarray(img), method=lambda m, x: m.encode_image(
        x, train=False, with_embeds=True))
    jt = jmethod.module.apply(variables, jnp.asarray(txt), jnp.asarray(kpm),
                              method=lambda m, t, k: m.encode_text(t, k, train=False,
                                                                   with_embeds=True))
    pmethod.model.eval()
    with torch.no_grad():
        pi = pmethod.model.encode_image(torch.from_numpy(img), with_embeds=True)
        pt = pmethod.model.encode_text(torch.from_numpy(txt), torch.from_numpy(kpm),
                                       with_embeds=True)
    for got, want in ((pi, ji), (pt, jt)):
        assert _rel(got[0].numpy(), want[0]) <= 1e-5
        assert got[1].shape == (BATCH, pmethod.eval_code_dims()) == (BATCH, 8)
        _assert_codes(pmethod.make_hash_code(got[1]).numpy(),
                      jmethod.make_hash_code(want[1]), want[0], 2)
    if which == "fusion":
        jf = jmethod.module.apply(variables, jnp.asarray(img), jnp.asarray(txt), jnp.asarray(kpm),
                                  method=lambda m, i, t, k: m.encode_fusion(i, t, k, train=False))
        with torch.no_grad():
            pf = pmethod.model.encode_fusion(torch.from_numpy(img), torch.from_numpy(txt),
                                             torch.from_numpy(kpm))
        assert pf[0].shape == (BATCH, 4, 4) and _rel(pf[0].numpy(), jf[0]) <= 1e-5


def test_nonfusion_compat_routes_text_through_the_image_head(pairs):
    _, _, pmethod = pairs["split"]
    m = pmethod.model
    assert m._txt_head() is m.hash.txt_token_hash
    m.compat_nonfusion_txt_via_img = True
    try:
        assert m._txt_head() is m.hash.img_token_hash
    finally:
        m.compat_nonfusion_txt_via_img = False
    with pytest.raises(ValueError, match="fusion"):
        m.encode_fusion(*map(torch.from_numpy, _inputs(1)))


def test_from_config_defaults_match_cmh_tpu():
    """A config without hash_func, merge_func and num_experts builds
    cmh_tpu's model: softmax (twice the bits), mean, 3 experts."""
    cfg = {"arch": "UMoED", "clip_variant": "tiny", "setDim": 4, "MoE": True,
           "decoder_layers": 1, "hidden_dim": "embed"}
    jm = jax_umoed.UMoEDMethod.from_config(config_from_dict({"model": cfg}).model, output_dim=8)
    pm = port_registry.require_model_class("UMoED").from_config(cfg, output_dim=8)
    assert (pm.model.output_dim, pm.model.hash_func, pm.model.merge_func) == (
        jm.module.output_dim, jm.module.hash_func, jm.module.merge_func) == (16, "softmax", "mean")
    moe = pm.model.hash.hash_module.decoder.layers[0].moe
    assert moe.phi.shape == (2048, 3, 8) and pm.eval_code_dims() == jm.eval_code_dims()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + k + "/") if isinstance(v, dict)
                   else {prefix + k: float(v)})
    return out


@pytest.mark.parametrize("branch", ["triplet pairwise", "triplet chamfer", "bayesian"])
def test_loss_and_gradients_match(branch):
    cfg = dict(FUSION)
    if branch == "triplet chamfer":
        cfg["distance"] = {"mode": "smooth_chamfer"}
    if branch == "bayesian":
        cfg["triplet"] = False
    jloss_fn = jax_umoed.UMoEDMethod.from_config(config_from_dict({"model": cfg}).model,
                                                 output_dim=8).loss
    ploss_fn = port_registry.require_model_class("UMoED").from_config(
        port_config({"model": cfg}).model, output_dim=8).loss
    rng = np.random.RandomState(5)
    outs = [rng.randn(8, 4, 4).astype(np.float32), np.sign(rng.randn(8, 8)).astype(np.float32),
            rng.randn(8, 4, 4).astype(np.float32), np.sign(rng.randn(8, 8)).astype(np.float32)]
    labels = (rng.rand(8, CLASSES) > 0.5).astype(np.float32)
    labels[np.arange(8), rng.randint(0, CLASSES, 8)] = 1

    def jloss(a, c):
        total, ld, _ = jloss_fn((a, jnp.asarray(outs[1]), c, jnp.asarray(outs[3])),
                                {"label": jnp.asarray(labels)}, {}, 0)
        return total, ld

    (jtotal, jld), jgrads = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(outs[0]), jnp.asarray(outs[2]))
    ta, tc = torch.from_numpy(outs[0]).requires_grad_(), torch.from_numpy(outs[2]).requires_grad_()
    total, ld, _ = ploss_fn((ta, torch.from_numpy(outs[1]), tc, torch.from_numpy(outs[3])),
                            {"label": torch.from_numpy(labels)}, {}, 0)
    total.backward()
    assert _rel(float(total.detach()), float(jtotal)) <= 1e-5
    want, got = _flat(jax.tree_util.tree_map(float, jld)), _flat(ld)
    assert got.keys() == want.keys()
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-5, k
    for t, g in zip((ta, tc), jgrads):
        assert torch.isfinite(t.grad).all() and _rel(t.grad.numpy(), g) <= 1e-5


def _extra(cfg):
    return {k: v for k, v in cfg.items() if k not in ("arch", "clip_variant")}


def test_test_mode_from_a_cmh_tpu_file_gives_cmh_tpu_maps(tmp_path, monkeypatch):
    monkeypatch.setenv("CMH_TPU_FUSED", "1")
    extra = dict(_extra(FUSION), decoder_layers=1)
    src = tiny_trainer(tmp_path / "src", "UMoED", "UMoEDTrainer", model_extra=extra)
    src.save_model(str(tmp_path), 0)
    jtr = tiny_trainer(tmp_path / "jax", "UMoED", "UMoEDTrainer", model_extra=extra,
                       run_extra={"is_train": False,
                                  "resume_model": str(tmp_path / "model-0.msgpack")})
    jmaps = jtr.test()
    cfg = jtr.cfg.to_dict()
    cfg["run"].update(save_dir=str(tmp_path / "port"), log_dir=str(tmp_path / "port_log"))
    ptr = port_registry.require_runner_class("UMoEDTrainer").from_config(
        cfg=port_config(cfg), device="cpu", auto_run=False)
    pmaps = ptr.test()
    jmat = scio.loadmat(os.path.join(jtr.save_dir, "mat_files", "test.mat"))
    pmat = scio.loadmat(os.path.join(ptr.save_dir, "mat_files", "test.mat"))
    for key in ("q_img", "q_txt", "r_img", "r_txt", "q_l", "r_l"):
        np.testing.assert_array_equal(pmat[key], jmat[key], err_msg=key)
    np.testing.assert_allclose(pmaps, jmaps, rtol=0, atol=1e-6)


BESTS = ("max_mapi2t", "max_mapt2i", "max_mapi2i", "max_mapt2t", "best_epoch_i",
         "best_epoch_t", "best_epoch_i2i", "best_epoch_t2t")


def test_cli_trains_validates_four_ways_and_resumes(tmp_path):
    cfg = {"model": dict(FUSION, clip_path="/nonexistent.pt", dropout=0.1, decoder_layers=1),
           "optimizer": {"arch": "BertAdam", "lr": 0.002, "clip_lr": 0.0005},
           "dataset": {"arch": "synthetic_dataset", "name": "synthetic",
                       "num_classes": CLASSES, "image_resolution": 32, "max_word": W},
           "run": {"arch": "UMoEDTrainer", "output_dim": 8, "batch_size": 16, "is_train": True,
                   "train_num": 32, "query_num": 16, "epochs": 3, "display_step": 1000,
                   "seed": 5, "checkpoint_every": 1, "auto_resume": True,
                   "log_dir": str(tmp_path / "log")}}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    argv = ["--config-file", str(path), "--save-dir", str(tmp_path / "out"), "--device", "cpu"]
    first = port_main(argv)
    hist = first.history
    assert [h["epoch"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) and len(h["maps"]) == 4 for h in hist)
    for i, (best, epoch) in enumerate((("max_mapi2t", "best_epoch_i"),
                                       ("max_mapt2i", "best_epoch_t"),
                                       ("max_mapi2i", "best_epoch_i2i"),
                                       ("max_mapt2t", "best_epoch_t2t"))):
        maps = [h["maps"][i] for h in hist]
        assert getattr(first, best) == max(maps) and getattr(first, epoch) == int(np.argmax(maps))
    files = sorted(os.listdir(os.path.join(first.save_dir, "mat_files")))
    assert files == ["i2i-best.mat", "i2t-best.mat", "last.mat", "t2i-best.mat", "t2t-best.mat"]
    assert not [p for p in os.listdir(first.save_dir) if p.startswith("model-")]
    mat = scio.loadmat(os.path.join(first.save_dir, "mat_files", "last.mat"))
    assert mat["q_img"].shape == mat["q_fus"].shape == (16, 8) and not mat["r_fus"].any()
    assert set(np.unique(mat["q_img"])) <= {-1.0, 1.0}
    again = port_main(argv)
    assert again.history == [] and again.global_step == first.global_step
    assert [getattr(again, b) for b in BESTS] == [getattr(first, b) for b in BESTS]
    sa, sb = first.model.state_dict(), again.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
