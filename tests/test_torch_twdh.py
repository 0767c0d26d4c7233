"""TwDH and the hash-center ops in cmh_torch against cmh_tpu on the CPU.

Inputs come from numpy seeds; models use ``CLIPConfig.tiny()`` in fp32 and
cmh_tpu runs its Pallas kernels in interpret mode (``CMH_TPU_FUSED=1``).
Weights cross both ways through ``convert.twdh_state_from_jax`` and
``torch_import.twdh_from_torch_state``. Tolerances: head outputs, losses
and their gradients 1e-5 relative (to the largest magnitude of the
reference); one train step's parameter update 1e-4 relative; the hash
centers, the transforms, ``hash_convert``'s targets and codes exact;
``bce_probs``' gradient at saturated probabilities finite and equal to
cmh_tpu's. The port draws cmh_tpu's tie vectors from the same key
(``fold_in(PRNGKey(center_seed), step)``), bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (before any torch work)
import torch
import yaml

import cmh_tpu.ops.hash_centers as jax_hc
import cmh_tpu.runners.twdh  # noqa: F401  (registers cmh_tpu's TwDH)
import cmh_torch.ops.hash_centers as port_hc
from cmh_torch.config import config_from_dict as port_config
from cmh_torch.export import load_encoders, save_encoders
from cmh_torch.main import main as port_main
from cmh_torch.models import convert
from cmh_torch.registry import load_components
from cmh_torch.utils import prng
from cmh_tpu.config import config_from_dict
from cmh_tpu.models import torch_import
from cmh_tpu.registry import registry as jax_registry
from tests.util_methods import tiny_trainer

port_registry = load_components()
LONG, SHORTS, CLASSES, BATCH, W = 64, (8, 16), 4, 6, 12
MODEL = {"arch": "TwDH", "clip_variant": "tiny", "long_dim": LONG, "short_dims": list(SHORTS),
         "numclass": CLASSES, "low_rate": 0.5, "quan_alpha": 0.5, "center_seed": 3,
         "long_center": "/nonexistent", "short_center": "/nonexistent",
         "trans_matrix": "/nonexistent"}


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


@pytest.fixture(scope="module")
def pair():
    jmethod = jax_registry.get_model_class("TwDH").from_config(
        config_from_dict({"model": MODEL}).model, output_dim=16)
    img, txt, kpm = _inputs()
    variables = jmethod.init_variables(jax.random.PRNGKey(1), {
        "image": jnp.asarray(img), "text": jnp.asarray(txt),
        "key_padding_mask": jnp.asarray(kpm)})
    variables = jax.tree_util.tree_map(np.asarray, variables)
    pmethod = port_registry.require_model_class("TwDH").from_config(
        port_config({"model": MODEL}).model, output_dim=16)
    pmethod.model.load_state_dict(
        convert.twdh_state_from_jax(variables["params"], variables["batch_stats"]), strict=True)
    return jmethod, variables, pmethod


def test_weights_cross_both_ways(pair):
    _, variables, pmethod = pair
    back, model_state = torch_import.twdh_from_torch_state(pmethod.model.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(variables["params"])
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), a, err_msg=str(path))
    for path, a in jax.tree_util.tree_leaves_with_path(variables["batch_stats"]):
        want = dict(jax.tree_util.tree_leaves_with_path(model_state["batch_stats"]))[path]
        np.testing.assert_array_equal(np.asarray(want), a)
    # and the port's own inverse writes cmh_tpu's tree
    params, mstate = convert.twdh_state_to_jax(pmethod.model.state_dict())
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(variables["params"]),
                                jax.tree_util.tree_leaves_with_path(params)):
        assert pa == pb
        np.testing.assert_array_equal(a, b, err_msg=str(pa))
    assert jax.tree_util.tree_structure(mstate["batch_stats"]) == \
        jax.tree_util.tree_structure(variables["batch_stats"])


def test_centers_and_transforms_are_bit_equal(pair):
    jmethod, _, pmethod = pair
    jstate = jax.tree_util.tree_map(np.asarray, jmethod.init_method_state())
    pstate = pmethod.init_method_state()
    np.testing.assert_array_equal(pstate["long_center"].numpy(), jstate["long_center"])
    assert sorted(pstate["short_centers"]) == sorted(jstate["short_centers"]) == ["16", "8"]
    for k in ("8", "16"):
        np.testing.assert_array_equal(pstate["short_centers"][k].numpy(),
                                      jstate["short_centers"][k])
        np.testing.assert_array_equal(pstate["trans"][k].numpy(), jstate["trans"][k])
        assert pstate["trans"][k].dtype == torch.float32
    assert pmethod.short_dims == [8, 16]


@pytest.mark.parametrize("n_class,bits", [(4, 64), (10, 4), (300, 128), (5, 12)])
def test_generate_hash_centers(n_class, bits):
    got = port_hc.generate_hash_centers(n_class, bits, seed=14)
    np.testing.assert_array_equal(got, jax_hc.generate_hash_centers(n_class, bits, seed=14))
    assert got.dtype == np.float32 and set(np.unique(got)) <= {-1.0, 1.0}


def test_targets_and_pair_conversion_exact():
    rng = np.random.RandomState(2)
    labels = (rng.rand(9, CLASSES) > 0.5).astype(np.float32)
    labels[0] = [1, 1, 0, 0]       # two Hadamard rows whose sum has zero bits
    centers = port_hc.generate_hash_centers(CLASSES, 16, seed=13)
    key = jax.random.fold_in(jax.random.PRNGKey(3), 7)
    want = jax_hc.hash_center_multilabels(jnp.asarray(labels), jnp.asarray(centers), key)
    tie = port_hc.tie_vector(prng.fold_in(prng.PRNGKey(3), 7), 16)
    got = port_hc.hash_center_multilabels(torch.from_numpy(labels), torch.from_numpy(centers),
                                          tie)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (labels @ centers == 0).any()
    np.testing.assert_array_equal(port_hc.hash_convert(got).numpy(),
                                  np.asarray(jax_hc.hash_convert(want)))


def test_tie_vector_is_a_function_of_seed_and_step():
    a, b, c = (port_hc.tie_vector(prng.fold_in(prng.PRNGKey(3), s), 32) for s in (5, 5, 6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert set(a.tolist()) == {-1.0, 1.0}


def test_bce_probs_value_and_gradients_match_at_saturation():
    rng = np.random.RandomState(4)
    p = rng.rand(5, 8).astype(np.float32)
    p[0, :4] = [0.0, 1.0, 0.0, 1.0]       # saturated pairs
    y = (rng.rand(5, 8) > 0.5).astype(np.float32)
    y[0, :4] = [0.0, 1.0, 1.0, 0.0]
    jv, (jgp, jgy) = jax.value_and_grad(jax_hc.bce_probs, argnums=(0, 1))(
        jnp.asarray(p), jnp.asarray(y))
    tp, ty = torch.from_numpy(p).requires_grad_(), torch.from_numpy(y).requires_grad_()
    v = port_hc.bce_probs(tp, ty)
    v.backward()
    assert _rel(float(v.detach()), float(jv)) <= 1e-6
    assert torch.isfinite(tp.grad).all() and torch.isfinite(ty.grad).all()
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgp), rtol=1e-6, atol=0)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(jgy), rtol=1e-6, atol=0)


def test_forward_outputs_match_in_eval(pair, monkeypatch):
    monkeypatch.setenv("CMH_TPU_FUSED", "1")
    jmethod, variables, pmethod = pair
    img, txt, kpm = _inputs(2)
    trans = jmethod.eval_method_state()["trans"]
    ji = jmethod.module.apply(variables, jnp.asarray(img), train=False, trans=trans,
                              method=lambda m, x, train, trans: m.encode_image(
                                  x, train=train, trans=trans))
    jt = jmethod.module.apply(variables, jnp.asarray(txt), jnp.asarray(kpm), train=False,
                              trans=trans, method=lambda m, t, k, train, trans: m.encode_text(
                                  t, k, train=train, trans=trans))
    pmethod.model.eval()
    with torch.no_grad():
        pi = pmethod.encode_image(torch.from_numpy(img))
        pt = pmethod.encode_text(torch.from_numpy(txt), torch.from_numpy(kpm))
    for got, want in ((pi, ji), (pt, jt)):
        assert _rel(got[0].numpy(), want[0]) <= 1e-5
        assert sorted(got[1]) == sorted(want[1])
        for k in want[1]:
            assert _rel(got[1][k].numpy(), want[1][k]) <= 1e-5
        long_codes = pmethod.make_hash_code(got[0]).numpy()
        assert long_codes.shape == (BATCH, LONG)
        pairs = np.asarray(want[0]).reshape(BATCH, -1, 2)
        decided = np.abs(pairs[..., 1] - pairs[..., 0]) > 1e-4
        np.testing.assert_array_equal(long_codes[decided],
                                      np.asarray(jmethod.make_hash_code(want[0]))[decided])


def _outputs(seed, b=12):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        logits = rng.randn(b, LONG, 2).astype(np.float32) * 3
        logits[0, :3] = [[60.0, -60.0]] * 3     # pairs that saturate to exactly 0 and 1
        e = np.exp(logits - logits.max(-1, keepdims=True))
        out.append((e / e.sum(-1, keepdims=True)).reshape(b, -1).astype(np.float32))
    labels = (rng.rand(b, CLASSES) > 0.5).astype(np.float32)
    labels[np.arange(b), rng.randint(0, CLASSES, b)] = 1
    return out, labels


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + k + "/") if isinstance(v, dict)
                   else {prefix + k: float(v)})
    return out


def test_loss_and_gradients_match(pair):
    jmethod, _, pmethod = pair
    outs, labels = _outputs(5)
    jstate = jmethod.init_method_state()

    def jloss(a, b):
        total, ld, _ = jmethod.loss((a, b), {"label": jnp.asarray(labels)}, jstate, 7)
        return total, ld

    (jtotal, jld), jgrads = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        *map(jnp.asarray, outs))
    touts = [torch.from_numpy(o).requires_grad_() for o in outs]
    total, ld, state = pmethod.loss(tuple(touts), {"label": torch.from_numpy(labels)},
                                    pmethod.init_method_state(), 7)
    total.backward()
    assert _rel(float(total.detach()), float(jtotal)) <= 1e-5
    want = _flat(jax.tree_util.tree_map(float, jld))
    got = _flat(jax.tree_util.tree_map(lambda t: t.detach(), ld))
    assert set(got) == set(want) and "Short/8/NCE" in got
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-5, k
    for t, g in zip(touts, jgrads):
        assert torch.isfinite(t.grad).all()
        assert _rel(t.grad.numpy(), g) <= 1e-5


def test_one_train_step_matches(tmp_path, monkeypatch):
    """One step of both trainers from the same weights on the same batch
    (the loss and every tensor's update, BertAdam's ε 1e-3 as in
    ``test_torch_methods.py``; the tensors whose gradient the image
    BatchNorm absorbs move by noise on both sides, bounded apart)."""
    monkeypatch.setenv("CMH_TPU_FUSED", "1")
    extra = {k: v for k, v in MODEL.items() if k not in ("arch", "clip_variant")}
    jtr = tiny_trainer(tmp_path / "jax", "TwDH", "TwDHTrainer",
                       model_extra=dict(extra, hash_func="softmax"),
                       optimizer_extra={"schedule": "warmup_constant", "warmup_proportion": 0.0,
                                        "e": 1e-3})
    cfg = jtr.cfg.to_dict()
    cfg["run"].update(save_dir=str(tmp_path / "port"), log_dir=str(tmp_path / "port_log"))
    ptr = port_registry.require_runner_class("TwDHTrainer").from_config(
        cfg=port_config(cfg), device="cpu", auto_run=False)

    def port_state(state):
        tree = jax.tree_util.tree_map(np.asarray, {"p": state.params, "m": state.model_state})
        return convert.twdh_state_from_jax(tree["p"], tree["m"]["batch_stats"])

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
        if k in BN_ABSORBED:
            # true gradient 0: both steps are fp32 noise, bounded by the weight decay's
            assert float((got[k] - v).abs().max()) <= 1e-9, k
            continue
        diff = np.abs((got[k] - after[k]).numpy())
        ulp = np.spacing(np.abs(after[k].numpy()))
        assert np.all(diff <= 1e-4 * np.abs(want_upd).max() + ulp), k


# biases that only shift the image BatchNorm's input (test_torch_train_fused.py)
BN_ABSORBED = {"backbone.visual.ln_post.bias", "hash.img_hash.atten.in_proj_bias",
               "hash.img_hash.atten.out_proj.bias"}


def _cfg(save_dir, run_extra=None):
    return {"model": dict(MODEL, clip_path="/nonexistent.pt", hash_func="softmax"),
            "optimizer": {"arch": "BertAdam", "lr": 0.002, "clip_lr": 0.0005},
            "dataset": {"arch": "synthetic_dataset", "name": "synthetic",
                        "num_classes": CLASSES, "image_resolution": 32, "max_word": W},
            "run": {"arch": "TwDHTrainer", "save_dir": str(save_dir),
                    "log_dir": str(save_dir / "log"), "output_dim": 16, "batch_size": 16,
                    "is_train": True, "train_num": 32, "query_num": 16, "epochs": 2,
                    "display_step": 1000, "seed": 5, **(run_extra or {})}}


def test_cli_trains_validates_every_width_and_resumes(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(_cfg(tmp_path / "unused",
                                        {"checkpoint_every": 1, "auto_resume": True})))
    argv = ["--config-file", str(path), "--save-dir", str(tmp_path / "out"), "--device", "cpu"]
    first = port_main(argv)
    assert [h["epoch"] for h in first.history] == [0, 1]
    for h in first.history:
        assert np.isfinite(h["loss"])
        assert sorted(h["maps_by_width"]) == ["16", "8", "long"]
        assert all(len(m) == 4 for m in h["maps_by_width"].values())
        assert h["maps"] == h["maps_by_width"]["long"]
    mats = sorted(os.listdir(os.path.join(first.save_dir, "mat_files")))
    assert mats == ["i2t-long.mat", "i2t-short-16.mat", "i2t-short-8.mat",
                    "t2i-long.mat", "t2i-short-16.mat", "t2i-short-8.mat"]
    assert first.max_short["8"]["i2t"] == max(h["maps_by_width"]["8"][0] for h in first.history)
    import scipy.io as scio

    assert scio.loadmat(os.path.join(first.save_dir, "mat_files", "i2t-long.mat"))[
        "q_img"].shape == (16, LONG)
    again = port_main(argv)
    assert again.history == [] and again.global_step == first.global_step
    assert again.max_short == first.max_short and again.best_epoch_short == first.best_epoch_short
    sa, sb = first.model.state_dict(), again.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    # a run that has not resumed starts its trackers at 0
    assert all(v == {"i2t": 0.0, "t2i": 0.0}
               for v in port_registry.require_runner_class("TwDHTrainer").from_config(
                   cfg=port_config(_cfg(tmp_path / "fresh")), device="cpu",
                   auto_run=False).max_short.values())


def test_encoder_file_carries_the_transforms(pair, tmp_path):
    _, _, pmethod = pair
    cfg = port_config({"model": MODEL, "run": {"output_dim": 16}})
    path = str(tmp_path / "enc.pt")
    save_encoders(pmethod.model, cfg, path, pmethod.eval_method_state())
    enc = load_encoders(path, device="cpu")
    img, txt, kpm = _inputs(3)
    long_codes, shorts = enc.encode_image(img)
    pmethod.model.eval()
    with torch.no_grad():
        want = pmethod.make_codes(pmethod.encode_image(torch.from_numpy(img)))
    np.testing.assert_array_equal(long_codes, want[0].numpy())
    assert sorted(shorts) == ["16", "8"]
    for k in shorts:
        np.testing.assert_array_equal(shorts[k], want[1][k].numpy())
    t_long, _ = enc.encode_text(txt, kpm)
    assert t_long.shape == (BATCH, LONG)
    save_encoders(pmethod.model, cfg, path)
    with pytest.raises(ValueError, match="no trans"):
        load_encoders(path, device="cpu")
