"""DIMCH and the set-wise distances in cmh_torch against cmh_tpu on the CPU.

Inputs come from numpy seeds; models use ``CLIPConfig.tiny()`` in fp32 and
cmh_tpu runs its Pallas kernels in interpret mode (``CMH_TPU_FUSED=1``).
Weights cross both ways through ``convert.dimch_state_from_jax`` /
``dimch_state_to_jax`` and ``torch_import.dimch_from_torch_state``.
Tolerances: head outputs, similarities, losses and their gradients 1e-5
relative (to the largest magnitude of the reference), the MMD term of the
loss to the rounding of cmh_tpu's expanded euclidean distance
(``mmd_tolerance``); codes exact where cmh_tpu's continuous code is not
within 1e-5 of 0; a cmh_tpu ``model-N.msgpack`` in test mode gives
cmh_tpu's ``.mat`` codes exactly and its mAPs within 1e-6. One train step
is in ``test_torch_train_dimch_umoed.py``.
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

import cmh_tpu.models.dimch as jax_dimch
import cmh_tpu.ops.distances as jax_dist
import cmh_tpu.ops.metrics as jax_metrics
import cmh_tpu.runners.dimch  # noqa: F401  (registers cmh_tpu's DIMCH)
import cmh_torch.ops.distances as port_dist
import cmh_torch.ops.metrics as port_metrics
from cmh_torch.config import config_from_dict as port_config
from cmh_torch.main import main as port_main
from cmh_torch.models import convert
from cmh_torch.registry import load_components
from cmh_tpu.config import config_from_dict
from cmh_tpu.models import torch_import
from tests.util_methods import tiny_trainer

port_registry = load_components()
CLASSES, BATCH, W, SET = 4, 6, 12, 4
LOSS_CFG = {"distance": {"mode": "smooth_chamfer", "temperature": 16.0},
            "chamfer": {"mmd_alpha": 1, "unif_alpha": 0.3, "mmd_gamma": 0.5,
                        "token_triplet_margin": 0.3},
            "hash_pars": {"triplet_alpha": 50, "quan_alpha": 1.0, "hash_triplet_alpha": 50,
                          "triplet_margin": 0.3}}


def model_cfg(hash_func="tanh", **extra):
    return {"arch": "DIMCH", "clip_variant": "tiny", "setDim": SET, "hash_func": hash_func,
            "txt_token_size": W, "dropout": 0.0, **LOSS_CFG, **extra}


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


def _labels(seed, b):
    rng = np.random.RandomState(seed)
    labels = (rng.rand(b, CLASSES) > 0.5).astype(np.float32)
    labels[np.arange(b), rng.randint(0, CLASSES, b)] = 1
    return labels


def _pair(hash_func):
    cfg = model_cfg(hash_func)
    jmethod = jax_dimch.DIMCHMethod.from_config(config_from_dict({"model": cfg}).model,
                                                output_dim=8)
    img, txt, kpm = _inputs()
    variables = jmethod.init_variables(jax.random.PRNGKey(1), {
        "image": jnp.asarray(img), "text": jnp.asarray(txt), "key_padding_mask": jnp.asarray(kpm)})
    variables = jax.tree_util.tree_map(np.asarray, variables)
    pmethod = port_registry.require_model_class("DIMCH").from_config(
        port_config({"model": cfg}).model, output_dim=8)
    pmethod.model.load_state_dict(convert.dimch_state_from_jax(variables["params"]),
                                  strict=True)
    return jmethod, variables, pmethod


@pytest.fixture(scope="module")
def pairs():
    return {h: _pair(h) for h in ("tanh", "softmax")}


def test_weights_cross_both_ways(pairs):
    _, variables, pmethod = pairs["tanh"]
    back, model_state = torch_import.dimch_from_torch_state(pmethod.model.state_dict())
    assert model_state == {}
    want = dict(jax.tree_util.tree_leaves_with_path(variables["params"]))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert got.keys() == want.keys()
    for path, a in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), a, err_msg=str(path))
    params, _ = convert.dimch_state_to_jax(pmethod.model.state_dict())
    mine = dict(jax.tree_util.tree_leaves_with_path(params))
    assert mine.keys() == want.keys()
    for path, a in want.items():
        np.testing.assert_array_equal(mine[path], a, err_msg=str(path))


def test_from_config_defaults_match_cmh_tpu():
    """A config without ``hash_func`` and ``setDim`` builds cmh_tpu's model:
    softmax (so twice the bits) and 64 instances."""
    jm = jax_dimch.DIMCHMethod.from_config(config_from_dict(
        {"model": {"arch": "DIMCH", "clip_variant": "tiny"}}).model, output_dim=16).module
    pm = port_registry.require_model_class("DIMCH").from_config(
        {"arch": "DIMCH", "clip_variant": "tiny"}, output_dim=16).model
    assert (pm.output_dim, pm.hash.img_token_hash.hash_func) == (jm.output_dim, jm.hash_func)
    assert pm.hash.txt_token_hash.token_layer.out_channels == jm.set_dim == 64
    assert pm.hash.img_token_hash.token_layer.in_channels == jm.clip_cfg.num_patches + 1


def test_token_mixer_is_the_conv1d():
    """The windowed product equals torch's own Conv1d (the reference's layer)."""
    from cmh_torch.models.dimch import TokenHash

    head = TokenHash(7, 8, 16, 5)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in head.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
        x = torch.from_numpy(np.random.RandomState(1).randn(3, 7, 16).astype(np.float32))
        want = torch.relu(head.token_layer(x))                  # (B, M, D)
        assert _rel(head.mix(x), want) <= 1e-6


@pytest.mark.parametrize("hash_func", ["tanh", "softmax"])
def test_forward_outputs_match_in_eval(pairs, hash_func, monkeypatch):
    monkeypatch.setenv("CMH_TPU_FUSED", "1")
    jmethod, variables, pmethod = pairs[hash_func]
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
        for g, w in zip(got, want):
            assert g.shape == w.shape and _rel(g.numpy(), w) <= 1e-5
        codes = pmethod.make_hash_code(got[1]).numpy()
        decided = np.abs(np.asarray(want[1])) > 1e-5
        np.testing.assert_array_equal(codes[decided],
                                      np.asarray(jmethod.make_hash_code(want[1]))[decided])


def _sets(seed, b=5, m=4, d=6):
    x = np.random.RandomState(seed).randn(b, m, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("mode", ["chamfer", "smooth_chamfer", "max", "avg"])
def test_setwise_similarity_and_gradients(mode):
    img, txt = _sets(1), _sets(2)
    img[0, 1] = img[0, 0]                     # a tie for the max
    kw = dict(mode=mode, denominator=2.0, temperature=16.0, temperature_txt_scale=0.5)
    w = np.random.RandomState(3).randn(5, 5).astype(np.float32)

    def jf(a, b):
        return jnp.sum(jax_dist.setwise_similarity(a, b, **kw) * w)

    jv, jg = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(img), jnp.asarray(txt))
    ta, tb = (torch.from_numpy(a).requires_grad_() for a in (img, txt))
    v = (port_dist.setwise_similarity(ta, tb, **kw) * torch.from_numpy(w)).sum()
    v.backward()
    assert _rel(float(v.detach()), float(jv)) <= 1e-5
    for t, g in zip((ta, tb), jg):
        assert _rel(t.grad.numpy(), g) <= 1e-5
    with pytest.raises(ValueError, match="unknown"):
        port_dist.setwise_similarity(ta, tb, mode="nope")


def _difference_distances(where, sqrt):
    """Euclidean distances from the differences (exactly 0 for equal rows),
    with the zero subgradient at 0, for one package's tensors."""
    def dist(a, b):
        sq = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        pos = sq > 0
        return where(pos, sqrt(where(pos, sq, 1.0)), 0.0 * sq)
    return dist


def test_generate_weight_sim_and_the_losses_with_gradients(monkeypatch):
    """cmh_tpu's euclidean distance expands ‖a‖² − 2a·b + ‖b‖², whose
    rounding noise at equal rows (every diagonal of MMD's k(x, x)) the
    square root lifts to about 1e-3; the two packages sum in other orders,
    so here both take the distance from the differences and the MMD is held
    at 1e-5 like the rest (the expanded form is the port's
    ``euclidean_similarity``, held against cmh_tpu's elsewhere)."""
    monkeypatch.setattr(jax_metrics, "euclidean_similarity",
                        _difference_distances(jnp.where, jnp.sqrt))
    monkeypatch.setattr(port_dist, "euclidean_similarity",
                        _difference_distances(torch.where, torch.sqrt))
    rng = np.random.RandomState(4)
    labels = _labels(5, 9)
    labels[1] = labels[0]                       # equal rows: sorted ties
    lsim, wts = port_metrics.generate_weight_sim(torch.from_numpy(labels),
                                                 torch.from_numpy(labels))
    jl, jw = jax_metrics.generate_weight_sim(jnp.asarray(labels), jnp.asarray(labels))
    np.testing.assert_array_equal(lsim.numpy(), np.asarray(jl))
    assert _rel(wts.numpy(), jw) <= 1e-6
    dist = rng.rand(9, 9).astype(np.float32)
    a, b = rng.randn(9, 6).astype(np.float32), rng.randn(9, 6).astype(np.float32)
    b[2] = a[2]                                 # a zero distance
    sets = _sets(6, b=9)
    cases = [
        ("triplet", lambda d: jax_dist.weighted_triplet_loss(d, jnp.asarray(labels), margin=0.3),
         lambda d: port_dist.weighted_triplet_loss(d, torch.from_numpy(labels), margin=0.3),
         dist),
        ("triplet sum", lambda d: jax_dist.weighted_triplet_loss(
            d, jnp.asarray(labels), margin=0.2, weighted=False, reduction="sum"),
         lambda d: port_dist.weighted_triplet_loss(
             d, torch.from_numpy(labels), margin=0.2, weighted=False, reduction="sum"), dist),
        ("cos", lambda x: jnp.sum(jax_dist.cos_distance(x, jnp.asarray(b))),
         lambda x: port_dist.cos_distance(x, torch.from_numpy(b)).sum(), a),
        ("mmd", lambda x: jax_dist.mmd_rbf_loss(x, jnp.asarray(b), gamma=0.5),
         lambda x: port_dist.mmd_rbf_loss(x, torch.from_numpy(b), gamma=0.5), a),
        ("uniformity", lambda x: jax_dist.batchwise_uniformity_loss(x, 4),
         lambda x: port_dist.batchwise_uniformity_loss(x, 4), sets),
        ("uniformity per sample", lambda x: jax_dist.batchwise_uniformity_loss_per_sample(x, 4),
         lambda x: port_dist.batchwise_uniformity_loss_per_sample(x, 4), sets),
    ]
    for name, jf, pf, x in cases:
        jv, jg = jax.value_and_grad(jf)(jnp.asarray(x))
        t = torch.from_numpy(x).requires_grad_()
        v = pf(t)
        v.backward()
        assert _rel(float(v.detach()), float(jv)) <= 1e-5, name
        assert torch.isfinite(t.grad).all() and _rel(t.grad.numpy(), jg) <= 1e-5, name
    assert float(port_dist.batchwise_uniformity_loss(torch.from_numpy(sets), 1)) == 0.0


def mmd_tolerance(x, y, gamma):
    """How far the MMD of two fp32 evaluations of cmh_tpu's formula may
    differ: 1e-5 of the sum of its three kernel means (it is their
    difference), plus the rounding noise of the expanded squared distance
    at equal rows (k(x, x)'s and k(y, y)'s diagonals), at most 4·D·ε·‖x‖²,
    which the square root lifts to γ·√(4·D·ε·max‖x‖²) a pair, 2N pairs of
    the N² in each mean."""
    def k(a, c):
        return torch.exp(-gamma * port_metrics.euclidean_similarity(a, c)).mean()

    n, d = x.shape
    r2 = float(max((x * x).sum(-1).max(), (y * y).sum(-1).max()))
    noise = gamma * (4 * d * float(np.finfo(np.float32).eps) * r2) ** 0.5 * 2 * n / n**2
    return 1e-5 * float(k(x, x) + 2.0 * k(x, y) + k(y, y)) + noise


def _outputs(seed, hash_func, b=8):
    rng = np.random.RandomState(seed)
    k = 16 if hash_func == "softmax" else 8
    embeds = [rng.randn(b, SET, k).astype(np.float32) for _ in range(2)]
    if hash_func == "softmax":
        hashes = [np.asarray(jax.nn.softmax(rng.randn(b, k // 2, 2) * 2, -1)).reshape(b, k)
                  for _ in range(2)]
    else:
        hashes = [np.tanh(rng.randn(b, k)).astype(np.float32) for _ in range(2)]
    return [embeds[0], hashes[0], embeds[1], hashes[1]], _labels(seed + 1, b)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + k + "/") if isinstance(v, dict)
                   else {prefix + k: float(v)})
    return out


@pytest.mark.parametrize("hash_func,mode", [("tanh", "smooth_chamfer"), ("softmax", "max")])
def test_loss_and_gradients_match(hash_func, mode):
    cfg = dict(model_cfg(hash_func), distance={"mode": mode})
    jloss_fn = jax_dimch.DIMCHMethod.from_config(config_from_dict({"model": cfg}).model,
                                                 output_dim=8).loss
    ploss_fn = port_registry.require_model_class("DIMCH").from_config(
        port_config({"model": cfg}).model, output_dim=8).loss
    outs, labels = _outputs(7, hash_func)

    def jloss(*o):
        total, ld, _ = jloss_fn(o, {"label": jnp.asarray(labels)}, {}, 0)
        return total, ld

    (jtotal, jld), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *map(jnp.asarray, outs))
    touts = [torch.from_numpy(o).requires_grad_() for o in outs]
    total, ld, _ = ploss_fn(tuple(touts), {"label": torch.from_numpy(labels)}, {}, 0)
    total.backward()
    assert _rel(float(total.detach()), float(jtotal)) <= 1e-5
    want = _flat(jax.tree_util.tree_map(float, jld))
    got = _flat(jax.tree_util.tree_map(lambda t: t.detach(), ld))
    assert got.keys() == want.keys()
    sets = [port_dist.normalize(torch.from_numpy(outs[i])).reshape(-1, outs[i].shape[-1])
            for i in (0, 2)]
    for k in want:
        if k == "Tokens/Maximum Mean Discrepancy":
            assert abs(got[k] - want[k]) <= mmd_tolerance(*sets, 0.5), k
        else:
            assert _rel(got[k], want[k]) <= 1e-5, k
    for t, g in zip(touts, jgrads):
        assert torch.isfinite(t.grad).all() and _rel(t.grad.numpy(), g) <= 1e-5


def test_test_mode_from_a_cmh_tpu_file_gives_cmh_tpu_maps(tmp_path, monkeypatch):
    monkeypatch.setenv("CMH_TPU_FUSED", "1")
    extra = {k: v for k, v in model_cfg().items() if k not in ("arch", "clip_variant")}
    src = tiny_trainer(tmp_path / "src", "DIMCH", "DIMCHTrainer", model_extra=extra)
    src.save_model(str(tmp_path), 0)
    path = str(tmp_path / "model-0.msgpack")
    run = {"is_train": False, "resume_model": path}
    jtr = tiny_trainer(tmp_path / "jax", "DIMCH", "DIMCHTrainer", model_extra=extra,
                       run_extra=run)
    jmaps = jtr.test()
    cfg = jtr.cfg.to_dict()
    cfg["run"].update(save_dir=str(tmp_path / "port"), log_dir=str(tmp_path / "port_log"))
    ptr = port_registry.require_runner_class("DIMCHTrainer").from_config(
        cfg=port_config(cfg), device="cpu", auto_run=False)
    pmaps = ptr.test()
    jmat = scio.loadmat(os.path.join(jtr.save_dir, "mat_files", "test.mat"))
    pmat = scio.loadmat(os.path.join(ptr.save_dir, "mat_files", "test.mat"))
    for key in ("q_img", "q_txt", "r_img", "r_txt", "q_l", "r_l"):
        np.testing.assert_array_equal(pmat[key], jmat[key], err_msg=key)
    np.testing.assert_allclose(pmaps, jmaps, rtol=0, atol=1e-6)


def test_cli_trains_validates_and_resumes(tmp_path):
    cfg = {"model": dict(model_cfg(), clip_path="/nonexistent.pt", dropout=0.3),
           "optimizer": {"arch": "BertAdam", "lr": 0.002, "clip_lr": 0.0005},
           "dataset": {"arch": "synthetic_dataset", "name": "synthetic",
                       "num_classes": CLASSES, "image_resolution": 32, "max_word": W},
           "run": {"arch": "DIMCHTrainer", "output_dim": 8, "batch_size": 16, "is_train": True,
                   "train_num": 32, "query_num": 16, "epochs": 2, "display_step": 1000,
                   "seed": 5, "checkpoint_every": 1, "auto_resume": True,
                   "log_dir": str(tmp_path / "log")}}
    del cfg["model"]["txt_token_size"]          # the trainer sets it from max_word
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    argv = ["--config-file", str(path), "--save-dir", str(tmp_path / "out"), "--device", "cpu"]
    first = port_main(argv)
    assert first.model.hash.txt_token_hash.token_layer.in_channels == W
    assert [h["epoch"] for h in first.history] == [0, 1]
    assert all(np.isfinite(h["loss"]) and len(h["maps"]) == 4 for h in first.history)
    mat = scio.loadmat(os.path.join(first.save_dir, "mat_files", "last.mat"))
    assert mat["q_img"].shape == (16, 8) and set(np.unique(mat["q_img"])) <= {-1.0, 1.0}
    again = port_main(argv)
    assert again.history == [] and again.global_step == first.global_step
    sa, sb = first.model.state_dict(), again.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_export_cli_sizes_the_text_token_set_from_max_word(tmp_path):
    """``python -m cmh_torch.export`` builds DIMCH's text mixer over
    ``dataset.max_word`` tokens, as the trainer does, and its encoders
    take token ids of that length."""
    from cmh_torch.export import load_encoders
    from cmh_torch.export import main as export_main

    cfg = {"model": {k: v for k, v in model_cfg().items() if k != "txt_token_size"},
           "dataset": {"max_word": W}, "run": {"output_dim": 8}}
    path = tmp_path / "dimch.yaml"
    path.write_text(yaml.safe_dump(cfg))
    out = str(tmp_path / "enc.pt")
    export_main(["--config-file", str(path), "--out", out, "--device", "cpu"])
    enc = load_encoders(out, device="cpu")
    assert enc.model.hash.txt_token_hash.token_layer.in_channels == W
    _, txt, kpm = _inputs(4)
    codes = enc.encode_text(txt, kpm)
    assert codes.shape == (BATCH, 8) and set(np.unique(codes)) <= {-1.0, 1.0}
