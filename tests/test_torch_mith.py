"""MITH in cmh_torch against cmh_tpu on the CPU.

Inputs come from numpy seeds; models use ``CLIPConfig.tiny()`` in fp32 with
dropout 0 and cmh_tpu runs its Pallas kernels in interpret mode
(``CMH_TPU_FUSED=1``). Weights cross both ways through
``convert.mith_state_from_jax`` and ``torch_import.mith_from_torch_state``.
Tolerances: head outputs, losses and their gradients 1e-5 relative (to the
largest magnitude of the reference; fp32 on both sides, only the order of
sums differs); one train step's parameter update 1e-4 relative (per
tensor, to the largest update of cmh_tpu's); the token aggregation's pseudo
labels, the banks' update, codes and weights carried across exact. The
port draws cmh_tpu's initial banks from the same key (``PRNGKey(20)``),
within 1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (before any torch work)
import torch
import yaml

import cmh_tpu.models.mith as jax_mith
import cmh_tpu.runners.mith  # noqa: F401  (registers cmh_tpu's trainer)
from cmh_torch.config import config_from_dict as port_config
from cmh_torch.main import main as port_main
from cmh_torch.models import convert
from cmh_torch.models import mith as port_mith
from cmh_torch.registry import load_components
from cmh_tpu.config import config_from_dict
from cmh_tpu.models import torch_import
from cmh_tpu.registry import registry as jax_registry
from tests.util_methods import tiny_trainer

port_registry = load_components()
BITS, CLASSES, BATCH, W, TRAIN = 8, 4, 6, 12, 20
MODEL = {"arch": "MITH", "clip_variant": "tiny", "drop_out": 0.0, "top_k_label": 4,
         "hash_func": "tanh"}


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
    """cmh_tpu's MITH from a seed and the port's with the same weights."""
    jmethod = jax_registry.get_model_class("MITH").from_config(
        config_from_dict({"model": MODEL}).model, output_dim=BITS, train_num=TRAIN)
    img, txt, kpm = _inputs()
    variables = jmethod.init_variables(jax.random.PRNGKey(1), {
        "image": jnp.asarray(img), "text": jnp.asarray(txt),
        "key_padding_mask": jnp.asarray(kpm)})
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    pmethod = port_registry.require_model_class("MITH").from_config(
        port_config({"model": MODEL}).model, output_dim=BITS, train_num=TRAIN)
    pmethod.model.load_state_dict(convert.mith_state_from_jax(params), strict=True)
    return jmethod, params, pmethod


def test_weights_cross_both_ways(pair):
    _, params, pmethod = pair
    back, model_state = torch_import.mith_from_torch_state(pmethod.model.state_dict(), BITS)
    assert model_state == {}
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), a, err_msg=str(path))
    again = convert.mith_state_from_jax(back)
    for k, v in pmethod.model.state_dict().items():
        assert torch.equal(again[k], v), k
    # one concept learner under both reference names
    assert pmethod.model.hash.gcl_t is pmethod.model.hash.gcl_i


def test_forward_outputs_match_in_eval(pair, monkeypatch):
    monkeypatch.setenv("CMH_TPU_FUSED", "1")
    jmethod, params, pmethod = pair
    img, txt, kpm = _inputs(2)
    variables = {"params": params}
    ji = jmethod.module.apply(variables, jnp.asarray(img), train=False,
                              method=lambda m, x, train: m.encode_image(x, train=train))
    jt = jmethod.module.apply(variables, jnp.asarray(txt), jnp.asarray(kpm), train=False,
                              method=lambda m, t, k, train: m.encode_text(t, k, train=train))
    jouts = jmethod.module.apply(variables, jnp.asarray(img), jnp.asarray(txt),
                                 jnp.asarray(kpm), train=False)
    model = pmethod.model.eval()
    with torch.no_grad():
        pi = model.encode_image(torch.from_numpy(img))
        pt = model.encode_text(torch.from_numpy(txt), torch.from_numpy(kpm))
        outs = model(torch.from_numpy(img), torch.from_numpy(txt), torch.from_numpy(kpm))
    assert len(outs) == len(jouts) == 8
    for got, want in [(pi, ji), (pt, jt)] + list(zip(outs, jouts)):
        assert tuple(got.shape) == tuple(want.shape)
        assert _rel(got.numpy(), want) <= 1e-5
    for got, want in ((pi, ji), (pt, jt)):
        codes = pmethod.make_hash_code(got).numpy()
        decided = np.abs(np.asarray(want)) > 1e-4
        np.testing.assert_array_equal(codes[decided],
                                      np.asarray(jmethod.make_hash_code(want))[decided])


@pytest.mark.parametrize("with_mask", [False, True])
def test_token_aggregation_matches(with_mask):
    rng = np.random.RandomState(3 + with_mask)
    n, seq, k, d = 3, 9, 6, 5
    x = rng.randn(n, seq, d).astype(np.float32)
    concept = np.tanh(rng.randn(n, seq, k) * 2).astype(np.float32)
    concept[0, :, 2] = -0.5                     # a concept no token takes: its column → 0
    kpm = None
    if with_mask:
        kpm = np.zeros((n, seq), bool)
        kpm[0, 6:] = True
        kpm[2, 2:] = True
    jm, jp = jax_mith.localized_token_aggregation(
        jnp.asarray(x), jnp.asarray(concept), 3, None if kpm is None else jnp.asarray(kpm))
    pm, pp = port_mith.localized_token_aggregation(
        torch.from_numpy(x), torch.from_numpy(concept), 3,
        None if kpm is None else torch.from_numpy(kpm))
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    assert _rel(pm.numpy(), jm) <= 1e-5
    assert np.all(pm.numpy()[0, 2] == 0.0)


def test_top_k_above_the_code_length_raises():
    concept = np.tanh(np.random.RandomState(0).randn(2, 4, 3)).astype(np.float32)
    x = np.zeros((2, 4, 5), np.float32)
    with pytest.raises(ValueError, match="top_k_label=4"):
        port_mith.localized_token_aggregation(torch.from_numpy(x), torch.from_numpy(concept), 4)
    with pytest.raises(Exception):
        jax_mith.localized_token_aggregation(jnp.asarray(x), jnp.asarray(concept), 4)
    with pytest.raises(ValueError, match="top_k_label=9"):
        port_registry.require_model_class("MITH").from_config(
            dict(MODEL, top_k_label=9), output_dim=BITS)


def _state(seed, b):
    """Banks, train labels, and a batch's head outputs, labels and indices."""
    rng = np.random.RandomState(seed)
    state = {name: rng.randn(TRAIN, BITS).astype(np.float32) for name in port_mith.BANKS}
    labels = (rng.rand(TRAIN, CLASSES) > 0.6).astype(np.float32)
    labels[np.arange(TRAIN), rng.randint(0, CLASSES, TRAIN)] = 1
    state["train_labels"] = labels
    idx = rng.choice(TRAIN, b, replace=False)
    outs = []
    for _ in range(2):
        outs += [rng.randn(b, 12).astype(np.float32),
                 np.tanh(rng.randn(b, BITS)).astype(np.float32),
                 np.tanh(rng.randn(b, BITS)).astype(np.float32),
                 rng.randn(b, BITS, 12).astype(np.float32)]
    # the loss takes l2-normalized features, as the model gives them
    for i in (0, 3, 4, 7):
        outs[i] /= np.linalg.norm(outs[i], axis=-1, keepdims=True)
    return state, outs, labels[idx], idx


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + k + "/") if isinstance(v, dict)
                   else {prefix + k: float(v)})
    return out


@pytest.mark.parametrize("duplicate", [False, True])
def test_loss_gradients_and_banks_match(pair, duplicate):
    """The loss, its dict, the outputs' gradients and the new banks. With
    ``duplicate``, the batch's last two rows repeat its first index with the
    first row's outputs, as a wrapped last batch does at dropout 0."""
    jmethod, _, pmethod = pair
    state, outs, labels, idx = _state(5, 7)
    if duplicate:
        idx[-2:] = idx[0]
        for o in outs:
            o[-2:] = o[0]
    batch = {"label": labels, "index": idx.astype(np.int32)}
    before = {k: v.copy() for k, v in state.items()}

    def jloss(*o):
        total, ld, new = jmethod.loss(tuple(o), {k: jnp.asarray(v) for k, v in batch.items()},
                                      {k: jnp.asarray(v) for k, v in state.items()}, 3)
        return total, (ld, new)

    (jtotal, (jld, jnew)), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(8)), has_aux=True)(*map(jnp.asarray, outs))
    touts = [torch.from_numpy(o).requires_grad_() for o in outs]
    total, ld, new = pmethod.loss(tuple(touts), {k: torch.from_numpy(v) for k, v in batch.items()},
                                  {k: torch.from_numpy(v) for k, v in state.items()}, 3)
    total.backward()
    assert _rel(float(total.detach()), float(jtotal)) <= 1e-5
    want = _flat(jax.tree_util.tree_map(float, jld))
    got = _flat(jax.tree_util.tree_map(lambda t: t.detach(), ld))
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-5, k
    for t, g in zip(touts, jgrads):
        assert _rel(t.grad.numpy(), g) <= 1e-5
    assert set(new) == set(jnew)
    for k in new:
        np.testing.assert_array_equal(new[k].numpy(), np.asarray(jnew[k]), err_msg=k)
    # the state is returned, not written in place (the tensors share the arrays' memory)
    for k, v in state.items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)


def test_repeated_bank_index_writes_the_last_row():
    bank = torch.zeros(5, 2)
    rows = torch.tensor([[1.0, 1.0], [2.0, 2.0], [3.0, 3.0], [4.0, 4.0]])
    out = port_mith.write_bank(bank, torch.tensor([3, 1, 3, 0]), rows)
    assert out.tolist() == [[4, 4], [2, 2], [0, 0], [3, 3], [0, 0]]
    assert bank.abs().sum() == 0


def test_init_method_state(pair):
    """The banks are cmh_tpu's normals from ``PRNGKey(20)`` (within 1e-6,
    the port's erf_inv), the same on every call whatever the run seed."""
    jmethod, _, pmethod = pair
    labels = np.eye(CLASSES, dtype=np.float32)[np.arange(TRAIN) % CLASSES]
    jmethod.train_labels = pmethod.train_labels = labels
    a, b = pmethod.init_method_state(), pmethod.init_method_state()
    want = jmethod.init_method_state()
    assert set(a) == set(port_mith.BANKS) | {"train_labels"}
    for name in port_mith.BANKS:
        assert a[name].shape == (TRAIN, BITS) and a[name].dtype == torch.float32
        assert torch.equal(a[name], b[name])
        assert np.abs(a[name].numpy() - np.asarray(want[name])).max() <= 1e-6
    assert not torch.equal(a["img_cls"], a["txt_cls"])
    assert torch.equal(a["train_labels"], torch.from_numpy(labels))
    pmethod.train_labels = None
    with pytest.raises(ValueError, match="train_labels"):
        pmethod.init_method_state()


def test_one_train_step_matches(tmp_path, monkeypatch):
    """One step of both trainers from the same weights and banks on the same
    batch: the loss, every tensor's update and the new banks (1e-5: they
    hold the step's codes). BertAdam's ε is 1e-3, as in
    ``test_torch_methods.py``, so that updates stay linear in gradients
    that are fp32 noise."""
    monkeypatch.setenv("CMH_TPU_FUSED", "1")
    jtr = tiny_trainer(tmp_path / "jax", "MITH", "MITHTrainer",
                       model_extra={"drop_out": 0.0, "top_k_label": 4, "hash_func": "tanh"},
                       optimizer_extra={"schedule": "warmup_constant", "warmup_proportion": 0.0,
                                        "e": 1e-3})
    cfg = jtr.cfg.to_dict()
    cfg["run"].update(save_dir=str(tmp_path / "port"), log_dir=str(tmp_path / "port_log"))
    ptr = port_registry.require_runner_class("MITHTrainer").from_config(
        cfg=port_config(cfg), device="cpu", auto_run=False)
    start = convert.mith_state_from_jax(jax.tree_util.tree_map(np.asarray, jtr.state.params))
    ptr.model.load_state_dict(start, strict=True)
    jstate = jax.tree_util.tree_map(np.asarray, jtr.state.method_state)
    np.testing.assert_array_equal(ptr.method_state["train_labels"].numpy(),
                                  jstate["train_labels"])
    for k in port_mith.BANKS:   # the port's own banks, cmh_tpu's draws within 1e-6
        assert np.abs(ptr.method_state[k].numpy() - jstate[k]).max() <= 1e-6, k
    batch = next(iter(jtr.train_loader))
    jtr.state, jloss, _ = jtr._train_step(jtr.state, {k: jnp.asarray(v) for k, v in batch.items()})
    ploss, _ = ptr.train_step(batch)
    assert _rel(float(ploss), float(jloss)) <= 1e-5
    after = convert.mith_state_from_jax(jax.tree_util.tree_map(np.asarray, jtr.state.params))
    got = ptr.model.state_dict()
    for k, v in start.items():
        want_upd = (after[k] - v).numpy()
        if not np.abs(want_upd).max() > 0:
            assert torch.equal(got[k], v), k          # no gradient on either side
            continue
        diff = np.abs((got[k] - after[k]).numpy())
        ulp = np.spacing(np.abs(after[k].numpy()))
        assert np.all(diff <= 1e-4 * np.abs(want_upd).max() + ulp), k
    for k in port_mith.BANKS:
        assert _rel(ptr.method_state[k].numpy(), np.asarray(jtr.state.method_state[k])) <= 1e-5


def test_concept_transformer_is_fp32(tmp_path, monkeypatch):
    """A train step's LayerNorms and kernel attentions: the tiny towers'
    11 and 2, and MITH's fp32 concept transformers' 8 and 2 (4 LayerNorms
    and block 0's attention a modality)."""
    import cmh_torch.ops.attention as attention_ops
    import cmh_torch.ops.layernorm as layernorm_ops

    seen = {"layernorm": [], "attention": []}
    for module, key in ((layernorm_ops, "layernorm"), (attention_ops, "attention")):
        orig = module._forward

        def counted(*args, _orig=orig, _key=key):
            seen[_key].append(args[0].dtype)
            return _orig(*args)

        monkeypatch.setattr(module, "_forward", counted)
    tr = _trainer(tmp_path, clip_dtype="bfloat16")
    tr.train_step(next(iter(tr.train_loader)))
    count = {k: {str(d).split(".")[-1]: v.count(d) for d in set(v)} for k, v in seen.items()}
    assert count == {"layernorm": {"bfloat16": 11, "float32": 8},
                     "attention": {"bfloat16": 2, "float32": 2}}


def _cfg(save_dir, run_extra=None, **model_extra):
    return {"model": dict(MODEL, clip_path="/nonexistent.pt", drop_out=0.1, **model_extra),
            "optimizer": {"arch": "BertAdam", "lr": 0.002, "clip_lr": 0.0005},
            "dataset": {"arch": "synthetic_dataset", "name": "synthetic",
                        "num_classes": CLASSES, "image_resolution": 32, "max_word": W},
            "run": {"arch": "MITHTrainer", "save_dir": str(save_dir),
                    "log_dir": str(save_dir / "log"), "output_dim": BITS, "batch_size": 16,
                    "is_train": True, "train_num": 40, "query_num": 16, "epochs": 2,
                    "display_step": 1000, "seed": 5, **(run_extra or {})}}


def _trainer(save_dir, run_extra=None, **model_extra):
    return port_registry.require_runner_class("MITHTrainer").from_config(
        cfg=port_config(_cfg(save_dir, run_extra, **model_extra)), device="cpu",
        auto_run=False)


def test_cli_trains_and_resumes_bit_equal(tmp_path):
    """Two epochs through ``python -m cmh_torch.main`` (3 steps an epoch, the
    last one ragged: 40 items at batch 16, dropout 0.1), four mAPs an epoch,
    and a rerun that resumes at epoch 2, trains nothing and holds the
    model, BertAdam and the banks of the first run bit for bit."""
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(_cfg(tmp_path / "unused",
                                        {"checkpoint_every": 1, "auto_resume": True})))
    argv = ["--config-file", str(path), "--save-dir", str(tmp_path / "out"), "--device", "cpu"]
    first = port_main(argv)
    assert [h["epoch"] for h in first.history] == [0, 1]
    for h in first.history:
        assert np.isfinite(h["loss"]) and len(h["maps"]) == 4
    assert any(p.startswith("model-") for p in os.listdir(first.save_dir))
    again = port_main(argv)
    assert again.history == [] and again.global_step == first.global_step == 6
    sa, sb = first.model.state_dict(), again.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = first.optimizer.state_dict(), again.optimizer.state_dict()
    for ga, gb in zip(oa["groups"], ob["groups"]):
        assert torch.equal(ga["m"], gb["m"]) and torch.equal(ga["v"], gb["v"])
    for k in first.method_state:
        assert torch.equal(first.method_state[k], again.method_state[k]), k
    # the banks moved from their initial draw
    fresh = _trainer(tmp_path / "fresh")
    assert not torch.equal(fresh.method_state["img_cls"], first.method_state["img_cls"])
