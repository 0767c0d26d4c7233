"""Baseline, DSPH and DNPH in cmh_torch against cmh_tpu on the CPU, each
test a case per method.

Inputs come from numpy seeds; models use ``CLIPConfig.tiny()`` in fp32 and
cmh_tpu runs its Pallas kernels in interpret mode (``CMH_TPU_FUSED=1``).
Tolerances: head outputs, losses and their gradients 1e-5 relative (to the
largest magnitude of the reference; fp32 on both sides, only the order of
sums differs); one train step's parameter update 1e-4 relative (per
tensor, to the largest update of cmh_tpu's); the SGD on the proxies 1e-6
relative (the same fp32 ops); codes, weights carried across and the
threshold table exact. The eval forward runs without dropout; the train
step keeps each method's dropout and DNPH's noise, which the port draws
from cmh_tpu's keys (``utils/prng.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (before any torch work)
import torch

from cmh_torch.config import config_from_dict as port_config
from cmh_torch.models import convert
from cmh_torch.models.clip.model import CLIPConfig
from cmh_torch.registry import load_components
from cmh_tpu.config import config_from_dict, load_config
from cmh_tpu.models import torch_import
from cmh_tpu.registry import registry as jax_registry
from tests.util_methods import tiny_trainer

load_components()
import cmh_tpu.models.baseline  # noqa: E402,F401  (registers cmh_tpu's methods)
import cmh_tpu.models.dnph  # noqa: E402,F401
import cmh_tpu.models.dsph  # noqa: E402,F401
import cmh_tpu.runners.baseline  # noqa: E402,F401
import cmh_tpu.runners.dnph  # noqa: E402,F401
import cmh_tpu.runners.dsph  # noqa: E402,F401
from cmh_torch.registry import registry as port_registry  # noqa: E402
from cmh_torch.utils import prng

METHODS = ("Baseline", "DSPH", "DNPH")
TO_PORT = {"Baseline": convert.baseline_state_from_jax, "DSPH": convert.dsph_state_from_jax,
           "DNPH": convert.dnph_state_from_jax}
FROM_PORT = {"Baseline": torch_import.baseline_from_torch_state,
             "DSPH": torch_import.dsph_from_torch_state,
             "DNPH": torch_import.dnph_from_torch_state}
BITS, CLASSES, BATCH, W = 8, 4, 6, 12
MODEL = {"clip_variant": "tiny", "dropout": 0.0, "numclass": CLASSES, "alpha": 0.8,
         "noise_alpha": 0.1}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    img = rng.randn(BATCH, 32, 32, 3).astype(np.float32)
    txt = rng.randint(1, 49405, (BATCH, W)).astype(np.int32)
    txt[:, 0] = 49406
    kpm = np.zeros((BATCH, W), bool)
    for i, n in enumerate(rng.randint(3, W + 1, BATCH)):
        txt[i, n - 1] = 49407
        txt[i, n:] = 0
        kpm[i, n:] = True
    return img, txt, kpm


def _labels(rng, b, c):
    labels = (rng.rand(b, c) > 0.6).astype(np.float32)
    labels[np.arange(b), rng.randint(0, c, b)] = 1
    labels[0] = 0                          # two multi-label items with no label in common
    labels[0, :2] = 1
    labels[1] = 0
    labels[1, 2:] = 1
    return labels


@pytest.fixture(scope="module", params=METHODS)
def pair(request):
    """cmh_tpu's method initialised from a seed and the port's method with
    the same weights."""
    arch = request.param
    cfg = config_from_dict({"model": dict(MODEL, arch=arch)}).model
    jmethod = jax_registry.get_model_class(arch).from_config(cfg, output_dim=BITS)
    img, txt, kpm = _inputs()
    variables = jmethod.init_variables(jax.random.PRNGKey(1), {
        "image": jnp.asarray(img), "text": jnp.asarray(txt), "key_padding_mask": jnp.asarray(kpm)})
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    pmethod = port_registry.require_model_class(arch).from_config(
        port_config({"model": dict(MODEL, arch=arch)}).model, output_dim=BITS)
    pmethod.model.load_state_dict(TO_PORT[arch](params), strict=True)
    return arch, jmethod, params, pmethod


def test_weights_cross_both_ways(pair):
    arch, _, params, pmethod = pair
    back, model_state = FROM_PORT[arch](pmethod.model.state_dict())
    assert model_state == {}
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), a, err_msg=str(path))
    again = TO_PORT[arch](back)
    for k, v in pmethod.model.state_dict().items():
        assert torch.equal(again[k], v), k


def test_forward_outputs_match_in_eval(pair, monkeypatch):
    monkeypatch.setenv("CMH_TPU_FUSED", "1")
    arch, jmethod, params, pmethod = pair
    img, txt, kpm = _inputs(2)
    variables = {"params": params}
    ji = jmethod.module.apply(variables, jnp.asarray(img), train=False,
                              method=lambda m, x, train: m.encode_image(x, train=train))
    jt = jmethod.module.apply(variables, jnp.asarray(txt), jnp.asarray(kpm), train=False,
                              method=lambda m, t, k, train: m.encode_text(t, k, train=train))
    model = pmethod.model.eval()
    with torch.no_grad():
        pi = model.encode_image(torch.from_numpy(img))
        pt = model.encode_text(torch.from_numpy(txt), torch.from_numpy(kpm))
        outs = model(torch.from_numpy(img), torch.from_numpy(txt), torch.from_numpy(kpm))
    jouts = jmethod.module.apply(variables, jnp.asarray(img), jnp.asarray(txt),
                                 jnp.asarray(kpm), train=False)
    for got, want in [(pi, ji), (pt, jt)] + list(zip(outs, jouts)):
        assert tuple(got.shape) == tuple(want.shape)
        assert _rel(got.detach().numpy(), want) <= 1e-5
    for got, want in ((pi, ji), (pt, jt)):
        codes = pmethod.make_hash_code(got).numpy()
        decided = np.abs(np.asarray(want)) > 1e-4
        np.testing.assert_array_equal(codes[decided],
                                      np.asarray(jmethod.make_hash_code(want))[decided])


def _outputs(arch, seed):
    """Head outputs and labels of a batch of 12, from numpy."""
    rng = np.random.RandomState(seed)
    b = 12
    out = [np.tanh(rng.randn(b, BITS) * 1.5).astype(np.float32) for _ in range(2)]
    if arch == "DNPH":
        out += [rng.randn(b, 80).astype(np.float32) for _ in range(2)]
    if arch in ("DSPH", "DNPH"):
        out.append((rng.randn(CLASSES, BITS) * 0.3).astype(np.float32))
    return out, _labels(rng, b, CLASSES)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + k + "/") if isinstance(v, dict)
                   else {prefix + k: float(v)})
    return out


def test_loss_and_gradients_match(pair):
    arch, jmethod, _, pmethod = pair
    outs, labels = _outputs(arch, 3)

    def jloss(*o):
        total, ld, _ = jmethod.loss(tuple(o), {"label": jnp.asarray(labels)}, {}, 5)
        return total, ld

    (jtotal, jld), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(len(outs))), has_aux=True)(*map(jnp.asarray, outs))
    touts = [torch.from_numpy(o).requires_grad_() for o in outs]
    total, ld, state = pmethod.loss(tuple(touts), {"label": torch.from_numpy(labels)}, {}, 5)
    total.backward()
    assert state == {}
    assert _rel(float(total.detach()), float(jtotal)) <= 1e-5
    want = _flat(jax.tree_util.tree_map(float, jld))
    got = _flat(jax.tree_util.tree_map(lambda t: t.detach(), ld))
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-5, k
    for t, g in zip(touts, jgrads):
        assert _rel(t.grad.numpy(), g) <= 1e-5


def test_one_train_step_matches(pair, tmp_path, monkeypatch):
    """One step of both trainers from the same weights on the same batch:
    the loss, and every tensor's update (BertAdam on the backbone and heads,
    SGD on the proxies). BertAdam's ε is 1e-3 here: at its default 1e-6 an
    element whose gradient is at fp32-noise scale (the attention key biases'
    true gradient is 0) takes a step of m/(√v + ε) set by that noise, up to
    the whole lr on either side (``test_torch_train_fused.py`` bounds such
    steps apart); at 1e-3 such steps are linear in the gradient, while the
    large gradients are still normalized by √v."""
    arch = pair[0]
    monkeypatch.setenv("CMH_TPU_FUSED", "1")
    jtr = tiny_trainer(tmp_path / "jax", arch, arch + "Trainer",
                       model_extra={"noise_alpha": 0.1, "numclass": CLASSES},
                       # full lr from the first step (warmup would make it 0)
                       optimizer_extra={"schedule": "warmup_constant", "warmup_proportion": 0.0,
                                        "e": 1e-3,
                                        "hyp": {"lr": 0.02}, "loss": {"lr": 0.01}})
    cfg = jtr.cfg.to_dict()
    cfg["run"].update(save_dir=str(tmp_path / "port"), log_dir=str(tmp_path / "port_log"))
    ptr = port_registry.require_runner_class(arch + "Trainer").from_config(
        cfg=port_config(cfg), device="cpu", auto_run=False)
    start = TO_PORT[arch](jax.tree_util.tree_map(np.asarray, jtr.state.params))
    ptr.model.load_state_dict(start, strict=True)
    batch = next(iter(jtr.train_loader))
    jtr.state, jloss, _ = jtr._train_step(jtr.state, {k: jnp.asarray(v) for k, v in batch.items()})
    ploss, _ = ptr.train_step(batch)
    assert _rel(float(ploss), float(jloss)) <= 1e-5
    after = TO_PORT[arch](jax.tree_util.tree_map(np.asarray, jtr.state.params))
    got = ptr.model.state_dict()
    for k, v in start.items():
        want_upd = (after[k] - v).numpy()
        assert np.abs(want_upd).max() > 0, k
        # the update is seen through p + Δp rounded to fp32: one spacing of
        # the parameter beside the 1e-4 relative
        diff = np.abs((got[k] - after[k]).numpy())
        ulp = np.spacing(np.abs(after[k].numpy()))
        assert np.all(diff <= 1e-4 * np.abs(want_upd).max() + ulp), k


def test_make_hash_code_matches(pair):
    _, jmethod, _, pmethod = pair
    codes = np.random.RandomState(4).randn(5, BITS).astype(np.float32)
    codes[0, :3] = 0.0
    got = pmethod.make_hash_code(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmethod.make_hash_code(jnp.asarray(codes))))
    assert pmethod.eval_code_dims() == BITS == pmethod.output_dim


@pytest.mark.parametrize("arch", ["DSPH", "DNPH"])
def test_proxies_sgd_matches_optax(arch):
    """Three steps of seeded gradients: the port's SGD group against
    cmh_tpu's ``extra_optimizers`` transform, with the YAML's settings."""
    path = f"configs/{arch}/config.yaml"
    jtx = jax_registry.get_runner_class(arch + "Trainer").extra_optimizers(
        None, load_config(path).optimizer)["proxies"]
    from cmh_torch.config import load_config as port_load

    pmethod = port_registry.require_model_class(arch).from_config(
        {"clip_variant": "tiny", "numclass": CLASSES}, output_dim=BITS)
    (group,) = pmethod.extra_param_groups(port_load(path).optimizer)
    (proxies,) = group["params"]
    rng = np.random.RandomState(5)
    p0 = rng.randn(CLASSES, BITS).astype(np.float32)
    with torch.no_grad():
        proxies.copy_(torch.from_numpy(p0))
    opt = torch.optim.SGD([group], lr=group["lr"])
    jp, jstate = jnp.asarray(p0), jtx.init(jnp.asarray(p0))
    for _ in range(3):
        g = rng.randn(CLASSES, BITS).astype(np.float32)
        proxies.grad = torch.from_numpy(g)
        opt.step()
        upd, jstate = jtx.update(jnp.asarray(g), jstate, jp)
        jp = jp + upd
        assert _rel(proxies.detach().numpy(), jp) <= 1e-6


def _std_formulas(arch, k, c):
    d = 512
    if arch == "Baseline":
        return {"hash.img_hash.0.weight": (2.0 / (d // 2)) ** 0.5,
                "hash.txt_hash.3.weight": (2.0 / k) ** 0.5}
    if arch == "DSPH":
        return {"hash.img_hash.fc.weight": 1.0 / (3 * d) ** 0.5,
                "hash.txt_hash.fc.weight": 1.0 / (3 * d) ** 0.5,
                "hyp.proxies": (2.0 / c) ** 0.5}
    return {"hash.image_hash.fc.weight": (2.0 / k) ** 0.5,
            "hash.text_pre.fc.weight": (2.0 / 80) ** 0.5,
            "loss.proxies": 1.0 / 8.0}


@pytest.mark.parametrize("arch", METHODS)
def test_init_scales_in_law(arch):
    """At full head width (512 → 64 bits, 80 classes) each head's and the
    proxies' std is within 10% of cmh_tpu's initializer; biases are cmh_tpu's
    (zero, or within ±1/√fan_in for DSPH's ``nn.Linear`` default)."""
    clip = dataclasses.replace(CLIPConfig.tiny(), embed_dim=512)
    method = port_registry.require_model_class(arch).from_config(
        {"numclass": 80}, output_dim=64, clip_cfg=clip)
    method.model.init_weights(prng.PRNGKey(0))
    sd = method.model.state_dict()
    for name, std in _std_formulas(arch, 64, 80).items():
        assert abs(float(sd[name].std()) / std - 1) < 0.1, name
    for name, t in sd.items():
        if name.startswith(("hash.", "hyp.", "loss.")) and name.endswith("bias"):
            bound = 1 / 512**0.5 if arch == "DSPH" else 0.0
            assert float(t.abs().max()) <= bound, name


def test_dnph_numclass_above_80_raises():
    for cls in (port_registry.require_model_class("DNPH"), jax_registry.get_model_class("DNPH")):
        with pytest.raises(ValueError, match="numclass=81 exceeds"):
            cls.from_config(config_from_dict({"model": {"clip_variant": "tiny",
                                                        "numclass": 81}}).model)


@pytest.mark.parametrize("bits,classes", [(16, 8), (64, 80)])
def test_dsph_threshold_lookup(bits, classes):
    from cmh_torch.models.dsph import lookup_threshold
    from cmh_tpu.models.dsph import lookup_threshold as jax_lookup

    assert lookup_threshold(bits, classes) == jax_lookup(bits, classes)
