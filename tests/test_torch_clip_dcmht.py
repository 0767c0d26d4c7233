"""cmh_torch's CLIP towers and DCMHT model against cmh_tpu on the CPU.

One tiny-config (``CLIPConfig.tiny()``, 2 layers, fp32) cmh_tpu DCMHT model
is initialised from a seed; its weights cross into the port through
``models/convert.py``; both packages then encode the same numpy inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (before any torch work)
import torch

from cmh_torch.models.clip.model import CLIPConfig
from cmh_torch.models.convert import dcmht_state_from_jax
from cmh_torch.models.dcmht import DCMHTModel
from cmh_torch.utils import prng
from cmh_tpu.config import config_from_dict
from cmh_tpu.models.dcmht import DCMHTMethod
from cmh_tpu.models.torch_import import dcmht_from_torch_state

# Tolerances on fp32 outputs. CMH_TPU_FUSED=1: cmh_tpu runs the Pallas
# kernels (interpret mode) whose formulas the port follows, so only the
# order of fp32 sums differs. CMH_TPU_FUSED=0: cmh_tpu scales q before the
# dot and uses nn.Conv for the patch embedding, which moves more last bits.
TOL = {"1": 2e-5, "0": 1e-4}
BITS, W = 8, 12


@pytest.fixture(scope="module")
def models():
    cfg_model = config_from_dict(
        {"model": {"clip_variant": "tiny", "hash_func": "softmax"}}).model
    method = DCMHTMethod.from_config(cfg_model, output_dim=BITS)
    rng = np.random.RandomState(0)
    img = rng.randn(4, 32, 32, 3).astype(np.float32)
    txt = rng.randint(1, 49405, (4, W)).astype(np.int32)
    txt[:, 0] = 49406
    kpm = np.zeros((4, W), bool)
    for i, n in enumerate([5, W, 7, 3]):     # ragged captions, SOT never padded
        txt[i, n - 1] = 49407
        txt[i, n:] = 0
        kpm[i, n:] = True
    variables = method.init_variables(
        jax.random.PRNGKey(1), {"image": jnp.asarray(img), "text": jnp.asarray(txt),
                                "key_padding_mask": jnp.asarray(kpm)})
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    # non-trivial BatchNorm running stats, so the eval path must carry them
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.rand(*a.shape).astype(np.float32),
        variables["batch_stats"])
    port = DCMHTModel(CLIPConfig.tiny(), output_dim=BITS)
    port.load_state_dict(dcmht_state_from_jax(params, stats), strict=True)
    return method, {"params": params, "batch_stats": stats}, port.eval(), img, txt, kpm


def _apply(method, variables, fn, *args):
    return method.module.apply(variables, *args, method=fn)


@pytest.mark.parametrize("fused", ["1", "0"])
def test_clip_encode_image_matches_jax(models, fused, monkeypatch):
    method, variables, port, img, _, _ = models
    monkeypatch.setenv("CMH_TPU_FUSED", fused)
    ref = _apply(method, variables,
                 lambda m, x: m.backbone.encode_image(x), jnp.asarray(img))
    with torch.no_grad():
        out = port.backbone.encode_image(torch.from_numpy(img))
    for a, r in zip(out, ref):           # cls, patch tokens, cls→patch attention
        assert a.shape == r.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=TOL[fused])


@pytest.mark.parametrize("fused", ["1", "0"])
def test_clip_encode_text_matches_jax(models, fused, monkeypatch):
    method, variables, port, _, txt, kpm = models
    monkeypatch.setenv("CMH_TPU_FUSED", fused)
    ref = _apply(method, variables,
                 lambda m, t, k: m.backbone.encode_text(t, k),
                 jnp.asarray(txt), jnp.asarray(kpm))
    with torch.no_grad():
        out = port.backbone.encode_text(torch.from_numpy(txt), torch.from_numpy(kpm))
    for a, r in zip(out[:3], ref[:3]):   # eos token, all tokens, eos attention
        assert a.shape == r.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=TOL[fused])
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))


@pytest.mark.parametrize("fused", ["1", "0"])
def test_dcmht_codes_match_jax(models, fused, monkeypatch):
    """Head outputs within tolerance and codes equal, except at pairs whose
    margin |p_hi − p_lo| is below ε = 1e-4 (there the order of fp32 sums
    may decide the argmax)."""
    method, variables, port, img, txt, kpm = models
    monkeypatch.setenv("CMH_TPU_FUSED", fused)
    eps = 1e-4
    hi = _apply(method, variables, lambda m, x: m.encode_image(x, train=False),
                jnp.asarray(img))
    ht = _apply(method, variables, lambda m, t, k: m.encode_text(t, k, train=False),
                jnp.asarray(txt), jnp.asarray(kpm))
    with torch.no_grad():
        pi = port.encode_image(torch.from_numpy(img))
        pt = port.encode_text(torch.from_numpy(txt), torch.from_numpy(kpm))
    for h_jax, h_port in ((hi, pi), (ht, pt)):
        h_jax = np.asarray(h_jax)
        np.testing.assert_allclose(h_port.numpy(), h_jax, atol=TOL[fused])
        want = np.asarray(method.make_hash_code(jnp.asarray(h_jax)))
        got = port.make_hash_code(h_port).numpy()
        pairs = h_jax.reshape(h_jax.shape[0], -1, 2)
        decided = np.abs(pairs[..., 1] - pairs[..., 0]) >= eps
        np.testing.assert_array_equal(got[decided], want[decided])
        assert set(np.unique(got)) <= {-1.0, 1.0}


def test_weights_round_trip_bit_for_bit(models):
    """dcmht_from_torch_state(dcmht_state_from_jax(p, s)) == (p, s), bits."""
    _, variables, port, _, _, _ = models
    sd = dcmht_state_from_jax(variables["params"], variables["batch_stats"])
    assert set(sd) == set(port.state_dict())
    params, state = dcmht_from_torch_state(sd)
    for tree, want in ((params, variables["params"]),
                       (state["batch_stats"], variables["batch_stats"])):
        assert (jax.tree_util.tree_structure(tree)
                == jax.tree_util.tree_structure(want))
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree),
                                jax.tree_util.tree_leaves(want)):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, path
            assert a.tobytes() == b.tobytes(), path


def test_random_init_is_seeded_and_finite():
    a = DCMHTModel(CLIPConfig.tiny(), BITS).init_weights(prng.PRNGKey(3))
    b = DCMHTModel(CLIPConfig.tiny(), BITS).init_weights(prng.PRNGKey(3))
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    img = torch.from_numpy(np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        h = a.eval().encode_image(img)
    assert h.shape == (2, 2 * BITS) and torch.isfinite(h).all()


def test_bf16_model_close_to_fp32(models):
    """The serving dtype: bf16 matmuls with fp32 params and LayerNorm stats
    stay near the fp32 forward (bf16 keeps about 3 significant digits, so
    the softmax-pair outputs may move by a few 1e-2)."""
    _, _, port, img, txt, kpm = models
    bf = DCMHTModel(CLIPConfig.tiny(dtype=torch.bfloat16), BITS)
    bf.load_state_dict(port.state_dict())
    with torch.no_grad():
        for f in (lambda m: m.encode_image(torch.from_numpy(img)),
                  lambda m: m.encode_text(torch.from_numpy(txt), torch.from_numpy(kpm))):
            a, b = f(bf.eval()), f(port)
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-2)
