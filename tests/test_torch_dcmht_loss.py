"""cmh_torch's DCMHT loss, similarity functions and training-mode BatchNorm
against cmh_tpu's, on the same outputs from numpy.

Tolerances: fp32 with the same formulas; cmh_tpu's matmuls run at
``precision="highest"`` and the port's with TF32 off, so only the order of
sums differs: 1e-5 relative on the loss terms, 1e-4 on the gradient (the
duplicated row puts one pair at the square root's kink, where the fp32
residue of the expanded distance decides the subgradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (before any torch work)
import torch

from cmh_torch.models.common import BatchNorm1d
from cmh_torch.models.dcmht import DCMHTMethod, dcmht_loss_fn
from cmh_torch.ops.metrics import euclidean_similarity
from cmh_tpu.models.common import _TorchBatchNorm
from cmh_tpu.models.dcmht import dcmht_loss_fn as jax_loss_fn
from cmh_tpu.ops.metrics import euclidean_similarity as jax_euclidean

BITS = 8


def _outputs(seed, batch=12, classes=5):
    rng = np.random.RandomState(seed)
    logits = rng.randn(2, batch, BITS, 2).astype(np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    probs = (e / e.sum(-1, keepdims=True)).reshape(2, batch, 2 * BITS)
    labels = (rng.rand(batch, classes) > 0.6).astype(np.float32)
    # every item carries a label, as in the datasets: an unlabelled item's
    # self-pair would count as negative, where sqrt of the fp32 cancellation
    # residue of |a|² − 2a·a + |a|² (about 1e-3 either way) enters the loss
    labels[np.arange(batch), rng.randint(0, classes, batch)] = 1
    labels[-1] = labels[0]            # a duplicate row: one pair at distance 0
    probs[:, -1] = probs[:, 0]
    return probs[0], probs[1], labels


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + k + "/") if isinstance(v, dict)
                   else {prefix + k: float(v)})
    return out


@pytest.mark.parametrize("sim", ["euclidean", "cosine"])
def test_loss_and_gradients_match(sim):
    img, txt, labels = _outputs(1 if sim == "euclidean" else 2)
    kw = dict(output_dim=BITS, vartheta=0.75, threshold=0.1, quan_alpha=0.01,
              similarity_function=sim)
    jfn = jax_loss_fn(**kw)

    def jloss(a, b):
        total, ld, _ = jfn((a, b), {"label": jnp.asarray(labels)}, {}, 0)
        return total, ld

    (jtotal, jld), jgrads = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(img), jnp.asarray(txt))
    ti = torch.from_numpy(img).requires_grad_()
    tt = torch.from_numpy(txt).requires_grad_()
    total, ld, _ = dcmht_loss_fn(**kw)((ti, tt), {"label": torch.from_numpy(labels)}, {}, 0)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-5)
    want, got = _flat(jax.tree_util.tree_map(float, jld)), _flat(
        jax.tree_util.tree_map(lambda t: t.detach(), ld))
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)
    for g, w in zip((ti.grad, tt.grad), jgrads):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)


def test_euclidean_has_a_zero_subgradient_at_zero():
    a = torch.tensor([[0.3, 0.7], [0.3, 0.7]], requires_grad=True)
    d = euclidean_similarity(a, a)
    assert float(d[0, 1].detach()) == 0.0
    d.sum().backward()
    assert torch.isfinite(a.grad).all()
    jd = jax.grad(lambda x: jax_euclidean(x, x).sum())(jnp.asarray(a.detach().numpy()))
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(jd), atol=1e-6)


def test_training_batchnorm_matches_torch_semantics_of_cmh_tpu():
    rng = np.random.RandomState(4)
    feats = 6
    bn = BatchNorm1d(feats)
    module = _TorchBatchNorm(feats)
    variables = module.init(jax.random.PRNGKey(0), jnp.zeros((4, feats)), train=False)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.rand(feats).astype(np.float32) + 0.5))
        bn.bias.copy_(torch.from_numpy(rng.randn(feats).astype(np.float32)))
    params = {"scale": jnp.asarray(bn.weight.detach().numpy()),
              "bias": jnp.asarray(bn.bias.detach().numpy())}
    stats = variables["batch_stats"]
    bn.train()
    for step in range(3):
        x = (rng.randn(10, feats) * 2 + 1).astype(np.float32)
        y, upd = module.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                              train=True, mutable=["batch_stats"])
        stats = upd["batch_stats"]
        out = bn(torch.from_numpy(x))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]),
                                   rtol=1e-6, atol=1e-6)
    bn.eval()
    x = rng.randn(3, feats).astype(np.float32)
    y = module.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    np.testing.assert_allclose(bn(torch.from_numpy(x)).detach().numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-5)


def test_method_contract():
    method = DCMHTMethod.from_config({"clip_variant": "tiny", "hash_func": "softmax"},
                                     output_dim=BITS)
    assert method.eval_code_dims() == BITS == method.output_dim
    codes = method.make_hash_code(torch.tensor([[0.9, 0.1] * BITS, [0.2, 0.8] * BITS]))
    assert codes.tolist() == [[-1.0] * BITS, [1.0] * BITS]
    names = [n for n, _ in method.model.named_parameters()]
    assert all(n.startswith(("backbone.", "hash.")) for n in names)
