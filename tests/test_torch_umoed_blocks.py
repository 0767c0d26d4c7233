"""UMoED's blocks in cmh_torch against cmh_tpu on the CPU: the subspace
codebook and ``linear_subspace_hash``, ``MultiHeadAttention``'s
cross-attention (``kv``), dropout on the probabilities and torch's default
init, the Soft-MoE and its encoder layer, the slot-aligned pairwise set
distance, and the token hash in each hash mode.

Weights come from cmh_tpu's initializers and cross through
``models/convert.py``; fp32 on both sides, dropout 0 where values are
compared. Tolerances: outputs and gradients 1e-5 relative (to the largest
magnitude of the reference); the codebook, packing and ``linear_subspace``
codes exact, except slots whose top two logits lie within 1e-5 (relative)
of each other, which are counted and printed. Cross-attention is also held
against torch's ``multi_head_attention_forward``, the reference layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (before any torch work)
import torch
import torch.nn.functional as F

import cmh_tpu.models.umoed as jax_umoed
import cmh_tpu.ops.hashing as jax_hashing
import cmh_torch.models.clip.model as port_clip
import cmh_torch.models.umoed as port_umoed
import cmh_torch.ops.hashing as port_hashing
from cmh_torch.models import convert, flax_init
from cmh_torch.models.common import dropout_rng
from cmh_torch.utils import prng
from cmh_tpu.models.clip.model import MultiHeadAttention as JaxMHA
from tests.test_torch_umoed import _assert_codes, _rel


@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16])
def test_codebook_and_linear_subspace_hash_exact(bits):
    np.testing.assert_array_equal(port_hashing.subspace_codebook(bits),
                                  jax_hashing._subspace_codebook(bits))
    rng = np.random.RandomState(bits)
    logits = rng.randn(3, 5, 2**bits).astype(np.float32)
    logits[0, 0, :2] = logits[0, 0].max() + 1.0          # a tie: the first maximum wins
    got = port_hashing.linear_subspace_hash(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_hashing.linear_subspace_hash(
        jnp.asarray(logits))))
    packed = port_hashing.pack_bits(torch.from_numpy(got))
    np.testing.assert_array_equal(port_hashing.as_uint32(packed),
                                  np.asarray(jax_hashing.pack_bits(jnp.asarray(got))))
    with pytest.raises(ValueError):
        port_hashing.subspace_codebook(3)


@pytest.mark.parametrize("hash_func,merge", [("linear_subspace", "concatenate"),
                                             ("softmax", "mean"), ("tanh", "concatenate"),
                                             ("tanh", "mean")])
def test_token_hash_modes_match(hash_func, merge):
    """One decoder layer with the Soft-MoE FFN and a first layer (hidden 8 of
    width 16), then each hash of the slots' logits."""
    tokens = np.random.RandomState(2).randn(3, 7, 16).astype(np.float32)
    jh = jax_umoed.UMoEDTokenHash(
        embed_dim=16, hidden_dim=8, vocab_size=4, set_dim=4, decoder_heads=2, decoder_layers=1,
        dropout=0.0, moe=True, num_experts=2, slots_per_expert=2, hash_func=hash_func,
        merge_func=merge)
    v = jax.tree_util.tree_map(np.asarray, jh.init(jax.random.PRNGKey(0), jnp.asarray(tokens),
                                                   train=False))
    ph = port_umoed.UMoEDTokenHash(16, 8, 4, 4, 2, 1, 0.0, True, 2, 2, hash_func, merge)
    ph.load_state_dict({k[1:]: t for k, t in convert._umoed_head(v["params"], "").items()})
    ph.eval()
    je, jhash = jh.apply(v, jnp.asarray(tokens), train=False)
    with torch.no_grad():
        pe, phash = ph(torch.from_numpy(tokens))
    assert _rel(pe.numpy(), je) <= 1e-5 and phash.shape == jhash.shape
    if hash_func == "linear_subspace":
        _assert_codes(phash.numpy(), jhash, je, 2)
    else:
        assert _rel(phash.numpy(), jhash) <= 1e-5


def _mha_pair(width=16, heads=2, seed=0):
    x = np.random.RandomState(seed).randn(3, 5, width).astype(np.float32)
    mem = np.random.RandomState(seed + 1).randn(3, 7, width).astype(np.float32)
    jm = JaxMHA(width, heads, jnp.float32, torch_init=True)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(seed), jnp.asarray(x), kv=jnp.asarray(mem))["params"])
    pm = port_clip.MultiHeadAttention(width, heads, torch.float32)
    pm.load_state_dict({k[1:]: v for k, v in convert._attention(params, "").items()})
    return jm, params, pm, x, mem


def test_cross_attention_matches_cmh_tpu_and_torch():
    jm, params, pm, x, mem = _mha_pair()
    jout, jw = jm.apply({"params": params}, jnp.asarray(x), kv=jnp.asarray(mem))
    tx, tmem = torch.from_numpy(x).requires_grad_(), torch.from_numpy(mem).requires_grad_()
    out, w = pm(tx, kv=tmem)
    assert out.shape == (3, 5, 16) and w.shape == (3, 5, 7)
    assert _rel(out.detach().numpy(), jout) <= 1e-5 and _rel(w.detach().numpy(), jw) <= 1e-5
    # torch's own MultiheadAttention, the reference decoder's layer
    ref, ref_w = F.multi_head_attention_forward(
        tx.transpose(0, 1), tmem.transpose(0, 1), tmem.transpose(0, 1), 16, 2,
        pm.in_proj_weight, pm.in_proj_bias, None, None, False, 0.0, pm.out_proj.weight,
        pm.out_proj.bias, training=False, need_weights=True)
    assert _rel(out.detach().numpy(), ref.transpose(0, 1).detach().numpy()) <= 1e-5
    assert _rel(w.detach().numpy(), ref_w.detach().numpy()) <= 1e-5
    g = np.random.RandomState(9).randn(3, 5, 16).astype(np.float32)
    jgx, jgm = jax.grad(lambda a, b: jnp.sum(jm.apply({"params": params}, a, kv=b)[0] * g),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(mem))
    (out * torch.from_numpy(g)).sum().backward()
    assert _rel(tx.grad.numpy(), jgx) <= 1e-5 and _rel(tmem.grad.numpy(), jgm) <= 1e-5


def test_torch_init_and_the_attention_paths(monkeypatch):
    """cmh_tpu's torch-default init of the attention (the port draws the same
    leaves: ``tests/test_torch_seed_parity.py``) within its bounds; the paths
    K2 takes and the explicit ones, dropout on the probabilities under one
    step key drawing the same mask again."""
    d = 64
    _, params, _, _, _ = _mha_pair(width=d, heads=4)
    mha = port_clip.MultiHeadAttention(d, 4, torch.float32, attn_dropout=0.5)
    mha.load_state_dict({k[1:]: v for k, v in convert._attention(params, "").items()})
    mha.attn_drop.path = ("self_attn", "attn_drop")
    for w, jw, bound in ((mha.in_proj_weight, params["in_proj_kernel"], (6 / (4 * d)) ** 0.5),
                         (mha.out_proj.weight, params["out_proj_kernel"], d**-0.5)):
        for a in (w.detach().numpy(), np.asarray(jw)):
            assert np.abs(a).max() <= bound and abs(a.std() / (bound / 3**0.5) - 1) < 0.05
    assert not mha.in_proj_bias.any() and not mha.out_proj.bias.any()
    # K2 is self-attention only and returns no weights: the explicit path
    # runs for cross-attention and for dropout in training
    calls = []
    real = port_clip.fused_attention
    monkeypatch.setattr(port_clip, "fused_attention",
                        lambda *a: calls.append(1) or real(*a))
    x = torch.randn(2, 5, d, generator=torch.Generator().manual_seed(1))
    mha.eval()
    quiet, _ = mha(x, need_weights=False)
    mha(x, need_weights=False, kv=x)
    assert len(calls) == 1
    mha.train()
    with dropout_rng(prng.PRNGKey(0)):
        dropped, _ = mha(x, need_weights=False)
    assert len(calls) == 1 and not torch.allclose(dropped, quiet)
    with dropout_rng(prng.PRNGKey(0)):
        again, _ = mha(x, need_weights=False)
    assert torch.equal(dropped, again)


def test_soft_moe_blocks_match():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 8).astype(np.float32)
    jm = jax_umoed.SoftMoE(in_features=8, out_features=6, num_experts=3, slots_per_expert=2)
    p = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    pm = port_umoed.SoftMoE(8, 6, 3, 2)
    pm.load_state_dict({"phi": torch.from_numpy(p["params"]["phi"]),
                        "experts.weight": torch.from_numpy(p["params"]["expert_kernel"]),
                        "experts.bias": torch.from_numpy(p["params"]["expert_bias"])})
    tx = torch.from_numpy(x).requires_grad_()
    out = pm(tx)
    assert _rel(out.detach().numpy(), jm.apply(p, jnp.asarray(x))) <= 1e-5
    jg = jax.grad(lambda a: jnp.sum(jm.apply(p, a) ** 2))(jnp.asarray(x))
    (out**2).sum().backward()
    assert _rel(tx.grad.numpy(), jg) <= 1e-5
    # the port draws cmh_tpu's init of the Soft-MoE from the same key
    drawn = flax_init.draw(prng.PRNGKey(0), p["params"], flax_init.HEAD_RULES["UMoED"])
    for name, leaf in p["params"].items():
        np.testing.assert_array_equal(drawn[name].numpy(), leaf, err_msg=name)
    # the encoder layer (self-attention with a key-padding mask, Soft-MoE FFN)
    src = rng.randn(2, 5, 16).astype(np.float32)
    kpm = np.zeros((2, 5), bool)
    kpm[0, 3:] = True
    jl = jax_umoed.SoftMoEEncoderLayer(d_model=16, nhead=2, dim_feedforward=32, num_experts=2,
                                       slots_per_expert=2)
    v = jax.tree_util.tree_map(np.asarray, jl.init(jax.random.PRNGKey(0), jnp.asarray(src),
                                                   jnp.asarray(kpm), train=False))["params"]
    pl = port_umoed.SoftMoEEncoderLayer(16, 2, 32, 0.0, 2, 2)
    sd = convert._attention(v["self_attn"], "self_attn")
    sd.update(convert._linear(v["linear1"], "linear"))
    sd.update(convert._norm(v["norm1"]["ln"], "norm1"))
    sd.update(convert._norm(v["norm2"]["ln"], "norm2"))
    sd.update({"moe.phi": torch.from_numpy(v["moe"]["phi"]),
               "moe.experts.weight": torch.from_numpy(v["moe"]["expert_kernel"]),
               "moe.experts.bias": torch.from_numpy(v["moe"]["expert_bias"])})
    pl.load_state_dict(sd)
    pl.eval()
    with torch.no_grad():
        got = pl(torch.from_numpy(src), torch.from_numpy(kpm))
    assert _rel(got.numpy(), jl.apply({"params": v}, jnp.asarray(src), jnp.asarray(kpm),
                                      train=False)) <= 1e-5


@pytest.mark.parametrize("mode,extreme", [("cosine", True), ("cosine", False),
                                          ("euclid", False)])
def test_pairwise_set_distance_matches(mode, extreme):
    rng = np.random.RandomState(1)
    img, txt = rng.randn(3, 4, 8).astype(np.float32), rng.randn(3, 4, 8).astype(np.float32)
    for return_sim in ((False, True) if mode == "cosine" else (False,)):
        got = port_umoed.pairwise_set_distance(torch.from_numpy(img), torch.from_numpy(txt),
                                               extreme, 0.3, return_sim, mode)
        want = jax_umoed.pairwise_set_distance(jnp.asarray(img), jnp.asarray(txt), extreme, 0.3,
                                               return_sim, mode)
        assert _rel(got.numpy(), want) <= 1e-5
