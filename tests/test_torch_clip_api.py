"""cmh_torch's standalone CLIP API (``models/clip/api.py``) against
cmh_tpu's, on the CPU.

``available_models`` and the named configurations are cmh_tpu's;
``load`` by name builds that configuration (seeded random init), and from
a local TorchScript archive infers cmh_tpu's geometry and holds the file's
weights exactly; ``tokenize`` gives cmh_tpu's ids (a CPU int32 tensor),
truncates alike and raises alike on overlong input. A narrow CLIP at
ViT-B/16's vision length, S = 197 (56 px in patches of 4, two layers of
width 64), runs the port's plain attention route against cmh_tpu's fused
attention (Pallas, interpret mode), forward and parameter gradients, both
fp32: within 1e-5 relative to each tensor's largest value (only the order
of fp32 sums differs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (before any torch work)
import torch

from cmh_torch.models.clip import api
from cmh_torch.models.clip.loader import save_torchscript_archive
from cmh_torch.models.clip.model import CLIP, CLIPConfig
from cmh_torch.models.convert import clip_state_from_jax, clip_state_to_jax
from cmh_torch.utils import prng
from cmh_tpu.models.clip import api as jax_api
from cmh_tpu.models.clip.model import CLIP as JaxCLIP
from cmh_tpu.models.clip.model import CLIPConfig as JaxCLIPConfig

REL = 1e-5
NARROW = dict(embed_dim=32, image_resolution=56, vision_layers=2, vision_width=64,
              vision_patch_size=4, context_length=16, vocab_size=49408,
              transformer_width=64, transformer_heads=2, transformer_layers=2)


def _fields(cfg):
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k != "dtype"}


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_available_models_and_configs_match_cmh_tpu():
    assert api.available_models() == jax_api.available_models() == [
        "ViT-B/32", "ViT-B/16", "ViT-L/14"]
    for name in api.available_models():
        mine, theirs = api._MODEL_CONFIGS[name], jax_api._MODEL_CONFIGS[name]
        assert _fields(mine) == _fields(theirs)
        assert (mine.vision_heads, mine.num_patches + 1) == \
            (theirs.vision_heads, theirs.num_patches + 1)
    assert api._MODEL_CONFIGS["ViT-B/16"].num_patches + 1 == 197
    assert api._MODEL_CONFIGS["ViT-L/14"].num_patches + 1 == 257


def test_load_by_name_builds_the_named_config():
    """ViT-B/16 on the CPU, as asked: the named geometry in the asked dtype,
    its 197 vision positions, eval mode, the weights of ``CLIP.init_weights``
    from the given key."""
    model, cfg = api.load("ViT-B/16", dtype=torch.float32, device="cpu", key=prng.PRNGKey(4))
    assert cfg == dataclasses.replace(api._MODEL_CONFIGS["ViT-B/16"], dtype=torch.float32)
    assert _fields(cfg) == _fields(jax_api._MODEL_CONFIGS["ViT-B/16"])
    sd = model.state_dict()
    assert sd["visual.conv1.weight"].shape == (768, 3, 16, 16)
    assert sd["visual.positional_embedding"].shape == (197, 768)
    assert not model.training and sd["visual.proj"].device.type == "cpu"
    # cmh_tpu's patch kernel: lecun-normal under flax's key for visual/conv1 (HWIO)
    kernel = prng.lecun_normal(prng.flax_key(prng.PRNGKey(4), "visual", "conv1", 1),
                               (16, 16, 3, 768))
    torch.testing.assert_close(sd["visual.conv1.weight"], kernel.permute(3, 2, 0, 1),
                               rtol=0, atol=0)


def test_load_refuses_unknown_names_and_a_missing_card(monkeypatch):
    with pytest.raises(ValueError, match="unknown model 'RN50'"):
        api.load("RN50", device="cpu")
    with pytest.raises(AssertionError, match="unknown model 'RN50'"):
        jax_api.load("RN50")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.load("ViT-B/32")


def test_load_from_a_local_archive_matches_cmh_tpu(tmp_path):
    """A tiny CLIP written as OpenAI's TorchScript archive (with its three
    integer entries): the geometry is inferred as cmh_tpu infers it, every
    weight is the file's, and the image and text encodings agree."""
    src = CLIP(CLIPConfig.tiny())
    src.init_weights(prng.PRNGKey(21))
    ints = {"input_resolution": torch.tensor(32), "context_length": torch.tensor(16),
            "vocab_size": torch.tensor(49408)}
    path = str(tmp_path / "tiny.pt")
    save_torchscript_archive({**src.state_dict(), **ints}, path)
    model, cfg = api.load("ViT-L/14", checkpoint_path=path, dtype=torch.float32, device="cpu")
    jmodule, jvars, jcfg = jax_api.load(checkpoint_path=path, dtype=jnp.float32)
    # the text tower's heads come from its width, width // 64, as in cmh_tpu
    assert _fields(cfg) == _fields(jcfg) == _fields(
        dataclasses.replace(CLIPConfig.tiny(), transformer_heads=1))
    theirs = clip_state_from_jax(jax.tree_util.tree_map(np.asarray, jvars["params"]), "m")
    mine = model.state_dict()
    assert set(mine) == {k[2:] for k in theirs}
    for k, v in theirs.items():
        assert torch.equal(mine[k[2:]], v) and torch.equal(mine[k[2:]], src.state_dict()[k[2:]])
    img = np.random.RandomState(2).randn(2, 32, 32, 3).astype(np.float32)
    txt = np.asarray(api.tokenize(["a dog on the grass", "two cats"], context_length=16))
    with torch.no_grad():
        got = (model.encode_image(torch.from_numpy(img))[0],
               model.encode_text(torch.from_numpy(txt))[0])
    want = (jmodule.apply(jvars, jnp.asarray(img), method=lambda m, x: m.encode_image(x))[0],
            jmodule.apply(jvars, jnp.asarray(txt), method=lambda m, t: m.encode_text(t))[0])
    for a, r in zip(got, want):
        assert a.shape == r.shape and _rel(a.numpy(), r) <= REL


CAPTIONS = ["a dog running on the grass", "A red car parked next to 3 trees.",
            "café terrace at night, Paris", "", "children_playing football at 5pm!!"]


@pytest.mark.parametrize("context_length", [77, 12])
def test_tokenize_matches_cmh_tpu(context_length):
    texts = [t for t in CAPTIONS if len(t) < 20] if context_length == 12 else CAPTIONS
    got = api.tokenize(texts, context_length=context_length)
    want = jax_api.tokenize(texts, context_length=context_length)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    assert got.shape == (len(texts), context_length)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(api.tokenize(CAPTIONS[0]).numpy(),
                                  jax_api.tokenize(CAPTIONS[0]))


def test_tokenize_truncates_or_raises_as_cmh_tpu():
    long = "a very long caption about many things " * 4
    got = api.tokenize([long, "short"], context_length=10, truncate=True)
    want = jax_api.tokenize([long, "short"], context_length=10, truncate=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[0, -1]) == 49407
    with pytest.raises(RuntimeError) as mine:
        api.tokenize(long, context_length=10)
    with pytest.raises(RuntimeError) as theirs:
        jax_api.tokenize(long, context_length=10)
    assert str(mine.value) == str(theirs.value)
    assert "too long for context length 10" in str(mine.value)


def test_narrow_clip_at_vit_b16_length_matches_pallas(monkeypatch):
    """S = 197 vision tokens (one fused block, then the explicit last one):
    the port's plain route on the CPU against cmh_tpu's fused attention in
    interpret mode, the image encoding and the gradients of every vision
    parameter."""
    monkeypatch.setenv("CMH_TPU_FUSED", "1")
    cfg = CLIPConfig(**NARROW, dtype=torch.float32)
    assert cfg.num_patches + 1 == 197
    model = CLIP(cfg)
    model.init_weights(prng.PRNGKey(5))
    params = clip_state_to_jax({f"b.{k}": v for k, v in model.state_dict().items()}, "b")
    jmodel = JaxCLIP(JaxCLIPConfig(**NARROW, dtype=jnp.float32))
    rng = np.random.RandomState(6)
    img = rng.randn(2, 56, 56, 3).astype(np.float32)
    proj = rng.randn(2, 32).astype(np.float32)

    def jloss(p):
        cls = jmodel.apply({"params": p}, jnp.asarray(img),
                           method=lambda m, x: m.encode_image(x))[0]
        return jnp.sum(cls * proj), cls

    (_, jcls), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    cls = model.encode_image(torch.from_numpy(img))[0]
    (cls * torch.from_numpy(proj)).sum().backward()
    assert _rel(cls.detach().numpy(), jcls) <= REL
    want = clip_state_from_jax(jax.tree_util.tree_map(np.asarray, jgrad), "b")
    grads = {f"b.{k}": p.grad for k, p in model.named_parameters() if k.startswith("visual.")}
    assert len(grads) == 4 + 2 * 2 + 2 * 12
    for k, g in grads.items():
        assert g is not None and _rel(g.numpy(), want[k]) <= REL, k
