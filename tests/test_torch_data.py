"""cmh_torch's tokenizer, eval transform and config loader against cmh_tpu."""

import os

import numpy as np
import pytest

import torch_threads  # noqa: F401  (before any torch work)
from cmh_torch.config import load_config
from cmh_torch.data.transforms import eval_transform, normalize
from cmh_torch.models.clip.tokenizer import SimpleTokenizer, tokenize_caption
from cmh_tpu.config import load_config as jax_load_config
from cmh_tpu.models.clip.tokenizer import SimpleTokenizer as JaxTokenizer
from cmh_tpu.models.clip.tokenizer import tokenize_caption as jax_tokenize_caption

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CAPTIONS = [
    "a dog on the grass",
    "Two people, riding bikes!!! down a hill...",
    "A red car parked next to 3 trees at 10:45pm.",
    "café crème, naïve façade — über-cool résumé",
    "it's the dog's bone; they're gone (we'll see)",
    "numbers 12345 and 3.14159, #hashtag @user",
    "C'est déjà l'été à Paris",
    "ÉCOLE Ñandú Straße",
    "under_score and snake_case_words",
    "cafÃ© mojibake text",
    "&amp;lt; html &amp; entities &gt;",
    "   lots   of\twhitespace\n here  ",
    "a very long caption " * 10,
    "",
]


@pytest.fixture(scope="module")
def tokenizers():
    return SimpleTokenizer(), JaxTokenizer()


@pytest.mark.parametrize("max_words", [32, 12])
def test_tokenize_caption_ids_equal(tokenizers, max_words):
    port, ref = tokenizers
    for cap in CAPTIONS:
        ids, mask = tokenize_caption(port, cap, max_words)
        rids, rmask = jax_tokenize_caption(ref, cap, max_words)
        np.testing.assert_array_equal(ids, rids, err_msg=cap)
        np.testing.assert_array_equal(mask, rmask, err_msg=cap)
        assert ids.dtype == np.int32 and ids.shape == (max_words,)


def test_decode_round_trip(tokenizers):
    port, _ = tokenizers
    assert port.decode(port.encode("a dog on the grass")).strip() == "a dog on the grass"
    assert port.vocab_size == 49408


def test_eval_transform_equals_pil_path(monkeypatch):
    from PIL import Image

    from cmh_tpu.data.transforms import eval_transform as jax_eval_transform

    monkeypatch.setenv("CMH_TPU_NO_NATIVE", "1")   # cmh_tpu's PIL path
    rng = np.random.RandomState(0)
    for shape, size in (((40, 52, 3), 32), ((300, 200, 3), 224)):
        img = Image.fromarray(rng.randint(0, 255, shape, dtype=np.uint8))
        got = eval_transform(img, size)
        np.testing.assert_array_equal(got, jax_eval_transform(img, size))
        assert got.shape == (size, size, 3) and got.dtype == np.float32
    dark = np.ones((2, 2, 3), np.uint8)   # integer input is divided by 255
    np.testing.assert_allclose(normalize(dark)[0, 0],
                               (1 / 255 - np.array([0.48145466, 0.4578275, 0.40821073]))
                               / np.array([0.26862954, 0.26130258, 0.27577711]), rtol=1e-6)


@pytest.mark.parametrize("name", ["config.yaml", "synthetic.yaml"])
def test_load_config_equals_cmh_tpu(name):
    path = os.path.join(ROOT, "configs", "DCMHT", name)
    cfg = load_config(path)
    assert cfg.to_dict() == jax_load_config(path).to_dict()
    assert cfg.run.get("output_dim") == jax_load_config(path).run.get("output_dim")
    with pytest.raises(FileNotFoundError):
        load_config(os.path.join(ROOT, "configs", "missing.yaml"))
