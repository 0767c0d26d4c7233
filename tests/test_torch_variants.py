"""The variant-timing tools edit kernel sources by string replacement
(``cmh_torch/tools/_variants.py``); every edit must find its target once."""

from pathlib import Path

import pytest

from cmh_torch.tools import _variants, hamming_variants
from cmh_torch.tools.layernorm_variants import VARIANTS

ROOT = Path(__file__).resolve().parents[1]
SOURCE = (ROOT / "cmh_torch" / "csrc" / "layernorm.cu").read_text()
HAMMING = (ROOT / "cmh_torch" / "csrc" / "hamming.cu").read_text()


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_layernorm_variant_edits_apply(name):
    text = _variants.edited(SOURCE, VARIANTS[name], name)
    assert (text == SOURCE) == (name == "base")


@pytest.mark.parametrize("name", sorted(hamming_variants.variants()))
def test_hamming_variant_edits_apply(name):
    """Every edit finds its target once; a variant without edits changes a
    setting of the wrapper that exists."""
    import cmh_torch.ops.hamming as H

    text = _variants.edited(HAMMING, hamming_variants.variants()[name], name)
    settings = hamming_variants.SETTINGS.get(name, {})
    assert (text == HAMMING) == (name == "base" or bool(settings))
    assert all(hasattr(H, k) for k in settings)


def test_edit_with_a_missing_or_repeated_target_raises():
    with pytest.raises(ValueError, match="found 0 times"):
        _variants.edited("abc", [("x", "y")], "missing")
    with pytest.raises(ValueError, match="found 2 times"):
        _variants.edited("aa", [("a", "b")], "repeated")
