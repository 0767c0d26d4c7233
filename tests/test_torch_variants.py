"""The variant-timing tools edit kernel sources by string replacement
(``cmh_torch/tools/_variants.py``); every edit must find its target once."""

from pathlib import Path

import pytest

import torch_threads  # noqa: F401  (before any torch work)
from cmh_torch.tools import _variants, hamming_variants, threefry_variants
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


@pytest.mark.parametrize("name", sorted(threefry_variants.variants()))
def test_threefry_variant_edits_apply(name):
    """As for hamming: each edit once, and a variant without edits changes
    a setting of ``ops/random.py`` that exists."""
    import cmh_torch.ops.random as R

    source = _variants.source("threefry")
    text = _variants.edited(source, threefry_variants.variants()[name], name)
    settings = threefry_variants.SETTINGS.get(name, {})
    assert (text == source) == (name == "base" or bool(settings))
    assert all(hasattr(R, k) for k in settings)


def test_sass_counts_by_pipe():
    text = """
        Function : kernel_a
        /*0000*/                   IMAD.MOV.U32 R1, RZ, RZ, c[0x0][0x28] ;
        /*0010*/                   SHF.L.W.U32.HI R2, R3, 0xd, R3 ;
        /*0020*/              @!P0 LOP3.LUT R2, R2, R4, RZ, 0x3c, !PT ;
        /*0030*/                   IMAD.IADD R4, R4, 0x1, R2 ;
        /*0040*/                   BRA 0x40 ;
        /*0050*/                   NOP ;
        Function : kernel_b
        /*0000*/                   IMAD.WIDE.U32 R2, R3, c[0x0][0x210], RZ ;
"""
    counts = threefry_variants.count_sass(text)
    assert counts["kernel_a"] == {"alu": 2, "fma": 2, "other": 1, "IMAD.MOV": 1, "SHF": 1,
                                  "LOP3": 1, "IMAD.IADD": 1, "BRA": 1}
    assert counts["kernel_b"] == {"alu": 0, "fma": 1, "other": 0, "IMAD.WIDE": 1}


def test_edit_with_a_missing_or_repeated_target_raises():
    with pytest.raises(ValueError, match="found 0 times"):
        _variants.edited("abc", [("x", "y")], "missing")
    with pytest.raises(ValueError, match="found 2 times"):
        _variants.edited("aa", [("a", "b")], "repeated")
