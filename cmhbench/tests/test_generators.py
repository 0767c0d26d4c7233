"""What the benchmark makes from a seed: the same seed gives the same
weights, batches and arrivals; seeds share one set of sizes and gaps."""

import tempfile

import pytest
import torch

from cmhbench import inputs, weights
from cmhbench.common import INPUTS, generator
from cmhbench.kinds import search
from cmhbench.reference import tokenizer
from cmhbench.tests import tiny

BIG = 2**31 + 4093           # seeds reach past 32 signed bits


def test_weights_repeat_for_a_seed_and_differ_across_seeds():
    cfg = tiny.config()
    a, clip, heads = weights.make(cfg, BIG, "cpu")
    b = weights.make(cfg, BIG, "cpu")[0]
    c = weights.make(cfg, BIG + 1, "cpu")[0]
    assert a.dtype == torch.float16 and torch.equal(a, b) and not torch.equal(a, c)
    assert clip["visual.conv1.weight"].shape == (64, 3, 8, 8)
    assert heads["hash.img_hash.fc2.weight"].shape == (16, 32)
    assert bool((heads["hash.img_hash.norm.running_var"] > 0).all())
    ref = weights.reference_params(cfg, BIG, "cpu")
    assert torch.equal(ref["backbone.visual.proj"], clip["visual.proj"].float())


def test_batches_repeat_and_keep_the_caption_layout():
    cfg, tr = tiny.config(), tiny.traffic("train-b256", min_tokens=4, max_tokens=12)
    one = inputs.batch(generator(BIG, INPUTS, "cpu"), 16, cfg, tr, "cpu")
    two = inputs.batch(generator(BIG, INPUTS, "cpu"), 16, cfg, tr, "cpu")
    for k in one:
        assert torch.equal(one[k], two[k])
    text, kpm = one["text"], one["key_padding_mask"]
    length = (text != 0).sum(1)
    assert bool(((length >= 4) & (length <= 12)).all())
    assert bool((text[:, 0] == inputs.SOT).all())
    assert torch.equal(text.long().argmax(1), length - 1)        # the end id is the largest
    assert torch.equal(kpm, text == 0)
    assert bool((one["label"].sum(1) >= 1).all())


def test_every_seed_offers_the_same_gaps_and_lengths_in_its_own_order():
    cfg = tiny.config()
    tr = tiny.traffic("search-text-poisson", rate=50)
    with tempfile.TemporaryDirectory() as d:
        plans = [search.schedule(tiny.context(cfg, tr, d, {}, seed=s, seconds=4.0), 4.0, 0)
                 for s in (BIG, BIG, BIG + 7)]
    assert plans[0] == plans[1] and plans[0] != plans[2]
    for plan in plans:
        assert len(plan) == 200 and plan[0][0] == 0.0 and plan[-1][0] < 4.0
    def gaps(plan):
        return [b[0] - a[0] for a, b in zip(plan, plan[1:])]

    assert gaps(plans[0]) != gaps(plans[2])
    assert sorted(gaps(plans[0]) + [4.0 - plans[0][-1][0]]) == pytest.approx(
        sorted(gaps(plans[2]) + [4.0 - plans[2][-1][0]]), abs=1e-9)
    lengths = [[len(c.split()) for _, c in plan] for plan in plans]
    assert lengths[0] != lengths[2] and sorted(lengths[0]) == sorted(lengths[2])
    assert all(8 <= len(c.split()) <= 16 for _, c in plans[0])


def test_captions_are_vocabulary_words_the_port_tokenizes_alike():
    from cmh_torch.models.clip.tokenizer import SimpleTokenizer, tokenize_caption

    words = set(inputs.vocabulary_words())
    assert len(words) > 20000
    caps = inputs.text_captions(torch.Generator().manual_seed(3), 40, 8, 16)
    port = SimpleTokenizer()
    for c in caps:
        assert set(c.split()) <= words
        ids, _ = tokenize_caption(port, c, 32)
        assert tokenizer.encode(c, 32) == ids.tolist()
