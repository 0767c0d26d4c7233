"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have, planted in the port, on the CPU at the port's
tiny CLIP, against the cell's own limits. (The exchange between cards is
no fault of these one-card cells.)"""

import tempfile

import pytest

from cmhbench import spec
from cmhbench.kinds import search, train, valid
from cmhbench.tests import tiny


def run(kind, traffic, cell, seconds=0.3):
    with tempfile.TemporaryDirectory() as d:
        out = kind.run(tiny.context(tiny.config(), traffic, d, spec.limits(cell),
                                      seconds=seconds))
    return {c.name: c.ok for c in out.checks}


TRAIN = dict(batch=16, pool=4, min_tokens=4, max_tokens=12, warm_steps=1, reference_chunk=8)


@pytest.mark.parametrize("cell", ["dcmht-vitb32-train", "dcmht-vitl14-train"])
def test_training_passes_unbroken(cell):
    assert all(run(train, tiny.traffic("train-b256", **TRAIN), cell).values())


@pytest.mark.parametrize("cell", ["dcmht-vitb32-train", "dcmht-vitl14-train"])
def test_a_step_that_leaves_the_state_unchanged(cell, monkeypatch):
    from cmh_torch.optim.bert_adam import BertAdam

    monkeypatch.setattr(BertAdam, "step", lambda self, closure=None: None)
    ok = run(train, tiny.traffic("train-b256", **TRAIN), cell)
    assert not ok["change_gap"] and not all(ok.values())


@pytest.mark.parametrize("cell", ["dcmht-vitb32-train", "dcmht-vitl14-train"])
def test_half_of_the_batch_left_out(cell, monkeypatch):
    from cmh_torch.runners.base import BaseTrainer

    whole = BaseTrainer.train_step

    def half(self, batch):
        n = batch["label"].shape[0] // 2
        return whole(self, {k: v[:n] for k, v in batch.items()})

    monkeypatch.setattr(BaseTrainer, "train_step", half)
    assert not all(run(train, tiny.traffic("train-b256", **TRAIN), cell).values())


SEARCH = dict(rate=20, gallery=1 << 14, gallery_chunk=1 << 12, warm_requests=2, check_requests=8)


def test_search_passes_unbroken():
    assert all(run(search, tiny.traffic("search-text-poisson", **SEARCH),
                   "dcmht-vitb32-search", 1.0).values())


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from cmh_torch.serving import RetrievalIndex

    exact = RetrievalIndex.search

    def altered(self, codes, topk=10, **kw):
        dist, idx = exact(self, codes, topk=topk, **kw)
        idx = idx.copy()
        idx[:, -1] = (idx[:, -1] + 1) % len(self)
        return dist, idx

    monkeypatch.setattr(RetrievalIndex, "search", altered)
    ok = run(search, tiny.traffic("search-text-poisson", **SEARCH), "dcmht-vitb32-search", 1.0)
    assert not ok["topk_mismatch"]


def test_a_token_altered_where_it_is_produced(monkeypatch):
    from cmh_torch.models.clip import tokenizer

    exact = tokenizer.tokenize_caption

    def altered(tok, caption, max_words=32):
        ids, kpm = exact(tok, caption, max_words)
        ids = ids.copy()
        ids[1] = (ids[1] + 1) % 49406
        return ids, kpm

    monkeypatch.setattr(tokenizer, "tokenize_caption", altered)
    ok = run(search, tiny.traffic("search-text-poisson", **SEARCH), "dcmht-vitb32-search", 1.0)
    assert not ok["tokens_differ"]


VALID = dict(query=50, retrieval=150, batch=32, make_chunk=64, reference_chunk=64)


def test_valid_passes_unbroken():
    assert all(run(valid, tiny.traffic("valid-mirflickr", **VALID), "dcmht-vitb32-valid").values())


def test_an_map_altered_where_it_is_produced(monkeypatch):
    from cmh_torch.runners.base import BaseTrainer

    exact = BaseTrainer.calc_map_4dir

    def altered(self, *args):
        maps = exact(self, *args)
        return (maps[0] + 0.01,) + tuple(maps[1:])

    monkeypatch.setattr(BaseTrainer, "calc_map_4dir", altered)
    ok = run(valid, tiny.traffic("valid-mirflickr", **VALID), "dcmht-vitb32-valid")
    assert not ok["map_gap"]


def test_a_code_altered_where_it_is_produced(monkeypatch):
    from cmh_torch.runners.base import BaseTrainer

    exact = BaseTrainer.get_code

    def altered(self, loader, length, wait=None):
        img, txt = exact(self, loader, length, wait)
        img[0] = -img[0]
        return img, txt

    monkeypatch.setattr(BaseTrainer, "get_code", altered)
    ok = run(valid, tiny.traffic("valid-mirflickr", **VALID), "dcmht-vitb32-valid")
    assert not ok["code_margin"]
