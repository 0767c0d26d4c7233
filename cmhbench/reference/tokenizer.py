"""CLIP's byte-level BPE for captions of lowercase words, written out from
OpenAI's ``simple_tokenizer.py``: the same byte map, merge ranks and
vocabulary order, read from the vocabulary file the port ships (a raw data
file both read). Text cleaning is left out: the benchmark's captions are
lowercase ASCII words separated by single spaces, which it leaves as they
are."""

from __future__ import annotations

import gzip
from functools import lru_cache
from typing import Dict, List, Tuple

from ..inputs import EOT, SOT, VOCAB_FILE


def _bytes_to_unicode() -> Dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


@lru_cache(maxsize=1)
def _tables() -> Tuple[Dict[str, int], Dict[Tuple[str, str], int]]:
    with gzip.open(VOCAB_FILE, "rt", encoding="utf-8") as f:
        merges = [tuple(m.split()) for m in f.read().split("\n")[1:49152 - 256 - 2 + 1]]
    vocab = list(_bytes_to_unicode().values())
    vocab = vocab + [v + "</w>" for v in vocab] + ["".join(m) for m in merges]
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    return {t: i for i, t in enumerate(vocab)}, {m: i for i, m in enumerate(merges)}


@lru_cache(maxsize=None)
def _bpe(word: str) -> Tuple[str, ...]:
    _, ranks = _tables()
    parts = list(word[:-1]) + [word[-1] + "</w>"]
    while len(parts) > 1:
        pairs = {(a, b) for a, b in zip(parts, parts[1:])}
        best = min(pairs, key=lambda p: ranks.get(p, float("inf")))
        if best not in ranks:
            break
        merged, i = [], 0
        while i < len(parts):
            if i < len(parts) - 1 and (parts[i], parts[i + 1]) == best:
                merged.append(parts[i] + parts[i + 1])
                i += 2
            else:
                merged.append(parts[i])
                i += 1
        parts = merged
    return tuple(parts)


def encode(caption: str, max_word: int) -> List[int]:
    """[start] + the caption's tokens, cut to ``max_word - 1``, + [end],
    padded with 0 to ``max_word``."""
    ids, _ = _tables()
    tokens = [SOT] + [ids[t] for w in caption.split(" ") for t in _bpe(w)]
    tokens = tokens[:max_word - 1] + [EOT]
    return tokens + [0] * (max_word - len(tokens))
