"""Byte-level BPE tokenizer (OpenAI CLIP vocabulary, 49408 entries).

Counterpart of ``cmh_tpu/models/clip/tokenizer.py:107-228`` with the same
byte→unicode map, merge table (its own byte-identical copy of
``bpe_simple_vocab_16e6.txt.gz``) and caption packing. It uses the standard
library's ``re`` instead of the ``regex`` package: ``\\p{L}`` becomes
``[^\\W\\d_]`` and ``\\p{N}`` becomes ``\\d``. ``ftfy`` is used when installed,
else the same minimal mojibake repair as cmh_tpu.
"""

from __future__ import annotations

import gzip
import html
import os
import re
import unicodedata
from functools import lru_cache
from typing import Dict, List

import numpy as np

from ...registry import registry

try:  # optional: exact parity with the reference text cleanup
    import ftfy

    _HAS_FTFY = True
except ImportError:
    _HAS_FTFY = False

SOT_TOKEN = "<|startoftext|>"
EOT_TOKEN = "<|endoftext|>"
SOT_ID = 49406
EOT_ID = 49407


def default_bpe() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "bpe_simple_vocab_16e6.txt.gz")


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Invertible byte→printable-unicode map (the GPT-2/CLIP scheme)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word) -> set:
    return set(zip(word[:-1], word[1:]))


def fix_text(text: str) -> str:
    """Minimal ftfy.fix_text: undo UTF-8-as-cp1252/latin-1 mojibake
    (iterated) and apply NFC normalization."""
    for _ in range(3):
        if all(ord(ch) < 128 for ch in text):
            break
        for enc in ("cp1252", "latin-1"):
            try:
                fixed = text.encode(enc).decode("utf-8")
            except (UnicodeEncodeError, UnicodeDecodeError):
                continue
            break
        else:
            break
        if fixed == text:
            break
        text = fixed
    return unicodedata.normalize("NFC", text)


def basic_clean(text: str) -> str:
    text = ftfy.fix_text(text) if _HAS_FTFY else fix_text(text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


_LETTER = r"[^\W\d_]"


@registry.register_tokenizer("clip_tokenizer")
class SimpleTokenizer:
    """CLIP BPE: text → lowercased word pieces → byte-level BPE merges."""

    def __init__(self, bpe_path: str = None) -> None:
        bpe_path = bpe_path or default_bpe()
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merge_lines = f.read().split("\n")
        # header line + the first 49152-256-2+1 merges define the 49408 vocab
        merge_lines = merge_lines[1: 49152 - 256 - 2 + 1]
        merges = [tuple(line.split()) for line in merge_lines]
        vocab: List[str] = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend([SOT_TOKEN, EOT_TOKEN])
        self.encoder: Dict[str, int] = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {SOT_TOKEN: SOT_TOKEN, EOT_TOKEN: EOT_TOKEN}
        # letters: word characters that are not digits or '_';
        # other: neither whitespace, letter nor digit (so '_' is "other")
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
            + _LETTER + r"""+|\d|(?:[^\s\w]|_)+""",
            re.IGNORECASE,
        )

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        result = " ".join(word)
        self.cache[token] = result
        return result

    def tokenize(self, text: str) -> List[str]:
        tokens: List[str] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            tokens.extend(self.bpe(token).split(" "))
        return tokens

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        return [self.encoder[t] for t in tokens]

    def encode(self, text: str) -> List[int]:
        return self.convert_tokens_to_ids(self.tokenize(text))

    def decode(self, token_ids: List[int]) -> str:
        text = "".join(self.decoder[t] for t in token_ids)
        return (bytearray(self.byte_decoder[c] for c in text)
                .decode("utf-8", errors="replace").replace("</w>", " "))


def tokenize_caption(tokenizer: SimpleTokenizer, caption: str, max_words: int = 32):
    """Caption → (int32 ids padded to max_words, key_padding_mask): [SOT] +
    pieces truncated to max_words−1, then [EOT], zero-padded; the mask is
    True at pad slots."""
    words = [SOT_TOKEN] + tokenizer.tokenize(caption)
    if len(words) > max_words - 1:
        words = words[: max_words - 1]
    words = words + [EOT_TOKEN]
    ids = tokenizer.convert_tokens_to_ids(words)
    ids = np.asarray(ids + [0] * (max_words - len(ids)), dtype=np.int32)
    return ids, ids == 0
