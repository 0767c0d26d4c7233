"""Inputs made from the seed: normalised images, captions as token ids or
as text, multi-hot labels, and the gallery's codes.

Images are uniform pixels normalised with CLIP's mean and standard
deviation, in the NHWC float32 layout the port's loader gives. Token
captions are [start] + words + [end] padded with 0 to ``max_word``; their
words are ids of the vocabulary below the two special ids, so the end id
is the largest, where CLIP reads the caption's embedding. Text captions
are whole words of the CLIP BPE vocabulary, read from the vocabulary file.
"""

from __future__ import annotations

import gzip
from functools import lru_cache
from pathlib import Path
from typing import Dict, List

import torch

SOT, EOT = 49406, 49407
MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)
VOCAB_FILE = Path(__file__).resolve().parents[1] / "cmh_torch/models/clip/bpe_simple_vocab_16e6.txt.gz"


def images(g: torch.Generator, n: int, res: int, device, out=None) -> torch.Tensor:
    """(n, res, res, 3) normalised float32 images (into ``out`` if given)."""
    x = torch.rand((n, res, res, 3), generator=g, device=device, out=out)
    mean = torch.tensor(MEAN, device=device)
    std = torch.tensor(STD, device=device)
    return x.sub_(mean).div_(std)


def lengths(g: torch.Generator, n: int, lo: int, hi: int, device) -> torch.Tensor:
    """n caption lengths in tokens, start and end included: one fixed set
    spread evenly over [lo, hi], in an order drawn from ``g``, so that every
    seed feeds the same sizes."""
    fixed = lo + torch.arange(n, device=device) * (hi - lo + 1) // n
    return fixed[torch.randperm(n, generator=g, device=device)]


def token_captions(g: torch.Generator, n: int, max_word: int, lo: int, hi: int, device):
    """(ids (n, max_word) int32, key-padding mask (n, max_word) bool)."""
    length = lengths(g, n, lo, hi, device)
    ids = torch.randint(256, SOT, (n, max_word), generator=g, device=device, dtype=torch.int32)
    pos = torch.arange(max_word, device=device)[None, :]
    ids = torch.where(pos == 0, SOT, ids)
    ids = torch.where(pos == length[:, None] - 1, EOT, ids)
    ids = torch.where(pos >= length[:, None], 0, ids).to(torch.int32)
    return ids, ids == 0


def labels(g: torch.Generator, n: int, classes: int, p: float, device) -> torch.Tensor:
    """(n, classes) float32 multi-hot labels: each class with probability
    ``p``, and one class drawn for each item so none is empty."""
    lab = torch.rand((n, classes), generator=g, device=device) < p
    lab[torch.arange(n, device=device),
        torch.randint(0, classes, (n,), generator=g, device=device)] = True
    return lab.float()


def batch(g: torch.Generator, n: int, cfg: dict, traffic: dict, device) -> Dict[str, torch.Tensor]:
    """One batch in the port's loader layout (image, text, key_padding_mask,
    label, index, valid)."""
    text, kpm = token_captions(g, n, cfg["max_word"], traffic["min_tokens"],
                               traffic["max_tokens"], device)
    return {"image": images(g, n, cfg["clip"]["image_resolution"], device),
            "text": text, "key_padding_mask": kpm,
            "label": labels(g, n, cfg["num_classes"], cfg["label_p"], device),
            "index": torch.arange(n, device=device, dtype=torch.int32),
            "valid": torch.ones(n, dtype=torch.bool, device=device)}


@lru_cache(maxsize=1)
def vocabulary_words() -> List[str]:
    """The vocabulary's whole words of three or more lowercase letters
    (entries ``<word></w>`` among the merges that make the 49,408 ids)."""
    with gzip.open(VOCAB_FILE, "rt", encoding="utf-8") as f:
        merges = f.read().split("\n")[1:49152 - 256 - 2 + 1]
    words = []
    for line in merges:
        token = "".join(line.split())
        if token.endswith("</w>"):
            w = token[:-4]
            if len(w) >= 3 and w.isascii() and w.isalpha() and w.islower():
                words.append(w)
    return words


def text_captions(g: torch.Generator, n: int, lo: int, hi: int) -> List[str]:
    """n captions of lo..hi vocabulary words (a CPU generator)."""
    words = vocabulary_words()
    count = torch.randint(lo, hi + 1, (n,), generator=g)
    picks = torch.randint(0, len(words), (int(count.sum()),), generator=g).tolist()
    out, at = [], 0
    for c in count.tolist():
        out.append(" ".join(words[i] for i in picks[at:at + c]))
        at += c
    return out


def gallery_chunk(g: torch.Generator, n: int, bits: int, device) -> torch.Tensor:
    """n random ±1 codes (n, bits) float32."""
    return torch.randint(0, 2, (n, bits), generator=g, device=device).float().mul_(2).sub_(1)
