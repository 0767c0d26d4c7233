"""Datasets (counterpart of ``cmh_tpu/data/dataset.py:22-189``).

Each item is (image HWC float32, caption ids (maxWords,) int32,
key_padding_mask, label, index). ``TransformerDataset`` reads images and
captions from the split of a ``.mat``/``.txt``/``.npy`` corpus and, in
training, picks one caption at random and augments the image, drawing from
numpy's global generator (or an injected ``RandomState``) as cmh_tpu does.
``SyntheticDataset`` makes deterministic items keyed by (seed, index).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..models.clip.tokenizer import tokenize_caption
from ..registry import registry
from .transforms import eval_transform, train_transform


class BaseDataset:
    def __len__(self):
        raise NotImplementedError()

    def __getitem__(self, index: int):
        raise NotImplementedError()

    def get_all_label(self) -> np.ndarray:
        raise NotImplementedError()

    def get_tag_length(self) -> int:
        return self.captions.shape[-1]


@registry.register_dataset("transformer_dataset")
class TransformerDataset(BaseDataset):
    def __init__(self, captions, indexs, labels, is_train: bool = True,
                 imageResolution: int = 224, tokenizer=None, maxWords: int = 32,
                 npy: bool = False, rng: Optional[np.random.RandomState] = None,
                 **kwargs) -> None:
        self.captions = captions
        self.indexs = indexs
        self.labels = labels
        self.is_train = is_train
        self.resolution = imageResolution
        self.tokenizer = tokenizer
        self.max_words = maxWords
        self.npy = npy
        self.rng = rng if rng is not None else np.random

    def __len__(self) -> int:
        return len(self.indexs)

    def _load_image(self, index: int) -> np.ndarray:
        from PIL import Image

        if self.npy:
            img = Image.fromarray(self.indexs[index], mode="RGB")
        else:
            img = Image.open(str(self.indexs[index]).strip()).convert("RGB")
        if self.is_train:
            state = (self.rng if isinstance(self.rng, np.random.RandomState)
                     else np.random.RandomState(self.rng.randint(0, 2**31 - 1)))
            return train_transform(img, self.resolution, state)
        return eval_transform(img, self.resolution)

    def _load_text(self, index: int):
        captions = self.captions[index]
        pick = self.rng.randint(0, len(captions)) if len(captions) > 1 else 0
        caption = captions[pick]
        # .mat cell arrays round-trip as nested object arrays
        while isinstance(caption, np.ndarray):
            caption = caption[0] if caption.size else ""
        if isinstance(caption, bytes):
            caption = caption.decode("utf-8")
        return tokenize_caption(self.tokenizer, str(caption).strip(), self.max_words)

    def get_all_label(self) -> np.ndarray:
        return np.asarray(self.labels, dtype=np.int64)

    def __getitem__(self, index: int):
        image = self._load_image(index)
        caption, kpm = self._load_text(index)
        label = np.asarray(self.labels[index], dtype=np.int64)
        return image, caption, kpm, label, index


@registry.register_dataset("synthetic_dataset")
class SyntheticDataset(BaseDataset):
    """Deterministic random images/captions/labels keyed by (seed, index):
    class-conditional patterns plus noise, captions from a fixed word pool,
    multi-hot labels. Train (seed 1) and retrieval (seed 1) agree item for
    item on their shared prefix, as the real split's retrieval ⊇ train."""

    WORDS = (
        "photo image picture view closeup shot of a the red green blue "
        "large small bright dark cat dog bird car tree house river mountain "
        "street beach sky person group playing sitting running standing"
    ).split()

    def __init__(self, num_items: int = 64, num_classes: int = 8,
                 imageResolution: int = 32, tokenizer=None, maxWords: int = 32,
                 is_train: bool = True, seed: int = 0, **kwargs) -> None:
        self.num_items = num_items
        self.num_classes = num_classes
        self.resolution = imageResolution
        self.tokenizer = tokenizer
        self.max_words = maxWords
        self.is_train = is_train
        self.seed = seed
        self._labels = np.zeros((num_items, num_classes), dtype=np.int64)
        primary = np.empty((num_items,), dtype=np.int64)
        captions = []
        for i in range(num_items):
            r = np.random.RandomState(seed * 100003 + 50021 + i)
            primary[i] = r.randint(0, num_classes)
            self._labels[i, primary[i]] = 1
            self._labels[i] |= (r.rand(num_classes) < 0.15).astype(np.int64)
            captions.append([" ".join(r.choice(self.WORDS, size=5))])
        self._primary = primary
        self.captions = np.asarray(captions)
        self.labels = self._labels

    def __len__(self) -> int:
        return self.num_items

    def __getitem__(self, index: int):
        rng = np.random.RandomState(self.seed * 100003 + index)
        r = self.resolution
        base = np.zeros((r, r, 3), dtype=np.float32)
        c = self._primary[index]
        base[..., c % 3] = (c + 1) / self.num_classes
        freq = (c + 1) * np.pi / r
        yy, xx = np.mgrid[0:r, 0:r]
        base[..., (c + 1) % 3] += 0.5 * np.sin(freq * xx) * np.cos(freq * yy)
        img = base + 0.1 * rng.randn(r, r, 3).astype(np.float32)
        caption, kpm = tokenize_caption(self.tokenizer, str(self.captions[index][0]),
                                        self.max_words)
        return img.astype(np.float32), caption, kpm, self._labels[index], index

    def get_all_label(self) -> np.ndarray:
        return self._labels
