"""Dataset construction (counterpart of ``cmh_tpu/data/builder.py:22-137``).

The split is cmh_tpu's: one ``np.random.permutation`` over the corpus; query
= first ``query_num``; train = next ``train_num``; retrieval = everything
after query (a superset of train). Caption/index/label ``.mat`` keys fall
back as cmh_tpu's do (caption/tags/YAll, index/imgs/FAll,
category/LAll/labels); scipy reads the ``.mat`` files.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..registry import registry


def split_data(
    captions,
    indexs,
    labels,
    query_num: int = 5000,
    train_num: int = 10000,
    random_index: Optional[np.ndarray] = None,
):
    if random_index is None:
        random_index = np.random.permutation(range(len(indexs)))
    query_index = random_index[:query_num]
    train_index = random_index[query_num : query_num + train_num]
    retrieval_index = random_index[query_num:]  # superset of train — intended

    def take(idx):
        return captions[idx], indexs[idx], labels[idx]

    q = take(query_index)
    t = take(train_index)
    r = take(retrieval_index)
    split_indexs = (q[1], t[1], r[1])
    split_captions = (q[0], t[0], r[0])
    split_labels = (q[2], t[2], r[2])
    return split_indexs, split_captions, split_labels


_CAPTION_KEYS = ("caption", "tags", "YAll")
_INDEX_KEYS = ("index", "imgs", "FAll")
_LABEL_KEYS = ("category", "LAll", "labels")


def _load_mat_first(path: str, keys) -> np.ndarray:
    import scipy.io as scio

    data = scio.loadmat(path)
    for key in keys:
        if key in data:
            return data[key]
    raise RuntimeError(
        f"unsupported .mat contents in {path}; expected one of {keys}"
    )


def load_captions(caption_file: str) -> np.ndarray:
    if caption_file.endswith("mat"):
        captions = _load_mat_first(caption_file, _CAPTION_KEYS)
        return captions[0] if captions.shape[0] == 1 else captions
    if caption_file.endswith("txt"):
        with open(caption_file, "r") as f:
            lines = f.readlines()
        return np.asarray([[item.strip()] for item in lines])
    raise ValueError("'captionFile' must be .mat or .txt")


def load_indexs(index_file: str) -> Tuple[np.ndarray, bool]:
    if index_file.endswith("mat"):
        return _load_mat_first(index_file, _INDEX_KEYS), False
    if index_file.endswith("npy"):
        return np.load(index_file), True
    raise RuntimeError("index file must be .mat or .npy")


def load_labels(label_file: str) -> np.ndarray:
    return _load_mat_first(label_file, _LABEL_KEYS)


def build_dataloader(
    captionFile: str,
    indexFile: str,
    labelFile: str,
    imageResolution: int = 224,
    query_num: int = 5000,
    train_num: int = 10000,
    dataset_cls: Optional[str] = None,
    **kwargs,
):
    """Load corpus files, split, and instantiate train/query/retrieval
    dataset objects (reference builder.py:34-104)."""
    assert dataset_cls is not None, "'dataset_cls' must be provided!"
    dataset = registry.require_dataset_class(dataset_cls)

    if dataset_cls == "synthetic_dataset":
        # synthetic data needs no files; sizes come from kwargs
        total = kwargs.pop("num_items", query_num + train_num + train_num)
        num_classes = kwargs.pop("num_classes", 8)
        common = dict(
            num_classes=num_classes, imageResolution=imageResolution, **kwargs
        )
        train_data = dataset(num_items=train_num, is_train=True, seed=1, **common)
        query_data = dataset(num_items=query_num, is_train=False, seed=2, **common)
        retrieval_data = dataset(
            num_items=total - query_num, is_train=False, seed=1, **common
        )
        return train_data, query_data, retrieval_data

    captions = load_captions(captionFile)
    indexs, npy = load_indexs(indexFile)
    labels = load_labels(labelFile)

    split_indexs, split_captions, split_labels = split_data(
        captions, indexs, labels, query_num=query_num, train_num=train_num
    )

    train_data = dataset(
        captions=split_captions[1], indexs=split_indexs[1], labels=split_labels[1],
        imageResolution=imageResolution, is_train=True, npy=npy, **kwargs,
    )
    query_data = dataset(
        captions=split_captions[0], indexs=split_indexs[0], labels=split_labels[0],
        imageResolution=imageResolution, is_train=False, npy=npy, **kwargs,
    )
    retrieval_data = dataset(
        captions=split_captions[2], indexs=split_indexs[2], labels=split_labels[2],
        imageResolution=imageResolution, is_train=False, npy=npy, **kwargs,
    )
    return train_data, query_data, retrieval_data
