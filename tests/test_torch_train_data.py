"""cmh_torch's data layer against cmh_tpu's, bit for bit: the split, the
datasets (synthetic, and a small ``.npy``/``.txt``/``.mat`` corpus with the
training augmentation) and the shuffled, padded loader batches under one
seed."""

import numpy as np
import pytest
import scipy.io as scio

import torch_threads  # noqa: F401  (before any torch work)
from cmh_torch.data import builder as port_builder
from cmh_torch.data.loader import HostDataLoader as PortLoader
from cmh_torch.models.clip.tokenizer import SimpleTokenizer
from cmh_torch.registry import load_components
from cmh_tpu.data import builder as jax_builder
from cmh_tpu.data.loader import HostDataLoader as JaxLoader
from cmh_tpu.models.clip.tokenizer import SimpleTokenizer as JaxTokenizer

load_components()
KEYS = ("image", "text", "key_padding_mask", "label", "index", "valid")


def _equal_items(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("seed", [1814, 5])
def test_split_indices_equal(seed):
    n = 97
    caps, idx, labels = np.arange(n) * 10, np.arange(n) + 1000, np.arange(n) * 3
    np.random.seed(seed)
    want = jax_builder.split_data(caps, idx, labels, query_num=11, train_num=40)
    np.random.seed(seed)
    got = port_builder.split_data(caps, idx, labels, query_num=11, train_num=40)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert len(got[0][2]) == n - 11          # retrieval = everything after query


def _synthetic(builder, tok):
    return builder.build_dataloader(
        captionFile="", indexFile="", labelFile="", imageResolution=32, maxWords=12,
        query_num=16, train_num=40, dataset_cls="synthetic_dataset", tokenizer=tok,
        num_classes=4, num_items=16 + 2 * 40)


def test_synthetic_datasets_equal():
    got = _synthetic(port_builder, SimpleTokenizer())
    want = _synthetic(jax_builder, JaxTokenizer())
    for g, w in zip(got, want):
        assert len(g) == len(w)
        np.testing.assert_array_equal(g.get_all_label(), w.get_all_label())
        for i in (0, 1, len(g) - 1):
            _equal_items(g[i], w[i])


@pytest.mark.parametrize("batch,shuffle", [(16, True), (7, True), (16, False)])
def test_loader_batches_equal_over_two_epochs(batch, shuffle):
    """The global-numpy shuffle, the wrap-around pad of the ragged last
    batch and the ``valid`` mask, for two epochs from one seed."""
    train = _synthetic(port_builder, SimpleTokenizer())[0]
    jtrain = _synthetic(jax_builder, JaxTokenizer())[0]
    runs = []
    for loader_cls, data in ((PortLoader, train), (JaxLoader, jtrain)):
        np.random.seed(3)
        loader = loader_cls(data, batch_size=batch, shuffle=shuffle, num_workers=2)
        runs.append([b for _ in range(2) for b in loader])
    assert len(runs[0]) == len(runs[1]) == 2 * -(-40 // batch)
    for g, w in zip(*runs):
        assert set(g) == set(w) == set(KEYS)
        for k in KEYS:
            assert g[k].dtype == w[k].dtype and g[k].tobytes() == w[k].tobytes(), k
    assert not runs[0][-1]["valid"].all() or 40 % batch == 0


def test_file_corpus_with_training_augmentation_equal(tmp_path, monkeypatch):
    """npy images, txt captions, .mat labels; the train split draws a crop,
    a flip and a caption from numpy's global generator in cmh_tpu's order."""
    monkeypatch.setenv("CMH_TPU_NO_NATIVE", "1")     # cmh_tpu's PIL path
    rng = np.random.RandomState(0)
    n = 30
    np.save(tmp_path / "imgs.npy", rng.randint(0, 255, (n, 40, 52, 3), dtype=np.uint8))
    (tmp_path / "caps.txt").write_text("\n".join(
        f"a photo of item {i} with a red car" for i in range(n)))
    scio.savemat(tmp_path / "labels.mat", {"category": (rng.rand(n, 5) > 0.5).astype(np.int64)})
    sets = []
    for builder, tok in ((port_builder, SimpleTokenizer()), (jax_builder, JaxTokenizer())):
        np.random.seed(11)
        data = builder.build_dataloader(
            captionFile=str(tmp_path / "caps.txt"), indexFile=str(tmp_path / "imgs.npy"),
            labelFile=str(tmp_path / "labels.mat"), imageResolution=24, maxWords=12,
            query_num=6, train_num=10, dataset_cls="transformer_dataset", tokenizer=tok)
        np.random.seed(12)
        sets.append([[ds[i] for i in range(len(ds))] for ds in data])
    for g, w in zip(*sets):
        for a, b in zip(g, w):
            _equal_items(a, b)


def test_synthetic_config_split_and_batches_equal():
    """``configs/DCMHT/synthetic.yaml`` as both trainers build it: each
    package's ``set_seed(1814)``, its dataset section, then one epoch of the
    shuffled train loader and the query loader."""
    import os

    from cmh_torch.config import load_config
    from cmh_torch.utils.seed import set_seed
    from cmh_tpu.utils.seed import set_seed as jax_set_seed

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, "configs", "DCMHT", "synthetic.yaml"))
    ds, run = cfg.dataset, cfg.run
    out = []
    for seed_fn, builder, loader_cls, tok in (
            (set_seed, port_builder, PortLoader, SimpleTokenizer()),
            (jax_set_seed, jax_builder, JaxLoader, JaxTokenizer())):
        seed_fn(run.get("seed", 1814))
        train, query, retrieval = builder.build_dataloader(
            captionFile="", indexFile="", labelFile="",
            imageResolution=ds.image_resolution, maxWords=ds.max_word,
            query_num=run.query_num, train_num=run.train_num,
            dataset_cls=ds.arch, tokenizer=tok, num_classes=ds.num_classes,
            num_items=run.query_num + 2 * run.train_num)
        out.append([retrieval.get_all_label()]
                   + list(loader_cls(train, batch_size=run.batch_size, shuffle=True))
                   + list(loader_cls(query, batch_size=run.batch_size)))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert len(out[0]) == len(out[1]) == 1 + 2 + 1
    for g, w in zip(out[0][1:], out[1][1:]):
        for k in KEYS:
            assert g[k].dtype == w[k].dtype and g[k].tobytes() == w[k].tobytes(), k
