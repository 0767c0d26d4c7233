"""``cmh_torch.tools.real_parity`` on the CPU against cmh_tpu's tool, on the
``.mat`` replica of ``tests/test_real_parity_tool.py``: the preflight report,
its named failures, the table's join with the published numbers, and one
epoch of training through ``run_ours``."""

import argparse
import json
import os

import numpy as np
import pytest
import scipy.io as scio
from PIL import Image

import torch_threads  # noqa: F401  (before any torch work)
from cmh_torch.tools import real_parity
from cmh_tpu.tools import real_parity as jax_parity

FILES = {"caption": "caption.mat", "index": "index.mat", "label": "label.mat"}


@pytest.fixture(scope="module")
def replica_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("parity_tool")
    ds = root / "cocomini"
    ds.mkdir()
    imgdir = root / "imgs"
    imgdir.mkdir()
    rng = np.random.RandomState(3)
    n = 12
    paths = []
    for i in range(n):
        arr = rng.randint(0, 255, size=(40, 36, 3), dtype=np.uint8)
        p = str(imgdir / f"im{i:05d}.jpg")
        Image.fromarray(arr).save(p)
        paths.append(p + "  ")  # trailing pad spaces, real char-matrix style
    caps = np.asarray([[f"a photo number {i}"] * 5 for i in range(n)])
    scio.savemat(str(ds / "caption.mat"), {"caption": caps})
    scio.savemat(str(ds / "index.mat"), {"FAll": np.asarray(paths)})
    labels = np.zeros((n, 6), dtype=np.uint8)
    for i in range(n):
        labels[i, rng.choice(6, 2, replace=False)] = 1
    scio.savemat(str(ds / "label.mat"), {"LAll": labels})
    return str(ds)


def test_published_and_aliases_are_cmh_tpus():
    assert real_parity.PUBLISHED == jax_parity.PUBLISHED
    for name in ("MSCOCO", "mirflickr25k", "NUS-WIDE", "coco", "flickr", "other"):
        assert real_parity._canonical(name) == jax_parity._canonical(name)


@pytest.mark.parametrize("resolution,query,train", [(32, 4, 6), (24, 2, 8)])
def test_preflight_report_equals_cmh_tpus(replica_dir, resolution, query, train):
    args = dict(resolution=resolution, max_word=12, query_num=query, train_num=train)
    report = real_parity.preflight(replica_dir, FILES, **args)
    assert report == jax_parity.preflight(replica_dir, FILES, **args)
    assert report["corpus_items"] == 12
    for split in ("query", "train", "retrieval"):
        assert f"image({resolution}, {resolution}, 3)" in report[f"{split}_item0"]


def _bad_label_dir(replica_dir, tmp_path):
    bad = tmp_path / "ds"
    bad.mkdir()
    for f in ("caption.mat", "index.mat"):
        os.link(os.path.join(replica_dir, f), str(bad / f))
    scio.savemat(str(bad / "label.mat"), {"wrongkey": np.zeros((12, 6))})
    return str(bad)


@pytest.mark.parametrize("case", ["missing file", "bad key", "undersized"])
def test_named_failures_match_cmh_tpus(replica_dir, tmp_path, case):
    data_dir, files, sizes = replica_dir, FILES, dict(query_num=4, train_num=6)
    if case == "missing file":
        files = {**FILES, "index": "nope.mat"}
    elif case == "bad key":
        data_dir = _bad_label_dir(replica_dir, tmp_path)
    else:
        sizes = dict(query_num=10, train_num=10)
    errors = []
    for tool in (real_parity, jax_parity):
        with pytest.raises((AssertionError, RuntimeError)) as info:
            tool.preflight(data_dir, files, resolution=32, max_word=12, **sizes)
        errors.append(info.value)
    assert type(errors[0]) is type(errors[1]) and str(errors[0]) == str(errors[1])
    assert str(errors[0]).startswith({"missing file": "[preflight:index]",
                                      "bad key": "[preflight:label]",
                                      "undersized": "[preflight:size]"}[case])


@pytest.mark.parametrize("dataset,rows", [
    ("mscoco", [{"method": "DCMHT", "bits": 64,
                 "ours": {"map_i2t": 0.7201, "map_t2i": 0.7149},
                 "reference": {"map_i2t": 0.7239, "map_t2i": 0.7144}}]),
    ("nuswide", [{"method": "MITH", "bits": 32, "ours": {"map_i2t": 0.5, "map_t2i": 0.5},
                  "reference": None},
                 {"method": "TwDH", "bits": 16, "ours": {"map_i2t": 0.7, "map_t2i": 0.71}}]),
])
def test_emit_table_equals_cmh_tpus(tmp_path, dataset, rows):
    real_parity.emit_table(rows, dataset, str(tmp_path / "ours.md"))
    jax_parity.emit_table(rows, dataset, str(tmp_path / "jax.md"))
    text = (tmp_path / "ours.md").read_text()
    assert text == (tmp_path / "jax.md").read_text()
    pub = real_parity.PUBLISHED.get((rows[-1]["method"], real_parity._canonical(dataset),
                                     rows[-1]["bits"]))
    assert f"{pub[0]:.4f}" in text and f"{pub[1]:.4f}" in text


def _args(replica_dir, **over):
    args = dict(config=None, clip_path="/nonexistent.pt", clip_variant="tiny",
                data_root=os.path.dirname(replica_dir), dataset=os.path.basename(replica_dir),
                caption_file="caption.mat", index_file="index.mat", label_file="label.mat",
                image_resolution=32, max_word=12, train_num=6, query_num=4, seed=1814,
                epochs=1, batch_size=2, scan_steps=None)
    args.update(over)
    return argparse.Namespace(**args)


def test_run_ours_trains_the_replica_one_epoch(replica_dir, tmp_path):
    cfg = real_parity._method_cfg("DCMHT", _args(replica_dir), 16, str(tmp_path))
    assert cfg.to_dict() == jax_parity._method_cfg("DCMHT", _args(replica_dir), 16,
                                                   str(tmp_path)).to_dict()
    out = real_parity.run_ours("DCMHT", cfg, device="cpu")
    assert set(out) == {"map_i2t", "map_t2i", "best_epoch_i", "best_epoch_t", "wall_s"}
    assert 0.0 < out["map_i2t"] <= 1.0 and 0.0 < out["map_t2i"] <= 1.0
    assert out["best_epoch_i"] == out["best_epoch_t"] == 0
    assert os.path.isfile(tmp_path / "mat_files" / "last.mat")


def test_main_preflight_only_and_reference_stage(replica_dir, capsys):
    common = ["--data-root", os.path.dirname(replica_dir), "--dataset",
              os.path.basename(replica_dir), "--image-resolution", "32", "--max-word", "12",
              "--train-num", "6", "--query-num", "4", "--device", "cpu"]
    out = real_parity.main(common + ["--preflight-only"])
    assert json.loads(capsys.readouterr().out) == out
    with pytest.raises(NotImplementedError, match="reference repository"):
        real_parity.main(common + ["--with-reference"])
