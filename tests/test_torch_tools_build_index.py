"""``cmh_torch.tools.build_index`` on the CPU: its index holds the codes
``get_code`` gives, in the npz layout cmh_tpu's ``RetrievalIndex`` reads,
and cmh_tpu's index file loads in the port's."""

import json

import numpy as np
import pytest
import yaml

import torch_threads  # noqa: F401  (before any torch work)
from cmh_torch.config import config_from_dict
from cmh_torch.export import load_encoders
from cmh_torch.ops.hashing import as_uint32, pack_bits
from cmh_torch.registry import load_components
from cmh_torch.serving import RetrievalIndex
from cmh_torch.tools import build_index
from cmh_tpu.serving import RetrievalIndex as JaxRetrievalIndex

MODELS = {
    "DCMHT": {"arch": "DCMHT", "hash_func": "softmax"},
    "TwDH": {"arch": "TwDH", "hash_func": "softmax", "long_dim": 32, "short_dims": [8],
             "numclass": 4, "long_center": "/nonexistent", "short_center": "/nonexistent",
             "trans_matrix": "/nonexistent"},
}


def _config(tmp_path, method):
    cfg = {"model": dict(MODELS[method], clip_path="/nonexistent.pt", clip_variant="tiny"),
           "optimizer": {"arch": "BertAdam", "lr": 0.002},
           "dataset": {"arch": "synthetic_dataset", "name": "synthetic", "num_classes": 4,
                       "image_resolution": 32, "max_word": 12},
           "run": {"arch": f"{method}Trainer", "save_dir": str(tmp_path / "run"),
                   "output_dim": 8, "batch_size": 8, "is_train": True, "train_num": 16,
                   "query_num": 8, "epochs": 1, "seed": 3}}
    path = tmp_path / f"{method}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return cfg, str(path)


@pytest.fixture(scope="module", params=sorted(MODELS))
def built(request, tmp_path_factory):
    """A seeded model file of the method, the tool's outputs from it, and the
    codes of an eval-only trainer that reads the same file."""
    method = request.param
    tmp = tmp_path_factory.mktemp(f"build_index_{method}")
    cfg, cfg_path = _config(tmp, method)
    runner = load_components().require_runner_class(f"{method}Trainer")
    trainer = runner.from_config(cfg=config_from_dict(cfg), device="cpu", auto_run=False)
    trainer.save_model(str(tmp), 0)
    model = str(tmp / "model-0.pt")
    outs = {}
    for modality in ("image", "text"):
        outs[modality] = build_index.main([
            "--config-file", cfg_path, "--model", model, "--modality", modality,
            "--out-index", str(tmp / f"gallery-{modality}"),
            "--out-encoders", str(tmp / "enc.pt"), "--device", "cpu"])
    cfg["run"].update(is_train=False, resume_model=model)
    evaluator = runner.from_config(cfg=config_from_dict(cfg), device="cpu", auto_run=False)
    codes = evaluator.get_code(evaluator.retrieval_loader, evaluator.retrieval_num)
    return method, outs, codes, tmp


def test_prints_one_json_line(built, capsys, tmp_path):
    method, outs, codes, tmp = built
    out = outs["image"]
    assert out == {"index": str(tmp / "gallery-image.npz"), "items": len(codes[0]),
                   "bits": 32 if method == "TwDH" else 8, "modality": "image",
                   "encoders": str(tmp / "enc.pt")}
    cfg, cfg_path = _config(tmp_path, method)
    build_index.main(["--config-file", cfg_path, "--model", str(tmp / "model-0.pt"),
                      "--out-index", str(tmp_path / "g.npz"), "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == {"index": str(tmp_path / "g.npz"), "items": len(codes[0]),
                                "bits": out["bits"], "modality": "image", "encoders": None}


@pytest.mark.parametrize("modality", ["image", "text"])
def test_index_holds_get_code_codes(built, modality):
    """The packed words are those of ``get_code``'s codes of the modality
    (TwDH: its long codes, index 0 or 1 of its four buffers)."""
    _, outs, codes, _ = built
    saved = np.load(outs[modality]["index"])
    want = as_uint32(pack_bits(codes[0 if modality == "image" else 1]))
    assert sorted(saved.files) == ["bits", "count", "packed"]
    np.testing.assert_array_equal(saved["packed"], want)
    assert int(saved["count"]) == len(want) and int(saved["bits"]) == codes[0].shape[1]


@pytest.mark.parametrize("modality", ["image", "text"])
def test_index_file_loads_both_ways_with_cmh_tpu(built, modality, tmp_path):
    _, outs, codes, _ = built
    gallery = codes[0 if modality == "image" else 1].numpy()
    # the port's file in cmh_tpu's index: the same packed words as cmh_tpu
    # packs from the same codes
    jax_loaded = JaxRetrievalIndex.load(outs[modality]["index"])
    jax_built = JaxRetrievalIndex(gallery.shape[1])
    jax_built.add(gallery)
    assert len(jax_loaded) == len(jax_built) == len(gallery)
    np.testing.assert_array_equal(np.concatenate(jax_loaded._chunks),
                                  np.concatenate(jax_built._chunks))
    # cmh_tpu's file in the port's index: the same words and searches
    jax_built.save(str(tmp_path / "jax.npz"))
    ours = np.load(outs[modality]["index"])
    theirs = np.load(str(tmp_path / "jax.npz"))
    for key in ("packed", "bits", "count"):
        assert ours[key].dtype == theirs[key].dtype, key
        np.testing.assert_array_equal(ours[key], theirs[key])
    a = RetrievalIndex.load(str(tmp_path / "jax.npz"), device="cpu")
    b = RetrievalIndex.load(outs[modality]["index"], device="cpu")
    queries = gallery[:3]
    for x, y in zip(a.search(queries, topk=5), b.search(queries, topk=5)):
        np.testing.assert_array_equal(x, y)


def test_encoders_give_the_index_codes(built):
    """The encoder file written beside the index codes the first retrieval
    items (the synthetic set's items depend on (seed, index) alone) as
    ``get_code`` did."""
    from cmh_torch.data.dataset import SyntheticDataset
    from cmh_torch.models.clip.tokenizer import SimpleTokenizer

    method, outs, codes, _ = built
    enc = load_encoders(outs["image"]["encoders"], device="cpu")
    items = SyntheticDataset(num_items=4, num_classes=4, imageResolution=32, seed=1,
                             tokenizer=SimpleTokenizer(), maxWords=12)
    out = enc.encode_image(np.stack([items[i][0] for i in range(4)]))
    if method == "TwDH":   # a tree: the long codes, and the short ones by width
        out = out[0]
    np.testing.assert_array_equal(np.asarray(out), codes[0][:4].numpy())


def test_unknown_runner_raises(tmp_path):
    cfg, cfg_path = _config(tmp_path, "DCMHT")
    cfg["run"]["arch"] = "NoSuchTrainer"
    (tmp_path / "bad.yaml").write_text(yaml.safe_dump(cfg))
    with pytest.raises(Exception, match="NoSuchTrainer"):
        build_index.main(["--config-file", str(tmp_path / "bad.yaml"), "--model", "x.pt",
                          "--out-index", str(tmp_path / "g"), "--device", "cpu"])
