"""``cmh_torch.tools.epoch_ab`` on the CPU: the JSON contract at the tiny
scale, the cached-artifact guard, the steady-state ratio convention on the
committed artifact, and its dataset against cmh_tpu's."""

import json
import os

import numpy as np
import pytest
import scipy.io as scio

import torch_threads  # noqa: F401  (before any torch work)
from cmh_torch.tools import epoch_ab
from cmh_tpu.tools import epoch_ab as jax_epoch_ab

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "tools", "artifacts", "ref_epoch_full.json")
TINY = ["--scale", "tiny", "--epochs", "1", "--train-num", "32", "--query-num", "16",
        "--batch", "16", "--device", "cpu"]
TINY_KEY = {"scale": "tiny", "res": 32, "train_num": 32, "query_num": 16, "batch": 16,
            "epochs": 1}


def test_tiny_json_contract(capsys):
    out = epoch_ab.main(TINY + ["--skip-reference"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["scale"] == "tiny" and out["backend_ours"] == "cpu"
    assert out["train_num"] == 32 and out["query_num"] == 16 and out["batch"] == 16
    assert out["ours_epoch_s"] > 0 and len(out["ours_epoch_times_s"]) == 1
    assert all(t > 0 for t in out["ours_epoch_times_s"])
    # no reference side → the ratio fields are null, not absent
    for key in ("ref_source", "ref_epoch_s", "ref_epoch_times_s", "speedup",
                "denominator_basis"):
        assert out[key] is None, key


def test_artifact_ratio_drops_the_first_reference_epoch(tmp_path):
    art = tmp_path / "ref.json"
    art.write_text(json.dumps({"params": dict(TINY_KEY, epochs=2),
                               "ref_epoch_times_s": [9.0, 3.0]}))
    out = epoch_ab.main([*TINY[:2], "--epochs", "2", *TINY[4:], "--ref-artifact", str(art)])
    assert out["ref_source"] == "artifact" and out["ref_epoch_times_s"] == [9.0, 3.0]
    assert out["ref_epoch_s"] == 3.0
    assert out["speedup"] == round(3.0 / out["ours_epoch_s"], 2)
    assert "another machine" in out["denominator_basis"]


def test_committed_artifact_reads_with_the_steady_convention():
    key = {"scale": "full", "res": 224, "train_num": 1000, "query_num": 500, "batch": 100,
           "epochs": 2}
    times = epoch_ab.read_artifact(ARTIFACT, key)
    assert times == [1324.746, 706.547]
    assert epoch_ab.reference_steady(times) == [706.547]
    assert epoch_ab.reference_steady([5.0]) == [5.0]


def test_mismatched_artifact_fails_loudly(tmp_path):
    art = tmp_path / "ref.json"
    art.write_text(json.dumps({"params": dict(TINY_KEY, train_num=999),
                               "ref_epoch_times_s": [1.0]}))
    with pytest.raises(ValueError, match="cached reference artifact measured"):
        epoch_ab.main(TINY + ["--ref-artifact", str(art)])
    # the committed full-scale artifact against a tiny invocation
    with pytest.raises(ValueError, match="'scale': 'full'"):
        epoch_ab.main(TINY + ["--ref-artifact", ARTIFACT])


def test_ref_only_needs_the_reference():
    with pytest.raises(NotImplementedError, match="reference repository"):
        epoch_ab.main(TINY + ["--ref-only"])


def test_dataset_is_cmh_tpus_as_jpeg_files(tmp_path):
    epoch_ab.make_dataset(str(tmp_path / "ours"), 40, 4, 32)
    jax_epoch_ab.make_dataset(str(tmp_path / "jax"), 40, 4, 32)
    ours, theirs = tmp_path / "ours" / "abdata", tmp_path / "jax" / "abdata"
    for name, key in (("label.mat", "category"), ("caption.mat", "caption")):
        np.testing.assert_array_equal(scio.loadmat(str(ours / name))[key],
                                      scio.loadmat(str(theirs / name))[key])
    from PIL import Image

    paths = scio.loadmat(str(ours / "index.mat"))["index"]
    want = np.load(str(theirs / "images.npy"))
    assert len(paths) == len(want) == 40
    for i in (0, 17, 39):
        got = np.asarray(Image.open(str(paths[i]).strip()), np.float32)
        # the same image through JPEG at quality 95: its pixel noise blurs,
        # its brightened class quadrants stay (a quadrant's mean a channel)
        def quadrants(a):
            return a.reshape(2, 16, 2, 16, 3).mean(axis=(1, 3))

        np.testing.assert_array_equal(quadrants(got) > 110, quadrants(want[i]) > 110)
        assert np.abs(got - want[i]).mean() < 16
