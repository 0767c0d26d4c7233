"""``cmh_torch.tools.twdh_matrix`` on the CPU against cmh_tpu's tool: the
lossless check, the ``.pkl`` both packages read, the same matrix from one
seed, and the tiny problem of ``tests/test_twdh_matrix_tool.py``."""

import numpy as np
import pytest

import torch_threads  # noqa: F401  (before any torch work)
from cmh_torch.ops import hash_centers
from cmh_torch.tools import twdh_matrix
from cmh_tpu.ops import hash_centers as jax_centers
from cmh_tpu.tools import twdh_matrix as jax_tool

LONG, SHORT, CLASSES = 16, 4, 4


def _centers():
    return (hash_centers.generate_hash_centers(CLASSES, LONG, seed=3),
            hash_centers.generate_hash_centers(CLASSES, SHORT, seed=4))


def test_tiny_problem_reaches_lossless(tmp_path):
    long_center, short_center = _centers()
    matrix, lossless, epochs = twdh_matrix.train_transform_matrix(
        long_center, short_center, epochs=30, steps_per_epoch=20, batch_size=32, lr=0.01,
        seed=0, logger=lambda *a: None)
    assert matrix.shape == (2 * LONG, 2 * SHORT) and matrix.dtype == np.float32
    assert lossless and epochs <= 30
    assert twdh_matrix.check(long_center, short_center, matrix)
    assert jax_tool.check(long_center, short_center, matrix)


@pytest.mark.parametrize("seed", range(4))
def test_check_agrees_with_cmh_tpu(seed):
    long_center, short_center = _centers()
    rng = np.random.RandomState(seed)
    random = rng.randn(2 * LONG, 2 * SHORT).astype(np.float32)
    # a lossless matrix by construction: each short pair is read from the
    # long pair of one long bit that equals the short bit on every class
    lossless = np.zeros((2 * LONG, 2 * SHORT), np.float32)
    for j in range(SHORT):
        i = next(i for i in range(LONG) if np.array_equal(long_center[:, i] > 0,
                                                           short_center[:, j] > 0))
        lossless[2 * i, 2 * j] = lossless[2 * i + 1, 2 * j + 1] = 1.0
    for m in (random, lossless, random * 0.0):
        assert twdh_matrix.check(long_center, short_center, m) == \
            jax_tool.check(long_center, short_center, m)
    assert twdh_matrix.check(long_center, short_center, lossless)


def test_pkl_round_trips_through_both_loaders(tmp_path):
    m = np.random.RandomState(1).randn(2 * LONG, 2 * SHORT).astype(np.float32)
    path = str(tmp_path / "16" / "4.pkl")
    twdh_matrix.save_matrix_pkl(m, path)
    np.testing.assert_array_equal(hash_centers.load_center_file(path), m)
    np.testing.assert_array_equal(jax_centers.load_center_file(path), m)
    jax_tool.save_matrix_pkl(m, str(tmp_path / "jax.pkl"))
    np.testing.assert_array_equal(hash_centers.load_center_file(str(tmp_path / "jax.pkl")), m)


@pytest.mark.parametrize("with_labels", [False, True])
def test_steps_fed_jax_draws_match_cmh_tpu(with_labels):
    """Both tools from one ``seed``: the port draws cmh_tpu's initial matrix,
    label batches and tie vectors from the same keys, so three steps of
    each (its loss and BertAdam) end at the same matrix (1e-6)."""
    long_center, short_center = _centers()
    label_bank = (np.random.RandomState(2).rand(10, CLASSES) < 0.5).astype(np.float32)
    label_bank[:, 0] = 1.0
    kw = dict(labels=label_bank if with_labels else None, epochs=1, steps_per_epoch=3,
              batch_size=32, lr=0.01, warmup=0.1, weight_decay=0.2, alpha=0.001, seed=7,
              logger=lambda *a: None)
    want, jlossless = jax_tool.train_transform_matrix(long_center, short_center, **kw)
    got, lossless, epochs = twdh_matrix.train_transform_matrix(long_center, short_center, **kw)
    assert (lossless, epochs) == (jlossless, 1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)


def test_main_writes_the_matrix(tmp_path, capsys):
    out = twdh_matrix.main(["--long-dim", "16", "--output-dim", "4", "--num-classes", "4",
                            "--post-epochs", "2", "--batch-size", "16", "--save-dir",
                            str(tmp_path), "--device", "cpu"])
    assert out["path"] == str(tmp_path / "16" / "4.pkl") and out["epochs"] <= 2
    assert hash_centers.load_center_file(out["path"]).shape == (32, 8)
    assert capsys.readouterr().out.strip().splitlines()[-1] == (
        f"saved {'lossless ' if out['lossless'] else ''}matrix to {out['path']}")
