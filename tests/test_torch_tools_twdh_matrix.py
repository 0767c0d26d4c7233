"""``cmh_torch.tools.twdh_matrix`` on the CPU against cmh_tpu's tool: the
lossless check, the ``.pkl`` both packages read, a training step fed JAX's
draws, and the tiny problem of ``tests/test_twdh_matrix_tool.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmh_torch.ops import hash_centers
from cmh_torch.tools import twdh_matrix
from cmh_tpu.ops import hash_centers as jax_centers
from cmh_tpu.optim.bert_adam import bert_adam
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
    """Three steps of the port's ``train_step`` and of cmh_tpu's step (its
    tool's loss and BertAdam), from one initial matrix with the same label
    batches and the tie vectors cmh_tpu draws from its keys."""
    long_center, short_center = _centers()
    alpha, lr, warmup, wd, t_total, batch = 0.001, 0.01, 0.1, 0.2, 20, 32
    key = jax.random.PRNGKey(7)
    key, mk = jax.random.split(key)
    m0 = jax.random.uniform(mk, (2 * LONG, 2 * SHORT), jnp.float32, -1.0, 1.0)
    lc, sc = jnp.asarray(long_center), jnp.asarray(short_center)
    label_bank = (np.random.RandomState(2).rand(10, CLASSES) < 0.5).astype(np.float32)
    label_bank[:, 0] = 1.0
    tx = bert_adam(lr=lr, warmup=warmup, t_total=t_total, schedule="warmup_cosine", b1=0.9,
                   b2=0.98, e=1e-6, weight_decay=wd, max_grad_norm=1.0)
    opt_state = tx.init(m0)

    matrix = torch.tensor(np.asarray(m0)).requires_grad_(True)
    optimizer = twdh_matrix.make_optimizer(matrix, lr, warmup, t_total, wd)
    tlc, tsc = torch.tensor(long_center), torch.tensor(short_center)
    m = m0
    for _ in range(3):
        key, bk, tk = jax.random.split(key, 3)
        if with_labels:
            labels = jnp.asarray(label_bank)[jax.random.randint(bk, (batch,), 0, 10)]
        else:
            labels = (jax.random.uniform(bk, (batch, CLASSES)) < 2.0 / CLASSES).astype(
                jnp.float32)
            labels = labels.at[jnp.arange(batch),
                               jax.random.randint(tk, (batch,), 0, CLASSES)].set(1.0)

        def loss_fn(mm):
            long_hash = jax_centers.hash_convert(
                jax_centers.hash_center_multilabels(labels, lc, tk))
            low_hash = jax_centers.hash_convert(
                jax_centers.hash_center_multilabels(labels, sc, tk))
            target = jax_tool.matrix_forward(mm, long_hash)
            parts = (jax_tool.soft_argmax_hash_loss_pairs(target),
                     jax_centers.bce_probs(target, low_hash), alpha * jnp.sum(jnp.abs(mm)))
            return sum(parts), parts

        (jloss, jparts), grads = jax.value_and_grad(loss_fn, has_aux=True)(m)
        updates, opt_state = tx.update(grads, opt_state, m)
        m = m + updates

        def ties(n):
            return torch.tensor(np.asarray(
                jax.random.randint(tk, (n,), 0, 2).astype(jnp.float32) * 2.0 - 1.0))

        loss, parts = twdh_matrix.train_step(matrix, optimizer, torch.tensor(np.asarray(labels)),
                                             tlc, tsc, ties(LONG), ties(SHORT), alpha)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose([float(p) for p in parts], [float(p) for p in jparts],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(matrix.detach().numpy(), np.asarray(m), rtol=0, atol=1e-6)


def test_main_writes_the_matrix(tmp_path, capsys):
    out = twdh_matrix.main(["--long-dim", "16", "--output-dim", "4", "--num-classes", "4",
                            "--post-epochs", "2", "--batch-size", "16", "--save-dir",
                            str(tmp_path), "--device", "cpu"])
    assert out["path"] == str(tmp_path / "16" / "4.pkl") and out["epochs"] <= 2
    assert hash_centers.load_center_file(out["path"]).shape == (32, 8)
    assert capsys.readouterr().out.strip().splitlines()[-1] == (
        f"saved {'lossless ' if out['lossless'] else ''}matrix to {out['path']}")
