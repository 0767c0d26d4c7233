"""Offline TwDH transform-matrix generation.

The port's ``cmh_tpu/tools/twdh_matrix.py`` (the reference's
``runners/TwDH/transform_matrix_generation/{model,train}.py``): learn a
(2·long, 2·short) matrix that maps the softmax-pair targets of the long
hash centers of a sample's classes to those of its short centers, with BCE
+ the soft-argmax pair sharpening + an L1 lasso, trained with BertAdam
(warmup-cosine, b2 0.98, e 1e-6, each leaf's gradient clipped to norm 1);
``check`` says whether the matrix reconstructs every short center from its
long one (the argmax of each pair equals the short code's sign), which
stops the training early.

The loss reads only labels and centers, so no image or caption is needed:
batches are drawn from the label matrix (``--label-file``) or synthesized
as multi-hot rows over the classes. Every draw comes from one
``torch.Generator`` seeded by ``--seed`` (cmh_tpu draws from a JAX key,
whose values the port cannot reproduce); ``train_step`` takes a step's
labels and tie vectors as arguments, so a test can feed JAX's draws.

    python -m cmh_torch.tools.twdh_matrix --long-dim 512 --output-dim 16 \
        --long-center-path .../512.pkl --short-center-path .../16.pkl \
        --save-dir out/ [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from ..ops.hash_centers import (bce_probs, generate_hash_centers, hash_center_multilabels,
                                hash_convert, load_center_file)
from ..optim.bert_adam import BertAdam


def soft_argmax_hash_loss_pairs(code: torch.Tensor) -> torch.Tensor:
    """1 − mean((p0 − p1)²) over the pair probabilities (the tool's
    sharper variant of the model's loss)."""
    code = code.reshape(code.shape[0], -1, 2)
    return 1.0 - torch.mean((code[:, :, 0] - code[:, :, 1]) ** 2)


def matrix_forward(matrix: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, 2·long) pair targets → (B, 2·short) pair probabilities."""
    out = torch.softmax((x @ matrix).reshape(x.shape[0], -1, 2), dim=-1)
    return out.reshape(out.shape[0], -1)


def check(long_center: np.ndarray, short_center: np.ndarray, matrix: np.ndarray) -> bool:
    """Whether the matrix reconstructs every short center losslessly."""
    low = (np.asarray(short_center) > 0).astype(np.int32)
    long_pairs = hash_convert(torch.as_tensor(np.asarray(long_center))).numpy()
    rec = (long_pairs @ np.asarray(matrix)).reshape(low.shape[0], low.shape[1], 2)
    return bool(np.array_equal(np.argmax(rec, axis=-1).astype(np.int32), low))


def matrix_loss(matrix, batch_labels, long_center, short_center, tie_long, tie_short,
                alpha: float):
    """The total loss and its (hash, bce, lasso) parts for one batch of
    labels; ``tie_long``/``tie_short`` break the centers' sum ties."""
    long_hash = hash_convert(hash_center_multilabels(batch_labels, long_center, tie_long))
    low_hash = hash_convert(hash_center_multilabels(batch_labels, short_center, tie_short))
    target = matrix_forward(matrix, long_hash)
    hash_loss = soft_argmax_hash_loss_pairs(target)
    class_loss = bce_probs(target, low_hash)
    lasso = alpha * torch.sum(torch.abs(matrix))
    return hash_loss + class_loss + lasso, (hash_loss, class_loss, lasso)


def train_step(matrix: torch.Tensor, optimizer: BertAdam, batch_labels, long_center,
               short_center, tie_long, tie_short, alpha: float):
    """One BertAdam step of ``matrix`` (a leaf that requires grad) in place;
    returns the loss and its parts, detached."""
    optimizer.zero_grad(set_to_none=True)
    loss, parts = matrix_loss(matrix, batch_labels, long_center, short_center, tie_long,
                              tie_short, alpha)
    loss.backward()
    optimizer.step()
    return loss.detach(), tuple(p.detach() for p in parts)


def make_optimizer(matrix: torch.Tensor, lr: float, warmup: float, t_total: int,
                   weight_decay: float) -> BertAdam:
    return BertAdam([matrix], lr=lr, warmup=warmup, t_total=t_total,
                    schedule="warmup_cosine", b1=0.9, b2=0.98, e=1e-6,
                    weight_decay=weight_decay, max_grad_norm=1.0)


def _signs(gen: torch.Generator, n: int) -> torch.Tensor:
    return torch.randint(0, 2, (n,), generator=gen).float() * 2.0 - 1.0


def train_transform_matrix(long_center: np.ndarray, short_center: np.ndarray,
                           labels: Optional[np.ndarray] = None, epochs: int = 100,
                           steps_per_epoch: int = 50, batch_size: int = 200,
                           lr: float = 0.001, warmup: float = 0.1, weight_decay: float = 0.2,
                           alpha: float = 0.001, seed: int = 1814, logger=print,
                           device="cpu"):
    """Returns (matrix (2·long, 2·short) float32, lossless, epochs run)."""
    long_dim, short_dim = long_center.shape[1], short_center.shape[1]
    n_class = long_center.shape[0]
    gen = torch.Generator().manual_seed(seed)
    init = torch.rand((2 * long_dim, 2 * short_dim), generator=gen) * 2.0 - 1.0
    matrix = init.to(device).requires_grad_(True)
    lc = torch.as_tensor(long_center, dtype=torch.float32, device=device)
    sc = torch.as_tensor(short_center, dtype=torch.float32, device=device)
    optimizer = make_optimizer(matrix, lr, warmup, steps_per_epoch * epochs, weight_decay)
    if labels is not None:
        labels = torch.as_tensor(np.asarray(labels), dtype=torch.float32)

    for epoch in range(epochs):
        for _ in range(steps_per_epoch):
            if labels is not None:
                batch = labels[torch.randint(0, labels.shape[0], (batch_size,), generator=gen)]
            else:
                # multi-hot rows over the center classes, one class sure
                batch = (torch.rand((batch_size, n_class), generator=gen)
                         < 2.0 / n_class).float()
                batch[torch.arange(batch_size),
                      torch.randint(0, n_class, (batch_size,), generator=gen)] = 1.0
            tie_long, tie_short = _signs(gen, long_dim), _signs(gen, short_dim)
            loss, parts = train_step(matrix, optimizer, batch.to(device), lc, sc,
                                     tie_long.to(device), tie_short.to(device), alpha)
        logger(f"epoch {epoch}: loss={float(loss):.4f} (hash={float(parts[0]):.4f}, "
               f"bce={float(parts[1]):.4f}, lasso={float(parts[2]):.4f})")
        m_np = matrix.detach().cpu().numpy()
        if check(long_center, short_center, m_np):
            logger("find a lossless transform matrix!")
            return m_np, True, epoch + 1
    return matrix.detach().cpu().numpy(), False, epochs


def save_matrix_pkl(matrix: np.ndarray, path: str) -> None:
    """Torch-pickle the matrix, as the reference's TwDH loader reads it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(torch.tensor(np.asarray(matrix), dtype=torch.float32), path)


def main(argv: Optional[list] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--long-dim", type=int, default=512)
    parser.add_argument("--output-dim", type=int, default=16)
    parser.add_argument("--num-classes", type=int, default=80)
    parser.add_argument("--long-center-path", type=str, default="")
    parser.add_argument("--short-center-path", type=str, default="")
    parser.add_argument("--label-file", type=str, default="")
    parser.add_argument("--post-epochs", type=int, default=100)
    parser.add_argument("--batch-size", type=int, default=200)
    parser.add_argument("--post-lr", type=float, default=0.001)
    parser.add_argument("--weight-decay", type=float, default=0.2)
    parser.add_argument("--warmup-proportion", type=float, default=0.1)
    parser.add_argument("--seed", type=int, default=1814)
    parser.add_argument("--save-dir", type=str, default="./")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where to train (default: the CUDA card)")
    args = parser.parse_args(argv)
    from .. import resolve_device

    device = resolve_device(args.device)

    if args.long_center_path and os.path.isfile(args.long_center_path):
        long_center = load_center_file(args.long_center_path)
    else:
        long_center = generate_hash_centers(args.num_classes, args.long_dim, 13)
    if args.short_center_path and os.path.isfile(args.short_center_path):
        short_center = load_center_file(args.short_center_path)
    else:
        short_center = generate_hash_centers(args.num_classes, args.output_dim, 14)

    labels = None
    if args.label_file and os.path.isfile(args.label_file):
        from ..data.builder import load_labels

        labels = load_labels(args.label_file)

    matrix, lossless, epochs = train_transform_matrix(
        long_center, short_center, labels=labels, epochs=args.post_epochs,
        batch_size=args.batch_size, lr=args.post_lr, warmup=args.warmup_proportion,
        weight_decay=args.weight_decay, seed=args.seed, device=device)
    out = os.path.join(args.save_dir, str(args.long_dim), f"{args.output_dim}.pkl")
    save_matrix_pkl(matrix, out)
    print(f"saved {'lossless ' if lossless else ''}matrix to {out}")
    return {"path": out, "lossless": lossless, "epochs": epochs}


if __name__ == "__main__":
    main()
