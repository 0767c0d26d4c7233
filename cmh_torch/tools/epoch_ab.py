"""Epoch-level A/B: the port's DCMHT epoch against a cached reference timing.

The port's side of ``cmh_tpu/tools/epoch_ab.py``: DCMHT trains on an
on-disk synthetic dataset (JPEG files listed in an ``index.mat``, so every
item is decoded and goes through the native transforms of
``data/transforms.py``), with deterministic transforms, and the wall time of
``train_epoch`` + ``valid`` (4-direction mAP) is measured per epoch after a
warm epoch:

    python -m cmh_torch.tools.epoch_ab [--scale tiny|full] [--epochs 2]
        [--ref-artifact tools/artifacts/ref_epoch_full.json] [--device cuda|cpu]

``--scale tiny`` is 32 pixels and a 2-layer CLIP; ``full`` is ViT-B/32 at
224 pixels, a 1,000-item epoch at batch 100 and 500 queries. The CLIP
weights are a seeded state dict in OpenAI's layout at those shapes, which
the trainer reads through ``model.clip_path``.

The reference side (the reference's torch trainer) is not run here: it
needs the reference repository, which the port does not ship, so
``--ref-only`` raises. A reference timing comes only from
``--ref-artifact``, a JSON file whose ``params`` must equal this
invocation's (or the tool fails, naming both); its ``ref_epoch_times_s``
give the ratio, with the reference's first epoch dropped when there are
more (the steady state on both sides, as cmh_tpu's tool does). With no
artifact it runs as ``--skip-reference``. The committed
``tools/artifacts/ref_epoch_full.json`` was measured with torch on a host
CPU, on another machine: its ratio to the card's epoch says nothing about
the card alone.

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import Optional

import numpy as np


def make_dataset(root: str, n_items: int, n_classes: int, res: int) -> str:
    """``<root>/abdata/{index,caption,label}.mat`` over ``n_items`` JPEG
    files of ``res`` pixels: cmh_tpu's seeded images (a quadrant brightened
    per class), labels and captions."""
    import scipy.io as scio
    from PIL import Image

    ds = os.path.join(root, "abdata")
    images = os.path.join(ds, "images")
    os.makedirs(images, exist_ok=True)
    rng = np.random.RandomState(7)
    labels = np.zeros((n_items, n_classes), dtype=np.float64)
    for i in range(n_items):
        pos = rng.choice(n_classes, size=rng.randint(1, 3), replace=False)
        labels[i, pos] = 1.0
    h = res // 2
    quads = [(slice(0, h), slice(0, h)), (slice(0, h), slice(h, None)),
             (slice(h, None), slice(0, h)), (slice(h, None), slice(h, None))]
    paths = []
    chunk = 512
    for start in range(0, n_items, chunk):
        stop = min(start + chunk, n_items)
        blk = rng.randint(40, 90, size=(stop - start, res, res, 3)).astype(np.float32)
        for c, (sy, sx) in enumerate(quads):
            blk[labels[start:stop, c % n_classes] > 0, sy, sx, c % 3] += 120.0
        for i, img in enumerate(np.clip(blk, 0, 255).astype(np.uint8)):
            path = os.path.join(images, f"{start + i:06d}.jpg")
            Image.fromarray(img).save(path, quality=95)
            paths.append(path)
    caps = [f"a synthetic photo of class {int(np.argmax(labels[i]))}" for i in range(n_items)]
    scio.savemat(os.path.join(ds, "index.mat"), {"index": np.asarray(paths)})
    scio.savemat(os.path.join(ds, "caption.mat"),
                 {"caption": np.asarray(caps).reshape(-1, 1)})
    scio.savemat(os.path.join(ds, "label.mat"), {"category": labels})
    return root


def write_clip(path: str, scale: str, res: int, device=None) -> None:
    """A seeded CLIP state dict in OpenAI's layout (fp32 tensors and the
    three integer entries): cmh_tpu's tool's tiny geometry, or ViT-B/32,
    with cmh_tpu's init from ``PRNGKey(0)`` drawn on ``device``."""
    import torch

    from ..models.clip.model import CLIP, CLIPConfig
    from ..utils import prng

    if scale == "tiny":
        cfg = CLIPConfig(embed_dim=32, image_resolution=res, vision_layers=2, vision_width=64,
                         vision_patch_size=8, context_length=16, transformer_width=64,
                         transformer_heads=1, transformer_layers=2)
    else:
        cfg = CLIPConfig()
    clip = CLIP(cfg)
    clip.init_weights(prng.PRNGKey(0), device)
    ints = {"input_resolution": cfg.image_resolution, "context_length": cfg.context_length,
            "vocab_size": cfg.vocab_size}
    torch.save({**{k: v.detach().float() for k, v in clip.state_dict().items()},
                **{k: torch.tensor(v) for k, v in ints.items()}}, path)


def cfg_dict(data_dir, clip_path, save_dir, *, res, train_num, query_num, batch, epochs,
             scan_steps=1):
    """cmh_tpu's A/B config: DCMHT, the on-disk dataset, 16 bits."""
    os.makedirs(save_dir, exist_ok=True)
    return {
        "model": {"arch": "DCMHT", "clip_path": clip_path, "hash_func": "softmax"},
        "optimizer": {"arch": "BertAdam", "lr": 0.001, "backbone_lr": 1e-5, "clip_lr": 1e-5},
        "dataset": {"arch": "transformer_dataset", "name": "abdata", "path": data_dir,
                    "img_file": "index.mat", "txt_file": "caption.mat",
                    "label_file": "label.mat", "image_resolution": res, "max_word": 16},
        "run": {"arch": "DCMHTTrainer", "save_dir": save_dir, "log_dir": save_dir,
                "output_dim": 16, "batch_size": batch, "eval_batch_size": 100,
                "is_train": True, "train_num": train_num, "query_num": query_num,
                "epochs": epochs, "seed": 1814, "shuffle": False, "num_workers": 0,
                "display_step": 10_000, "top_k": None, "scan_steps": scan_steps},
    }


def time_ours(cfg, epochs: int, device):
    """Seconds of ``train_epoch`` + ``valid`` for each of ``epochs`` epochs
    after a warm one, deterministic transforms on the train split."""
    from ..config import config_from_dict
    from ..registry import load_components

    trainer = load_components().require_runner_class("DCMHTTrainer").from_config(
        cfg=config_from_dict(cfg), device=device, auto_run=False)
    trainer.train_loader.dataset.is_train = False
    # warm epoch: the first launches, the optimizer's buffers, the file cache
    trainer.train_epoch(0)
    trainer.valid(0, k=None)
    times = []
    for e in range(epochs):
        t0 = time.perf_counter()
        trainer.train_epoch(e + 1)
        trainer.valid(e + 1, k=None)   # reads the mAPs back: the card is done
        times.append(time.perf_counter() - t0)
    return times


def read_artifact(path: str, key: dict) -> list:
    """The reference epoch times of a cached artifact measured with ``key``."""
    with open(path) as f:
        cached = json.load(f)
    if cached.get("params") != key:
        raise ValueError(f"cached reference artifact measured {cached.get('params')}, this "
                         f"invocation asks for {key} — re-point --ref-artifact")
    return [float(t) for t in cached["ref_epoch_times_s"]]


def reference_steady(ref_times: list) -> list:
    """The reference epochs a ratio takes: all but the first when there are
    more (its first epoch carries torch's lazy set-up and a cold page cache,
    as the warm epoch does on our side)."""
    return ref_times[1:] if len(ref_times) > 1 else ref_times


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", choices=["tiny", "full"], default="tiny",
                    help="tiny: 32px/2-layer CLIP; full: 224px ViT-B/32, 1000-item epoch "
                         "at batch 100")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--skip-reference", action="store_true")
    ap.add_argument("--train-num", type=int, default=None)
    ap.add_argument("--query-num", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--scan-steps", type=int, default=None,
                    help="cmh_tpu's steps a dispatch; the port steps one at a time")
    ap.add_argument("--ref-artifact", default=None,
                    help="JSON of a cached reference timing (params must match)")
    ap.add_argument("--ref-only", action="store_true",
                    help="measure the reference side only (not available in the port)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where our side runs (default: the CUDA card)")
    args = ap.parse_args(argv)
    from .. import resolve_device

    device = resolve_device(args.device)
    if args.ref_only:
        raise NotImplementedError(
            "--ref-only times the reference's torch trainer, which needs the reference "
            "repository; the port does not ship it (pass --ref-artifact instead)")

    if args.scale == "tiny":
        res, n_items, train_num, query_num, batch = 32, 600, 200, 100, 25
    else:
        res, n_items, train_num, query_num, batch = 224, 1500, 1000, 500, 100
    train_num = args.train_num if args.train_num is not None else train_num
    query_num = args.query_num if args.query_num is not None else query_num
    batch = args.batch if args.batch is not None else batch
    n_items = max(n_items, train_num + query_num)
    scan_steps = args.scan_steps
    if scan_steps is None:
        scan_steps = 25 if args.scale == "full" else 1
    common = dict(res=res, train_num=train_num, query_num=query_num, batch=batch,
                  epochs=args.epochs)
    key = dict(scale=args.scale, **common)
    ref_times = ref_source = None
    if args.ref_artifact and os.path.exists(args.ref_artifact):
        ref_times, ref_source = read_artifact(args.ref_artifact, key), "artifact"

    root = tempfile.mkdtemp(prefix="epoch_ab_")
    try:
        t0 = time.perf_counter()
        make_dataset(root, n_items, 4, res)
        clip_path = os.path.join(root, "clip.pt")
        write_clip(clip_path, args.scale, res, device)
        setup_s = time.perf_counter() - t0
        our_times = time_ours(cfg_dict(root, clip_path, os.path.join(root, "ours"), **common,
                                       scan_steps=scan_steps), args.epochs, device)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    import torch

    ref_steady = ref_times and reference_steady(ref_times)
    # the speedup is taken over the epoch seconds as reported, so the two agree
    ours = round(float(np.median(our_times)), 3)
    out = {
        "scale": args.scale, "train_num": train_num, "query_num": query_num, "batch": batch,
        "scan_steps": scan_steps, "backend_ours": device.type,
        "device_ours": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "setup_s": round(setup_s, 3),
        "ref_source": ref_source, "ref_epoch_times_s": ref_times,
        "ref_epoch_s": ref_times and round(float(np.median(ref_steady)), 3),
        "ours_epoch_times_s": [round(float(t), 3) for t in our_times],
        "ours_epoch_s": ours,
        "speedup": ref_times and round(float(np.median(ref_steady)) / ours, 2),
        "denominator_basis": ref_times and (
            f"torch reference trainer on a host CPU ({ref_source}, measured on another "
            f"machine), {train_num}-item epoch, batch {batch}, steady-state epochs"),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
