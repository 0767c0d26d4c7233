"""One-command parity table for real benchmark archives.

The port's ``cmh_tpu/tools/real_parity.py``, without its reference stage:

    python -m cmh_torch.tools.real_parity \
        --data-root ./data/transformer --dataset coco \
        --clip-path ./ViT-B-32.pt \
        --methods DCMHT --output-dims 16,32,64 \
        [--preflight-only] [--device cuda|cpu] --save-dir result/parity

Stages:

1. **Preflight**: loads each archive file and reports its container (shape,
   dtype), then materializes item 0 of each split through the port's
   loader (image, token ids, padding mask, label), so a broken archive
   fails here with a named report (``[preflight:<part>]``).
2. **Ours**: for each (method, bits): ``configs/<METHOD>/config.yaml`` with
   the dataset, CLIP and run fields from the command line, trained with the
   reference protocol (train_num 10000, query_num 5000 by default), the
   best i→t and t→i mAP recorded.
3. **Table**: markdown and JSON of ours beside the published TABLE I numbers
   (``PUBLISHED``) where a row exists.

``--with-reference`` (the reference's torch trainer on the same files)
raises: it needs the reference repository, which the port does not ship.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np

# mAP@5000 I->T / T->I published in the reference repo
# (runners/TwDH/data/result.png TABLE I, transcribed in BASELINE.md "In-repo
# published numbers"). Keyed (method, dataset, bits).
PUBLISHED = {
    ("TwDH", "mirflickr", 16): (0.8783, 0.8566),
    ("TwDH", "mirflickr", 32): (0.8927, 0.8718),
    ("TwDH", "mirflickr", 64): (0.8993, 0.8759),
    ("TwDH", "nuswide", 16): (0.7842, 0.7748),
    ("TwDH", "nuswide", 32): (0.8144, 0.7965),
    ("TwDH", "nuswide", 64): (0.8191, 0.7955),
    ("TwDH", "coco", 16): (0.7348, 0.7348),
    ("TwDH", "coco", 32): (0.8051, 0.8027),
    ("TwDH", "coco", 64): (0.8422, 0.8514),
    ("DCMHT", "coco", 16): (0.6402, 0.6477),
    ("DCMHT", "coco", 32): (0.6952, 0.6964),
    ("DCMHT", "coco", 64): (0.7239, 0.7144),
}

# dataset-name aliases → the PUBLISHED table's canonical names
_DATASET_ALIASES = {
    "mirflickr25k": "mirflickr", "flickr25k": "mirflickr", "flickr": "mirflickr",
    "mscoco": "coco", "coco2014": "coco",
    "nus-wide": "nuswide", "nus_wide": "nuswide",
}

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _canonical(name: str) -> str:
    low = name.lower()
    return _DATASET_ALIASES.get(low, low)


def _describe(arr) -> str:
    if isinstance(arr, np.ndarray):
        return f"shape={arr.shape} dtype={arr.dtype}"
    return f"type={type(arr).__name__}"


def preflight(data_dir: str, files: dict, resolution: int, max_word: int, query_num: int,
              train_num: int) -> dict:
    """Check the three archive files and item 0 of each split; returns a
    report dict (raises with a named report section on the first failure)."""
    from ..data.builder import load_captions, load_indexs, load_labels, split_data
    from ..data.dataset import TransformerDataset
    from ..registry import load_components

    report = {"data_dir": data_dir}
    paths = {k: os.path.join(data_dir, v) for k, v in files.items()}
    for kind, p in paths.items():
        if not os.path.isfile(p):
            raise AssertionError(f"[preflight:{kind}] missing file {p} — expected the "
                                 f"archive layout <data-root>/<dataset>/{files[kind]}")

    try:
        captions = load_captions(paths["caption"])
        report["caption"] = _describe(captions)
    except Exception as e:
        raise RuntimeError(
            f"[preflight:caption] {paths['caption']} not readable by "
            f"load_captions (keys tried: caption/tags/YAll): {e}") from e
    try:
        indexs, npy = load_indexs(paths["index"])
        report["index"] = _describe(indexs) + f" npy={npy}"
    except Exception as e:
        raise RuntimeError(
            f"[preflight:index] {paths['index']} not readable by "
            f"load_indexs (keys tried: index/imgs/FAll): {e}") from e
    try:
        labels = load_labels(paths["label"])
        report["label"] = _describe(labels)
    except Exception as e:
        raise RuntimeError(
            f"[preflight:label] {paths['label']} not readable by "
            f"load_labels (keys tried: category/LAll/labels): {e}") from e

    n = len(indexs)
    if len(captions) != n or len(labels) != n:
        raise AssertionError(f"[preflight:size] corpus sizes disagree: captions="
                             f"{len(captions)} index={n} labels={len(labels)}")
    if n < query_num + train_num:
        raise AssertionError(f"[preflight:size] corpus has {n} items < query_num+train_num "
                             f"= {query_num + train_num}")
    report["corpus_items"] = int(n)

    # any fixed seed proves the split's plumbing
    np.random.seed(1814)
    split_indexs, split_captions, split_labels = split_data(
        captions, indexs, labels, query_num=query_num, train_num=train_num)
    tokenizer_cls = load_components().get_tokenizer_class("clip_tokenizer")
    tokenizer = tokenizer_cls() if tokenizer_cls else None
    for name, (si, sc, sl) in zip(("query", "train", "retrieval"),
                                  zip(split_indexs, split_captions, split_labels)):
        ds = TransformerDataset(captions=sc, indexs=si, labels=sl, imageResolution=resolution,
                                is_train=False, npy=npy, tokenizer=tokenizer,
                                maxWords=max_word)
        try:
            img, cap, mask, label, _ = ds[0]
        except Exception as e:
            raise RuntimeError(
                f"[preflight:{name}] split built but item 0 failed to "
                f"materialize (image decode / tokenize / label): {e}") from e
        if img.shape[-3:] != (resolution, resolution, 3):
            raise AssertionError(f"[preflight:{name}] image shape {img.shape}")
        if int(np.sum(np.asarray(cap) != 0)) < 2:
            raise AssertionError(f"[preflight:{name}] tokenized caption is empty: {cap[:8]}")
        report[f"{name}_item0"] = (
            f"image{tuple(img.shape)} tokens{tuple(np.asarray(cap).shape)} "
            f"pad_mask_nonpad={int(np.sum(~np.asarray(mask, dtype=bool)))} "
            f"label{tuple(np.asarray(label).shape)}")
    return report


def _method_cfg(method: str, args, dim: int, save_dir: str):
    from ..config import load_config

    cfg_path = args.config or os.path.join(REPO, "configs", method, "config.yaml")
    if not os.path.isfile(cfg_path):
        raise AssertionError(f"no config for method {method}: {cfg_path}")
    cfg = load_config(cfg_path)
    cfg.model.update({"clip_path": args.clip_path})
    if args.clip_variant:
        cfg.model.update({"clip_variant": args.clip_variant})
    cfg.dataset.update({
        "path": args.data_root, "name": args.dataset,
        "txt_file": args.caption_file, "img_file": args.index_file,
        "label_file": args.label_file,
        "image_resolution": args.image_resolution,
        "max_word": args.max_word,
    })
    run_over = {"output_dim": dim, "save_dir": save_dir, "log_dir": save_dir,
                "train_num": args.train_num, "query_num": args.query_num,
                "seed": args.seed, "is_train": True}
    if args.epochs is not None:
        run_over["epochs"] = args.epochs
    if args.batch_size is not None:
        run_over["batch_size"] = args.batch_size
    if args.scan_steps is not None:
        run_over["scan_steps"] = args.scan_steps
    cfg.run.update(run_over)
    return cfg


def run_ours(method: str, cfg, device="cuda") -> dict:
    """Train ``cfg`` on ``device``; the best i→t and t→i mAP and epochs."""
    from ..registry import load_components

    runner_cls = load_components().require_runner_class(cfg.run.get("arch"))
    t0 = time.perf_counter()
    trainer = runner_cls.from_config(cfg=cfg, device=device, auto_run=False)
    trainer.train()
    return {"map_i2t": float(trainer.max_mapi2t), "map_t2i": float(trainer.max_mapt2i),
            "best_epoch_i": int(trainer.best_epoch_i), "best_epoch_t": int(trainer.best_epoch_t),
            "wall_s": round(time.perf_counter() - t0, 1)}


def emit_table(rows, dataset, out_path):
    lines = [
        f"# Real-data parity — {dataset}",
        "",
        "| method | bits | ours i->t | ours t->i | ref i->t | ref t->i | "
        "|d| max | published i->t | published t->i |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        ours, ref = r.get("ours"), r.get("reference")
        pub = PUBLISHED.get((r["method"], _canonical(dataset), r["bits"]))
        delta = ""
        if ours and ref:
            d = max(abs(ours["map_i2t"] - ref["map_i2t"]),
                    abs(ours["map_t2i"] - ref["map_t2i"]))
            delta = f"{d:.4f} {'OK' if d <= 0.005 else 'OVER'}"

        def fmt(side, key):
            return f"{side[key]:.4f}" if side else "—"

        pub_i2t = f"{pub[0]:.4f}" if pub else "—"
        pub_t2i = f"{pub[1]:.4f}" if pub else "—"
        lines.append(
            f"| {r['method']} | {r['bits']} | {fmt(ours, 'map_i2t')} | "
            f"{fmt(ours, 'map_t2i')} | {fmt(ref, 'map_i2t')} | "
            f"{fmt(ref, 'map_t2i')} | {delta or '—'} | {pub_i2t} | {pub_t2i} |")
    lines += ["", "Parity target: |ours - reference| <= 0.005 per direction "
              "(BASELINE.md north star). Published = reference repo TABLE I "
              "(mAP@5000; match the run protocol before comparing).", ""]
    with open(out_path, "w") as f:
        f.write("\n".join(lines))


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-root", required=True,
                    help="dir containing <dataset>/{caption,index,label}.mat")
    ap.add_argument("--dataset", required=True,
                    help="subdir name: coco | mirflickr | nuswide | ...")
    ap.add_argument("--clip-path", default="./ViT-B-32.pt")
    ap.add_argument("--caption-file", default="caption.mat")
    ap.add_argument("--index-file", default="index.mat")
    ap.add_argument("--label-file", default="label.mat")
    ap.add_argument("--methods", default="DCMHT", help="comma list, e.g. DCMHT,MITH,TwDH")
    ap.add_argument("--output-dims", default="16,32,64")
    ap.add_argument("--config", default=None,
                    help="explicit config.yaml (else configs/<METHOD>/)")
    ap.add_argument("--train-num", type=int, default=10000)
    ap.add_argument("--query-num", type=int, default=5000)
    ap.add_argument("--epochs", type=int, default=None,
                    help="override the method config's epochs")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--scan-steps", type=int, default=None)
    ap.add_argument("--seed", type=int, default=1814)
    ap.add_argument("--image-resolution", type=int, default=224)
    ap.add_argument("--max-word", type=int, default=32)
    ap.add_argument("--clip-variant", default=None,
                    help="e.g. 'tiny' for smoke-testing the pipeline without the full ViT-B/32")
    ap.add_argument("--with-reference", action="store_true",
                    help="also train the reference's torch trainer (not available in the port)")
    ap.add_argument("--preflight-only", action="store_true")
    ap.add_argument("--save-dir", default="result/parity")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to train (default: the CUDA card)")
    args = ap.parse_args(argv)
    from .. import resolve_device

    device = resolve_device(args.device)
    if args.with_reference:
        raise NotImplementedError(
            "--with-reference trains the reference's torch trainer, which needs the reference "
            "repository; the port does not ship it")

    data_dir = os.path.join(args.data_root, args.dataset)
    files = {"caption": args.caption_file, "index": args.index_file, "label": args.label_file}
    report = preflight(data_dir, files, resolution=args.image_resolution,
                       max_word=args.max_word, query_num=args.query_num,
                       train_num=args.train_num)
    print(json.dumps({"preflight": report}, indent=1))
    if args.preflight_only:
        return {"preflight": report}

    if not os.path.isfile(args.clip_path):
        raise AssertionError(f"pretrained CLIP checkpoint not found: {args.clip_path}")
    os.makedirs(args.save_dir, exist_ok=True)
    rows = []
    for method in (m.strip() for m in args.methods.split(",")):
        for dim in (int(d) for d in args.output_dims.split(",")):
            tag = f"{method}-{args.dataset}-{dim}"
            cfg = _method_cfg(method, args, dim, os.path.join(args.save_dir, tag, "ours"))
            os.makedirs(cfg.run.get("save_dir"), exist_ok=True)
            row = {"method": method, "bits": dim, "ours": run_ours(method, cfg, device)}
            print(json.dumps({tag: row["ours"]}))
            rows.append(row)

    out_json = os.path.join(args.save_dir, f"parity_{args.dataset}.json")
    with open(out_json, "w") as f:
        json.dump({"dataset": args.dataset, "preflight": report, "rows": rows}, f, indent=1)
    emit_table(rows, args.dataset, os.path.join(args.save_dir, f"parity_{args.dataset}.md"))
    print(json.dumps({"parity_table": out_json}))
    return {"preflight": report, "rows": rows, "parity_table": out_json}


if __name__ == "__main__":
    main()
