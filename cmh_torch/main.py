"""Training and evaluation CLI of the port (counterpart of ``main.py``).

    python -m cmh_torch.main --config-file configs/DCMHT/synthetic_tpu.yaml \
        --save-dir result/DCMHT [--device cuda|cpu] [--seed N]

The save dir gets a timestamped subdirectory with ``log/``; the YAML is
loaded into the config tree and the runner named by ``run.arch`` is built
from the registry and run on ``--device`` (the card by default; without one
the runner raises unless given ``--device cpu``). ``--distribute`` is not
ported yet and raises.
"""

from __future__ import annotations

import argparse
import datetime
import os
from typing import Optional


def get_args(argv: Optional[list] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config-file", type=str,
                        default="configs/DCMHT/config.yaml",
                        help="choices a hash model to run.")
    parser.add_argument("--save-dir", type=str, default="./result/DCMHT",
                        help="save dir.")
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                        help="where to run (default: the CUDA card)")
    parser.add_argument("--seed", type=int, default=None,
                        help="override run.seed from the YAML (default 1814)")
    parser.add_argument("--distribute", action="store_true", default=False,
                        help="multi-GPU training (not ported yet)")
    return parser.parse_args(argv)


def read_config(config_file: str, args):
    from .config import load_config

    cfg = load_config(config_file)
    cfg.run.update({"save_dir": args.save_dir})
    if args.seed is not None:
        cfg.run.update({"seed": args.seed})
    return cfg


def main(argv: Optional[list] = None):
    args = get_args(argv)
    if args.distribute:
        raise NotImplementedError(
            "--distribute is not ported to cmh_torch yet (ROADMAP.md Queue 1, "
            "'Multi-GPU')")
    from . import resolve_device
    from .registry import load_components

    resolve_device(args.device)
    stamp = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M")
    args.save_dir = os.path.join(args.save_dir, stamp)
    log_dir = os.path.join(args.save_dir, "log")
    os.makedirs(log_dir, exist_ok=True)
    cfg = read_config(args.config_file, args)
    cfg.run.update({"log_dir": log_dir})
    runner_cls = load_components().require_runner_class(
        cfg.run.get("arch", "DCMHTTrainer"))
    return runner_cls.from_config(cfg=cfg, device=args.device)


if __name__ == "__main__":
    main()
