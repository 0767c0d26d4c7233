"""Training and evaluation CLI of the port (counterpart of ``main.py``).

    python -m cmh_torch.main --config-file configs/DCMHT/synthetic_tpu.yaml \
        --save-dir result/DCMHT [--device cuda|cpu] [--seed N] [--distribute]

The save dir gets a timestamped subdirectory with ``log/``; the YAML is
loaded into the config tree and the runner named by ``run.arch`` is built
from the registry and run on ``--device`` (the card by default; without one
the runner raises unless given ``--device cpu``).

Data parallelism (``parallel/dp.py``), one process per card:

- ``--distribute`` on one host starts one process per visible card, as the
  reference's ``mp.spawn`` did, and raises with fewer than two;
- ``run.multi_host: true`` joins a group from cmh_tpu's own keys
  (``distributed_addr``, ``distributed_port``, ``num_processes``,
  ``process_id``): one command a process, on any number of hosts, its card
  ``process_id`` modulo the host's cards (NCCL), or the CPU (gloo, with
  ``--device cpu``);
- ``run.distribute: true`` alone runs the data-parallel path in a group of
  one.

``run.tp: T`` makes the processes cmh_tpu's (dp, tp) mesh of ``world // T``
by ``T`` (``parallel/tp.py``); the processes must divide by T (cmh_tpu's
``ValueError`` otherwise, before any process starts or joins).

``run_config`` alone opens these groups and leaves them at the end; a
trainer only reads the group it runs in.
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
                        help="data-parallel training, one process per visible card")
    return parser.parse_args(argv)


def read_config(config_file: str, args):
    from .config import load_config

    cfg = load_config(config_file)
    cfg.run.update({"save_dir": args.save_dir})
    if args.seed is not None:
        cfg.run.update({"seed": args.seed})
    return cfg


def maybe_init_distributed(cfg, device: str) -> bool:
    """Join the data-parallel group that ``run.multi_host`` describes
    (cmh_tpu ``main.py:50-81``), or open a group of one for
    ``run.distribute`` alone (cmh_tpu builds a one-device mesh from that
    key); returns whether it did."""
    run = cfg.run
    if not run.get("multi_host", False) and not run.get("distribute", False):
        return False
    import torch

    from .parallel import dp

    tp_size = int(run.get("tp", 1) or 1)
    if not run.get("multi_host", False):
        dp.init("localhost", dp.free_port(), 1, 0, torch.device(device), tp=tp_size)
        return True
    missing = [k for k in ("num_processes", "process_id") if run.get(k, None) is None]
    if missing:
        raise ValueError(f"run.multi_host needs run.{' and run.'.join(missing)}")
    rank = int(run["process_id"])
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    dp.init(run.get("distributed_addr", "localhost"), run.get("distributed_port", 12345),
            int(run["num_processes"]), rank, dev, tp=tp_size)
    return True


def _spawned(rank: int, cfg_dict: dict, world: int, port: int, device: str):
    """One process of ``--distribute``: rank ``rank`` of ``world``."""
    from .config import config_from_dict

    cfg = config_from_dict(cfg_dict)
    cfg.run.update({"multi_host": True, "distributed_addr": "localhost",
                    "distributed_port": port, "num_processes": world, "process_id": rank})
    run_config(cfg, device)


def run_config(cfg, device: str):
    """Build and run the runner that ``run.arch`` names, in the group that
    ``run.multi_host`` or ``run.distribute`` asks for, which is left again
    at the end."""
    from .parallel import dp
    from .registry import load_components

    before = dp.current()
    try:
        if before is None:
            maybe_init_distributed(cfg, device)
        runner_cls = load_components().require_runner_class(
            cfg.run.get("arch", "DCMHTTrainer"))
        return runner_cls.from_config(cfg=cfg, device=device)
    finally:
        if before is None:
            dp.shutdown()


def main(argv: Optional[list] = None):
    args = get_args(argv)
    from . import resolve_device

    resolve_device(args.device)
    stamp = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M")
    args.save_dir = os.path.join(args.save_dir, stamp)
    log_dir = os.path.join(args.save_dir, "log")
    cfg = read_config(args.config_file, args)
    cfg.run.update({"log_dir": log_dir})
    if args.distribute:
        import torch
        import torch.multiprocessing as mp

        from .parallel import dp, tp

        world = torch.cuda.device_count() if args.device == "cuda" else 0
        if world < 2:
            raise AssertionError("distribute training needs more than one device!")
        tp.check_world(world, int(cfg.run.get("tp", 1) or 1))
        os.makedirs(log_dir, exist_ok=True)
        mp.spawn(_spawned, args=(cfg.to_dict(), world, dp.free_port(), args.device),
                 nprocs=world)
        return None
    if not cfg.run.get("multi_host", False) or int(cfg.run.get("process_id", 0) or 0) == 0:
        os.makedirs(log_dir, exist_ok=True)
    return run_config(cfg, args.device)


if __name__ == "__main__":
    main()
