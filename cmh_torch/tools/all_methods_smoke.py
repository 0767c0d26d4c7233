"""One-method smoke on the device: a real train step and a 4-direction valid.

The port's ``cmh_tpu/tools/all_methods_smoke.py``: every registered method
must build, step and run ``valid`` (kernel K3 on the card) on the device,
at the tiny CLIP and on synthetic data, one method a call:

    python -m cmh_torch.tools.all_methods_smoke --method MITH [--device cuda|cpu]
    → @SMOKE@{"method": "MITH", "ok": true, "backend": "cuda", "loss": ...,
       "maps": [...], "build_s": ..., "step1_s": ..., "eval_s": ...}

The recipes are cmh_tpu's (its per-method test smokes).
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
from typing import Optional

RECIPES = {
    "DCMHT": dict(runner="DCMHTTrainer", model={"hash_func": "softmax"}),
    "MITH": dict(runner="MITHTrainer",
                 model={"hash_func": "tanh", "top_k_label": 3,
                        "transformer_layers": 1, "res_mlp_layers": 1},
                 batch=8),
    "DSPH": dict(runner="DSPHTrainer",
                 model={"hash_func": "tanh", "numclass": 4, "alpha": 0.8},
                 optimizer={"hyp": {"lr": 0.02}}),
    "DNPH": dict(runner="DNPHTrainer",
                 model={"hash_func": "tanh", "numclass": 4, "mrg": 1.0,
                        "noise_alpha": 0.1},
                 optimizer={"loss": {"lr": 0.0001}}),
    "TwDH": dict(runner="TwDHTrainer",
                 model={"hash_func": "softmax", "long_dim": 32,
                        "short_dims": [8], "numclass": 4,
                        "quan_alpha": 0.5, "low_rate": 0.1,
                        "long_center": "/nonexistent_centers",
                        "short_center": "/nonexistent_centers",
                        "trans_matrix": "/nonexistent_centers"},
                 batch=8),
    "DIMCH": dict(runner="DIMCHTrainer",
                  model={"hash_func": "tanh", "setDim": 4, "dropout": 0.1,
                         "distance": {"mode": "smooth_chamfer"},
                         "chamfer": {"mmd_alpha": 1.0, "unif_alpha": 0.3,
                                     "token_triplet_margin": 0.3},
                         "hash_pars": {"triplet_alpha": 50, "quan_alpha": 1.0,
                                       "hash_triplet_alpha": 50,
                                       "triplet_margin": 0.3}},
                  batch=8),
    "UMoED": dict(runner="UMoEDTrainer",
                  model={"hash_func": "linear_subspace",
                         "merge_func": "concatenate", "setDim": 8,
                         "MoE": True, "fusion": True, "num_experts": 2,
                         "slots_per_expert": 2, "decoder_heads": 2,
                         "decoder_layers": 1, "hidden_dim": 32,
                         "dropout": 0.1, "extreme": True, "extreme_T": 0.3,
                         "triplet": True, "distance_mode": "cosine",
                         "distance": {"mode": "pairwise"},
                         "chamfer": {"unif_alpha": 0.8,
                                     "token_triplet_margin": 0.1},
                         "hash_pars": {"triplet_alpha": 1,
                                       "triplet_margin": 0.3}},
                  batch=8, output_dim=8),
    "Baseline": dict(runner="BaselineTrainer",
                     model={"hash_func": "tanh", "quan_alpha": 0.001,
                            "dropout": 0.1}),
}


def smoke_config(method: str, save_dir: str) -> dict:
    """The run config of ``method``'s recipe: tiny CLIP, synthetic data, one
    epoch of two steps."""
    r = RECIPES[method]
    batch = r.get("batch", 16)
    return {
        "model": dict({"arch": method, "clip_path": "/nonexistent.pt",
                       "clip_variant": "tiny"}, **r["model"]),
        "optimizer": dict({"arch": "BertAdam", "lr": 0.002, "clip_lr": 0.0005},
                          **r.get("optimizer", {})),
        "dataset": {"arch": "synthetic_dataset", "name": "synthetic", "num_classes": 4,
                    "image_resolution": 32, "max_word": 12},
        "run": {"arch": r["runner"], "save_dir": save_dir, "log_dir": save_dir,
                "output_dim": r.get("output_dim", 8), "batch_size": batch,
                "is_train": True, "train_num": 2 * batch, "query_num": batch,
                "epochs": 1, "display_step": 1000, "seed": 5},
    }


def run_method(method: str, device="cuda") -> dict:
    """Build ``method``'s trainer on ``device``, take one train step on its
    first batch and run one ``valid``; the JSON record of the smoke."""
    import math

    import torch

    from .. import resolve_device
    from ..config import config_from_dict
    from ..registry import load_components

    dev = resolve_device(device)
    tmp = tempfile.mkdtemp(prefix=f"smoke_{method}_")
    try:
        cfg = config_from_dict(smoke_config(method, tmp))
        t0 = time.perf_counter()
        tr = load_components().require_runner_class(RECIPES[method]["runner"]).from_config(
            cfg=cfg, device=dev, auto_run=False)
        build_s = time.perf_counter() - t0

        batch = next(iter(tr.train_loader))
        t0 = time.perf_counter()
        loss, _ = tr.train_step(batch)
        loss = float(loss)   # the host read waits for the device
        step1_s = time.perf_counter() - t0
        if not math.isfinite(loss):
            raise AssertionError(f"{method}: loss not finite")

        t0 = time.perf_counter()
        maps = [float(m) for m in tr.valid(epoch=0)]
        eval_s = time.perf_counter() - t0
        if not all(0.0 <= m <= 1.0 for m in maps):
            raise AssertionError(f"{method}: mAPs outside [0, 1]: {maps}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"method": method, "ok": True, "backend": dev.type,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "loss": round(loss, 6), "maps": [round(m, 6) for m in maps],
            "build_s": round(build_s, 2), "step1_s": round(step1_s, 2),
            "eval_s": round(eval_s, 2)}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--method", required=True, choices=sorted(RECIPES))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to run (default: the CUDA card)")
    args = ap.parse_args(argv)
    from .. import resolve_device

    resolve_device(args.device)   # no card and no --device cpu: raise, print nothing
    try:
        out = run_method(args.method, args.device)
    except Exception as e:   # one line either way: a battery of calls parses it
        out = {"method": args.method, "ok": False, "error": f"{type(e).__name__}: {e}"[:500]}
    print("@SMOKE@" + json.dumps(out))
    return out


if __name__ == "__main__":
    main()
