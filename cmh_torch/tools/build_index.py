"""Build a serving index (and optionally an encoder file) from a trained run.

The port's ``cmh_tpu/tools/build_index.py``: the dataset's retrieval split is
encoded through the trained model with the trainer's own eval path (the
same transforms, binarization and batches), the codes of one modality are
packed into a ``RetrievalIndex`` and saved in the npz layout both packages
read, and ``--out-encoders`` writes the encoder file
``cmh_torch.server`` loads beside it:

    python -m cmh_torch.tools.build_index --config-file configs/DCMHT/config.yaml \
        --model result/.../model-9.pt --out-index gallery \
        [--modality image|text] [--out-encoders enc.pt] [--device cuda|cpu]

``--model`` is a ``model-N.pt`` of the port or a cmh_tpu ``model-N.msgpack``.
It prints one JSON line: the index path, items, bits, modality and encoder
path.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--model", required=True,
                    help="weights from a training run (model-N.pt or cmh_tpu's model-N.msgpack)")
    ap.add_argument("--out-index", required=True,
                    help="output .npz path prefix for the RetrievalIndex")
    ap.add_argument("--modality", choices=("image", "text"), default="image",
                    help="which tower's codes populate the gallery")
    ap.add_argument("--out-encoders", default=None,
                    help="also write the encoder file to this path")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to encode (default: the CUDA card)")
    args = ap.parse_args(argv)

    from .. import resolve_device

    device = resolve_device(args.device)

    from ..config import load_config
    from ..registry import load_components
    from ..serving import RetrievalIndex

    cfg = load_config(args.config_file)
    # an eval-only trainer: the dataset, the model with the run's weights
    # (run.resume_model) and the eval path
    cfg.run.update({"is_train": False, "resume_model": args.model,
                    "save_dir": os.path.dirname(os.path.abspath(args.out_index)) or "."})
    runner_cls = load_components().require_runner_class(cfg.run.get("arch", "DCMHTTrainer"))
    tr = runner_cls.from_config(cfg=cfg, device=device, auto_run=False)

    codes = tr.get_code(tr.retrieval_loader, tr.retrieval_num)
    # TwDH gives (long image, long text, short image, short text), the other
    # methods (image, text): index the asked modality's top-level codes
    gallery = codes[0 if args.modality == "image" else 1]
    index = RetrievalIndex(bits=gallery.shape[1], device=device)
    index.add(gallery)
    index.save(args.out_index)
    out_path = args.out_index if args.out_index.endswith(".npz") else args.out_index + ".npz"

    if args.out_encoders:
        from ..export import save_encoders

        save_encoders(tr.model, cfg, args.out_encoders, tr.method.eval_method_state())

    out = {"index": out_path, "items": len(index), "bits": index.bits,
           "modality": args.modality, "encoders": args.out_encoders}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
