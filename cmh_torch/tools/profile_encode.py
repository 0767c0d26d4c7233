"""Time the eval path: encoding alone, the codes, and the codes with mAP.

The port's ``cmh_tpu/tools/profile_encode.py``:

    python -m cmh_torch.tools.profile_encode [--batch 256] [--nbatches 4]
        [--runs 3] [--tiny] [--trace] [--device cuda|cpu]

On the method's trainer (the synthetic config of ``profile_train``) and
``--nbatches`` query batches of ``--batch`` made on the device ahead of
time, the median of ``--runs`` timings (host clock, synchronized, after a
warm call) of:

  A. the product path, ``get_code``: encode → ``make_hash_code`` → the ±1
     codes scattered by index (what ``valid`` and ``build_index`` run);
  B. encode only: both towers and the hash heads, no binarization;
  C. A and then the 4-direction mAP of those codes against themselves (K3
     on the card).

A − B is the binarization and scatter, C − A the mAP. ``--trace`` profiles
one call of C with ``torch.profiler``, writes its Chrome trace and prints
the breakdown by kernel (by host operator on the CPU). ``main`` returns the
numbers as a dict.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from typing import Optional

from .profile_train import (device_batches, op_table, print_table, profiled,
                            synchronize, synthetic_trainer)


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--method", default="DCMHT")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--nbatches", type=int, default=4)
    ap.add_argument("--output-dim", type=int, default=64)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--trace", action="store_true",
                    help="profile the product path with its mAP and print the breakdown")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to run (default: the CUDA card)")
    args = ap.parse_args(argv)
    from .. import resolve_device

    device = resolve_device(args.device)

    import torch

    from ..ops.map_bucketed import calc_map_k_4dir_auto

    n_items = args.batch * args.nbatches
    tr = synthetic_trainer(args.method, args.batch, args.output_dim, args.tiny, n_items,
                           device)
    print(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}, "
          f"batch {args.batch} × {args.nbatches} batches", flush=True)
    batches = device_batches(tr.query_loader, device)
    labels = tr.query_labels

    def timed(fn):
        fn()
        synchronize(device)
        times = []
        for _ in range(args.runs):
            t0 = time.perf_counter()
            fn()
            synchronize(device)
            times.append(time.perf_counter() - t0)
        return sorted(times)[len(times) // 2]

    def product():
        return tr.get_code(batches, n_items)

    @torch.no_grad()
    def encode_only():
        tr.model.eval()
        return [(tr.model.encode_image(b["image"]),
                 tr.model.encode_text(b["text"], b["key_padding_mask"])) for b in batches]

    def with_map():
        img, txt = product()[:2]
        return calc_map_k_4dir_auto(img, txt, img, txt, labels, labels, None)

    t_a = timed(product)
    print(f"A product get_code:          {t_a * 1e3:7.1f} ms ({n_items / t_a:7.0f} items/s)",
          flush=True)
    t_b = timed(encode_only)
    print(f"B encode only:               {t_b * 1e3:7.1f} ms ({n_items / t_b:7.0f} items/s)",
          flush=True)
    t_c = timed(with_map)
    print(f"C codes + 4-direction mAP:   {t_c * 1e3:7.1f} ms ({n_items / t_c:7.0f} items/s)",
          flush=True)
    out = {"batch": args.batch, "nbatches": args.nbatches, "device": device.type,
           "product_ms": t_a * 1e3, "encode_only_ms": t_b * 1e3, "encode_map_ms": t_c * 1e3,
           "product_items_per_sec": n_items / t_a,
           "encode_only_items_per_sec": n_items / t_b,
           "encode_map_items_per_sec": n_items / t_c,
           "hash_scatter_overhead_ms": (t_a - t_b) * 1e3, "map_ms": (t_c - t_a) * 1e3}
    print(json.dumps(out), flush=True)

    if args.trace:
        prof, path = profiled(with_map, device, tempfile.mkdtemp(prefix="cmh_prof_enc_"),
                              "encode-map")
        table = op_table(prof, device, 1)
        print(f"trace written to {path}")
        print_table(table, "call")
        out.update(trace=path, **table)
    return out


if __name__ == "__main__":
    main()
