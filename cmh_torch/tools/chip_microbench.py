"""Card microbenchmarks: bf16 matmul rate by contraction depth, launch cost.

The port's ``cmh_tpu/tools/chip_microbench.py``, for the CUDA card:

    python -m cmh_torch.tools.chip_microbench [--quick] [--device cuda|cpu]

It prints the card's name and power limit (``nvidia-smi``) first, then:

- square bf16 matmuls, TFLOP/s at n = 1024, 2048, 4096 and 8192 (``--quick``
  skips 8192);
- the bf16 matmuls of a ViT-B/32 layer at batch 256 (12800 rows: the qkv
  projection 768 → 2304, the MLP's 768 → 3072 and 3072 → 768);
- the cost of a launch: 256 back-to-back trivial kernels, per launch on the
  host clock (the host's launch rate) and on the card's clock when they are
  queued behind a spin kernel (the card's own cost of a launch).

These are ``torch.matmul`` calls: a measurement of the card and of
PyTorch's library, not a port of a kernel. On the card each time is the
median of 3 runs of CUDA events around back-to-back calls queued behind a
spin kernel, over varied inputs; on the CPU (``--device cpu``) the host
clock. ``main`` returns the numbers as a dict.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from typing import Optional


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def run_ms(fn, iters: int, device) -> float:
    """Milliseconds of ``iters`` calls of ``fn(i)`` back to back (after one
    warm pass): CUDA events on the card, with a spin kernel queued first so
    that the host's launch rate does not show; the host clock on the CPU."""
    import torch

    for i in range(iters):
        fn(i)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for i in range(iters):
            fn(i)
        return (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    torch.cuda.synchronize(device)
    host_s = time.perf_counter() - t0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(2 * host_s * 2e9) + 1_000_000)   # ~2 GHz SM clock
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def median3(fn, iters: int, device) -> float:
    return sorted(run_ms(fn, iters, device) for _ in range(3))[1]


def mm_rate(M: int, K: int, N: int, iters: int, device, gen) -> dict:
    """bf16 (M, K) @ (K, N) over ``iters`` different left operands."""
    import torch

    w = (torch.randn((K, N), generator=gen) / K ** 0.5).to(device, torch.bfloat16)
    xs = [(torch.randn((M, K), generator=gen) * 0.3).to(device, torch.bfloat16)
          for _ in range(iters)]
    ms = median3(lambda i: torch.matmul(xs[i], w), iters, device) / iters
    out = {"shape": [M, K, N], "ms": ms, "tflops": 2 * M * K * N / (ms * 1e-3) / 1e12}
    print(f"({M},{K})@({K},{N}): {ms:8.3f} ms  {out['tflops']:6.1f} TF/s", flush=True)
    return out


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="skip n=8192")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="what to measure (default: the CUDA card)")
    args = ap.parse_args(argv)
    from .. import resolve_device

    device = resolve_device(args.device)
    import torch

    card = card_line() if device.type == "cuda" else "cpu"
    print(f"device: {card}", flush=True)
    gen = torch.Generator().manual_seed(0)

    print("\n-- square bf16 matmuls (rate vs contraction depth K) --", flush=True)
    square = [mm_rate(n, n, n, 8 if n < 8192 else 2, device, gen)
              for n in (1024, 2048, 4096) + (() if args.quick else (8192,))]

    print("\n-- model shapes (ViT-B/32 at batch 256) --", flush=True)
    model = [mm_rate(12800, 768, 2304, 8, device, gen),    # qkv projection
             mm_rate(12800, 768, 3072, 8, device, gen),    # MLP up
             mm_rate(12800, 3072, 768, 8, device, gen)]    # MLP down

    print("\n-- launch cost (256 trivial kernels back to back) --", flush=True)
    x = torch.randn((8, 128), generator=gen).to(device, torch.bfloat16)
    n = 256
    host_us = []
    for _ in range(3):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(n):
            x.mul_(1.0000001)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        host_us.append((time.perf_counter() - t0) / n * 1e6)
    launch = {"host_us": sorted(host_us)[1]}
    print(f"per launch: {launch['host_us']:.2f} us (host clock, synchronized)", flush=True)
    if device.type == "cuda":
        launch["device_us"] = median3(lambda i: x.mul_(1.0000001), n, device) / n * 1e3
        print(f"per launch: {launch['device_us']:.3f} us (CUDA events, queued behind a spin)",
              flush=True)
    return {"device": card, "square": square, "model_shapes": model, "launch": launch}


if __name__ == "__main__":
    main()
