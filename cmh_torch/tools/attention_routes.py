"""Time the K2 kernels at the main path's shapes, here and in an earlier
checkout, on the card.

    python -m cmh_torch.tools.attention_routes [--earlier DIR]

The bf16 one-block kernels (``csrc/attention.cu``) at the shapes the ViT-B/32
towers give them: the forward at batch 256, the backward at batch 100,
vision (12 heads, S = 50, no mask) and text (8 heads, S = 32, causal and
key-padding masks); the bf16 row-tiled kernels (``csrc/attention_tiled.cu``)
at the vision towers of ViT-B/16 (forward, 256 images, 12 heads, S = 197)
and ViT-L/14 (forward and backward, batch 100, 16 heads, S = 257) and the
forward one past the logit rows' shared-memory limit (4, 16, 3153, 64);
the fp32 row tiles at ViT-L/14's vision shape at batch 4 (phase 14c's) both
ways and MITH's 128-bit concept tokens (100, 8, 128, 64) backward. All run
on the head views of a packed projection, timed with ``chip_smoke.cuda_ms``;
the last four shapes also time their plain versions (``... plain``).
Each run is a process of its own that imports ``cmh_torch`` from the tree
named; with ``--earlier DIR`` (an unpacked ``git archive`` of an earlier
commit, inside a git-ignored directory of this repository) the runs go
earlier, current, current, earlier, so that a change shows as a difference
beside the spread of two runs of one tree. Each tree's kernels are built
before the runs, both trees' ``nvcc`` processes at once; libraries already
built for this tree are copied into the earlier tree's build directory when
their content-hashed names match.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

# (direction, tower, batch, heads, S, masks, dtype, time the plain version too)
SHAPES = (("fwd", "vision", 256, 12, 50, False, "bf16", False),
          ("fwd", "text", 256, 8, 32, True, "bf16", False),
          ("bwd", "vision", 100, 12, 50, False, "bf16", False),
          ("bwd", "text", 100, 8, 32, True, "bf16", False),
          ("fwd", "ViT-B/16 vision", 256, 12, 197, False, "bf16", False),
          ("fwd", "ViT-L/14 vision", 100, 16, 257, False, "bf16", False),
          ("bwd", "ViT-L/14 vision", 100, 16, 257, False, "bf16", False),
          ("fwd", "ViT-L/14 vision", 4, 16, 257, False, "fp32", True),
          ("bwd", "ViT-L/14 vision", 4, 16, 257, False, "fp32", True),
          ("bwd", "MITH 128-bit concepts", 100, 8, 128, False, "fp32", True),
          ("fwd", "past the logit rows", 4, 16, 3153, False, "bf16", True))


def _times() -> dict:
    """ms of each shape through this process's ``cmh_torch``."""
    import torch

    from chip_smoke import cuda_ms
    from cmh_torch.ops.attention import (attention_bwd, attention_bwd_plain, attention_plain,
                                         fused_attention, kpm_bias)

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for which, tower, n, h, s, masks, dt, plain in SHAPES:
        packed = torch.randn(n, s, 4 * h * 64, generator=gen, device="cuda")
        packed = packed.bfloat16() if dt == "bf16" else packed
        q, k, v, do = (t.reshape(n, s, h, 64).transpose(1, 2)
                       for t in packed.split(h * 64, -1))
        mask = kpm = None
        if masks:
            mask = torch.full((s, s), float("-inf"), device="cuda").triu(1)
            kpm = torch.arange(s, device="cuda")[None] >= torch.randint(
                2, s + 1, (n, 1), generator=gen, device="cuda")
        bias = None if kpm is None else kpm_bias(kpm)
        if which == "fwd":
            fn = lambda: fused_attention(q, k, v, 0.125, mask, kpm)
            ref = lambda: attention_plain(q, k, v, 0.125, mask, bias)
        else:
            fn = lambda: attention_bwd(q, k, v, 0.125, mask, bias, do)
            ref = lambda: attention_bwd_plain(q, k, v, 0.125, mask, bias, do)
        name = f"{which} {tower} ({n},{h},{s},64) {dt}"
        out[name] = cuda_ms(fn)
        if plain:
            out[f"{name} plain"] = cuda_ms(ref, iters=10, warmup=2)
    return out


def _run(tree: str) -> dict:
    env = {**os.environ, "PYTHONPATH": tree}
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--child"], cwd=tree,
                         env=env, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"timing in {tree} failed:\n{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", help="an earlier checkout of the repository")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(_times()), flush=True)
        return 0
    from cmh_torch.ops import _build

    here = str(_build.BUILD_DIR.parents[1])
    order = [("current", here), ("current", here)]
    build = None
    if args.earlier:
        earlier = os.path.abspath(args.earlier)
        dst = os.path.join(earlier, "build", "cmh_torch")
        os.makedirs(dst, exist_ok=True)
        for lib in _build.BUILD_DIR.glob("*.so"):
            if not os.path.exists(os.path.join(dst, lib.name)):
                shutil.copy2(lib, dst)
        build = subprocess.Popen(
            [sys.executable, "-c", "from cmh_torch.ops import _build; "
             "_build.build_all(['attention', 'attention_tiled'])"],
            cwd=earlier, env={**os.environ, "PYTHONPATH": earlier})
        order = [("earlier", earlier), *order, ("earlier", earlier)]
    _build.build_all(["attention", "attention_tiled"])
    if build is not None and build.wait() != 0:
        raise RuntimeError(f"building the kernels of {args.earlier} failed")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[routes] {smi.strip()}", flush=True)
    runs = []
    for name, tree in order:
        runs.append((name, _run(tree)))
        print(f"[routes] {name}: {runs[-1][1]}", flush=True)
    for shape in runs[0][1]:
        by = {}
        for name, times in runs:
            by.setdefault(name, []).append(times[shape])
        print(f"[routes] {shape}: " + "; ".join(
            f"{name} {', '.join(f'{t:.5f}' for t in ts)} ms" for name, ts in by.items()),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
