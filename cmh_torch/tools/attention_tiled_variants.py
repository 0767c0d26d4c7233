"""Time edited copies of ``csrc/attention_tiled.cu`` against it on the card.

    python -m cmh_torch.tools.attention_tiled_variants [name ...]

Each variant is the source (with ``attention_mma.cuh`` written in place)
plus a few string edits (``VARIANTS``), built with the package's nvcc flags
into ``build/attention_tiled_variants/``, all at once
(``tools/_variants.py``). Through the package's wrappers, on the head views
of a packed projection: the bf16 row-tiled forward at ViT-B/16's (256, 12,
197, 64) and ViT-L/14's (100, 16, 257, 64) vision shapes, at (4, 16, 3152,
64) with its logit rows in shared memory and, through ``_launch_rows``, in
device memory, and at (4, 16, 3153, 64), past the shared-memory limit; the
bf16 backward at ViT-L/14's; the fp32 (3xTF32) forward and backward at
(4, 16, 257, 64) and the backward at MITH's 128-bit (100, 8, 128, 64).
Each with its device time from ``chip_smoke.cuda_ms`` and, in bf16, its
elements off the plain version, in fp32 its largest error against it. The
ablations compute wrong results on purpose: they show what each phase of a
forward and each launch of a backward costs; "one-tf32" what the three-pass
split costs, "tf32-chain" what its per-step sums cost.
"""

from __future__ import annotations

import sys

from cmh_torch.tools import _variants

_WALK = "    if (active && k0 < cols)\n"
_SOFTMAX = "    for (int c = 32 * w + lane; c < cols; c += block_order ? 1024 : 32) {\n"
_QLOAD = "const float4 qn = *reinterpret_cast<const float4*>(qp + dn * 16);"
_KLOAD = "const float4 kn = *reinterpret_cast<const float4*>(kp + dn * kChunk);"
_UNROLL = "#pragma unroll 8\n  for (int d = 0; d < HD; ++d) {"
_TILES = "  for (int n = kFwdTiles; n >= 1; --n)\n"
_PV = ("          mma_bf16(o[2 * nn], pa, vb[0], vb[1]);\n"
       "          mma_bf16(o[2 * nn + 1], pa, vb[2], vb[3]);\n")


_MMA3 = ("  if (SWAP) {\n    mma_tf32(c, ah, bl[0], bl[1]);\n    mma_tf32(c, al, bh[0], bh[1]);\n"
         "  } else {\n    mma_tf32(c, al, bh[0], bh[1]);\n    mma_tf32(c, ah, bl[0], bl[1]);\n  }\n")
_FOLD = ("    float p[4] = {0.f, 0.f, 0.f, 0.f};\n    mma3<false>(p, xh, xl, bh, bl);\n"
         "#pragma unroll\n    for (int e = 0; e < 4; ++e) acc[nn][e] += p[e];\n")
_TF32_PV = "    acc_product_tf32<HD>(o, x[j], sv + 8 * j * LD, g, t);   // P V, P unnormalised\n"
_SPLIT = "  lo = tf32_rna(x - __uint_as_float(hi));\n"


def _skip_launch(kernel: str, params: str = "HD"):
    target = f"  {kernel}<{params}><<<grid"
    return [(target, f"  if (false) {kernel}<{params}><<<grid")]


VARIANTS = {
    "base": [],
    "no-walk": [(_WALK, _WALK.replace("active && ", "false && "))],   # forward without QK^T
    "no-softmax": [(_SOFTMAX, _SOFTMAX.replace("c < cols", "c < 0"))],
    "q-once": [(_QLOAD, _QLOAD.replace(" + dn * 16", ""))],    # the walk's Q reads hoisted
    "k-once": [(_KLOAD, _KLOAD.replace(" + dn * kChunk", ""))],  # ... its K reads
    "full-unroll": [(_UNROLL, _UNROLL.replace(" 8", ""))],   # the walk unrolled over all of hd
    "fwd-2-tiles": [(_TILES, _TILES.replace("kFwdTiles", "2"))],   # smaller forward blocks
    "fwd-1-tile": [(_TILES, _TILES.replace("kFwdTiles", "1"))],
    "no-pv": [(_PV, "          o[2 * nn][0] += __uint_as_float(vb[0] ^ pa[0]);\n")],
    "dkdv-4-blocks": [("__launch_bounds__(32 * kMmaWarps)\ntiled_bwd_dkdv_mma(",
                       "__launch_bounds__(32 * kMmaWarps, 4)\ntiled_bwd_dkdv_mma(")],
    "chunk-sums": [("const bool chunks = s > kChunkSumsS;", "const bool chunks = true;")],
    "no-stats": _skip_launch("tiled_bwd_stats_mma"),    # backward without launch 1
    "no-dkdv": _skip_launch("tiled_bwd_dkdv_mma", "HD, CHUNKS"),   # ... launch 2
    "no-dq": _skip_launch("tiled_bwd_dq_mma", "HD, CHUNKS"),       # ... launch 3
    # the bf16 forward's logit rows in device memory: tiles a block, blocks an SM
    "rows-4-tiles": [("constexpr int kRowsTiles = 2;", "constexpr int kRowsTiles = 4;")],
    "rows-1-block": [("constexpr int kRowsBlocksPerSm = 4;", "constexpr int kRowsBlocksPerSm = 1;")],
    "rows-2-blocks": [("constexpr int kRowsBlocksPerSm = 4;",
                       "constexpr int kRowsBlocksPerSm = 2;")],
    "one-tf32": [(_MMA3, "")],                 # fp32 products as one TF32 pass, a_hi b_hi
    "tf32-chain": [(_FOLD, "    mma3<false>(acc[nn], xh, xl, bh, bl);\n")],  # one mma chain
    # lo left to the mma's truncation, no cvt at all (a coarser split)
    "tf32-lo-unrounded": [(_SPLIT, "  lo = __float_as_uint(x - __uint_as_float(hi));\n")],
    "tf32-fwd-4-warps": [("constexpr int kTfFwdWarps = 8;", "constexpr int kTfFwdWarps = 4;")],
    "tf32-no-pv": [(_TF32_PV, "")],            # the fp32 forward without P V
    "tf32-no-stats": _skip_launch("tiled_bwd_stats_tf32"),
    "tf32-no-dkdv": _skip_launch("tiled_bwd_dkdv_tf32"),
    "tf32-no-dq": _skip_launch("tiled_bwd_dq_tf32"),
}

# (direction, what, batch, heads, S, dtype); "fwd-rows" is the bf16 forward
# with its logit rows in device memory at any S (``_launch_rows``)
SHAPES = (("fwd", "ViT-B/16", 256, 12, 197, "bf16"), ("fwd", "ViT-L/14", 100, 16, 257, "bf16"),
          ("fwd", "rows in shared memory", 4, 16, 3152, "bf16"),
          ("fwd-rows", "rows in device memory", 4, 16, 3152, "bf16"),
          ("fwd", "past the logit rows", 4, 16, 3153, "bf16"),
          ("bwd", "ViT-L/14", 100, 16, 257, "bf16"),
          ("fwd", "ViT-L/14", 4, 16, 257, "fp32"), ("bwd", "ViT-L/14", 4, 16, 257, "fp32"),
          ("bwd", "MITH 128-bit", 100, 8, 128, "fp32"))


def _fp32_off(got, want) -> str:
    """The largest error against the plain version, and whether it meets
    the fp32 check (1e-5 relative and absolute)."""
    err = (got - want).abs().max().item()
    ok = bool(((got - want).abs() <= 1e-5 + 1e-5 * want.abs()).all())
    return f"{err:.3g}{'' if ok else ' fails'}"


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    import cmh_torch.ops.attention as A

    if not torch.cuda.is_available():
        print("attention_tiled_variants: no CUDA device", file=sys.stderr)
        return 2
    names = (argv if argv is not None else sys.argv[1:]) or list(VARIANTS)
    libs = _variants.build(_variants.source("attention_tiled"), VARIANTS, names,
                           "attention_tiled_variants")
    print(cs.smi_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for which, what, n, h, s, dt in SHAPES:
        q, k, v = cs.head_views(torch, gen, n, h, s, 3)
        (do,) = cs.head_views(torch, gen, n, h, s, 1)
        if dt == "fp32":
            q, k, v, do = (t.float() for t in (q, k, v, do))
        args = (q, k, v, 0.125, None, None)
        if which == "bwd":
            fn, plain = lambda a=args, d=do: A._launch_bwd(*a, d), \
                lambda a=args, d=do: A.attention_bwd_plain(*a, d)
        else:
            fn = (lambda a=args: A._launch_rows(*a)) if which == "fwd-rows" else \
                (lambda a=args: A._launch(*a))
            plain = lambda a=args: (A.attention_plain(*a),)
        cases.append((f"{which} {what} ({n},{h},{s},64) {dt}", fn, plain,
                      _fp32_off if dt == "fp32" else _variants.bf16_off))
    for name, so in libs.items():
        with _variants.swapped(so):
            row = {}
            for case, fn, plain, off in cases:
                got = fn()
                got = got if isinstance(got, tuple) else (got,)
                offs = [off(a, b) for a, b in zip(got, plain())]
                ms = cs.cuda_ms(fn, iters=20, warmup=3)
                row[case] = (round(ms, 5), offs if len(offs) > 1 else offs[0])
            print(name, row, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
