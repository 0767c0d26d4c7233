"""Time edited copies of ``csrc/attention_tiled.cu`` against it on the card.

    python -m cmh_torch.tools.attention_tiled_variants [name ...]

Each variant is the source (with ``attention_mma.cuh`` written in place)
plus a few string edits (``VARIANTS``), built with the package's nvcc flags
into ``build/attention_tiled_variants/``, all at once
(``tools/_variants.py``). The bf16 row-tiled forward runs at ViT-B/16's
(256, 12, 197, 64) and ViT-L/14's (100, 16, 257, 64) vision shapes and the
backward at ViT-L/14's, on the head views of a packed projection, through
the package's wrappers, with their device time from ``chip_smoke.cuda_ms``
and their elements off the plain version. The ablations compute wrong
results on purpose: they show what each phase of the forward and each
launch of the backward costs.
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
}

# (direction, what, batch, heads, S)
SHAPES = (("fwd", "ViT-B/16", 256, 12, 197), ("fwd", "ViT-L/14", 100, 16, 257),
          ("bwd", "ViT-L/14", 100, 16, 257))


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
    for which, what, n, h, s in SHAPES:
        q, k, v = cs.head_views(torch, gen, n, h, s, 3)
        (do,) = cs.head_views(torch, gen, n, h, s, 1)
        cases.append((f"{which} {what} ({n},{h},{s},64)", which == "bwd", (q, k, v, 0.125, None,
                                                                            None), do))
    off = _variants.bf16_off
    for name, so in libs.items():
        with _variants.swapped(so):
            row = {}
            for case, bwd, args, do in cases:
                if bwd:
                    got = A._launch_bwd(*args, do)
                    want = A.attention_bwd_plain(*args, do)
                    ms = cs.cuda_ms(lambda: A._launch_bwd(*args, do), iters=20, warmup=3)
                    row[case] = (round(ms, 5), [off(a, b) for a, b in zip(got, want)])
                else:
                    got, want = A._launch(*args), A.attention_plain(*args)
                    ms = cs.cuda_ms(lambda: A._launch(*args), iters=20, warmup=3)
                    row[case] = (round(ms, 5), off(got, want))
            print(name, row, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
