"""Time edited copies of ``csrc/layernorm.cu`` against it on the card.

    python -m cmh_torch.tools.layernorm_variants [name ...]
    python -m cmh_torch.tools.layernorm_variants --earlier FILE [name ...]

Each variant is the source with a few string edits (``VARIANTS``), built
with the package's nvcc flags into ``build/layernorm_variants/``, all at
once (``tools/_variants.py``). K1-fwd and K1-bwd of each then run through
the package's wrappers in bf16 at the main path's four LayerNorm shapes
(the image and text towers at the serving batch 256 and the training batch
100), with their device time from ``chip_smoke.cuda_ms``, their time with a
cold L2 (``chip_smoke.cold_ms``) and their elements off the plain version.
The ablations compute wrong results on purpose: they show what each part
of a kernel costs.

``--earlier FILE`` times ``EARLIER_VARIANTS`` on the earlier two-kernel
source (one row per warp, gamma and beta read per element, a separate
``layernorm_bwd_reduce``; ``csrc/layernorm.cu`` in the git history before
the persistent design), with its C entry points edited to the current
wrapper's arguments and its grid to its own wrapper's choice.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from cmh_torch.tools import _variants

SHAPES = ((256 * 50, 768), (256 * 32, 512), (100 * 50, 768), (100 * 32, 512))

_FWD_OUT = "        for (int e = 0; e < V; ++e) v[e] = (v[e] - mu) * inv * g[i][e] + b[i][e];\n"
_FWD_STATS = ("    warp_sum2(s, ss);\n    const float mu = s / d;\n"
              "    const float var = fmaxf(ss / d - mu * mu, 0.f);\n"
              "    const float inv = rsqrtf(var + 1e-5f);\n\n    uint4* yr")
_BWD_STATS = _FWD_STATS.replace("uint4* yr", "float s1")
_PARAM = "      if (j < nvec) f = *reinterpret_cast<const float4*>(src + j * V + k);"
_ACC = "          ag[i][e] += dv[e] * xh;\n          ab[i][e] += dv[e];\n"
_DX = "          xv[e] = inv * (dy - m1 - xh * m2);"
_PARTIALS = "  // the block's partial row: dgamma, then dbeta"


def _const(name, value):
    old = f"constexpr int {name} = "
    return (old, f"constexpr int {name} = {value};  //")


VARIANTS = {
    "base": [],
    # gamma and beta constants instead of their loads
    "const-gb": [(_PARAM, "      f = make_float4(1.25f, 0.5f, 1.25f, 0.5f);")],
    # forward: y = x; backward: dx = x + dO, no statistics and no dgamma/dbeta
    "load-store": [(_FWD_OUT, ""), (_FWD_STATS, "    uint4* yr"),
                   (_BWD_STATS, "    const float mu = 0.f, inv = 1.f;\n    float s1"),
                   ("    warp_sum2(s1, s2);\n", ""), (_ACC, ""),
                   (_DX, "          xv[e] += dv[e];"),
                   (_PARTIALS, "  return;\n" + _PARTIALS)],
    # backward: the row pass and the block partials, no barrier and no final sum
    "no-final": [("  grid_barrier(sync, nb);", "  return;")],
    # backward: the row pass alone (dx; no dgamma/dbeta)
    "no-dgb": [(_PARTIALS, "  return;\n" + _PARTIALS)],
    # forward: no row in flight (each row's loads issued when it is reduced)
    "no-prefetch": [("    if (row + stride < rows) load_row(nxt, x + (row + stride) * d, lane, nvec);",
                     "    load_row(cur, x + row * d, lane, nvec);"),
                    ("      cur[i] = nxt[i];\n", "")],
    # launch geometry: warps a block and resident blocks an SM
    "fwd-4x6": [_const("kFwdMinBlocks", 6)],
    "fwd-8x2": [_const("kFwdWarps", 8), _const("kFwdMinBlocks", 2)],
    "bwd-4x3": [_const("kBwdWarps", 4), _const("kBwdMinBlocks", 3)],
    "bwd-4x2": [_const("kBwdWarps", 4), _const("kBwdMinBlocks", 2)],
}

_ABI = [
    ("void* y, int rows, int d, int dtype, int device,",
     "void* y, int rows, int d, int, int dtype, int device,"),
    ("void* dx, void* part_g, void* part_b, void* dgamma,",
     "void* dx, void* part_g, void*, void* dgamma,"),
    ("  float* pb = static_cast<float*>(part_b);",
     "  const int most = (rows + 7) / 8;   // its wrapper's grid: min(256, rows / 8)\n"
     "  blocks = blocks < 256 ? blocks : 256;\n"
     "  blocks = blocks < most ? blocks : most;\n"
     "  blocks = blocks > 1 ? blocks : 1;\n"
     "  float* pb = pg + (size_t)blocks * d;"),
    ('extern "C" {\n', 'extern "C" {\n\nint cmh_layernorm_blocks_per_sm(int) { return 2; }\n'
                       'int cmh_layernorm_warps_per_block(int) { return 8; }\n'),
]
_E_FWD_OUT = "        o[e] = (v[i][e] - mu) * inv * gamma[c] + beta[c];"
_E_FWD_SHFL = ("\n    s += __shfl_xor_sync(0xffffffffu, s, o);\n"
               "    ss += __shfl_xor_sync(0xffffffffu, ss, o);\n")
_E_BWD_SHFL = _E_FWD_SHFL.replace("\n    ", "\n      ")
_E_BWD_SHFL2 = ("\n      s1 += __shfl_xor_sync(0xffffffffu, s1, o);\n"
                "      s2 += __shfl_xor_sync(0xffffffffu, s2, o);\n")
_E_DY = "          const float dy = dv[i][e] * gamma[j * V + e];\n"
_E_ACC = "          ag[i][e] += dv[i][e] * xh;\n          ab[i][e] += dv[i][e];\n"
_E_REDUCE = ("  layernorm_bwd_reduce<<<(d + 255) / 256, 256, 0, st>>>(part_g, part_b, dgamma,\n"
             "                                                       dbeta, blocks, d);\n")
_E_PARTIALS = "  // the block's partial sums: warps add in a fixed order\n"

EARLIER_VARIANTS = {
    "base": _ABI,
    "const-gb": _ABI + [
        (_E_FWD_OUT, "        o[e] = (v[i][e] - mu) * inv * 1.25f + 0.5f;"),
        (_E_DY + "          ag", "          const float dy = dv[i][e] * 1.25f;\n          ag"),
        (_E_DY + "          o[e]", "          const float dy = dv[i][e] * 1.25f;\n          o[e]")],
    "load-store": _ABI + [
        (_E_FWD_OUT, "        o[e] = v[i][e];"), (_E_FWD_SHFL, "\n"),
        (_E_BWD_SHFL, "\n"), (_E_BWD_SHFL2, "\n"), (_E_ACC, ""),
        ("          const float xh = (xv[i][e] - mu) * inv;", "          const float xh = xv[i][e];"),
        ("          o[e] = inv * (dy - m1 - xv[i][e] * m2);", "          o[e] = xv[i][e] + dv[i][e];"),
        (_E_PARTIALS, "  return;\n" + _E_PARTIALS), (_E_REDUCE, "")],
    "no-reduce": _ABI + [(_E_REDUCE, "")],
    "row-pass-only": _ABI + [(_E_PARTIALS, "  return;\n" + _E_PARTIALS), (_E_REDUCE, "")],
}


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    import cmh_torch.ops.layernorm as L
    from cmh_torch.ops import _build

    ap = argparse.ArgumentParser(prog="python -m cmh_torch.tools.layernorm_variants")
    ap.add_argument("--earlier", type=Path, help="the earlier two-kernel layernorm.cu")
    ap.add_argument("names", nargs="*")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("layernorm_variants: no CUDA device", file=sys.stderr)
        return 2
    if args.earlier:
        table, text, dirname = EARLIER_VARIANTS, args.earlier.read_text(), "layernorm_variants_earlier"
    else:
        table, dirname = VARIANTS, "layernorm_variants"
        text = (_build.CSRC / "layernorm.cu").read_text()
    libs = _variants.build(text, table, args.names or list(table), dirname)
    print(cs.smi_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for n, d in SHAPES:
        x = torch.randn(n, d, generator=gen, device="cuda").mul_(3).add_(1).bfloat16()
        do = torch.randn(n, d, generator=gen, device="cuda").bfloat16()
        g, b = (torch.randn(d, generator=gen, device="cuda") for _ in range(2))
        cases.append((f"({n},{d})", x, g, b, do, L.layernorm_plain(x, g, b),
                      L.layernorm_bwd_plain(x, g, do)))

    for name, so in libs.items():
        with _variants.swapped(so):
            row = {}
            for shape, x, g, b, do, want, want_b in cases:
                got = L._launch(x, g, b)
                row[f"fwd {shape}"] = (round(cs.cuda_ms(lambda: L._launch(x, g, b)), 5),
                                       round(cs.cold_ms(L._launch, (x, g, b)), 5),
                                       _variants.bf16_off(got, want))
                got = L._launch_bwd(x, g, do)
                err = max((a - w).abs().max().item() for a, w in zip(got[1:], want_b[1:]))
                row[f"bwd {shape}"] = (round(cs.cuda_ms(lambda: L._launch_bwd(x, g, do)), 5),
                                       round(cs.cold_ms(L._launch_bwd, (x, g, do)), 5),
                                       _variants.bf16_off(got[0], want_b[0]), f"{err:.2e}")
            print(name, row, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
