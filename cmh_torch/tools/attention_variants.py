"""Time edited copies of ``csrc/attention.cu`` against it on the card.

    python -m cmh_torch.tools.attention_variants [name ...]

Each variant is the source with a few string edits (``VARIANTS``), built
with the package's nvcc flags into ``build/attention_variants/``, all at
once (``tools/_variants.py``). The bf16 forward and backward of each then
run through the package's wrappers at the main path's shapes (the head
views of a packed projection at batch 256 forward and 100 backward, vision
and text), with their device time from ``chip_smoke.cuda_ms`` and their
elements off the plain version. The ablations compute wrong results on
purpose: they show what each phase of the forward costs.
"""

from __future__ import annotations

import sys

from cmh_torch.tools import _variants

_LOGITS = ("  for (int k4 = 0; k4 < HD / 4; ++k4) {   // hd elements 4 k4 .. 4 k4 + 3\n"
           "    const uint2 a0")
_SOFTMAX = ("      softmax_rows<NT>(x, tile * 16 + g, s, b, mask, kpm, scale, t);\n"
            "    } else {",
            "      softmax_rows<NT, NT - 1>(x, tile * 16 + g, s, b, mask, kpm, scale, t);")
_PV = ("        mma_bf16(o[2 * nn], pa, vb[0], vb[1]);\n"
       "        mma_bf16(o[2 * nn + 1], pa, vb[2], vb[3]);")
_NO_LOGITS = [(_LOGITS, _LOGITS.replace("k4 < HD / 4", "k4 < 0"))]
_NO_SOFTMAX = [(_SOFTMAX[0], "    } else {"), (_SOFTMAX[1], "")]
_NO_PV = [(_PV, "        o[2 * nn][0] += __uint_as_float(vb[0] ^ pa[0]);")]

VARIANTS = {
    "base": [],
    "no-logits": _NO_LOGITS,            # forward without QK^T
    "no-softmax": _NO_SOFTMAX,          # forward without the softmax
    "no-pv": _NO_PV,                    # forward without P V
    "load-store": _NO_LOGITS + _NO_SOFTMAX + _NO_PV,
}


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    import cmh_torch.ops.attention as A

    if not torch.cuda.is_available():
        print("attention_variants: no CUDA device", file=sys.stderr)
        return 2
    names = (argv if argv is not None else sys.argv[1:]) or list(VARIANTS)
    libs = _variants.build(_variants.source("attention"), VARIANTS, names,
                           "attention_variants")
    print(cs.smi_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for tower, h, s in (("vision", 12, 50), ("text", 8, cs.MAX_WORDS)):
        for n, bwd in ((cs.B, False), (cs.TRAIN_B, True)):
            q, k, v = cs.head_views(torch, gen, n, h, s, 3)
            (do,) = cs.head_views(torch, gen, n, h, s, 1)
            mask = bias = None
            if tower == "text":
                mask, _, bias, _ = cs.text_masks(torch, gen, n, s)
            cases.append((f"{tower}-{'bwd' if bwd else 'fwd'}", bwd, (q, k, v, 64**-0.5, mask, bias), do))

    off = _variants.bf16_off
    for name, so in libs.items():
        with _variants.swapped(so):
            row = {}
            for case, bwd, args, do in cases:
                if bwd:
                    got = A._launch_bwd(*args, do)
                    want = A.attention_bwd_plain(*args, do)
                    ms = cs.cuda_ms(lambda: A._launch_bwd(*args, do))
                    row[case] = (round(ms, 5), [off(a, b) for a, b in zip(got, want)])
                else:
                    got, want = A._launch(*args), A.attention_plain(*args)
                    ms = cs.cuda_ms(lambda: A._launch(*args))
                    row[case] = (round(ms, 5), off(got, want))
            print(name, row, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
