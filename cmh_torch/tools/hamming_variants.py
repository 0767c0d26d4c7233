"""Time edited copies of ``csrc/hamming.cu`` against it on the card.

    python -m cmh_torch.tools.hamming_variants [name ...]
    python -m cmh_torch.tools.hamming_variants --earlier FILE

Each variant is the source with a few string edits (``variants()``), built
with the package's nvcc flags into ``build/hamming_variants/``, all at once
(``tools/_variants.py``), and some also change a setting of the wrapper
(``SETTINGS``). K4 then runs through the package's wrapper at
``chip_smoke.py``'s four K4 shapes (``SHAPES``), with its device time from
``chip_smoke.cuda_ms``, its time with a cold L2 (``chip_smoke.cold_ms``) and
whether it equals the plain version; and a serving search of 4 queries
over 2^20 + 4,096 items (``serving.topk_blocked``: K4 on both gallery
blocks, the int64 keys and the ``torch.topk`` merge that reads K4's output
back) with its device time. A first line times ``Tensor.fill_`` writing each
output's bytes, a floor for the kernel's stores. The ablations compute wrong
results on purpose: they show what each part of the kernel costs.

``--earlier FILE`` builds an earlier ``hamming.cu`` (one thread for each
(query, gallery row), one byte store each; ``git show
45c2f87:cmh_torch/csrc/hamming.cu``) with its C entry point edited to the
current wrapper's arguments, and times it against the current source in
the order earlier, current, current, earlier.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from cmh_torch.tools import _variants

# (queries, gallery rows, bits): chip_smoke.check_hamming's shapes
SHAPES = ((64, (1 << 20) + 777, 16), (64, (1 << 20) + 777, 64), (4, 1 << 20, 16),
          (64, 1 << 18, 1024))

_KEEP = "  const uint4 c = realign(shfl4(d, (lane + 31) & 31), d, s);\n  if (valid <= 0) return;\n"
_POPC_REG = "acc[r / PER] += __popc(qw ^ gr[r][k]) << (8 * (r % PER));"
_POPC_ANY = "acc[j][r / PER] += __popc(qw ^ gk[r]) << (8 * (r % PER));"
_BYTES = ("  if (valid <= 0) return;\n"
          "  {\n"
          "    const uint32_t v[4] = {d.x, d.y, d.z, d.w};\n"
          "#pragma unroll\n"
          "    for (int j = 0; j < 16; ++j)\n"
          "      if (16 * lane + j < valid) p[16 * lane + j] = static_cast<uint8_t>(v[j >> 2] >> (8 * (j & 3)));\n"
          "    return;\n"
          "  }\n"
          "  const uint4 c = d;\n")
_SMEM = ("  __shared__ __align__(16) uint8_t staged[kThreads / 32][512];\n"
         "  uint8_t* sb = staged[threadIdx.x >> 5];\n"
         "  const uint32_t v[4] = {d.x, d.y, d.z, d.w};\n"
         "#pragma unroll\n"
         "  for (int j = 0; j < 16; ++j)\n"
         "    sb[(s + 16 * lane + j) & 511] = static_cast<uint8_t>(v[j >> 2] >> (8 * (j & 3)));\n"
         "  __syncwarp();\n"
         "  const uint4 c = reinterpret_cast<const uint4*>(sb)[lane];\n"
         "  __syncwarp();\n"
         "  if (valid <= 0) return;\n")
_PICK = "Config pick(int out_u8, int w, int tile_q) {\n"
_THREADS = "constexpr int kThreads = 128;"
_PICK_U8 = "  if (out_u8) {\n    if (w == 1) return config<uint8_t, 1>(w, tile_q);\n"
_IMAD = ('asm("mad.lo.u32 %0, %1, %2, %0;" : "+r"(acc[r / PER]) '
         ': "r"(__popc(qw ^ gr[r][k])), "r"(1u << (8 * (r % PER))));')


def variants() -> dict:
    """{name: edits} (the tensor-core variant reads its kernel from
    ``tools/hamming_mma.cu``)."""
    mma = (Path(__file__).with_name("hamming_mma.cu").read_text() + "\n")
    return {
        "base": [],
        # uint8 over one or two words on mma.sync, the output staged in shared
        # memory (tools/hamming_mma.cu)
        "tensor-cores": [(_PICK, mma + _PICK),
                         (_PICK_U8, _PICK_U8.replace("  if (out_u8) {\n", "  if (out_u8) {\n"
                                                     "    if (w == 1) return mma_config<1>(tile_q);\n"
                                                     "    if (w == 2) return mma_config<2>(tile_q);\n"))],
        # the distances and no stores (a test the compiler cannot decide keeps them)
        "popc-only": [(_KEEP, "  if (valid <= 0 || (d.x ^ d.y ^ d.z ^ d.w) != valid * 0x9E3779B9u) return;\n"
                              "  const uint4 c = d;\n")],
        # the stores of XORs: no popcounts
        "stores-only": [(_POPC_REG, _POPC_REG.replace("__popc", "")),
                        (_POPC_ANY, _POPC_ANY.replace("__popc", ""))],
        "byte-stores": [(_KEEP, _BYTES)],                       # 16 one-byte stores a lane
        "realign-smem": [(_KEEP, _SMEM)],                       # shift through shared memory
        "default-stores": [("    __stcs(reinterpret_cast<uint4*>(base + 16 * lane), c);   // evict-first",
                            "    *reinterpret_cast<uint4*>(base + 16 * lane) = c;")],
        "imad-sums": [(_POPC_REG, _IMAD)],                      # the sums as mad.lo (FMA pipe)
        # every span stored as if its row were aligned (to the wrong bytes):
        # no shuffle, no shift, no partial chunks at the ends
        "no-realign": [("  const int s = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);\n"
                        "  uint8_t* base = p - s;                       // chunk 0, 16-byte aligned\n"
                        "  const uint4 c = realign(shfl4(d, (lane + 31) & 31), d, s);\n",
                        "  const int s = 0;\n"
                        "  uint8_t* base = reinterpret_cast<uint8_t*>(reinterpret_cast<uintptr_t>(p) & ~uintptr_t(15));\n"
                        "  const uint4 c = d;\n")],
        # realigned, but the partial chunks at the spans' ends are not written
        "no-partials": [("  if (head || tail) {", "  if (valid < 0 && (head || tail)) {")],
        # 2 or 8 warps a block (default 4)
        "threads-64": [(_THREADS, _THREADS.replace("128", "64"))],
        "threads-256": [(_THREADS, _THREADS.replace("128", "256"))],
        # queries split until the grid fills this many resident waves (default 1)
        "waves-0.5": [], "waves-2": [],
    }


SETTINGS = {"waves-0.5": {"_WAVES": 0.5}, "waves-2": {"_WAVES": 2}}

EARLIER_VARIANTS = {
    "base": [("int out_u8, int device, void* stream) {",
              "int out_u8, int, int device, void* stream) {"),
             # its own grid ignores the query tile; any geometry will do
             ('extern "C" {\n', 'extern "C" {\n\nvoid cmh_hamming_geometry(int, int, int, int, int* geo) '
                                 '{ geo[0] = 256; geo[1] = 8; }\n')],
}


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    import cmh_torch.ops.hamming as H
    from cmh_torch.ops import _build
    from cmh_torch.ops.hashing import pack_bits
    from cmh_torch.serving import _DEVICE_BLOCK, topk_blocked

    ap = argparse.ArgumentParser(prog="python -m cmh_torch.tools.hamming_variants")
    ap.add_argument("--earlier", type=Path, help="an earlier hamming.cu")
    ap.add_argument("names", nargs="*")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hamming_variants: no CUDA device", file=sys.stderr)
        return 2
    current = (_build.CSRC / "hamming.cu").read_text()
    if args.earlier:
        old = _variants.build(args.earlier.read_text(), EARLIER_VARIANTS, ["base"],
                              "hamming_variants_earlier")["base"]
        new = _variants.build(current, variants(), ["base"], "hamming_variants")["base"]
        order = [("earlier", old), ("base", new), ("base", new), ("earlier", old)]
    else:
        table = variants()
        libs = _variants.build(current, table, args.names or list(table), "hamming_variants")
        order = list(libs.items())
    print(cs.smi_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def packed(n, bits):
        return pack_bits(torch.randint(0, 2, (n, bits), generator=gen, device="cuda").float() * 2 - 1)

    cases = []
    for nq, ng, bits in SHAPES:
        q, g = packed(nq, bits), packed(ng, bits)
        cases.append((f"Q={nq} N={ng} {bits}-bit", bits, q, g, H.hamming_plain(q, g, bits)))
        torch.cuda.synchronize()
    sq, sg = packed(4, 16), packed(_DEVICE_BLOCK + 4096, 16)
    # PyTorch writing each output's bytes: a floor for the kernel's stores
    fill = [torch.empty_like(want) for *_, want in cases]
    print("fill_", {shape: round(cs.cuda_ms(lambda: out.fill_(7)), 5)
                    for (shape, *_), out in zip(cases, fill)}, flush=True)
    del fill

    for name, so in order:
        saved = {k: getattr(H, k) for k in SETTINGS.get(name, {})}
        try:
            for k, v in SETTINGS.get(name, {}).items():
                setattr(H, k, v)
            with _variants.swapped(so):
                row = {}
                for shape, bits, q, g, want in cases:
                    got = H._launch(q, g, bits)
                    row[shape] = (round(cs.cuda_ms(lambda: H._launch(q, g, bits)), 5),
                                  round(cs.cold_ms(lambda a, b: H._launch(a, b, bits), (q, g)), 5),
                                  "equal" if torch.equal(got, want) else "differs")
                row[f"search Q=4 N={sg.shape[0]}"] = round(
                    cs.cuda_ms(lambda: topk_blocked(sq, sg, 10, _DEVICE_BLOCK, 16)), 5)
                print(name, row, flush=True)
        finally:
            for k, v in saved.items():
                setattr(H, k, v)
    return 0


if __name__ == "__main__":
    sys.exit(main())
