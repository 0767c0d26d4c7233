"""Time ``csrc/threefry.cu`` and edited or earlier copies of it on the card.

    python -m cmh_torch.tools.threefry_variants [--sass] [name ...]
    python -m cmh_torch.tools.threefry_variants --earlier DIR [--sass]

Each variant is the source with a few string edits (``variants()``), built
with the package's nvcc flags into ``build/threefry_variants/``, all at once
(``tools/_variants.py``): ``imad-wide`` takes each rotation from one
``IMAD.WIDE.U32`` on the FMA pipe instead of a funnel shift on the ALU pipe;
``add-injections`` and ``fma-injections`` put both words' key injections on
one pipe; ``exact-division`` builds the source as it is and makes the
wrapper divide with ``__fdiv_rn`` everywhere; ``streaming``,
``one-compare``, ``fp32-8``, ``threads-*`` and ``grid-*`` change the fp32
loads and stores, the keep test, the elements a thread, the block and the
grid. The ablations ``no-guard``, ``no-division`` and ``no-load`` compute
wrong results on purpose: they show what the division's range test, the
division and the loads of x cost. Each then runs at ``chip_smoke.py``'s
phase 18 shapes (``SHAPES``): ``threefry_bits`` at 2^26 words, and
``dropout_fwd`` at UMoED's largest mask (100, 64, 2048) and a hash head's
(100, 256) in fp32 and bf16 and at rank 1's heads of UMoED's attention
probabilities at tp=2 (100, 4, 64, 82), each with its device time from
``chip_smoke.cuda_ms`` and whether it equals the plain version.

``--earlier DIR`` takes ``DIR/cmh_torch/csrc/threefry.cu`` from an earlier
checkout (an unpacked ``git archive``, in a git-ignored directory of this
repository; the one-element-a-thread source is ``git archive 2ac4db6``'s),
calls it through its own C signature (64-bit counters, the part map's
(inner, part, whole, start)) and times it against the current source in the
order earlier, current, current, earlier.

``--sass`` disassembles each library it built (``cuobjdump -sass``) and
counts each kernel's instructions by the pipe they issue to on sm_90: the
ALU pipe (integer adds, logic, shifts, compares and selects), the FMA pipe
(``IMAD`` in all its forms and the fp32 arithmetic) and the rest (memory,
branches, conversions, uniform-datapath and special-function instructions).
ptxas unrolls a thread's elements, and the head and the tail loop each hold
one more copy, so a kernel's counts cover that many threefry calls (6 in
``threefry_bits_kernel``, 6 in the fp32 and 10 in the bf16
``dropout_kernel``).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

from cmh_torch.tools import _variants

BITS_N = 1 << 26
# (what, shape, dtype, part)
SHAPES = (("UMoED drop_ff", (100, 64, 2048), "float32", None),
          ("UMoED drop_ff", (100, 64, 2048), "bfloat16", None),
          ("hash head", (100, 256), "float32", None),
          ("hash head", (100, 256), "bfloat16", None),
          ("UMoED attention, tp=2 rank 1", (100, 4, 64, 82), "bfloat16", (1, 4, 8)))

_WIDE = """
#pragma unroll
  for (int s = 0; s < 5; ++s) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      const uint64_t p = static_cast<uint64_t>(x1) * k.rot[(s & 1) * 4 + r];
      x1 = (static_cast<uint32_t>(p) | static_cast<uint32_t>(p >> 32)) ^ x0;
    }
    x0 += k.inj0[s];
    x1 += k.inj1[s];
  }
  return x0 ^ x1;
"""
_FIRST = "  uint32_t x0 = k.x0, x1 = k.x1 + j;\n"
_CAP = "  const uint32_t cap = 132 * 16;"
_GUARD = "      slow |= !fast(a[e], d);\n"
_DIVIDE = "      for (int e = 0; e < V; ++e) a[e] = fast_quotient(a[e], d);\n"
_LOAD = "    Vec<T>::load(x + j, a);\n"
_THREADS = "constexpr int kThreads = 256;"
_VEC4 = """  static constexpr int kN = 4;
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  }
  __device__ static void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }"""
_VEC8 = """  static constexpr int kN = 8;
  __device__ static void load(const float* p, float (&v)[8]) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    const float4 z = *reinterpret_cast<const float4*>(p + 4);
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
    v[4] = z.x; v[5] = z.y; v[6] = z.z; v[7] = z.w;
  }
  __device__ static void store(float* p, const float (&v)[8]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }"""
_INJ = "    k.inj1[s] = ks[(s + 2) % 3] + static_cast<uint32_t>(s + 1);\n  }\n"


def _injections(x0, x1):
    """x0's and x1's key injections as plain adds (``add``, which ptxas may
    fold into the next round's add) or as IMADs (``fma``)."""
    edits = []
    for s in range(5):
        old = (f"  add_on_fma(x0, k.inj0[{s}], k.one); x1 += k.inj1[{s}];\n")
        new = "".join(f"  {w} += k.inj{i}[{s}];" if how == "add" else
                      f"  add_on_fma({w}, k.inj{i}[{s}], k.one);"
                      for i, (w, how) in enumerate((("x0", x0), ("x1", x1)))) + "\n"
        edits.append((old, new))
    return edits


def variants() -> dict:
    """{name: edits}."""
    return {
        "base": [],
        # each rotation as one IMAD.WIDE.U32 by 2^r (FMA pipe), the multiplier
        # a kernel argument so that ptxas keeps the multiply; its halves' OR
        # and the xor one LOP3 (the rounds below the return are dead code)
        "imad-wide": [("  uint32_t one;\n};", "  uint32_t one;\n  uint32_t rot[8];\n};"),
                      (_INJ, _INJ + "  const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};\n"
                       "  for (int r = 0; r < 8; ++r) k.rot[r] = 1u << rot[r];\n"),
                      (_FIRST, _FIRST + _WIDE)],
        "exact-division": [],
        # the grid-stride loop's cap: 8 or 32 blocks of 256 an SM (default 16)
        "grid-8": [(_CAP, _CAP.replace("16", "8"))],
        "grid-32": [(_CAP, _CAP.replace("16", "32"))],
        # ablations, wrong on purpose: no range test for the reciprocal path;
        # no division at all; no loads of x (the loop's elements all 1)
        "no-guard": [(_GUARD, "")],
        "no-division": [(_GUARD, ""), (_DIVIDE, "")],
        "no-load": [(_LOAD, "#pragma unroll\n    for (int e = 0; e < V; ++e) a[e] = 1.0f;\n")],
        # the key injections: both as plain adds (ptxas folds x0's into an
        # IADD3, ALU pipe), or both as IMADs (FMA pipe; default x0's alone)
        "add-injections": _injections("add", "add"),
        "fma-injections": _injections("fma", "fma"),
        # fp32 loads and stores that stream past the caches (__ldcs, __stcs)
        "streaming": [("    const float4 w = *reinterpret_cast<const float4*>(p);\n    v[0]",
                       "    const float4 w = __ldcs(reinterpret_cast<const float4*>(p));\n    v[0]"),
                      ("    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);",
                       "    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));")],
        # the keep test as one compare of the bits (wrong only at keep_prob 1)
        "one-compare": [("a[e] = (bits[e] >> 9) < d.below ? a[e] : 0.0f;",
                         "a[e] = bits[e] < (d.below << 9) ? a[e] : 0.0f;")],
        # 8 fp32 elements a thread (two 16-byte words; default 4)
        "fp32-8": [(_VEC4, _VEC8)],
        # blocks of 128 or 512 threads (default 256)
        "threads-128": [(_THREADS, _THREADS.replace("256", "128"))],
        "threads-512": [(_THREADS, _THREADS.replace("256", "512"))],
    }


# the wrapper's settings a variant changes
SETTINGS = {"exact-division": {"_fast_division": lambda *_: False}}

# VIADD (sm_90's add of an immediate) is left under "other": which pipe it
# issues to is not documented
ALU = {"IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "ISETP", "FSETP", "SEL", "FSEL",
       "LEA", "IABS", "IMNMX", "FMNMX", "PLOP3", "FLO", "POPC", "BMSK", "SGXT"}
FMA = {"IMAD", "FFMA", "FMUL", "FADD", "HFMA2", "HMUL2", "HADD2"}


def count_sass(text: str) -> dict:
    """{kernel: {"alu": n, "fma": n, "other": n, opcode: n, ...}} of
    ``cuobjdump -sass`` output; IMAD keeps its first modifier (IMAD.WIDE,
    IMAD.IADD, ...), other opcodes none."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m[1]
            out[name] = {"alu": 0, "fma": 0, "other": 0}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name and m and m[1] != "NOP":
            op = m[1]
            base = op.split(".")[0]
            pipe = "alu" if base in ALU else "fma" if base in FMA else "other"
            out[name][pipe] += 1
            key = ".".join(op.split(".")[:2]) if base == "IMAD" else base
            out[name][key] = out[name].get(key, 0) + 1
    return out


def sass_counts(so: Path) -> dict:
    """``count_sass`` of a built library."""
    from cmh_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    return count_sass(subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True,
                                     text=True, check=True).stdout)


def _old_argtypes(lib):
    u32, u64, i64, i, p, f = (ctypes.c_uint32, ctypes.c_uint64, ctypes.c_int64, ctypes.c_int,
                              ctypes.c_void_p, ctypes.c_float)
    lib.cmh_threefry_bits.argtypes = [u32, u32, u64, i64, p, p]
    lib.cmh_dropout_fwd.argtypes = [u32, u32, p, p, i64, f, f, i64, i64, i64, i64, i, p]
    return lib


def _cases(torch, R, prng):
    gen = torch.Generator(device="cuda").manual_seed(0)
    key = prng.PRNGKey(1814)
    cases = []
    for what, shape, dt, part in SHAPES:
        x = torch.randn(shape, generator=gen, device="cuda").to(getattr(torch, dt))
        full = x
        if part:   # x as its part of a whole array
            dim, start, whole = part
            full = torch.zeros((*shape[:dim], whole, *shape[dim + 1:]), dtype=x.dtype,
                               device="cuda")
            full.narrow(dim, start, shape[dim]).copy_(x)
        want = R.dropout_plain(full, key, 0.3)
        if part:
            want = want.narrow(dim, start, shape[dim])
        cases.append((f"dropout_fwd {what} {list(shape)} {dt}", x, part, want))
    return key, cases


def _timings(torch, cs, R, prng, key, cases, earlier_lib=None) -> dict:
    """ms (and whether it equals the plain version) of each shape, through
    the current wrapper or, with ``earlier_lib``, the earlier C signature."""
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty(BITS_N, dtype=torch.int32, device="cuda")
    want_bits = (prng.random_bits(key, (1 << 20,), device="cuda") & prng.MASK).to(torch.int32)
    if earlier_lib is None:
        lib = R._lib()
        bits = lambda: lib.cmh_threefry_bits(key[0], key[1], 0, 0, out.data_ptr(), BITS_N, stream)
    else:
        lib = earlier_lib
        bits = lambda: lib.cmh_threefry_bits(key[0], key[1], 0, BITS_N, out.data_ptr(), stream)
    bits()
    row = {f"threefry_bits [{BITS_N}]": (round(cs.cuda_ms(bits, iters=20), 5),
                                         "equal" if torch.equal(out[:1 << 20], want_bits)
                                         else "differs")}
    for name, x, part, want in cases:
        if earlier_lib is None:
            fn = lambda: R._launch(R.dropout, x, key, 0.3, part)
        else:
            y = torch.empty_like(x)
            threshold, scale = R._scale(0.3, x.dtype)
            inner, size, whole, start = R._part(x.shape, part)
            args = (key[0], key[1], x.data_ptr(), y.data_ptr(), x.numel(), threshold,
                    scale.float().item(), inner, size, whole, start,
                    R._DTYPES[x.dtype], stream)
            fn = lambda: (lib.cmh_dropout_fwd(*args), y)[1]
        got = fn()
        row[name] = (round(cs.cuda_ms(fn), 5), "equal" if torch.equal(got, want) else "differs")
    return row


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from cmh_torch.ops import random as R
    from cmh_torch.utils import prng

    ap = argparse.ArgumentParser(prog="python -m cmh_torch.tools.threefry_variants")
    ap.add_argument("--earlier", type=Path, help="an earlier checkout (unpacked git archive)")
    ap.add_argument("--sass", action="store_true", help="count each kernel's SASS by pipe")
    ap.add_argument("names", nargs="*")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("threefry_variants: no CUDA device", file=sys.stderr)
        return 2
    text = _variants.source("threefry")
    if args.earlier:
        old = (args.earlier / "cmh_torch" / "csrc" / "threefry.cu").read_text()
        libs = _variants.build(old, {"earlier": []}, ["earlier"], "threefry_variants_earlier")
        libs.update(_variants.build(text, variants(), ["base"], "threefry_variants"))
        order = [("earlier", libs["earlier"]), ("base", libs["base"]), ("base", libs["base"]),
                 ("earlier", libs["earlier"])]
    else:
        table = variants()
        libs = _variants.build(text, table, args.names or list(table), "threefry_variants")
        order = list(libs.items())
    print(cs.smi_line(), flush=True)
    if args.sass:
        for name, so in libs.items():
            for kernel, counts in sass_counts(so).items():
                print(f"[sass] {name} {kernel}: {counts}", flush=True)
    key, cases = _cases(torch, R, prng)
    for name, so in order:
        saved = {k: getattr(R, k) for k in SETTINGS.get(name, {})}
        try:
            for k, v in SETTINGS.get(name, {}).items():
                setattr(R, k, v)
            with _variants.swapped(so) as lib:
                earlier = _old_argtypes(lib) if name == "earlier" else None
                print(name, _timings(torch, cs, R, prng, key, cases, earlier), flush=True)
        finally:
            for k, v in saved.items():
                setattr(R, k, v)
    return 0


if __name__ == "__main__":
    sys.exit(main())
