// A variant of csrc/hamming.cu for cmh_torch/tools/hamming_variants.py
// ("tensor-cores"): uint8 output over one or two words on mma.sync, spliced
// in before `pick`, which sends those widths here. Measured and not kept: it
// is faster than the CUDA-core kernel at 64 bits and slower at 16 bits and at
// 4 queries (PERF.md).
//
// ---- Tensor-core path: uint8 output, W = WS in {1, 2} ----
// dist(q, n) = popc(q) + sum_i g_i (1 - 2 q_i) over the bits i: one
// mma.sync m16n8k32 s8 a word takes 16 gallery rows (A, bits as 0/1 bytes)
// against 8 queries (B, bits as +1/-1 bytes) with C seeded by popc(q), so
// D is the distance and no popcount runs per output. A block takes
// kMmaRows gallery rows (128 a warp, eight m-blocks of 16) against up to
// kMmaTileQ queries; it stages its bytes in shared memory, each query's row
// already shifted by that row's alignment s, then each warp stores whole
// rows of 512 bytes as 16-byte chunks.
constexpr int kMmaRows = 512;                  // gallery rows a block
constexpr int kMmaTileQ = kMaxTileQ;           // queries a block at most: 8 tiles of 8
constexpr int kObStride = 528;                 // a staged row: 512 bytes and the shift s
static_assert(kMmaRows == kThreads / 32 * 8 * 16, "eight m-blocks of 16 rows a warp");

// Bits `shift` .. `shift` + 3 of x as four bytes of 0 or 1.
__device__ __forceinline__ uint32_t nibble01(uint32_t x, int shift) {
  return (((x >> shift) & 0xFu) * 0x00204081u) & 0x01010101u;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp writes `valid` (<= 512) bytes of an output row that starts s
// bytes past the 16-byte-aligned `base`; `staged` holds the row shifted by
// s (its byte s + n is the row's byte n) and is 16-byte aligned.
__device__ __forceinline__ void store_staged(uint8_t* base, const uint8_t* staged, int s,
                                             int valid, int lane) {
  const int end = s + valid;
  if ((lane > 0 || s == 0) && end >= 16 * lane + 16)
    __stcs(reinterpret_cast<uint4*>(base + 16 * lane),
           *reinterpret_cast<const uint4*>(staged + 16 * lane));
  const bool head = s > 0 || end < 16;
  const int last = (end - 1) >> 4;
  const bool tail = last > 0 && (end & 15);
  const int j = lane & 15;                     // lanes 0-15: the head's bytes, 16-31: the tail's
  if (lane < 16 ? head && j >= s && j < end : tail && j < (end & 15)) {
    const int at = lane < 16 ? j : 16 * last + j;
    base[at] = staged[at];
  }
}

template <int WS>
__global__ void __launch_bounds__(kThreads)
hamming_mma_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ g,
                   uint8_t* __restrict__ out, int nq, int ng, int w, int tile_q) {
  extern __shared__ uint4 staged_rows[];
  uint8_t* ob = reinterpret_cast<uint8_t*>(staged_rows);   // (round_up(tile_q, 8), kObStride)
  uint32_t* sgal = reinterpret_cast<uint32_t*>(ob + (tile_q + 7) / 8 * 8 * kObStride);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;   // the mma fragments' groupID and thread in group
  const int q0 = blockIdx.y * tile_q, tq = min(tile_q, nq - q0);
  const long n0 = (long)blockIdx.x * kMmaRows;
  const int valid = static_cast<int>(min((long)kMmaRows, ng - n0));
  const uint32_t* gt = g + n0 * WS;            // the block's gallery rows, (kMmaRows, WS) words
  for (int i = threadIdx.x; i < valid * WS; i += kThreads) sgal[i] = gt[i];

  // B: query 8 nt + grp's bits 4 tig .. + 3 and 16 + 4 tig .. + 3 of each word
  // as +1 (0) or -1 (1); pc: popc of queries 8 nt + 2 tig and + 1, the
  // columns of this thread's sums; off: where their staged rows start
  uint32_t bq[8][WS][2];
  int pc[8][2], off[8][2];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (8 * nt >= tq) break;
    const int qb = 8 * nt + grp;
#pragma unroll
    for (int k = 0; k < WS; ++k) {
      const uint32_t x = qb < tq ? q[(long)(q0 + qb) * WS + k] : 0u;
      bq[nt][k][0] = nibble01(x, 4 * tig) * 0xFEu | 0x01010101u;
      bq[nt][k][1] = nibble01(x, 16 + 4 * tig) * 0xFEu | 0x01010101u;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int qc = min(8 * nt + 2 * tig + e, tq - 1);
      pc[nt][e] = 0;
#pragma unroll
      for (int k = 0; k < WS; ++k) pc[nt][e] += __popc(q[(long)(q0 + qc) * WS + k]);
      const uintptr_t p = reinterpret_cast<uintptr_t>(out + (long)(q0 + qc) * ng + n0);
      off[nt][e] = (8 * nt + 2 * tig + e) * kObStride + static_cast<int>(p & 15);
    }
  }

  __syncthreads();
  for (int mb = 8 * warp; mb < 8 * warp + 8; ++mb) {
    const int r = 16 * mb + grp;               // A rows r and r + 8 of the block
    uint32_t a[WS][4];
#pragma unroll
    for (int k = 0; k < WS; ++k) {             // rows past the gallery: junk, never stored
      const uint32_t x = sgal[r * WS + k], y = sgal[(r + 8) * WS + k];
      a[k][0] = nibble01(x, 4 * tig);
      a[k][1] = nibble01(y, 4 * tig);
      a[k][2] = nibble01(x, 16 + 4 * tig);
      a[k][3] = nibble01(y, 16 + 4 * tig);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (8 * nt >= tq) break;
      int d[4] = {pc[nt][0], pc[nt][1], pc[nt][0], pc[nt][1]};
#pragma unroll
      for (int k = 0; k < WS; ++k) mma_s8(d, a[k], bq[nt][k][0], bq[nt][k][1]);
      ob[off[nt][0] + r] = static_cast<uint8_t>(d[0]);
      ob[off[nt][1] + r] = static_cast<uint8_t>(d[1]);
      ob[off[nt][0] + r + 8] = static_cast<uint8_t>(d[2]);
      ob[off[nt][1] + r + 8] = static_cast<uint8_t>(d[3]);
    }
  }
  __syncthreads();
  for (int qi = warp; qi < tq; qi += kThreads / 32) {
    uint8_t* p = out + (long)(q0 + qi) * ng + n0;
    const int s = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
    store_staged(p - s, ob + qi * kObStride, s, valid, lane);
  }
}

template <int WS>
Config mma_config(int tile_q) {
  return {reinterpret_cast<const void*>(hamming_mma_kernel<WS>), kMmaRows,
          (size_t)(tile_q + 7) / 8 * 8 * kObStride + kMmaRows * WS * sizeof(uint32_t)};
}

