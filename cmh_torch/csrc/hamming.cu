// Hamming distances between packed binary codes: out[q, n] =
// sum_w popcount(Q[q, w] ^ G[n, w]), Q (nq, W) and G (ng, W) 32-bit words,
// out (nq, ng) row-major as uint8 (codes of at most 255 bits) or int32.
//
// Replaces the TPU kernel cmh_tpu/ops/hamming_pallas.py:_hamming_kernel
// (called from hamming_packed). The TPU wrapper transposes the gallery to (W, N)
// so words lie along the vector lanes; here no transpose is needed.
//
// Bound on the card: bytes for short codes, by far the largest stream being
// the (nq, ng) output (a 16-bit code is 4 bytes of gallery against nq output
// bytes a gallery row); popcounts for long ones, since __popc issues at 16 a
// clock an SM, a quarter of XOR's rate (Q*N*W of them: at 64 bits they take
// longer than the bytes, at 1,024 bits four times longer).
//
// The design. A thread owns R consecutive gallery rows (16 for uint8, 4 for
// int32), so its distances for one query are 16 bytes: one 16-byte store. A
// block of kThreads threads takes R * kThreads gallery rows and a tile of
// queries (the wrapper splits the queries over grid.y until the grid fills
// the blocks the card holds at once) whose words sit in shared memory and are
// read as broadcasts. The gallery tile is staged through shared memory with
// 4-byte coalesced loads, so any 4-byte-aligned gallery view is read in
// place, into a [word][row][thread] layout each thread reads without bank
// conflicts.
//   - W <= 2 (uint8) or W == 8 (int32): each thread keeps its R * W gallery
//     words in registers and walks the queries one at a time.
//   - any other W: words are walked from shared memory, kSubQ queries at a
//     time, in chunks of at most chunk_words() words.
// uint8 sums are kept packed, four rows a word (no carry: each is <= 255).
// Output row q starts at byte q * N * size, so rows start at every alignment
// mod 16. A warp's 32 lanes hold 512 contiguous bytes of a row that start s
// bytes past a 16-byte boundary: each lane takes its left neighbour's 16
// bytes with a shuffle and funnel-shifts the pair by s, so lane t holds the
// aligned chunk it stores whole (evict-first: the output passes through the
// L2 once); lane 0's shifted value holds both the head of the warp's span
// and the s bytes past its end, and those partial chunks (and a short last
// warp) go out as single bytes from 16 lanes each.
//
// On an NVIDIA H100 80GB HBM3 at 700.00 W, Q=64 x N=1,049,353 (PERF.md;
// chip_smoke.py phase 3, tools/hamming_variants.py): 0.034-0.036 ms at 16
// bits, 1.6-1.7x its byte bound and 1.6x PyTorch's fill_ of the same bytes;
// 0.053-0.055 ms at 64 bits, 1.7x its popcount floor. Measured and not kept
// (tools/hamming_variants.py): realigning through shared memory, one-byte
// stores, default stores, 2 or 8 warps a block, and mma.sync on the tensor
// cores (tools/hamming_mma.cu: faster at 64 bits, slower at 16 and at 4
// queries).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;                  // 4 warps a block
constexpr int kSubQ = 8;                       // queries a pass over the words (any W)
constexpr int kMaxTileQ = 64;                  // queries a block at most
constexpr int kStride = kThreads + 1;          // padded [word][row] line of threads

template <typename OutT>   // gallery words staged at once for any W: 66 KB of shared memory
__host__ __device__ constexpr int chunk_words() { return sizeof(OutT) == 1 ? 8 : 32; }

__device__ __forceinline__ uint4 shfl4(uint4 v, int src) {
  return make_uint4(__shfl_sync(0xffffffffu, v.x, src), __shfl_sync(0xffffffffu, v.y, src),
                    __shfl_sync(0xffffffffu, v.z, src), __shfl_sync(0xffffffffu, v.w, src));
}

// Bytes 16 - s .. 31 - s of the 32 bytes x ++ d (x first): the 16-byte chunk
// that starts s bytes before d's own first byte.
__device__ __forceinline__ uint4 realign(uint4 x, uint4 d, int s) {
  if (s == 0) return d;
  const int o = 16 - s, sh = 8 * (o & 3);
  uint32_t a, b, c, e, f;                      // five words from word o / 4
  switch (o >> 2) {
    case 0: a = x.x; b = x.y; c = x.z; e = x.w; f = d.x; break;
    case 1: a = x.y; b = x.z; c = x.w; e = d.x; f = d.y; break;
    case 2: a = x.z; b = x.w; c = d.x; e = d.y; f = d.z; break;
    default: a = x.w; b = d.x; c = d.y; e = d.z; f = d.w; break;
  }
  return make_uint4(__funnelshift_r(a, b, sh), __funnelshift_r(b, c, sh),
                    __funnelshift_r(c, e, sh), __funnelshift_r(e, f, sh));
}

// One warp writes its `valid` bytes of an output row, starting at `p`: lane
// t's 16 bytes d belong at p + 16 t. All 32 lanes call it with the same p
// and valid (valid <= 512).
__device__ __forceinline__ void store_row(uint8_t* p, uint4 d, int valid, int lane) {
  const int s = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
  uint8_t* base = p - s;                       // chunk 0, 16-byte aligned
  const uint4 c = realign(shfl4(d, (lane + 31) & 31), d, s);
  if (valid <= 0) return;
  const int end = s + valid;                   // bytes from base
  if ((lane > 0 || s == 0) && end >= 16 * lane + 16)
    __stcs(reinterpret_cast<uint4*>(base + 16 * lane), c);   // evict-first
  const bool head = s > 0 || end < 16;         // chunk 0 is partial
  const int last = (end - 1) >> 4;             // the last chunk touched (32: past lane 31's)
  const bool tail = last > 0 && (end & 15);    // and it is partial
  if (head || tail) {
    // lanes 0-15 write the head's bytes, 16-31 the tail's; chunk 32 is lane 0's value
    const uint4 v = shfl4(c, lane < 16 ? 0 : last & 31);
    const int j = lane & 15;
    const uint32_t word = j < 4 ? v.x : j < 8 ? v.y : j < 12 ? v.z : v.w;
    const uint8_t byte = static_cast<uint8_t>(word >> (8 * (j & 3)));
    if (lane < 16 ? head && j >= s && j < end : tail && j < (end & 15))
      base[lane < 16 ? j : 16 * last + j] = byte;
  }
}

// WS > 0: W == WS, gallery words held in registers. WS == 0: any W, words
// walked from shared memory.
template <typename OutT, int WS>
__global__ void __launch_bounds__(kThreads)
hamming_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ g,
               OutT* __restrict__ out, int nq, int ng, int w, int tile_q) {
  constexpr int R = 16 / sizeof(OutT);         // gallery rows a thread
  constexpr int PER = 4 / sizeof(OutT);        // rows a 32-bit word of sums
  constexpr int TILE = R * kThreads;           // gallery rows a block
  extern __shared__ uint32_t smem[];
  uint32_t* sq = smem;                         // the query tile, (round_up(tile_q, kSubQ), w)
  uint32_t* sg = smem + ((tile_q + kSubQ - 1) / kSubQ) * kSubQ * w;   // [word][row][thread]
  const int t = threadIdx.x, lane = t & 31;
  const int q0 = blockIdx.y * tile_q, tq = min(tile_q, nq - q0);
  const int wc = WS > 0 ? WS : min(w, chunk_words<OutT>());
  const long n0 = (long)blockIdx.x * TILE;
  const int rows = static_cast<int>(min((long)TILE, ng - n0));
  const uint32_t* gt = g + n0 * w;
  const long nw0 = n0 + (t >> 5) * 32 * R;     // the warp's first row
  const int valid = static_cast<int>(max(0L, min(32L * R, ng - nw0))) * (int)sizeof(OutT);
  auto stage = [&](int w0, int nw) {           // words w0 .. w0 + nw of the tile's rows
    for (int i = t; i < rows * nw; i += kThreads) {
      const int n = i / nw, k = i - n * nw;
      sg[(k * R + n % R) * kStride + n / R] = gt[(long)n * w + w0 + k];
    }
  };
  auto put = [&](int qi, const uint32_t (&acc)[4]) {
    uint8_t* p = reinterpret_cast<uint8_t*>(out + (long)(q0 + qi) * ng + nw0);
    store_row(p, make_uint4(acc[0], acc[1], acc[2], acc[3]), valid, lane);
  };

  for (int i = t; i < tq * w; i += kThreads) sq[i] = q[(long)q0 * w + i];
  if constexpr (WS > 0) {
    stage(0, WS);
    __syncthreads();
    uint32_t gr[R][WS];
#pragma unroll
    for (int k = 0; k < WS; ++k)
#pragma unroll
      for (int r = 0; r < R; ++r) gr[r][k] = sg[(k * R + r) * kStride + t];
    for (int i = 0; i < tq; ++i) {
      uint32_t acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int k = 0; k < WS; ++k) {
        const uint32_t qw = sq[i * WS + k];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r / PER] += __popc(qw ^ gr[r][k]) << (8 * (r % PER));
      }
      put(i, acc);
    }
  } else {
    for (int i0 = 0; i0 < tq; i0 += kSubQ) {
      uint32_t acc[kSubQ][4] = {};
      for (int w0 = 0; w0 < w; w0 += wc) {
        if (wc < w || i0 == 0) {               // the chunk is not in shared memory yet
          if (i0 > 0 || w0 > 0) __syncthreads();
          stage(w0, min(wc, w - w0));
          __syncthreads();
        }
        for (int k = 0; k < min(wc, w - w0); ++k) {
          uint32_t gk[R];
#pragma unroll
          for (int r = 0; r < R; ++r) gk[r] = sg[(k * R + r) * kStride + t];
#pragma unroll
          for (int j = 0; j < kSubQ; ++j) {
            const uint32_t qw = sq[(i0 + j) * w + w0 + k];
#pragma unroll
            for (int r = 0; r < R; ++r)
              acc[j][r / PER] += __popc(qw ^ gk[r]) << (8 * (r % PER));
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kSubQ; ++j)
        if (i0 + j < tq) put(i0 + j, acc[j]);
    }
  }
}

// The instantiation for an output type and W, and its shared memory.
struct Config {
  const void* fn;
  int rows;                                    // gallery rows a block
  size_t smem;
};

template <typename OutT, int WS>
Config config(int w, int tile_q) {
  constexpr int R = 16 / sizeof(OutT);
  const int wc = WS > 0 ? WS : (w < chunk_words<OutT>() ? w : chunk_words<OutT>());
  return {reinterpret_cast<const void*>(hamming_kernel<OutT, WS>), R * kThreads,
          ((size_t)(tile_q + kSubQ - 1) / kSubQ * kSubQ * w + (size_t)wc * R * kStride)
              * sizeof(uint32_t)};
}

Config pick(int out_u8, int w, int tile_q) {
  if (out_u8) {
    if (w == 1) return config<uint8_t, 1>(w, tile_q);
    if (w == 2) return config<uint8_t, 2>(w, tile_q);
    return config<uint8_t, 0>(w, tile_q);
  }
  if (w == 8) return config<int32_t, 8>(w, tile_q);
  return config<int32_t, 0>(w, tile_q);
}

cudaError_t allow_smem(const Config& c) {
  if (c.smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(c.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
}

}  // namespace

extern "C" {

// out_u8: 1 writes uint8 distances, 0 writes int32. tile_q: queries a block
// (grid.y = ceil(nq / tile_q)).
int cmh_hamming(const void* q, const void* g, void* out, int nq, int ng, int w, int out_u8,
                int tile_q, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (nq == 0 || ng == 0) return cudaSuccess;
  if (w < 1 || tile_q < 1 || tile_q > kMaxTileQ) return cudaErrorInvalidValue;
  const Config c = pick(out_u8, w, tile_q);
  if ((e = allow_smem(c)) != cudaSuccess) return e;
  const long tiles = ((long)ng + c.rows - 1) / c.rows;
  const dim3 grid((unsigned)tiles, (nq + tile_q - 1) / tile_q);
  void* args[] = {&q, &g, &out, &nq, &ng, &w, &tile_q};
  e = cudaLaunchKernel(c.fn, grid, dim3(kThreads), args, c.smem,
                       static_cast<cudaStream_t>(stream));
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The launch geometry for (out_u8, w) at a query tile of tile_q: geo[0] =
// gallery rows a block, geo[1] = blocks one SM holds at once (0 on error).
void cmh_hamming_geometry(int out_u8, int w, int tile_q, int device, int* geo) {
  geo[0] = geo[1] = 0;
  if (cudaSetDevice(device) != cudaSuccess || w < 1 || tile_q < 1 || tile_q > kMaxTileQ) return;
  const Config c = pick(out_u8, w, tile_q);
  int n = 0;
  if (allow_smem(c) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, c.fn, kThreads, c.smem) != cudaSuccess)
    return;
  geo[0] = c.rows;
  geo[1] = n;
}

}  // extern "C"
