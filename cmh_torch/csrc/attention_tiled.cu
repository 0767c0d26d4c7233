// Self-attention for long sequences: softmax(scale * Q K^T + mask + kpm_bias) V
// and its backward, each (batch, head) split over tiles of query (or key)
// rows, so that no block's thread count, and in the backward no block's
// shared memory, grows with S. The one-block kernels of attention.cu hold a
// whole (batch, head) in one block and stop at S = 176 (bf16 forward, hd 64),
// 128 (bf16 backward), 162 and 117 (fp32); ops/attention.py routes every
// longer S here, by S alone.
//
// Replaces, for those lengths, cmh_tpu/ops/attention_pallas.py:_fwd_kernel
// (called from _attention_fwd) and _bwd_kernel (from _attention_bwd), with
// their arithmetic: logits are the fp32 dot of the inputs times scale, then
// + the (S, S) fp32 mask, then + the (B, S) fp32 key-padding bias (each
// through __fmul_rn/__fadd_rn, so that no contraction into an FMA can differ
// between kernels); the row softmax is fp32; the forward rounds the
// NORMALISED probabilities to the input dtype before PV (fp32 sums); the
// backward uses the unrounded fp32 probabilities. A row whose every key is
// masked gives NaN, as the plain version does; a key block that is wholly
// masked adds 0 to the row sum.
//
// Every kernel here runs its products on the tensor cores (mma.sync, fp32
// accumulators; bf16 helpers in attention_mma.cuh). Query (or key) rows go
// in tiles of 16, in mma accumulator layout; the other side streams through
// shared memory in chunks of 64 rows by cp.async, double-buffered.
//
// bf16 (mma.sync m16n8k16, bf16 operands), hd 32 or 64:
//  - Forward (tiled_fwd_mma), one launch and ONE walk over the keys, up to 4
//    tiles a block. The logits stay fp32 FMA chains over hd in order from 0
//    on the CUDA cores: P is rounded to bf16, and tensor-core sums, which
//    round differently, would move a P across a rounding step often enough
//    that the one-step check fails (attention.cu, attention_fwd_mma). Each K
//    chunk is converted once as it lands into fp32 K^T (hd x 64), and each
//    tile keeps its Q rows as fp32 Q^T (hd x 16); a lane that owns 4 rows and
//    4 keys reads 32 bytes for 16 FMAs per hd element. Each tile writes its
//    16 x S logits once, into its own logit rows (16 ceil(S / 16) + 8 words
//    a row: 17.5 KB at S = 257), and those rows bound how many tiles an SM
//    holds: 8 at S = 257. So two warps share a tile, 16 warps an SM: in the
//    walk each takes half of each chunk's keys, in the softmax half the rows,
//    in P V half the output columns; they trade row maxima and sums through
//    shared memory. The softmax runs from the logit rows as torch.softmax
//    forms it: the row max (exact in any order); the row sum for S <= 2048
//    in its warp's lane order (per lane L = c mod 32 a sequential sum over
//    c = L, L + 32, ..., then a butterfly over L with offsets 16, 8, 4, 2,
//    1), past 2048 in its block order (per thread T = c mod 1024 of a
//    1024-thread block a sequential sum over c = T, T + 1024, ..., then the
//    butterfly within each warp of 32 threads and across the 32 warps); no
//    online rescaling, so that w is the plain version's to the bit; a
//    correctly rounded division; the rounding to bf16. P is then the A
//    operand of P V on mma (V through ldmatrix.trans), and the output leaves
//    through a 16-row stage with 16-byte stores. The logit rows live in
//    shared memory up to S = 3152 (hd 64) or 3376 (hd 32); past that one
//    tile's rows no longer fit in 227 KB, and they live in device memory
//    (tiled_fwd_mma_rows, the same code): a persistent grid of
//    kRowsBlocksPerSm blocks of kRowsTiles tiles an SM, each block with its
//    own slot of rows, so that the scratch is sized by the blocks the card
//    holds (214 MB at S = 3153) and not by B H. Sixteen warps an SM, as in
//    shared memory, beat fewer whose rows would stay in the 50 MB L2.
//  - Backward, three launches over fp32 scratch (4, B H, S), none with
//    atomics, so a rerun gives the same bits: (1) tiled_bwd_stats_mma, per
//    query tile, one walk over K and V for the row max m, the sum l (each
//    thread's partial rescaled as its max grows, then joined under the
//    row's max), 1 / l and D = sum_j w_ij dW_ij; (2) tiled_bwd_dkdv_mma, per
//    key tile, over the query chunks; (3) tiled_bwd_dq_mma, per query tile,
//    over the key chunks. All five products run on mma: S = Q K^T and
//    dW = dO V^T as exact bf16 products with fp32 sums, by the same
//    instructions in the same k order in every launch (launch 2 forms
//    S^T = K Q^T, whose elements are the same products summed in the same
//    order), so w = exp(logit - m) / l is bit-equal between launches 2 and
//    3; dV = W^T dO, dK = scale dlog^T Q and dQ = scale dlog K take W and
//    dlog = w (dW - D) straight from the accumulators as kPieces bf16
//    pieces (split_pair). No shared memory grows with S, so every S runs.
//
// fp32 (MITH's concept tokens past S 117, fp32 towers past S 162), hd up to
// 128 (padded with zeros to 32, 64 or 128): mma.sync m16n8k8 in TF32 as
// 3xTF32. Each fp32 operand x is split into hi = cvt.rna.tf32(x) and
// lo = cvt.rna.tf32(x - hi); a product is lo hi + hi lo + hi hi with fp32
// sums, which leaves out only lo lo (about 2^-22 of the product). Q, K, V
// and dO stay fp32 in shared memory (rows padded to hd + 4 words, so that
// every fragment read falls in distinct banks) and each warp splits the
// fragments it reads. A warp owns 16 rows: eight warps a forward block, four
// a backward one. The products of a chunk are straight-line code with no
// guard (the last chunk, if it holds at most 16 keys, takes 2 n-tiles for
// 8), so that independent mma chains interleave.
//  - Forward (tiled_fwd_tf32), ONE walk over the keys with an online
//    softmax: per 64-key chunk S on mma, the logits, the running row max,
//    the row sum and the output rescaled as the max grows, then P V on mma
//    with the unnormalised fp32 P straight from the accumulators (fp32 P is
//    not rounded, so no order of torch.softmax's need be kept); the output
//    is divided by the row sum at the end.
//  - Backward (tiled_bwd_{stats,dkdv,dq}_tf32), the three launches of bf16
//    over the same scratch: (1) m, l, 1 / l and D in one walk, rescaling as
//    the max grows; (2) and (3) form S (S^T in (2), its cross terms issued in
//    swapped order) and dW with the same instructions in the same k order,
//    so w is bit-equal between them; dV, dK and dQ on mma from W and dlog in
//    the accumulators.
// An mma's fp32 sums do not round to nearest: the long products (P V, dV,
// dK, dQ, over S) add each 8-deep step's three mma sums, formed from zero,
// to their totals by a rounded fp32 add, so no chain of mma sums is longer
// than three; S and dW chain over hd (24 sums at hd 64).
//
// Every kernel reads its inputs through element strides (b, h, s) with hd
// contiguous (the head views of a packed projection) and writes its outputs
// through their own strides.
//
// Bound on the card: at ViT-L/14's (100, 16, 257, 64) in bf16 the forward
// moves 210 MB (0.063 ms at 3.35 TB/s), but its one logit walk is 13.5 GFLOP
// of fp32 FMA work that the check keeps off the tensor cores: 0.20 ms at
// 67 TFLOP/s, the floor of this design (0.23 ms at ViT-B/16's (256, 12, 197,
// 64)); the logit rows limit an SM to 8 tiles, and the walk runs well below
// that rate. The backward
// moves 368 MB (0.110 ms); its tensor-core work, 15 products of 13.5 GFLOP
// (S and dW in each launch, and each of dV, dK and dQ in three pieces), is
// 0.21 ms at 989 TFLOP/s, and the exps and the pieces run on the CUDA cores
// beside it. Past S = 1024 (kChunkSumsS) the backward sums each chunk's
// products apart before adding them to its totals. In fp32 a product costs
// three TF32 ones: 1.08 GFLOP of fp32 work in the forward at (4, 16, 257, 64)
// is 3.24 GFLOP on mma, 0.0065 ms at 495 TFLOP/s; the fragment splits run on
// the CUDA cores beside it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

constexpr int kMaxDevices = 64;
// torch.softmax (CUDA, fp32 rows) sums a row of up to 2048 in one warp's lane
// order and a longer one over a block of 1024 threads; the bf16 forward
// follows it, so that P rounds as in the plain version
constexpr int kWarpSoftmaxMax = 2048;

template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t smem, int device,
                       size_t (&configured)[kMaxDevices]) {
  if (smem <= 48 * 1024) return cudaSuccess;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem <= configured[device]) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) configured[device] = smem;
  return e;
}

// ------------------------------------------------- bf16 on the tensor cores

constexpr int kChunk = 64;       // rows of a streamed K, V, Q or dO chunk
constexpr int kMmaWarps = 4;     // warps of a backward block
constexpr int kFwdTiles = 4;     // most 16-row tiles (two warps each) of a forward block
// Past the S at which one tile's logit rows fit in shared memory: tiles of a
// forward block, and its resident blocks an SM, each with its own slot of
// rows in device memory (214 MB at S = 3153, hd 64, on 132 SMs)
constexpr int kRowsTiles = 2;
constexpr int kRowsBlocksPerSm = 4;
constexpr int kTfFwdWarps = 8;   // warps (16-row tiles) of an fp32 forward block
constexpr int kPieces = 3;       // bf16 pieces of W and dlog in dV, dK and dQ
// Past this S the backward sums each 64-row chunk's products apart and adds
// the chunk sums to the totals: an mma's fp32 sums do not round to nearest,
// and over hundreds of chained steps their error passes the one-step check
// on outputs near 0
constexpr int kChunkSumsS = 1024;
constexpr size_t kMaxSmem = 227 * 1024;    // a block's dynamic shared memory on sm_90
constexpr size_t kHalfSmem = 113 * 1024;   // each of two blocks on one SM (228 KB, 1 KB a block kept)

// The forward's logit rows: 16 ceil(s / 16) + 8 words, so that the float2
// reads of P V's A fragments (8 rows, 4 lanes a row) fall in distinct banks
__host__ __device__ constexpr int logit_ld(int s) { return 16 * ((s + 15) / 16) + 8; }

// The forward's shared memory but its logit rows: per 16-row tile (two
// warps) its Q rows transposed to fp32 (hd x 16) and 48 floats through which
// its warps trade row maxima and sums; per block one K chunk transposed to
// fp32 (hd x 64) and the bf16 tile it lands in (V's two bf16 chunks take
// their place after the walk)
__host__ __device__ constexpr size_t fwd_rest_smem(int hd, int tiles) {
  return (size_t)tiles * (16 * hd * 4 + 48 * 4) + (size_t)kChunk * hd * 4 +
         (size_t)kChunk * (hd + 8) * 2;
}

// ... and with each tile's 16 logit rows
__host__ __device__ constexpr size_t fwd_mma_smem(int s, int hd, int tiles) {
  return (size_t)tiles * 16 * (size_t)logit_ld(s) * 4 + fwd_rest_smem(hd, tiles);
}

// 16-row tiles of a forward block: the most, of 4 down to 1, that leave room
// for a second block on the SM; else 1 while one tile's rows fit; else 0
// (the rows then live in device memory: tiled_fwd_mma_rows)
int fwd_mma_tiles(int s, int hd) {
  for (int n = kFwdTiles; n >= 1; --n)
    if (fwd_mma_smem(s, hd, n) <= kHalfSmem) return n;
  return fwd_mma_smem(s, hd, 1) <= kMaxSmem ? 1 : 0;
}

// The backward's shared memory: per warp two 16-row bf16 tiles (its rows of
// Q and dO, or of K and V, later the output stage); two chunks of 64 rows of
// the other side's pair; and with stats, each chunk's m, l, 1 / l and D
__host__ __device__ constexpr size_t bwd_mma_smem(int hd, bool stats) {
  return (size_t)kMmaWarps * 2 * 16 * (hd + 8) * 2 + (size_t)2 * 2 * kChunk * (hd + 8) * 2 +
         (stats ? (size_t)2 * 4 * kChunk * 4 : 0);
}

// 4 bytes global -> shared; zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}

// rows [row0, row0 + rows) of one (batch, head) of a strided bf16 tensor
// (base at the (batch, head)) into a tile with leading dimension HD + 8, by
// cp.async; rows >= s are zero-filled
template <int HD>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* base, long long st_s,
                                                int row0, int rows, int s, int tid,
                                                int nthreads) {
  constexpr int CH = HD / 8, LD = HD + 8;
  for (int i = tid; i < rows * CH; i += nthreads) {
    const int r = i / CH, c = i - r * CH, row = row0 + r;
    const bool ok = row < s;
    cp_async16(dst + r * LD + c * 8, ok ? base + row * st_s + c * 8 : base, ok);
  }
}

// A warp's 16 x HD fp32 accumulators (times mul), rounded to bf16, through its
// 16-row stage into rows row0.. (< s) of dst (at the (batch, head)), with
// 16-byte stores
template <int HD>
__device__ __forceinline__ void store_tile(bf16* dst, long long st_s,
                                           const float (&acc)[HD / 8][4], float mul,
                                           bf16* stage, int row0, int s, int lane) {
  constexpr int CH = HD / 8, LD = HD + 8;
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    *reinterpret_cast<uint32_t*>(stage + g * LD + 8 * j + 2 * t) =
        pack_bf16(acc[j][0] * mul, acc[j][1] * mul);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LD + 8 * j + 2 * t) =
        pack_bf16(acc[j][2] * mul, acc[j][3] * mul);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i - r * CH, row = row0 + r;
    if (row < s)
      *reinterpret_cast<uint4*>(dst + row * st_s + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * LD + c * 8);
  }
}

// The logit of query r and key c: the fp32 dot x times scale, + the mask at
// (r, c), + the key-padding bias at c, each rounded on its own; keys >= s are
// -inf, and padded query rows (r >= s) read no mask
__device__ __forceinline__ float logit_at(float x, int r, int c, int s, int b, float scale,
                                          const float* __restrict__ mask,
                                          const float* __restrict__ kpm) {
  if (c >= s) return -INFINITY;
  float lg = __fmul_rn(x, scale);
  if (mask != nullptr && r < s) lg = __fadd_rn(lg, __ldg(mask + (long long)r * s + c));
  if (kpm != nullptr) lg = __fadd_rn(lg, __ldg(kpm + (long long)b * s + c));
  return lg;
}

// x / d, correctly rounded as `/` is, from inv = __frcp_rn(d) and one fma
// correction (Markstein)
__device__ __forceinline__ float div_rn(float x, float d, float inv) {
  const float q = __fmul_rn(x, inv);
  return fmaf(fmaf(-q, d, x), inv, q);
}

// Each of N values summed over the warp's lanes by a butterfly with
// offsets 16, 8, 4, 2, 1 (torch.softmax's warp reduction)
template <int N>
__device__ __forceinline__ void warp_sums(float (&p)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < N; ++r) p[r] += __shfl_xor_sync(0xffffffffu, p[r], o);
}

// The forward's walk over 32 keys (one half of a K chunk, for one of the
// two warps of a 16-row tile): the logits of the tile's 16 query rows, each
// an FMA chain over hd in order from 0, into its logit rows (columns below
// cols), and the running max of the thread's rows. Lane (rg, cg) =
// (lane / 8, lane % 8) owns rows 4 rg .. 4 rg + 3 and keys
// k0 + 4 cg .. k0 + 4 cg + 3: per hd element a 16-byte read of Q^T and one
// of K^T (kt, at key k0) feed 16 FMAs.
template <int HD>
__device__ __forceinline__ void fwd_keys(float* lrow, float (&m)[4], const float* qt,
                                         const float* kt, int ls, int cols, int row0, int k0,
                                         int s, int b, float scale,
                                         const float* __restrict__ mask,
                                         const float* __restrict__ kpm, int rg, int cg) {
  float x[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i][0] = x[i][1] = x[i][2] = x[i][3] = 0.f;
  // hd element d + 1's reads are in flight while d's FMAs run; the loop is
  // unrolled 8 times, not fully, so that its code stays small
  const float* qp = qt + 4 * rg;
  const float* kp = kt + 4 * cg;
  float4 qv = *reinterpret_cast<const float4*>(qp);
  float4 kv = *reinterpret_cast<const float4*>(kp);
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    const int dn = (d + 1) & (HD - 1);   // past the last element: a harmless reread of 0
    const float4 qn = *reinterpret_cast<const float4*>(qp + dn * 16);
    const float4 kn = *reinterpret_cast<const float4*>(kp + dn * kChunk);
    const float q[4] = {qv.x, qv.y, qv.z, qv.w};
    const float k[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) x[i][j] = fmaf(q[i], k[j], x[i][j]);
    qv = qn;
    kv = kn;
  }
  const int c0 = k0 + 4 * cg;
  if (c0 >= cols) return;   // past the last 16-key tile: never read
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * rg + i;
    float lg[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lg[j] = logit_at(x[i][j], row0 + r, c0 + j, s, b, scale, mask, kpm);
      m[i] = fmaxf(m[i], lg[j]);
    }
    *reinterpret_cast<float4*>(lrow + r * ls + c0) = make_float4(lg[0], lg[1], lg[2], lg[3]);
  }
}

// The sums of exp(logit - max) of N logit rows (rows[r] the r-th, mr[r] its
// max), each exp written back in place, in torch.softmax's order: for
// s <= kWarpSoftmaxMax its warp's lane order; past it its block order, per
// w = (c mod 1024) / 32 the lane sums over c = 32 w + lane + 1024 i, reduced
// over the lanes and kept by lane w, then the 32 of them by the same
// butterfly. Keys past s add exp(-inf) = 0.
template <int N>
__device__ __forceinline__ void row_sums(float (&p)[N], float* lrow, int ls, int row_first,
                                         const float (&mr)[N], int cols, int s, int lane) {
#pragma unroll
  for (int r = 0; r < N; ++r) p[r] = 0.f;
  const bool block_order = s > kWarpSoftmaxMax;
  for (int w = 0; w < (block_order ? 32 : 1); ++w) {
    float pw[N];
#pragma unroll
    for (int r = 0; r < N; ++r) pw[r] = 0.f;
    for (int c = 32 * w + lane; c < cols; c += block_order ? 1024 : 32) {
#pragma unroll
      for (int r = 0; r < N; ++r) {
        float* at = lrow + (row_first + r) * ls + c;
        const float e = expf(*at - mr[r]);
        *at = e;
        pw[r] += e;
      }
    }
    warp_sums(pw);
#pragma unroll
    for (int r = 0; r < N; ++r) p[r] = block_order ? (lane == w ? pw[r] : p[r]) : pw[r];
  }
  if (block_order) warp_sums(p);
}

// The forward of work item `item` (with ROWS; else blockIdx.x): 16-row query
// tiles of one (batch, head), per_bh items to it, two warps to a tile, each
// tile's logit rows in shared memory or, with ROWS, in block blockIdx.x's
// slot of rows; see the file's head for the design.
template <int HD, bool ROWS>
__device__ __forceinline__ void fwd_mma_item(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ mask, const float* __restrict__ kpm, bf16* __restrict__ out,
    Strides stq, Strides stk, Strides stv, Strides sto, int heads, int s, int per_bh,
    float scale, unsigned item, float* rows) {
  constexpr int LD = HD + 8, CH = HD / 8, NO = HD / 16;   // NO: a warp's output n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int np = blockDim.x >> 6, ls = logit_ld(s), kc = (s + 15) / 16, cols = 16 * kc;
  float* slog = ROWS ? rows + (size_t)blockIdx.x * np * 16 * ls
                     : reinterpret_cast<float*>(smem_raw);
  float* sqt = ROWS ? reinterpret_cast<float*>(smem_raw)
                    : slog + (size_t)np * 16 * ls;   // per tile Q^T, hd x 16
  float* sred = sqt + np * 16 * HD;           // per tile: two warps' row maxima, row sums
  float* skt = sred + np * 48;                // K^T, hd x 64
  bf16* skb = reinterpret_cast<bf16*>(skt + kChunk * HD);   // where a K chunk lands
  bf16* sv = reinterpret_cast<bf16*>(skt);    // V's two chunks, after the walk

  const unsigned it = ROWS ? item : blockIdx.x;
  const int bh = it / per_bh, b = bh / heads, h = bh - b * heads;
  const int tid = threadIdx.x, nth = blockDim.x, lane = tid & 31, pl = tid & 63;
  const int pair = tid >> 6, half = (tid >> 5) & 1;
  const int g = lane >> 2, t = lane & 3, rg = lane >> 3, cg = lane & 7;
  const int tile = (it - bh * per_bh) * np + pair, row0 = tile * 16;
  const bool active = tile < kc;             // uniform over the tile's two warps
  float* lrow = slog + (size_t)pair * 16 * ls;
  float* qt = sqt + pair * 16 * HD;
  float* red = sred + pair * 48;
  const bf16* kbase = k + b * stk.b + h * stk.h;
  const bf16* vbase = v + b * stv.b + h * stv.h;
  const int chunks = (s + kChunk - 1) / kChunk;

  load_rows_async<HD>(skb, kbase, stk.s, 0, kChunk, s, tid, nth);
  cp_async_commit();
  {   // the tile's Q rows, transposed to fp32; rows >= s are 0
    const bf16* qb = q + b * stq.b + h * stq.h;
    for (int i = pl; i < 16 * CH; i += 64) {
      const int r = i & 15, c = i >> 4, row = row0 + r;
      uint4 w = make_uint4(0, 0, 0, 0);
      if (row < s) w = __ldg(reinterpret_cast<const uint4*>(qb + row * stq.s + c * 8));
      float* dst = qt + c * 8 * 16 + r;
      dst[0] = bf16_lo(w.x);
      dst[16] = bf16_hi(w.x);
      dst[32] = bf16_lo(w.y);
      dst[48] = bf16_hi(w.y);
      dst[64] = bf16_lo(w.z);
      dst[80] = bf16_hi(w.z);
      dst[96] = bf16_lo(w.w);
      dst[112] = bf16_hi(w.w);
    }
  }

  // the walk: K chunk n lands as bf16 and becomes fp32 K^T, and chunk n + 1's
  // copy runs while the warps form their logits against chunk n, each warp
  // of a tile one half of the chunk's keys
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int n = 0; n < chunks; ++n) {
    cp_async_wait_group<0>();
    __syncthreads();        // chunk n has landed; no warp still reads chunk n - 1
    for (int i = tid; i < kChunk * CH; i += nth) {
      const int key = i % kChunk, c = i / kChunk;
      const uint4 w = *reinterpret_cast<const uint4*>(skb + key * LD + c * 8);
      float* dst = skt + c * 8 * kChunk + key;
      dst[0] = bf16_lo(w.x);
      dst[kChunk] = bf16_hi(w.x);
      dst[2 * kChunk] = bf16_lo(w.y);
      dst[3 * kChunk] = bf16_hi(w.y);
      dst[4 * kChunk] = bf16_lo(w.z);
      dst[5 * kChunk] = bf16_hi(w.z);
      dst[6 * kChunk] = bf16_lo(w.w);
      dst[7 * kChunk] = bf16_hi(w.w);
    }
    __syncthreads();
    if (n + 1 < chunks) {
      load_rows_async<HD>(skb, kbase, stk.s, (n + 1) * kChunk, kChunk, s, tid, nth);
      cp_async_commit();
    }
    const int k0 = n * kChunk + 32 * half;
    if (active && k0 < cols)
      fwd_keys<HD>(lrow, m, qt, skt + 32 * half, ls, cols, row0, k0, s, b, scale, mask, kpm, rg,
                   cg);
  }
  __syncthreads();          // the K chunk's space is free: V's first two chunks
  load_rows_async<HD>(sv, vbase, stv.s, 0, kChunk, s, tid, nth);
  cp_async_commit();
  if (chunks > 1) load_rows_async<HD>(sv + kChunk * LD, vbase, stv.s, kChunk, kChunk, s, tid, nth);
  cp_async_commit();

  // the row maxima: over each warp's 8 lanes of a row, then its two warps'
  if (active) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], o));
      if (cg == 0) red[16 * half + 4 * rg + i] = m[i];
    }
  }
  __syncthreads();
  // the row sums: each warp of a tile 8 of its rows, side by side
  if (active) {
    float mr[8], p[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) mr[r] = fmaxf(red[8 * half + r], red[16 + 8 * half + r]);
    row_sums(p, lrow, ls, 8 * half, mr, cols, s, lane);
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (lane == r) red[32 + 8 * half + r] = p[r];
  }
  __syncthreads();          // the sums, and every exp written back, reach both warps

  // P V: P = exp / l, rounded to bf16, straight into A fragments; each warp of
  // a tile half of the output columns
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  const float l[2] = {active ? red[32 + g] : 1.f, active ? red[40 + g] : 1.f};
  const float inv[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
  for (int n = 0; n < chunks; ++n) {
    cp_async_wait_group<1>();
    __syncthreads();        // V chunk n has landed
    if (active) {
      const bf16* vt = sv + (n & 1) * kChunk * LD + half * (HD / 2);
      const int tiles = min(kChunk / 16, kc - n * (kChunk / 16));
#pragma unroll
      for (int kt = 0; kt < kChunk / 16; ++kt) {
        if (kt >= tiles) break;
        const int c = n * kChunk + kt * 16 + 2 * t;
        const float2 e0 = *reinterpret_cast<const float2*>(lrow + g * ls + c);
        const float2 e1 = *reinterpret_cast<const float2*>(lrow + (g + 8) * ls + c);
        const float2 e2 = *reinterpret_cast<const float2*>(lrow + g * ls + c + 8);
        const float2 e3 = *reinterpret_cast<const float2*>(lrow + (g + 8) * ls + c + 8);
        const uint32_t pa[4] = {
            pack_bf16(div_rn(e0.x, l[0], inv[0]), div_rn(e0.y, l[0], inv[0])),
            pack_bf16(div_rn(e1.x, l[1], inv[1]), div_rn(e1.y, l[1], inv[1])),
            pack_bf16(div_rn(e2.x, l[0], inv[0]), div_rn(e2.y, l[0], inv[0])),
            pack_bf16(div_rn(e3.x, l[1], inv[1]), div_rn(e3.y, l[1], inv[1]))};
#pragma unroll
        for (int nn = 0; nn < NO / 2; ++nn) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, vt + kt * 16 * LD + bt_off(lane, LD) + nn * 16);
          mma_bf16(o[2 * nn], pa, vb[0], vb[1]);
          mma_bf16(o[2 * nn + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();        // every warp is done with V chunk n's buffer
    if (n + 2 < chunks)
      load_rows_async<HD>(sv + (n & 1) * kChunk * LD, vbase, stv.s, (n + 2) * kChunk, kChunk, s,
                          tid, nth);
    cp_async_commit();
  }
  // the output: both warps' columns into a 16-row stage in the tile's Q^T
  // space (free since the walk), then out with 16-byte stores
  bf16* stage = reinterpret_cast<bf16*>(qt);
  if (active) {
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int c = half * (HD / 2) + 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(stage + g * LD + c) = pack_bf16(o[j][0], o[j][1]);
      *reinterpret_cast<uint32_t*>(stage + (g + 8) * LD + c) = pack_bf16(o[j][2], o[j][3]);
    }
  }
  __syncthreads();
  if (!active) return;
  bf16* ob = out + b * sto.b + h * sto.h;
  for (int i = pl; i < 16 * CH; i += 64) {
    const int r = i / CH, c = i - r * CH, row = row0 + r;
    if (row < s)
      *reinterpret_cast<uint4*>(ob + row * sto.s + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * LD + c * 8);
  }
}

// Forward, logit rows in shared memory: one item a block
template <int HD>
__global__ void __launch_bounds__(64 * kFwdTiles, 2)
tiled_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const float* __restrict__ mask,
              const float* __restrict__ kpm, bf16* __restrict__ out, Strides stq,
              Strides stk, Strides stv, Strides sto, int heads, int s, int per_bh,
              float scale) {
  fwd_mma_item<HD, false>(q, k, v, mask, kpm, out, stq, stk, stv, sto, heads, s, per_bh,
                          scale, 0, nullptr);
}

// Forward, logit rows in device memory (S past what shared memory holds): a
// persistent grid over the items, block i's rows in slot i of rows
// (kRowsTiles tiles of 16 rows of logit_ld(s) floats)
template <int HD>
__global__ void __launch_bounds__(64 * kRowsTiles, 2 * kFwdTiles / kRowsTiles)
tiled_fwd_mma_rows(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ mask,
                   const float* __restrict__ kpm, bf16* __restrict__ out, Strides stq,
                   Strides stk, Strides stv, Strides sto, int heads, int s, int per_bh,
                   int items, float* __restrict__ rows, float scale) {
  for (unsigned item = blockIdx.x; item < (unsigned)items; item += gridDim.x) {
    __syncthreads();   // the last item's stage and sums are read
    fwd_mma_item<HD, true>(q, k, v, mask, kpm, out, stq, stk, stv, sto, heads, s, per_bh,
                           scale, item, rows);
  }
}

// x (16 x 16) = the warp's 16 rows (A fragments a, k = hd) against the 16 rows
// of a bf16 tile bt (leading dimension HD + 8): S, S^T or dW, on mma with
// fp32 sums, in k order from 0
template <int HD>
__device__ __forceinline__ void rows_dot(float (&x)[2][4], const uint32_t (&a)[HD / 16][4],
                                         const bf16* bt, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t kb[4];
    ldsm_x4(kb, bt + b_off(lane, HD + 8) + kk * 16);
    mma_bf16(x[0], a[kk], kb[0], kb[1]);
    mma_bf16(x[1], a[kk], kb[2], kb[3]);
  }
}

// acc (the warp's 16 rows x HD) += X B: X the warp's 16 x 16 fp32 tile x in
// accumulator layout, as the A operand (k = its 16 columns) in NP bf16 pieces,
// smallest first; B the 16 x HD bf16 tile bt (rows = k) through ldmatrix.trans
template <int HD, int NP>
__device__ __forceinline__ void pieces_product(float (&acc)[HD / 8][4], const float (&x)[2][4],
                                               const bf16* bt, int lane) {
  uint32_t p0[NP], p1[NP], p2[NP], p3[NP];
  split_pair<NP>(x[0][0], x[0][1], p0);
  split_pair<NP>(x[0][2], x[0][3], p1);
  split_pair<NP>(x[1][0], x[1][1], p2);
  split_pair<NP>(x[1][2], x[1][3], p3);
#pragma unroll
  for (int nn = 0; nn < HD / 16; ++nn) {
    uint32_t bb[4];
    ldsm_x4_trans(bb, bt + bt_off(lane, HD + 8) + nn * 16);
#pragma unroll
    for (int p = NP - 1; p >= 0; --p) {
      const uint32_t a[4] = {p0[p], p1[p], p2[p], p3[p]};
      mma_bf16(acc[2 * nn], a, bb[0], bb[1]);
      mma_bf16(acc[2 * nn + 1], a, bb[2], bb[3]);
    }
  }
}

// acc += part, element by element in rounded fp32, and part back to 0
template <int CH>
__device__ __forceinline__ void fold(float (&acc)[CH][4], float (&part)[CH][4]) {
#pragma unroll
  for (int j = 0; j < CH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[j][e] += part[j][e];
      part[j][e] = 0.f;
    }
}

// A warp's two 16-row tiles (rows row0.. of x and of y) by cp.async into
// stage and stage + 16 (HD + 8), joined to the caller's next group
template <int HD>
__device__ __forceinline__ void load_pair_rows(bf16* stage, const bf16* x, Strides sx,
                                               const bf16* y, Strides sy, int b, int h,
                                               int row0, int s, int lane) {
  load_rows_async<HD>(stage, x + b * sx.b + h * sx.h, sx.s, row0, 16, s, lane, 32);
  load_rows_async<HD>(stage + 16 * (HD + 8), y + b * sy.b + h * sy.h, sy.s, row0, 16, s, lane,
                      32);
}

template <int HD>
__device__ __forceinline__ void a_frags(uint32_t (&a)[HD / 16][4], const bf16* tile,
                                        int lane) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) ldsm_x4(a[kk], tile + a_off(lane, HD + 8) + kk * 16);
}

// Backward 1: per query tile, one walk over K and V: S and dW on mma, and
// per thread, for each of its two rows, the running max, the sum of
// exp(logit - max) and of exp(logit - max) dW, rescaled as the max grows;
// the quad's values then join under the row's max. Into the scratch go m,
// l, 1 / l (rounded, as every later launch divides by it) and
// D = (sum_j exp(logit - m) dW) / l. A row with every key masked keeps
// m = -inf, so that w is NaN there in launches 2 and 3.
template <int HD>
__global__ void __launch_bounds__(32 * kMmaWarps)
tiled_bwd_stats_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ mask,
                    const float* __restrict__ kpm, const bf16* __restrict__ dout,
                    float* __restrict__ stats, Strides stq, Strides stk, Strides stv,
                    Strides sto, int bhs, int heads, int s, int per_bh, float scale) {
  constexpr int LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* stage = reinterpret_cast<bf16*>(smem_raw);
  bf16* sbuf = stage + kMmaWarps * 2 * 16 * LD;     // two chunks of (K, V)
  const int bh = blockIdx.x / per_bh, b = bh / heads, h = bh - b * heads;
  const int tid = threadIdx.x, nth = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tile = (blockIdx.x - bh * per_bh) * kMmaWarps + warp, row0 = tile * 16;
  const bool active = row0 < s;
  const bf16* kbase = k + b * stk.b + h * stk.h;
  const bf16* vbase = v + b * stv.b + h * stv.h;
  const int chunks = (s + kChunk - 1) / kChunk;
  bf16* my = stage + warp * 2 * 16 * LD;
  auto fetch = [&](int n) {
    if (n < chunks) {
      bf16* buf = sbuf + (n & 1) * 2 * kChunk * LD;
      load_rows_async<HD>(buf, kbase, stk.s, n * kChunk, kChunk, s, tid, nth);
      load_rows_async<HD>(buf + kChunk * LD, vbase, stv.s, n * kChunk, kChunk, s, tid, nth);
    }
    cp_async_commit();
  };
  load_pair_rows<HD>(my, q, stq, dout, sto, b, h, row0, s, lane);
  fetch(0);
  fetch(1);

  uint32_t qa[HD / 16][4], da[HD / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, d[2] = {0.f, 0.f};
  for (int n = 0; n < chunks; ++n) {
    cp_async_wait_group<1>();
    __syncthreads();
    if (active) {
      if (n == 0) {
        a_frags<HD>(qa, my, lane);
        a_frags<HD>(da, my + 16 * LD, lane);
      }
      const bf16* sk = sbuf + (n & 1) * 2 * kChunk * LD;
      const bf16* sv = sk + kChunk * LD;
      const int k0 = n * kChunk, tiles = min(kChunk / 16, (s - k0 + 15) / 16);
      for (int kt = 0; kt < tiles; ++kt) {
        float x[2][4], y[2][4];
        rows_dot<HD>(x, qa, sk + kt * 16 * LD, lane);
        rows_dot<HD>(y, da, sv + kt * 16 * LD, lane);
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            x[j][e] = logit_at(x[j][e], row0 + g + 8 * (e >> 1),
                               k0 + kt * 16 + 8 * j + 2 * t + (e & 1), s, b, scale, mask, kpm);
            mx[e >> 1] = fmaxf(mx[e >> 1], x[j][e]);
          }
        float mu[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {   // rescale to the new max (-inf: nothing yet)
          mu[r] = mx[r] == -INFINITY ? 0.f : mx[r];
          const float rs = expf(m[r] - mu[r]);
          l[r] *= rs;
          d[r] *= rs;
          m[r] = mx[r];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float ex = expf(x[j][e] - mu[e >> 1]);
            l[e >> 1] += ex;
            d[e >> 1] = fmaf(ex, y[j][e], d[e >> 1]);
          }
      }
    }
    __syncthreads();
    fetch(n + 2);
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mm = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, 2));
    const float sc = expf(m[r] - (mm == -INFINITY ? 0.f : mm));
    float lt = l[r] * sc, dt = d[r] * sc;
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    dt += __shfl_xor_sync(0xffffffffu, dt, 1);
    dt += __shfl_xor_sync(0xffffffffu, dt, 2);
    const int row = row0 + g + 8 * r;
    if (t == 0 && row < s) {
      const long long at = (long long)bh * s + row, plane = (long long)bhs * s;
      stats[at] = mm;
      stats[plane + at] = lt;
      stats[2 * plane + at] = __frcp_rn(lt);
      stats[3 * plane + at] = dt / lt;
    }
  }
}

// w = exp(logit - m) / l (0 for padded query rows; inv = 1 / l rounded) and
// dlog = w (dW - D), in place of the logits x and dW y; the same
// instructions in launches 2 and 3, so w is bit-equal between them
__device__ __forceinline__ void grad_pair(float& x, float& y, int r, int c, int s, int b,
                                          float scale, const float* __restrict__ mask,
                                          const float* __restrict__ kpm, float m, float l,
                                          float inv, float dd) {
  const float w =
      r < s ? div_rn(expf(logit_at(x, r, c, s, b, scale, mask, kpm) - m), l, inv) : 0.f;
  x = w;
  y = w * (y - dd);
}

// Backward 2: per key tile (the warp's 16 keys as the A operand), over the
// query chunks: S^T = K Q^T, dW^T = V dO^T, then dV += W^T dO and
// dK += dlog^T Q, W and dlog in pieces from the accumulators (with CHUNKS,
// each chunk's sums apart first)
template <int HD, bool CHUNKS>
__global__ void __launch_bounds__(32 * kMmaWarps)
tiled_bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ mask,
                   const float* __restrict__ kpm, const bf16* __restrict__ dout,
                   const float* __restrict__ stats, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, Strides stq, Strides stk, Strides stv, Strides sto,
                   Strides sdk, Strides sdv, int bhs, int heads, int s, int per_bh,
                   float scale) {
  constexpr int LD = HD + 8, CH = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* stage = reinterpret_cast<bf16*>(smem_raw);
  bf16* sbuf = stage + kMmaWarps * 2 * 16 * LD;                 // two chunks of (Q, dO)
  float* sst = reinterpret_cast<float*>(sbuf + 2 * 2 * kChunk * LD);   // two of (m, l, 1/l, D)
  const int bh = blockIdx.x / per_bh, b = bh / heads, h = bh - b * heads;
  const int tid = threadIdx.x, nth = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tile = (blockIdx.x - bh * per_bh) * kMmaWarps + warp, key0 = tile * 16;
  const bool active = key0 < s;
  const bf16* qbase = q + b * stq.b + h * stq.h;
  const bf16* dbase = dout + b * sto.b + h * sto.h;
  const int chunks = (s + kChunk - 1) / kChunk;
  bf16* my = stage + warp * 2 * 16 * LD;
  auto fetch = [&](int n) {
    if (n < chunks) {
      bf16* buf = sbuf + (n & 1) * 2 * kChunk * LD;
      load_rows_async<HD>(buf, qbase, stq.s, n * kChunk, kChunk, s, tid, nth);
      load_rows_async<HD>(buf + kChunk * LD, dbase, sto.s, n * kChunk, kChunk, s, tid, nth);
      float* st = sst + (n & 1) * 4 * kChunk;   // m, l, 1 / l, D; 0 past s
      for (int i = tid; i < 4 * kChunk; i += nth) {
        const int a = i / kChunk, row = n * kChunk + i - a * kChunk;
        const bool ok = row < s;
        cp_async4(st + i, ok ? stats + (a * (long long)bhs + bh) * s + row : stats, ok);
      }
    }
    cp_async_commit();
  };
  load_pair_rows<HD>(my, k, stk, v, stv, b, h, key0, s, lane);
  fetch(0);
  fetch(1);

  uint32_t ka[HD / 16][4], va[HD / 16][4];
  float av[CH][4], ak[CH][4], cv[CH][4], ck[CH][4];   // totals, a chunk's sums
#pragma unroll
  for (int j = 0; j < CH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) av[j][e] = ak[j][e] = cv[j][e] = ck[j][e] = 0.f;
  for (int n = 0; n < chunks; ++n) {
    cp_async_wait_group<1>();
    __syncthreads();
    if (active) {
      if (n == 0) {
        a_frags<HD>(ka, my, lane);
        a_frags<HD>(va, my + 16 * LD, lane);
      }
      const bf16* sq = sbuf + (n & 1) * 2 * kChunk * LD;
      const bf16* sdo = sq + kChunk * LD;
      const float* st = sst + (n & 1) * 4 * kChunk;
      const int tiles = min(kChunk / 16, (s - n * kChunk + 15) / 16);
      for (int qt = 0; qt < tiles; ++qt) {
        float x[2][4], y[2][4];
        rows_dot<HD>(x, ka, sq + qt * 16 * LD, lane);    // S^T: rows keys, columns queries
        rows_dot<HD>(y, va, sdo + qt * 16 * LD, lane);   // dW^T
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = qt * 16 + 8 * j + 2 * t + (e & 1);
            grad_pair(x[j][e], y[j][e], n * kChunk + qc, key0 + g + 8 * (e >> 1), s, b, scale,
                      mask, kpm, st[qc], st[kChunk + qc], st[2 * kChunk + qc],
                      st[3 * kChunk + qc]);
          }
        pieces_product<HD, kPieces>(CHUNKS ? cv : av, x, sdo + qt * 16 * LD, lane);
        pieces_product<HD, kPieces>(CHUNKS ? ck : ak, y, sq + qt * 16 * LD, lane);
      }
      if (CHUNKS) {
        fold(av, cv);
        fold(ak, ck);
      }
    }
    __syncthreads();
    fetch(n + 2);
  }
  if (!active) return;
  store_tile<HD>(dv + b * sdv.b + h * sdv.h, sdv.s, av, 1.f, my, key0, s, lane);
  store_tile<HD>(dk + b * sdk.b + h * sdk.h, sdk.s, ak, scale, my, key0, s, lane);
}

// Backward 3: per query tile, over the key chunks: S, dW, then dQ += dlog K
// with dlog in pieces from the accumulators (with CHUNKS, each chunk's sums
// apart first)
template <int HD, bool CHUNKS>
__global__ void __launch_bounds__(32 * kMmaWarps)
tiled_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ mask,
                 const float* __restrict__ kpm, const bf16* __restrict__ dout,
                 const float* __restrict__ stats, bf16* __restrict__ dq, Strides stq,
                 Strides stk, Strides stv, Strides sto, Strides sdq, int bhs, int heads, int s,
                 int per_bh, float scale) {
  constexpr int LD = HD + 8, CH = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* stage = reinterpret_cast<bf16*>(smem_raw);
  bf16* sbuf = stage + kMmaWarps * 2 * 16 * LD;     // two chunks of (K, V)
  const int bh = blockIdx.x / per_bh, b = bh / heads, h = bh - b * heads;
  const int tid = threadIdx.x, nth = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tile = (blockIdx.x - bh * per_bh) * kMmaWarps + warp, row0 = tile * 16;
  const bool active = row0 < s;
  const bf16* kbase = k + b * stk.b + h * stk.h;
  const bf16* vbase = v + b * stv.b + h * stv.h;
  const int chunks = (s + kChunk - 1) / kChunk;
  bf16* my = stage + warp * 2 * 16 * LD;
  auto fetch = [&](int n) {
    if (n < chunks) {
      bf16* buf = sbuf + (n & 1) * 2 * kChunk * LD;
      load_rows_async<HD>(buf, kbase, stk.s, n * kChunk, kChunk, s, tid, nth);
      load_rows_async<HD>(buf + kChunk * LD, vbase, stv.s, n * kChunk, kChunk, s, tid, nth);
    }
    cp_async_commit();
  };
  load_pair_rows<HD>(my, q, stq, dout, sto, b, h, row0, s, lane);
  fetch(0);
  fetch(1);

  float m[2], l[2], inv[2], dd[2];   // 0 past s, where w is 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    const long long at = (long long)bh * s + row, plane = (long long)bhs * s;
    m[r] = row < s ? stats[at] : 0.f;
    l[r] = row < s ? stats[plane + at] : 0.f;
    inv[r] = row < s ? stats[2 * plane + at] : 0.f;
    dd[r] = row < s ? stats[3 * plane + at] : 0.f;
  }
  uint32_t qa[HD / 16][4], da[HD / 16][4];
  float acc[CH][4], cacc[CH][4];   // the total, a chunk's sums
#pragma unroll
  for (int j = 0; j < CH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = cacc[j][e] = 0.f;
  for (int n = 0; n < chunks; ++n) {
    cp_async_wait_group<1>();
    __syncthreads();
    if (active) {
      if (n == 0) {
        a_frags<HD>(qa, my, lane);
        a_frags<HD>(da, my + 16 * LD, lane);
      }
      const bf16* sk = sbuf + (n & 1) * 2 * kChunk * LD;
      const bf16* sv = sk + kChunk * LD;
      const int tiles = min(kChunk / 16, (s - n * kChunk + 15) / 16);
      for (int kt = 0; kt < tiles; ++kt) {
        float x[2][4], y[2][4];
        rows_dot<HD>(x, qa, sk + kt * 16 * LD, lane);
        rows_dot<HD>(y, da, sv + kt * 16 * LD, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            grad_pair(x[j][e], y[j][e], row0 + g + 8 * r,
                      n * kChunk + kt * 16 + 8 * j + 2 * t + (e & 1), s, b, scale, mask, kpm,
                      m[r], l[r], inv[r], dd[r]);
          }
        pieces_product<HD, kPieces>(CHUNKS ? cacc : acc, y, sk + kt * 16 * LD, lane);
      }
      if (CHUNKS) fold(acc, cacc);
    }
    __syncthreads();
    fetch(n + 2);
  }
  if (active) store_tile<HD>(dq + b * sdq.b + h * sdq.h, sdq.s, acc, scale, my, row0, s, lane);
}

// ------------------------------------------- fp32 on the tensor cores, 3xTF32

// x rounded to tf32 (10 explicit mantissa bits), to nearest with ties away
// from zero, as the bit pattern mma takes
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + (what lo drops), hi = cvt.rna.tf32(x) and
// lo = cvt.rna.tf32(x - hi); x - hi is exact in fp32. hi is formed on the
// integer units, (bits + 0x1000) with the low 13 bits cleared, which is
// cvt.rna's value for every finite x at a fraction of the conversion's
// cost; a NaN x gives hi = -0 there, and lo keeps the NaN.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += a (16 x 8, row) * b (8 x 8, col), tf32 products, fp32 sums; not
// volatile, so that independent products interleave
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32: a_lo b_hi, a_hi b_lo, a_hi b_hi, in that order. With
// SWAP the two cross terms trade places, so that S^T = K Q^T (a = K) chains
// the same three products in the same order as S = Q K^T (a = Q).
template <bool SWAP>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if (SWAP) {
    mma_tf32(c, ah, bl[0], bl[1]);
    mma_tf32(c, al, bh[0], bh[1]);
  } else {
    mma_tf32(c, al, bh[0], bh[1]);
    mma_tf32(c, ah, bl[0], bl[1]);
  }
  mma_tf32(c, ah, bh[0], bh[1]);
}

// The A operand (16 x 8) at rows 0.., columns 0.. of an fp32 tile (leading
// dimension LD), split
template <int LD>
__device__ __forceinline__ void a_tf32(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* tile,
                                       int g, int t) {
  split_tf32(tile[g * LD + t], hi[0], lo[0]);
  split_tf32(tile[(g + 8) * LD + t], hi[1], lo[1]);
  split_tf32(tile[g * LD + t + 4], hi[2], lo[2]);
  split_tf32(tile[(g + 8) * LD + t + 4], hi[3], lo[3]);
}

// The A operand from a 16 x 8 accumulator tile x (rows g, g + 8, columns
// 2t, 2t + 1), split, with k slot t holding column 2t and slot t + 4 column
// 2t + 1: the accumulator layout is then the operand layout, and the B side
// takes its k rows in the same slots (b_krows_tf32)
__device__ __forceinline__ void a_acc_tf32(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                           const float (&x)[4]) {
  split_tf32(x[0], hi[0], lo[0]);
  split_tf32(x[2], hi[1], lo[1]);
  split_tf32(x[1], hi[2], lo[2]);
  split_tf32(x[3], hi[3], lo[3]);
}

// The B operand (k x n = 8 x 8) from 8 rows n of a tile whose rows run
// along k (B = tile^T: K for S = Q K^T), split
template <int LD>
__device__ __forceinline__ void b_rows_tf32(uint32_t (&hi)[2], uint32_t (&lo)[2],
                                            const float* tile, int g, int t) {
  split_tf32(tile[g * LD + t], hi[0], lo[0]);
  split_tf32(tile[g * LD + t + 4], hi[1], lo[1]);
}

// The B operand from 8 k rows of a tile whose rows run along n (V for P V),
// k slot t holding row 2t and slot t + 4 row 2t + 1 (a_acc_tf32's slots),
// split
template <int LD>
__device__ __forceinline__ void b_krows_tf32(uint32_t (&hi)[2], uint32_t (&lo)[2],
                                             const float* tile, int g, int t) {
  split_tf32(tile[2 * t * LD + g], hi[0], lo[0]);
  split_tf32(tile[(2 * t + 1) * LD + g], hi[1], lo[1]);
}

// x[j] = the 16 rows of a (the A operand, k = hd) against rows 8 j .. 8 j + 7
// of b, and y[j] likewise of c against d: S and dW (or S^T and dW^T, SWAP),
// in 3xTF32 chained over hd in order from 0. Straight-line code with no
// guard, so that the products of the 2 NT independent sums interleave.
template <int HD, int NT, bool SWAP>
__device__ __forceinline__ void rows_dot2_tf32(float (&x)[NT][4], float (&y)[NT][4],
                                               const float* a, const float* b, const float* c,
                                               const float* d, int g, int t) {
  constexpr int LD = HD + 4;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = y[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    uint32_t ah[4], al[4], ch[4], cl[4];
    a_tf32<LD>(ah, al, a + 8 * kk, g, t);
    a_tf32<LD>(ch, cl, c + 8 * kk, g, t);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bh[2], bl[2], dh[2], dl[2];
      b_rows_tf32<LD>(bh, bl, b + 8 * j * LD + 8 * kk, g, t);
      b_rows_tf32<LD>(dh, dl, d + 8 * j * LD + 8 * kk, g, t);
      mma3<SWAP>(x[j], ah, al, bh, bl);
      mma3<SWAP>(y[j], ch, cl, dh, dl);
    }
  }
}

// x[j] = S alone, as rows_dot2_tf32 forms it
template <int HD, int NT>
__device__ __forceinline__ void rows_dot_tf32(float (&x)[NT][4], const float* a, const float* b,
                                              int g, int t) {
  constexpr int LD = HD + 4;
#pragma unroll
  for (int j = 0; j < NT; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    uint32_t ah[4], al[4];
    a_tf32<LD>(ah, al, a + 8 * kk, g, t);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bh[2], bl[2];
      b_rows_tf32<LD>(bh, bl, b + 8 * j * LD + 8 * kk, g, t);
      mma3<false>(x[j], ah, al, bh, bl);
    }
  }
}

// acc (16 rows x HD) += X B for a 16 x 8 slice X of an accumulator tile
// (a_acc_tf32) and the 8 k rows of b (b_krows_tf32): each n-tile's three mma
// sums formed from zero, then added to acc in rounded fp32
template <int HD>
__device__ __forceinline__ void acc_product_tf32(float (&acc)[HD / 8][4], const float (&x)[4],
                                                 const float* b, int g, int t) {
  constexpr int LD = HD + 4;
  uint32_t xh[4], xl[4];
  a_acc_tf32(xh, xl, x);
#pragma unroll
  for (int nn = 0; nn < HD / 8; ++nn) {
    uint32_t bh[2], bl[2];
    b_krows_tf32<LD>(bh, bl, b + 8 * nn, g, t);
    float p[4] = {0.f, 0.f, 0.f, 0.f};
    mma3<false>(p, xh, xl, bh, bl);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nn][e] += p[e];
  }
}

// rows [row0, row0 + rows) of one (batch, head) of a strided fp32 tensor
// (base at the (batch, head)) into a tile with leading dimension HD + 4, by
// cp.async; rows >= s and columns >= hd are zero-filled. 16-byte copies when
// hd is a multiple of 4 (rows then start on 16 bytes: ops/attention.py:
// kernel_strides), else 4-byte ones
template <int HD>
__device__ __forceinline__ void load_f32_async(float* dst, const float* base, long long st_s,
                                               int row0, int rows, int s, int hd, int tid,
                                               int nthreads) {
  constexpr int LD = HD + 4;
  if ((hd & 3) == 0) {
    constexpr int CH = HD / 4;
    for (int i = tid; i < rows * CH; i += nthreads) {
      const int r = i / CH, c = 4 * (i - r * CH), row = row0 + r;
      const bool ok = row < s && c < hd;
      cp_async16(dst + r * LD + c, ok ? base + row * st_s + c : base, ok);
    }
  } else {
    for (int i = tid; i < rows * HD; i += nthreads) {
      const int r = i / HD, c = i - r * HD, row = row0 + r;
      const bool ok = row < s && c < hd;
      cp_async4(dst + r * LD + c, ok ? base + row * st_s + c : base, ok);
    }
  }
}

// A warp's 16 x HD fp32 accumulators (times mul) into rows row0.. (< s),
// columns < hd, of dst (at the (batch, head))
template <int HD>
__device__ __forceinline__ void store_f32(float* dst, long long st_s,
                                          const float (&acc)[HD / 8][4], const float (&mul)[2],
                                          int row0, int s, int hd, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= s) continue;
#pragma unroll
    for (int nn = 0; nn < HD / 8; ++nn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * nn + 2 * t + e;
        if (c < hd) dst[row * st_s + c] = acc[nn][2 * r + e] * mul[r];
      }
  }
}

// the logits of the warp's rows row0 + g (+ 8) against keys k0 + 8 j + 2 t
// (+ 1) in place of the dots x, and each row's max over them and m
template <int N>
__device__ __forceinline__ void chunk_logits(float (&x)[N][4], float (&mx)[2],
                                             const float (&m)[2], int row0, int k0, int s,
                                             int b, float scale, const float* __restrict__ mask,
                                             const float* __restrict__ kpm, int g, int t) {
  mx[0] = m[0];
  mx[1] = m[1];
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[j][e] = logit_at(x[j][e], row0 + g + 8 * (e >> 1), k0 + 8 * j + 2 * t + (e & 1), s, b,
                           scale, mask, kpm);
        mx[e >> 1] = fmaxf(mx[e >> 1], x[j][e]);
      }
#pragma unroll
  for (int r = 0; r < 2; ++r) {   // over the quad that shares the row
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
}

// One key chunk of the forward (N n-tiles of 8 keys from k0: 8, or 2 for a
// last chunk of at most 16 keys): S on mma, the logits, the online softmax's
// rescale, then P V added to o, P unnormalised
template <int HD, int N>
__device__ __forceinline__ void fwd_chunk_tf32(float (&o)[HD / 8][4], float (&m)[2],
                                               float (&l)[2], const float* myq, const float* sk,
                                               const float* sv, int row0, int k0, int s, int b,
                                               float scale, const float* __restrict__ mask,
                                               const float* __restrict__ kpm, int g, int t) {
  constexpr int LD = HD + 4;
  float x[N][4], mx[2], mu[2];
  rows_dot_tf32<HD, N>(x, myq, sk, g, t);
  chunk_logits<N>(x, mx, m, row0, k0, s, b, scale, mask, kpm, g, t);
#pragma unroll
  for (int r = 0; r < 2; ++r) {   // rescale to the new max (-inf: nothing yet)
    mu[r] = mx[r] == -INFINITY ? 0.f : mx[r];
    const float rs = expf(m[r] - mu[r]);
    l[r] *= rs;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[j][2 * r] *= rs;
      o[j][2 * r + 1] *= rs;
    }
    m[r] = mx[r];
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[j][e] = expf(x[j][e] - mu[e >> 1]);
      l[e >> 1] += x[j][e];
    }
    acc_product_tf32<HD>(o, x[j], sv + 8 * j * LD, g, t);   // P V, P unnormalised
  }
}

// the n-tiles of 8 keys a chunk from k0 needs: 8, or 2 for a last chunk of
// at most 16 keys (keys past s give -inf logits and zero rows)
__device__ __forceinline__ bool whole_chunk(int s, int k0) { return s - k0 > 16; }

// Forward: block blockIdx.x holds 128 query rows of one (batch, head),
// per_bh blocks to it, a warp to each 16-row tile; one walk over the key
// chunks (see the file's head)
template <int HD>
__global__ void __launch_bounds__(32 * kTfFwdWarps, HD == 128 ? 1 : 2)
tiled_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ mask,
               const float* __restrict__ kpm, float* __restrict__ out, Strides stq,
               Strides stk, Strides stv, Strides sto, int heads, int s, int hd, int per_bh,
               float scale) {
  constexpr int LD = HD + 4, NO = HD / 8, ROWS = kTfFwdWarps * 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);   // the block's Q rows
  float* sbuf = sq + ROWS * LD;                       // two chunks of (K, V)
  const int bh = blockIdx.x / per_bh, b = bh / heads, h = bh - b * heads;
  const int tid = threadIdx.x, nth = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int blk0 = (blockIdx.x - bh * per_bh) * ROWS, row0 = blk0 + warp * 16;
  const bool active = row0 < s;
  const float* kbase = k + b * stk.b + h * stk.h;
  const float* vbase = v + b * stv.b + h * stv.h;
  const int chunks = (s + kChunk - 1) / kChunk;
  auto fetch = [&](int n) {
    if (n < chunks) {
      float* buf = sbuf + (n & 1) * 2 * kChunk * LD;
      load_f32_async<HD>(buf, kbase, stk.s, n * kChunk, kChunk, s, hd, tid, nth);
      load_f32_async<HD>(buf + kChunk * LD, vbase, stv.s, n * kChunk, kChunk, s, hd, tid, nth);
    }
    cp_async_commit();
  };
  load_f32_async<HD>(sq, q + b * stq.b + h * stq.h, stq.s, blk0, ROWS, s, hd, tid,
                     nth);   // joins chunk 0's group
  fetch(0);
  fetch(1);

  const float* myq = sq + warp * 16 * LD;
  float o[NO][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  for (int n = 0; n < chunks; ++n) {
    cp_async_wait_group<1>();
    __syncthreads();
    if (active) {
      const float* sk = sbuf + (n & 1) * 2 * kChunk * LD;
      const float* sv = sk + kChunk * LD;
      const int k0 = n * kChunk;
      if (whole_chunk(s, k0))
        fwd_chunk_tf32<HD, kChunk / 8>(o, m, l, myq, sk, sv, row0, k0, s, b, scale, mask, kpm,
                                       g, t);
      else
        fwd_chunk_tf32<HD, 2>(o, m, l, myq, sk, sv, row0, k0, s, b, scale, mask, kpm, g, t);
    }
    __syncthreads();
    fetch(n + 2);
  }
  if (!active) return;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];   // an all-masked row: l = 0 and o = 0, so NaN
  }
  store_f32<HD>(out + b * sto.b + h * sto.h, sto.s, o, inv, row0, s, hd, g, t);
}

// One key chunk of backward launch 1: S and dW on mma, then per thread the
// running max, sum and sum of exp(logit - max) dW, rescaled as the max grows
template <int HD, int N>
__device__ __forceinline__ void stats_chunk_tf32(float (&m)[2], float (&l)[2], float (&d)[2],
                                                 const float* myq, const float* mydo,
                                                 const float* sk, const float* sv, int row0,
                                                 int k0, int s, int b, float scale,
                                                 const float* __restrict__ mask,
                                                 const float* __restrict__ kpm, int g, int t) {
  float x[N][4], y[N][4], mx[2], mu[2];
  rows_dot2_tf32<HD, N, false>(x, y, myq, sk, mydo, sv, g, t);
  chunk_logits<N>(x, mx, m, row0, k0, s, b, scale, mask, kpm, g, t);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mu[r] = mx[r] == -INFINITY ? 0.f : mx[r];
    const float rs = expf(m[r] - mu[r]);
    l[r] *= rs;
    d[r] *= rs;
    m[r] = mx[r];
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float ex = expf(x[j][e] - mu[e >> 1]);
      l[e >> 1] += ex;
      d[e >> 1] = fmaf(ex, y[j][e], d[e >> 1]);
    }
}

// Backward 1: per query tile, one walk over K and V: S and dW on mma, and
// per thread, for each of its two rows, the running max, the sum of
// exp(logit - max) and of exp(logit - max) dW, rescaled as the max grows
// (the max is the row's, taken over the quad each chunk). Into the scratch
// go m, l, 1 / l and D = (sum_j exp(logit - m) dW) / l, as in bf16.
template <int HD>
__global__ void __launch_bounds__(32 * kMmaWarps)
tiled_bwd_stats_tf32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ mask,
                     const float* __restrict__ kpm, const float* __restrict__ dout,
                     float* __restrict__ stats, Strides stq, Strides stk, Strides stv,
                     Strides sto, int bhs, int heads, int s, int hd, int per_bh, float scale) {
  constexpr int LD = HD + 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);   // the block's 64 Q rows, then dO's
  float* sdo = sq + kMmaWarps * 16 * LD;
  float* sbuf = sdo + kMmaWarps * 16 * LD;            // two chunks of (K, V)
  const int bh = blockIdx.x / per_bh, b = bh / heads, h = bh - b * heads;
  const int tid = threadIdx.x, nth = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int blk0 = (blockIdx.x - bh * per_bh) * kMmaWarps * 16, row0 = blk0 + warp * 16;
  const bool active = row0 < s;
  const float* kbase = k + b * stk.b + h * stk.h;
  const float* vbase = v + b * stv.b + h * stv.h;
  const int chunks = (s + kChunk - 1) / kChunk;
  auto fetch = [&](int n) {
    if (n < chunks) {
      float* buf = sbuf + (n & 1) * 2 * kChunk * LD;
      load_f32_async<HD>(buf, kbase, stk.s, n * kChunk, kChunk, s, hd, tid, nth);
      load_f32_async<HD>(buf + kChunk * LD, vbase, stv.s, n * kChunk, kChunk, s, hd, tid, nth);
    }
    cp_async_commit();
  };
  load_f32_async<HD>(sq, q + b * stq.b + h * stq.h, stq.s, blk0, kMmaWarps * 16, s, hd, tid, nth);
  load_f32_async<HD>(sdo, dout + b * sto.b + h * sto.h, sto.s, blk0, kMmaWarps * 16, s, hd, tid,
                     nth);
  fetch(0);
  fetch(1);

  const float* myq = sq + warp * 16 * LD;
  const float* mydo = sdo + warp * 16 * LD;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, d[2] = {0.f, 0.f};
  for (int n = 0; n < chunks; ++n) {
    cp_async_wait_group<1>();
    __syncthreads();
    if (active) {
      const float* sk = sbuf + (n & 1) * 2 * kChunk * LD;
      const float* sv = sk + kChunk * LD;
      const int k0 = n * kChunk;
      if (whole_chunk(s, k0))
        stats_chunk_tf32<HD, kChunk / 8>(m, l, d, myq, mydo, sk, sv, row0, k0, s, b, scale,
                                         mask, kpm, g, t);
      else
        stats_chunk_tf32<HD, 2>(m, l, d, myq, mydo, sk, sv, row0, k0, s, b, scale, mask, kpm,
                                g, t);
    }
    __syncthreads();
    fetch(n + 2);
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {   // m is the row's already: the quad's sums add
    float lt = l[r], dt = d[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    dt += __shfl_xor_sync(0xffffffffu, dt, 1);
    dt += __shfl_xor_sync(0xffffffffu, dt, 2);
    const int row = row0 + g + 8 * r;
    if (t == 0 && row < s) {
      const long long at = (long long)bh * s + row, plane = (long long)bhs * s;
      stats[at] = m[r];
      stats[plane + at] = lt;
      stats[2 * plane + at] = __frcp_rn(lt);
      stats[3 * plane + at] = dt / lt;
    }
  }
}

// Backward 2: per key tile (the warp's 16 keys as the A operand), over the
// query chunks, 32 queries at a time: S^T = K Q^T and dW^T = V dO^T (the
// cross terms swapped), w and dlog in place, then dV += W^T dO and
// dK += dlog^T Q
template <int HD>
__global__ void __launch_bounds__(32 * kMmaWarps)
tiled_bwd_dkdv_tf32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ mask,
                    const float* __restrict__ kpm, const float* __restrict__ dout,
                    const float* __restrict__ stats, float* __restrict__ dk,
                    float* __restrict__ dv, Strides stq, Strides stk, Strides stv, Strides sto,
                    Strides sdk, Strides sdv, int bhs, int heads, int s, int hd, int per_bh,
                    float scale) {
  constexpr int LD = HD + 4, NO = HD / 8, QS = 32;   // QS: queries a step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sk = reinterpret_cast<float*>(smem_raw);   // the block's 64 K rows, then V's
  float* sv = sk + kMmaWarps * 16 * LD;
  float* sbuf = sv + kMmaWarps * 16 * LD;             // two chunks of (Q, dO)
  float* sst = sbuf + 2 * 2 * kChunk * LD;            // two of (m, l, 1/l, D)
  const int bh = blockIdx.x / per_bh, b = bh / heads, h = bh - b * heads;
  const int tid = threadIdx.x, nth = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int blk0 = (blockIdx.x - bh * per_bh) * kMmaWarps * 16, key0 = blk0 + warp * 16;
  const bool active = key0 < s;
  const float* qbase = q + b * stq.b + h * stq.h;
  const float* dbase = dout + b * sto.b + h * sto.h;
  const int chunks = (s + kChunk - 1) / kChunk;
  auto fetch = [&](int n) {
    if (n < chunks) {
      float* buf = sbuf + (n & 1) * 2 * kChunk * LD;
      load_f32_async<HD>(buf, qbase, stq.s, n * kChunk, kChunk, s, hd, tid, nth);
      load_f32_async<HD>(buf + kChunk * LD, dbase, sto.s, n * kChunk, kChunk, s, hd, tid, nth);
      float* st = sst + (n & 1) * 4 * kChunk;   // m, l, 1 / l, D; 0 past s
      for (int i = tid; i < 4 * kChunk; i += nth) {
        const int a = i / kChunk, row = n * kChunk + i - a * kChunk;
        const bool ok = row < s;
        cp_async4(st + i, ok ? stats + (a * (long long)bhs + bh) * s + row : stats, ok);
      }
    }
    cp_async_commit();
  };
  load_f32_async<HD>(sk, k + b * stk.b + h * stk.h, stk.s, blk0, kMmaWarps * 16, s, hd, tid, nth);
  load_f32_async<HD>(sv, v + b * stv.b + h * stv.h, stv.s, blk0, kMmaWarps * 16, s, hd, tid, nth);
  fetch(0);
  fetch(1);

  const float* myk = sk + warp * 16 * LD;
  const float* myv = sv + warp * 16 * LD;
  float av[NO][4], ak[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) av[j][e] = ak[j][e] = 0.f;
  for (int n = 0; n < chunks; ++n) {
    cp_async_wait_group<1>();
    __syncthreads();
    if (active) {
      const float* sq = sbuf + (n & 1) * 2 * kChunk * LD;
      const float* sdo = sq + kChunk * LD;
      const float* st = sst + (n & 1) * 4 * kChunk;
      const int steps = (min(s - n * kChunk, kChunk) + QS - 1) / QS;
      for (int qs = 0; qs < steps; ++qs) {
        float x[QS / 8][4], y[QS / 8][4];   // S^T, dW^T
        rows_dot2_tf32<HD, QS / 8, true>(x, y, myk, sq + qs * QS * LD, myv, sdo + qs * QS * LD,
                                         g, t);
#pragma unroll
        for (int j = 0; j < QS / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = qs * QS + 8 * j + 2 * t + (e & 1);
            grad_pair(x[j][e], y[j][e], n * kChunk + qc, key0 + g + 8 * (e >> 1), s, b, scale,
                      mask, kpm, st[qc], st[kChunk + qc], st[2 * kChunk + qc],
                      st[3 * kChunk + qc]);
          }
#pragma unroll
        for (int j = 0; j < QS / 8; ++j) {
          acc_product_tf32<HD>(av, x[j], sdo + (qs * QS + 8 * j) * LD, g, t);   // W^T dO
          acc_product_tf32<HD>(ak, y[j], sq + (qs * QS + 8 * j) * LD, g, t);    // dlog^T Q
        }
      }
    }
    __syncthreads();
    fetch(n + 2);
  }
  if (!active) return;
  const float one[2] = {1.f, 1.f}, sc[2] = {scale, scale};
  store_f32<HD>(dv + b * sdv.b + h * sdv.h, sdv.s, av, one, key0, s, hd, g, t);
  store_f32<HD>(dk + b * sdk.b + h * sdk.h, sdk.s, ak, sc, key0, s, hd, g, t);
}

// One key chunk of backward launch 3: S and dW as in launch 1, w and dlog in
// place, then dQ += dlog K
template <int HD, int N>
__device__ __forceinline__ void dq_chunk_tf32(float (&acc)[HD / 8][4], const float (&m)[2],
                                              const float (&l)[2], const float (&inv)[2],
                                              const float (&dd)[2], const float* myq,
                                              const float* mydo, const float* sk,
                                              const float* sv, int row0, int k0, int s, int b,
                                              float scale, const float* __restrict__ mask,
                                              const float* __restrict__ kpm, int g, int t) {
  constexpr int LD = HD + 4;
  float x[N][4], y[N][4];
  rows_dot2_tf32<HD, N, false>(x, y, myq, sk, mydo, sv, g, t);
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      grad_pair(x[j][e], y[j][e], row0 + g + 8 * r, k0 + 8 * j + 2 * t + (e & 1), s, b, scale,
                mask, kpm, m[r], l[r], inv[r], dd[r]);
    }
#pragma unroll
  for (int j = 0; j < N; ++j) acc_product_tf32<HD>(acc, y[j], sk + 8 * j * LD, g, t);   // dlog K
}

// Backward 3: per query tile, over the key chunks: S and dW as in launch 1,
// w and dlog in place, then dQ += dlog K
template <int HD>
__global__ void __launch_bounds__(32 * kMmaWarps)
tiled_bwd_dq_tf32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ mask,
                  const float* __restrict__ kpm, const float* __restrict__ dout,
                  const float* __restrict__ stats, float* __restrict__ dq, Strides stq,
                  Strides stk, Strides stv, Strides sto, Strides sdq, int bhs, int heads, int s,
                  int hd, int per_bh, float scale) {
  constexpr int LD = HD + 4, NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);   // the block's 64 Q rows, then dO's
  float* sdo = sq + kMmaWarps * 16 * LD;
  float* sbuf = sdo + kMmaWarps * 16 * LD;            // two chunks of (K, V)
  const int bh = blockIdx.x / per_bh, b = bh / heads, h = bh - b * heads;
  const int tid = threadIdx.x, nth = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int blk0 = (blockIdx.x - bh * per_bh) * kMmaWarps * 16, row0 = blk0 + warp * 16;
  const bool active = row0 < s;
  const float* kbase = k + b * stk.b + h * stk.h;
  const float* vbase = v + b * stv.b + h * stv.h;
  const int chunks = (s + kChunk - 1) / kChunk;
  auto fetch = [&](int n) {
    if (n < chunks) {
      float* buf = sbuf + (n & 1) * 2 * kChunk * LD;
      load_f32_async<HD>(buf, kbase, stk.s, n * kChunk, kChunk, s, hd, tid, nth);
      load_f32_async<HD>(buf + kChunk * LD, vbase, stv.s, n * kChunk, kChunk, s, hd, tid, nth);
    }
    cp_async_commit();
  };
  load_f32_async<HD>(sq, q + b * stq.b + h * stq.h, stq.s, blk0, kMmaWarps * 16, s, hd, tid, nth);
  load_f32_async<HD>(sdo, dout + b * sto.b + h * sto.h, sto.s, blk0, kMmaWarps * 16, s, hd, tid,
                     nth);
  fetch(0);
  fetch(1);

  float m[2], l[2], inv[2], dd[2];   // 0 past s, where w is 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    const long long at = (long long)bh * s + row, plane = (long long)bhs * s;
    m[r] = row < s ? stats[at] : 0.f;
    l[r] = row < s ? stats[plane + at] : 0.f;
    inv[r] = row < s ? stats[2 * plane + at] : 0.f;
    dd[r] = row < s ? stats[3 * plane + at] : 0.f;
  }
  const float* myq = sq + warp * 16 * LD;
  const float* mydo = sdo + warp * 16 * LD;
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int n = 0; n < chunks; ++n) {
    cp_async_wait_group<1>();
    __syncthreads();
    if (active) {
      const float* sk = sbuf + (n & 1) * 2 * kChunk * LD;
      const float* sv = sk + kChunk * LD;
      const int k0 = n * kChunk;
      if (whole_chunk(s, k0))
        dq_chunk_tf32<HD, kChunk / 8>(acc, m, l, inv, dd, myq, mydo, sk, sv, row0, k0, s, b,
                                      scale, mask, kpm, g, t);
      else
        dq_chunk_tf32<HD, 2>(acc, m, l, inv, dd, myq, mydo, sk, sv, row0, k0, s, b, scale, mask,
                             kpm, g, t);
    }
    __syncthreads();
    fetch(n + 2);
  }
  const float sc[2] = {scale, scale};
  if (active) store_f32<HD>(dq + b * sdq.b + h * sdq.h, sdq.s, acc, sc, row0, s, hd, g, t);
}

// --------------------------------------------------------------- launchers

struct Args {
  const void *q, *k, *v, *dout;
  const float *mask, *kpm;
  void *out, *dq, *dk, *dv;
  float* stats;
  Strides st[7];   // q, k, v, then out (forward) or dout, dq, dk, dv (backward)
  int bh, heads, s, hd, device;
  float scale;
  cudaStream_t stream;
};

// blocks of `warps` 16-row tiles over each (batch, head)
int tf32_per_bh(int s, int warps) { return ((s + 15) / 16 + warps - 1) / warps; }

// The fp32 kernels' shared memory: `rows` tiles of 64 fp32 rows (hd + 4
// words) and, with stats, two chunks of (m, l, 1 / l, D)
constexpr size_t tf32_smem(int hd, int rows, bool stats) {
  return (size_t)rows * kChunk * (hd + 4) * 4 + (stats ? (size_t)2 * 4 * kChunk * 4 : 0);
}

template <int HD>
cudaError_t launch_fwd_tf32(const Args& a) {
  static size_t configured[kMaxDevices] = {};
  const int per_bh = tf32_per_bh(a.s, kTfFwdWarps);
  // 16 kTfFwdWarps Q rows, two chunks of (K, V)
  const size_t smem = tf32_smem(HD, kTfFwdWarps / 4 + 4, false);
  cudaError_t e = allow_smem(tiled_fwd_tf32<HD>, smem, a.device, configured);
  if (e != cudaSuccess) return e;
  tiled_fwd_tf32<HD><<<a.bh * per_bh, 32 * kTfFwdWarps, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.mask, a.kpm, static_cast<float*>(a.out), a.st[0],
      a.st[1], a.st[2], a.st[3], a.heads, a.s, a.hd, per_bh, a.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bwd_tf32(const Args& a) {
  static size_t configured[3][kMaxDevices] = {};
  const int per_bh = tf32_per_bh(a.s, kMmaWarps), grid = a.bh * per_bh;
  const float *q = static_cast<const float*>(a.q), *k = static_cast<const float*>(a.k);
  const float *v = static_cast<const float*>(a.v), *dout = static_cast<const float*>(a.dout);
  // Q and dO (or K and V) rows, two chunks of the other pair
  const size_t s13 = tf32_smem(HD, 6, false), s2 = tf32_smem(HD, 6, true);
  cudaError_t e = allow_smem(tiled_bwd_stats_tf32<HD>, s13, a.device, configured[0]);
  if (e != cudaSuccess) return e;
  tiled_bwd_stats_tf32<HD><<<grid, 32 * kMmaWarps, s13, a.stream>>>(
      q, k, v, a.mask, a.kpm, dout, a.stats, a.st[0], a.st[1], a.st[2], a.st[3], a.bh,
      a.heads, a.s, a.hd, per_bh, a.scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  e = allow_smem(tiled_bwd_dkdv_tf32<HD>, s2, a.device, configured[1]);
  if (e != cudaSuccess) return e;
  tiled_bwd_dkdv_tf32<HD><<<grid, 32 * kMmaWarps, s2, a.stream>>>(
      q, k, v, a.mask, a.kpm, dout, a.stats, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.st[0], a.st[1], a.st[2], a.st[3], a.st[5], a.st[6], a.bh,
      a.heads, a.s, a.hd, per_bh, a.scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  e = allow_smem(tiled_bwd_dq_tf32<HD>, s13, a.device, configured[2]);
  if (e != cudaSuccess) return e;
  tiled_bwd_dq_tf32<HD><<<grid, 32 * kMmaWarps, s13, a.stream>>>(
      q, k, v, a.mask, a.kpm, dout, a.stats, static_cast<float*>(a.dq), a.st[0], a.st[1],
      a.st[2], a.st[3], a.st[4], a.bh, a.heads, a.s, a.hd, per_bh, a.scale);
  return cudaGetLastError();
}

// hd padded with zeros to 32, 64 or 128
cudaError_t dispatch_fwd_tf32(const Args& a) {
  if (a.hd <= 32) return launch_fwd_tf32<32>(a);
  if (a.hd <= 64) return launch_fwd_tf32<64>(a);
  if (a.hd <= 128) return launch_fwd_tf32<128>(a);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_bwd_tf32(const Args& a) {
  if (a.hd <= 32) return launch_bwd_tf32<32>(a);
  if (a.hd <= 64) return launch_bwd_tf32<64>(a);
  if (a.hd <= 128) return launch_bwd_tf32<128>(a);
  return cudaErrorInvalidValue;
}

template <int HD>
cudaError_t launch_fwd_mma(const Args& a, int tiles) {
  static size_t configured[kMaxDevices] = {};
  const int per_bh = ((a.s + 15) / 16 + tiles - 1) / tiles;
  const size_t smem = fwd_mma_smem(a.s, HD, tiles);
  cudaError_t e = allow_smem(tiled_fwd_mma<HD>, smem, a.device, configured);
  if (e != cudaSuccess) return e;
  tiled_fwd_mma<HD><<<a.bh * per_bh, 64 * tiles, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.mask, a.kpm, static_cast<bf16*>(a.out), a.st[0],
      a.st[1], a.st[2], a.st[3], a.heads, a.s, per_bh, a.scale);
  return cudaGetLastError();
}

// the blocks of tiled_fwd_mma_rows, one slot of rows each: kRowsBlocksPerSm
// an SM
cudaError_t rows_slots(int device, int* slots) {
  int sms = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *slots = sms * kRowsBlocksPerSm;
  return e;
}

size_t rows_slot_bytes(int s) { return (size_t)kRowsTiles * 16 * logit_ld(s) * 4; }

template <int HD>
cudaError_t launch_fwd_mma_rows(const Args& a, float* rows) {
  static size_t configured[kMaxDevices] = {};
  int slots = 0;
  cudaError_t e = rows_slots(a.device, &slots);
  if (e != cudaSuccess) return e;
  const int per_bh = ((a.s + 15) / 16 + kRowsTiles - 1) / kRowsTiles, items = a.bh * per_bh;
  const size_t smem = fwd_rest_smem(HD, kRowsTiles);
  e = allow_smem(tiled_fwd_mma_rows<HD>, smem, a.device, configured);
  if (e != cudaSuccess) return e;
  tiled_fwd_mma_rows<HD><<<min(slots, items), 64 * kRowsTiles, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.mask, a.kpm, static_cast<bf16*>(a.out), a.st[0],
      a.st[1], a.st[2], a.st[3], a.heads, a.s, per_bh, items, rows, a.scale);
  return cudaGetLastError();
}

template <int HD, bool CHUNKS>
cudaError_t launch_bwd_mma(const Args& a) {
  static size_t configured[3][kMaxDevices] = {};
  const int per_bh = ((a.s + 15) / 16 + kMmaWarps - 1) / kMmaWarps, grid = a.bh * per_bh;
  const bf16 *q = static_cast<const bf16*>(a.q), *k = static_cast<const bf16*>(a.k);
  const bf16 *v = static_cast<const bf16*>(a.v), *dout = static_cast<const bf16*>(a.dout);
  const size_t s13 = bwd_mma_smem(HD, false), s2 = bwd_mma_smem(HD, true);
  cudaError_t e = allow_smem(tiled_bwd_stats_mma<HD>, s13, a.device, configured[0]);
  if (e != cudaSuccess) return e;
  tiled_bwd_stats_mma<HD><<<grid, 32 * kMmaWarps, s13, a.stream>>>(
      q, k, v, a.mask, a.kpm, dout, a.stats, a.st[0], a.st[1], a.st[2], a.st[3], a.bh,
      a.heads, a.s, per_bh, a.scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  e = allow_smem(tiled_bwd_dkdv_mma<HD, CHUNKS>, s2, a.device, configured[1]);
  if (e != cudaSuccess) return e;
  tiled_bwd_dkdv_mma<HD, CHUNKS><<<grid, 32 * kMmaWarps, s2, a.stream>>>(
      q, k, v, a.mask, a.kpm, dout, a.stats, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
      a.st[0], a.st[1], a.st[2], a.st[3], a.st[5], a.st[6], a.bh, a.heads, a.s, per_bh,
      a.scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  e = allow_smem(tiled_bwd_dq_mma<HD, CHUNKS>, s13, a.device, configured[2]);
  if (e != cudaSuccess) return e;
  tiled_bwd_dq_mma<HD, CHUNKS><<<grid, 32 * kMmaWarps, s13, a.stream>>>(
      q, k, v, a.mask, a.kpm, dout, a.stats, static_cast<bf16*>(a.dq), a.st[0], a.st[1],
      a.st[2], a.st[3], a.st[4], a.bh, a.heads, a.s, per_bh, a.scale);
  return cudaGetLastError();
}

Strides strides_at(const long long* st, int i) { return {st[3 * i], st[3 * i + 1], st[3 * i + 2]}; }

Args fwd_args(const void* q, const void* k, const void* v, const void* mask, const void* kpm,
              void* out, const long long* strides, int b, int heads, int s, int hd,
              float scale, int device, void* stream) {
  Args a{q, k, v, nullptr, static_cast<const float*>(mask), static_cast<const float*>(kpm),
         out, nullptr, nullptr, nullptr, nullptr, {}, b * heads, heads, s, hd, device, scale,
         static_cast<cudaStream_t>(stream)};
  for (int i = 0; i < 4; ++i) a.st[i] = strides_at(strides, i);
  return a;
}

}  // namespace

extern "C" {

// 16-row tiles of a bf16 forward block at (s, hd), 0 when one tile's logit
// rows do not fit in shared memory (cmh_attention_tiled_fwd_rows then takes
// s), and that block's dynamic shared memory (with 0 tiles, what one tile
// would need).
int cmh_attention_tiled_fwd_tiles(int s, int hd) { return fwd_mma_tiles(s, hd); }

long cmh_attention_tiled_fwd_smem(int s, int hd) {
  const int n = fwd_mma_tiles(s, hd);
  return (long)fwd_mma_smem(s, hd, n > 0 ? n : 1);
}

// dtype 0 = fp32, 1 = bf16. q, k, v are read through element strides (b, h, s)
// with hd contiguous; strides holds (b, h, s) of q, k, v and out. mask (s, s)
// and kpm (b, s) are fp32 and may be null. fp32 takes hd <= 128, bf16 hd 32
// or 64 while one tile's logit rows fit in shared memory
// (cmh_attention_tiled_fwd_tiles > 0; past that, cmh_attention_tiled_fwd_rows).
int cmh_attention_tiled_fwd(int dtype, const void* q, const void* k, const void* v,
                            const void* mask, const void* kpm, void* out,
                            const long long* strides, int b, int heads, int s, int hd,
                            float scale, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (b == 0 || heads == 0 || s == 0) return cudaSuccess;
  const Args a = fwd_args(q, k, v, mask, kpm, out, strides, b, heads, s, hd, scale, device,
                          stream);
  if (dtype != 1) return dispatch_fwd_tf32(a);
  const int tiles = fwd_mma_tiles(s, hd);
  if (tiles == 0) return cudaErrorInvalidValue;   // the rows need device memory
  if (hd == 64) return launch_fwd_mma<64>(a, tiles);
  if (hd == 32) return launch_fwd_mma<32>(a, tiles);
  return cudaErrorInvalidValue;
}

// Bytes of device memory the bf16 forward's logit rows take at s on device
// (one slot a resident block of cmh_attention_tiled_fwd_rows, whatever b and
// heads), or -1 on an error.
long cmh_attention_tiled_fwd_rows_bytes(int s, int device) {
  int slots = 0;
  if (rows_slots(device, &slots) != cudaSuccess) return -1;
  return (long)(slots * rows_slot_bytes(s));
}

// The bf16 forward (hd 32 or 64) with its logit rows in `rows`, at least
// cmh_attention_tiled_fwd_rows_bytes(s, device) bytes of device memory,
// 16-byte aligned; at any s. The other arguments as cmh_attention_tiled_fwd's.
int cmh_attention_tiled_fwd_rows(const void* q, const void* k, const void* v,
                                 const void* mask, const void* kpm, void* out,
                                 const long long* strides, int b, int heads, int s, int hd,
                                 float scale, void* rows, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (b == 0 || heads == 0 || s == 0) return cudaSuccess;
  const Args a = fwd_args(q, k, v, mask, kpm, out, strides, b, heads, s, hd, scale, device,
                          stream);
  if (hd == 64) return launch_fwd_mma_rows<64>(a, static_cast<float*>(rows));
  if (hd == 32) return launch_fwd_mma_rows<32>(a, static_cast<float*>(rows));
  return cudaErrorInvalidValue;
}

// strides holds (b, h, s) of q, k, v, dout, dq, dk, dv; stats is fp32 scratch
// of 4 b heads s floats that the first launch writes: the row max, the row
// sum, 1 / sum and D. fp32 takes hd <= 128, bf16 hd 32 or 64.
int cmh_attention_tiled_bwd(int dtype, const void* q, const void* k, const void* v,
                            const void* mask, const void* kpm, const void* dout, void* dq,
                            void* dk, void* dv, void* stats, const long long* strides, int b,
                            int heads, int s, int hd, float scale, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (b == 0 || heads == 0 || s == 0) return cudaSuccess;
  Args a{q, k, v, dout, static_cast<const float*>(mask), static_cast<const float*>(kpm),
         nullptr, dq, dk, dv, static_cast<float*>(stats), {}, b * heads, heads, s, hd, device,
         scale, static_cast<cudaStream_t>(stream)};
  for (int i = 0; i < 7; ++i) a.st[i] = strides_at(strides, i);
  if (dtype != 1) return dispatch_bwd_tf32(a);
  const bool chunks = s > kChunkSumsS;
  if (hd == 64) return chunks ? launch_bwd_mma<64, true>(a) : launch_bwd_mma<64, false>(a);
  if (hd == 32) return chunks ? launch_bwd_mma<32, true>(a) : launch_bwd_mma<32, false>(a);
  return cudaErrorInvalidValue;
}

}  // extern "C"
