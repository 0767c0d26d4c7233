// Self-attention for long sequences: softmax(scale * Q K^T + mask + kpm_bias) V
// and its backward, each (batch, head) split over tiles of 32 query (or key)
// rows, so that no block's shared memory or thread count grows with S. The
// one-block kernels of attention.cu hold a whole (batch, head) in one block
// and stop at S = 176 (bf16 forward, hd 64), 128 (bf16 backward), 162 and 117
// (fp32); ops/attention.py routes every longer S here, by S alone.
//
// Replaces, for those lengths, cmh_tpu/ops/attention_pallas.py:_fwd_kernel
// (called from _attention_fwd) and _bwd_kernel (from _attention_bwd), with
// their arithmetic: logits are the fp32 dot of the inputs (an FMA chain over
// hd in order, on the CUDA cores) times scale, then + the (S, S) fp32 mask,
// then + the (B, S) fp32 key-padding bias; the row softmax is fp32; the
// forward rounds the NORMALISED probabilities to the input dtype before PV
// (fp32 sums); the backward uses the unrounded fp32 probabilities.
//
// No online rescaling: P is rounded to bf16 after the normalisation, so w must
// be the plain version's to the bit, or P moves a rounding step (and the
// output row with it) far more often than the one-step check allows. A first
// walk over the key blocks takes each row's max m (exact in any order); a
// second takes l = sum exp(logit - m) in torch.softmax's order (per lane
// L = c mod 32 a sequential sum over c = L, L + 32, ..., then a butterfly over
// L with offsets 16, 8, 4, 2, 1: key c of a block of 32 is lane c mod 32,
// and thread tx holds lanes tx and tx + 16); a third forms w = exp(s - m) / l,
// rounds it and multiplies. The backward is three launches, none with
// atomics, so it is deterministic:
//   1. stats: per query tile, m, l and D = sum_j w_ij dW_ij (dW = dO V^T,
//      taken as (sum_j exp(s_ij - m) dW_ij) / l in the sum walk) into fp32
//      scratch (3, B H, S) that the wrapper allocates;
//   2. dK, dV: per key tile, a walk over the query tiles;
//   3. dQ: per query tile, a walk over the key tiles.
// Every launch recomputes the logits and w with the same instructions in the
// same order (the scale, mask and bias through __fmul_rn/__fadd_rn, so that
// no contraction into an FMA can differ between kernels), so w is bit-equal
// across them. A row whose every key is masked has m = -inf and l = 0, so w
// is NaN there, as in the plain version; a key block that is wholly masked
// adds 0 to l.
//
// Layout: tiles of 32 rows are fp32 in shared memory with rows padded to
// HDP + 4 words (HDP = hd rounded up to 32, 64 or 128; padding is zero), so
// the logits read 16 bytes of a row at a time and the 16 rows a half-warp
// reads fall in distinct banks. 256 threads as a 16 x 16 grid: thread
// (ty, tx) owns rows ty and ty + 16 and columns tx + 16 j of every 32-row
// output tile. Inputs are read through element strides (b, h, s) with hd
// contiguous (the head views of a packed projection in place) and outputs
// written through their own strides.
//
// Bound on the card: at ViT-L/14's (100, 16, 257, 64) in bf16 the forward
// moves 210 MB (0.063 ms at 3.35 TB/s), but its walks are 54 GFLOP of fp32
// FMA work on the CUDA cores (three logit walks of 13.5 GFLOP and P V),
// 0.8 ms at 67 TFLOP/s, and the backward's about 2.5 times that: the CUDA
// cores bind these kernels, and the simple tiles (one shared-memory load or
// more an FMA pair) run well above even that. Fewer logit walks and tensor
// cores for the backward's products are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;           // rows of a query or key tile
constexpr int kLdP = kTile + 1;     // leading dimension of a 32 x 32 tile
constexpr int kMaxDevices = 64;

struct Strides { long long b, h, s; };   // element strides; hd is contiguous

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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// the probability as the PV product takes it: rounded to the input dtype
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// rows [row0, row0 + 32) of one (batch, head) of a strided tensor into an fp32
// tile with leading dimension HDP + 4; rows >= s and columns >= hd are 0
template <typename T, int HDP>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          Strides st, int b, int h, int row0, int s,
                                          int hd) {
  const T* base = src + b * st.b + h * st.h;
  for (int i = threadIdx.x; i < kTile * HDP; i += kThreads) {
    const int r = i / HDP, c = i - r * HDP, row = row0 + r;
    dst[r * (HDP + 4) + c] = (row < s && c < hd) ? to_f(base[row * st.s + c]) : 0.f;
  }
}

// x[i][j] = dot(a row ty + 16 i, b row tx + 16 j): FMA chains over hd in
// order (the zero padding past hd, up to a multiple of 4, adds exact zeros)
template <int LD>
__device__ __forceinline__ void dot_tile(float (&x)[2][2], const float* a, const float* b,
                                         int hd, int ty, int tx) {
  x[0][0] = x[0][1] = x[1][0] = x[1][1] = 0.f;
  for (int t = 0; t < hd; t += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + ty * LD + t);
    const float4 a1 = *reinterpret_cast<const float4*>(a + (ty + 16) * LD + t);
    const float4 b0 = *reinterpret_cast<const float4*>(b + tx * LD + t);
    const float4 b1 = *reinterpret_cast<const float4*>(b + (tx + 16) * LD + t);
    const float av[2][4] = {{a0.x, a0.y, a0.z, a0.w}, {a1.x, a1.y, a1.z, a1.w}};
    const float bv[2][4] = {{b0.x, b0.y, b0.z, b0.w}, {b1.x, b1.y, b1.z, b1.w}};
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) x[i][j] = fmaf(av[i][e], bv[j][e], x[i][j]);
  }
}

// The logits of query rows q0 + ty + 16 i against key columns k0 + tx + 16 j:
// dot * scale + mask + key-padding bias; key columns >= s are -inf
template <int LD>
__device__ __forceinline__ void logits(float (&x)[2][2], const float* sq, const float* sk,
                                       int hd, int q0, int k0, int s, int b, float scale,
                                       const float* __restrict__ mask,
                                       const float* __restrict__ kpm, int ty, int tx) {
  dot_tile<LD>(x, sq, sk, hd, ty, tx);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = q0 + ty + 16 * i, c = k0 + tx + 16 * j;
      float lg = __fmul_rn(x[i][j], scale);
      if (c >= s) {
        lg = -INFINITY;
      } else {
        if (mask != nullptr && r < s) lg = __fadd_rn(lg, __ldg(mask + (long long)r * s + c));
        if (kpm != nullptr) lg = __fadd_rn(lg, __ldg(kpm + (long long)b * s + c));
      }
      x[i][j] = lg;
    }
}

// reductions over the 16 threads (tx) that share a row: lanes of one half-warp
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The first walk over the key blocks: the max m of each of the thread's two
// query rows (-inf when every key is masked)
template <typename T, int HDP>
__device__ __forceinline__ void max_walk(float (&m)[2], const float* sq, float* sk,
                                         const T* __restrict__ k, Strides stk, int b, int h,
                                         int q0, int s, int hd, float scale,
                                         const float* __restrict__ mask,
                                         const float* __restrict__ kpm, int ty, int tx) {
  constexpr int LD = HDP + 4;
  m[0] = m[1] = -INFINITY;
  for (int k0 = 0; k0 < s; k0 += kTile) {
    __syncthreads();
    load_rows<T, HDP>(sk, k, stk, b, h, k0, s, hd);
    __syncthreads();
    float x[2][2];
    logits<LD>(x, sq, sk, hd, q0, k0, s, b, scale, mask, kpm, ty, tx);
#pragma unroll
    for (int i = 0; i < 2; ++i) m[i] = fmaxf(m[i], fmaxf(x[i][0], x[i][1]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) m[i] = row_max(m[i]);
}

// A row's sum from this thread's lane partials (lanes tx and tx + 16) in
// torch.softmax's butterfly order
__device__ __forceinline__ float lane_total(const float (&p)[2]) {
  return row_sum(p[0] + p[1]);
}

// ------------------------------------------------------------------ forward

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
attention_fwd_tiled(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ mask,
                    const float* __restrict__ kpm, T* __restrict__ out, Strides stq,
                    Strides stk, Strides stv, Strides sto, int heads, int s, int hd,
                    int tiles, float scale) {
  constexpr int LD = HDP + 4, NJ = HDP / 16;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* sk = sq + kTile * LD;
  float* sv = sk + kTile * LD;
  float* sp = sv + kTile * LD;      // 32 x 32 probabilities

  const int bh = blockIdx.x / tiles, q0 = (blockIdx.x - bh * tiles) * kTile;
  const int b = bh / heads, h = bh - b * heads;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  load_rows<T, HDP>(sq, q, stq, b, h, q0, s, hd);

  float m[2];
  max_walk<T, HDP>(m, sq, sk, k, stk, b, h, q0, s, hd, scale, mask, kpm, ty, tx);
  float p[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, l[2];
  for (int k0 = 0; k0 < s; k0 += kTile) {
    __syncthreads();
    load_rows<T, HDP>(sk, k, stk, b, h, k0, s, hd);
    __syncthreads();
    float x[2][2];
    logits<LD>(x, sq, sk, hd, q0, k0, s, b, scale, mask, kpm, ty, tx);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) p[i][j] += expf(x[i][j] - m[i]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = lane_total(p[i]);

  float o[2][NJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[i][j] = 0.f;
  for (int k0 = 0; k0 < s; k0 += kTile) {
    __syncthreads();
    load_rows<T, HDP>(sk, k, stk, b, h, k0, s, hd);
    load_rows<T, HDP>(sv, v, stv, b, h, k0, s, hd);
    __syncthreads();
    float x[2][2];
    logits<LD>(x, sq, sk, hd, q0, k0, s, b, scale, mask, kpm, ty, tx);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        sp[(ty + 16 * i) * kLdP + tx + 16 * j] = round_to<T>(expf(x[i][j] - m[i]) / l[i]);
    __syncthreads();
    // padded keys have P = 0 (or NaN in an all-masked row) and V = 0
    for (int t = 0; t < kTile; ++t) {
      const float p0 = sp[ty * kLdP + t], p1 = sp[(ty + 16) * kLdP + t];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = sv[t * LD + tx + 16 * j];
        o[0][j] = fmaf(p0, vv, o[0][j]);
        o[1][j] = fmaf(p1, vv, o[1][j]);
      }
    }
  }
  T* base = out + b * sto.b + h * sto.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < hd) base[row * sto.s + c] = from_f<T>(o[i][j]);
    }
  }
}

// ----------------------------------------------------------------- backward

// 1. per query tile: m, l and D = sum_j w dW into stats[0..2][bh][row]
template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
attention_bwd_stats(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ mask,
                    const float* __restrict__ kpm, const T* __restrict__ dout,
                    float* __restrict__ stats, Strides stq, Strides stk, Strides stv,
                    Strides sto, int bhs, int heads, int s, int hd, int tiles, float scale) {
  constexpr int LD = HDP + 4;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* sdo = sq + kTile * LD;
  float* sk = sdo + kTile * LD;
  float* sv = sk + kTile * LD;

  const int bh = blockIdx.x / tiles, q0 = (blockIdx.x - bh * tiles) * kTile;
  const int b = bh / heads, h = bh - b * heads;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  load_rows<T, HDP>(sq, q, stq, b, h, q0, s, hd);
  load_rows<T, HDP>(sdo, dout, sto, b, h, q0, s, hd);

  float m[2];
  max_walk<T, HDP>(m, sq, sk, k, stk, b, h, q0, s, hd, scale, mask, kpm, ty, tx);
  // the sum walk, and sum_j exp(s_ij - m) dW_ij beside it
  float p[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, l[2], d[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < s; k0 += kTile) {
    __syncthreads();
    load_rows<T, HDP>(sk, k, stk, b, h, k0, s, hd);
    load_rows<T, HDP>(sv, v, stv, b, h, k0, s, hd);
    __syncthreads();
    float x[2][2], g[2][2];
    logits<LD>(x, sq, sk, hd, q0, k0, s, b, scale, mask, kpm, ty, tx);
    dot_tile<LD>(g, sdo, sv, hd, ty, tx);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float e = expf(x[i][j] - m[i]);
        p[i][j] += e;
        d[i] = fmaf(e, g[i][j], d[i]);
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = lane_total(p[i]);
    d[i] = row_sum(d[i]) / l[i];
    const int row = q0 + ty + 16 * i;
    if (tx == 0 && row < s) {
      const long long at = (long long)bh * s + row;
      stats[at] = m[i];
      stats[(long long)bhs * s + at] = l[i];
      stats[2LL * bhs * s + at] = d[i];
    }
  }
}

// w and dlog = w (dW - D) of query rows q0.. against key columns k0.. into the
// 32 x 32 tiles sw and sg (rows = query); padded query rows give 0
template <int LD>
__device__ __forceinline__ void grad_tiles(float* sw, float* sg, const float* sq,
                                           const float* sdo, const float* sk, const float* sv,
                                           const float (&m)[2], const float (&l)[2],
                                           const float (&d)[2], int hd, int q0, int k0, int s,
                                           int b, float scale, const float* __restrict__ mask,
                                           const float* __restrict__ kpm, int ty, int tx) {
  float x[2][2], g[2][2];
  logits<LD>(x, sq, sk, hd, q0, k0, s, b, scale, mask, kpm, ty, tx);
  dot_tile<LD>(g, sdo, sv, hd, ty, tx);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool real = q0 + ty + 16 * i < s;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float w = real ? expf(x[i][j] - m[i]) / l[i] : 0.f;
      sw[(ty + 16 * i) * kLdP + tx + 16 * j] = w;
      sg[(ty + 16 * i) * kLdP + tx + 16 * j] = w * (g[i][j] - d[i]);
    }
  }
}

// 2. per key tile: dV = sum over query rows of w^T dO, dK = scale sum dlog^T Q
template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ mask,
                   const float* __restrict__ kpm, const T* __restrict__ dout,
                   const float* __restrict__ stats, T* __restrict__ dk, T* __restrict__ dv,
                   Strides stq, Strides stk, Strides stv, Strides sto, Strides sdk,
                   Strides sdv, int bhs, int heads, int s, int hd, int tiles, float scale) {
  constexpr int LD = HDP + 4, NJ = HDP / 16;
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;
  float* sv = sk + kTile * LD;
  float* sq = sv + kTile * LD;
  float* sdo = sq + kTile * LD;
  float* sw = sdo + kTile * LD;
  float* sg = sw + kTile * kLdP;
  float* srow = sg + kTile * kLdP;   // m, l, D of the query tile's rows

  const int bh = blockIdx.x / tiles, k0 = (blockIdx.x - bh * tiles) * kTile;
  const int b = bh / heads, h = bh - b * heads;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  load_rows<T, HDP>(sk, k, stk, b, h, k0, s, hd);
  load_rows<T, HDP>(sv, v, stv, b, h, k0, s, hd);

  float av[2][NJ], ak[2][NJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) av[i][j] = ak[i][j] = 0.f;
  for (int q0 = 0; q0 < s; q0 += kTile) {
    __syncthreads();
    load_rows<T, HDP>(sq, q, stq, b, h, q0, s, hd);
    load_rows<T, HDP>(sdo, dout, sto, b, h, q0, s, hd);
    if (threadIdx.x < 3 * kTile) {
      const int w = threadIdx.x / kTile, r = threadIdx.x - w * kTile, row = q0 + r;
      srow[threadIdx.x] = row < s ? stats[(long long)w * bhs * s + (long long)bh * s + row]
                                  : (w == 1 ? 1.f : 0.f);
    }
    __syncthreads();
    const float m[2] = {srow[ty], srow[ty + 16]};
    const float l[2] = {srow[kTile + ty], srow[kTile + ty + 16]};
    const float d[2] = {srow[2 * kTile + ty], srow[2 * kTile + ty + 16]};
    grad_tiles<LD>(sw, sg, sq, sdo, sk, sv, m, l, d, hd, q0, k0, s, b, scale, mask, kpm,
                   ty, tx);
    __syncthreads();
    // this thread's key rows ty, ty + 16; contract over the 32 query rows
    for (int t = 0; t < kTile; ++t) {
      const float w0 = sw[t * kLdP + ty], w1 = sw[t * kLdP + ty + 16];
      const float g0 = sg[t * kLdP + ty], g1 = sg[t * kLdP + ty + 16];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float dov = sdo[t * LD + tx + 16 * j], qv = sq[t * LD + tx + 16 * j];
        av[0][j] = fmaf(w0, dov, av[0][j]);
        av[1][j] = fmaf(w1, dov, av[1][j]);
        ak[0][j] = fmaf(g0, qv, ak[0][j]);
        ak[1][j] = fmaf(g1, qv, ak[1][j]);
      }
    }
  }
  T* bk = dk + b * sdk.b + h * sdk.h;
  T* bv = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= s) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < hd) {
        bv[row * sdv.s + c] = from_f<T>(av[i][j]);
        bk[row * sdk.s + c] = from_f<T>(ak[i][j] * scale);
      }
    }
  }
}

// 3. per query tile: dQ = scale sum over key rows of dlog K
template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ mask,
                 const float* __restrict__ kpm, const T* __restrict__ dout,
                 const float* __restrict__ stats, T* __restrict__ dq, Strides stq,
                 Strides stk, Strides stv, Strides sto, Strides sdq, int bhs, int heads,
                 int s, int hd, int tiles, float scale) {
  constexpr int LD = HDP + 4, NJ = HDP / 16;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* sdo = sq + kTile * LD;
  float* sk = sdo + kTile * LD;
  float* sv = sk + kTile * LD;
  float* sw = sv + kTile * LD;
  float* sg = sw + kTile * kLdP;

  const int bh = blockIdx.x / tiles, q0 = (blockIdx.x - bh * tiles) * kTile;
  const int b = bh / heads, h = bh - b * heads;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  load_rows<T, HDP>(sq, q, stq, b, h, q0, s, hd);
  load_rows<T, HDP>(sdo, dout, sto, b, h, q0, s, hd);
  float m[2], l[2], d[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + ty + 16 * i;
    const long long at = (long long)bh * s + row;
    m[i] = row < s ? stats[at] : 0.f;
    l[i] = row < s ? stats[(long long)bhs * s + at] : 1.f;
    d[i] = row < s ? stats[2LL * bhs * s + at] : 0.f;
  }

  float aq[2][NJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) aq[i][j] = 0.f;
  for (int k0 = 0; k0 < s; k0 += kTile) {
    __syncthreads();
    load_rows<T, HDP>(sk, k, stk, b, h, k0, s, hd);
    load_rows<T, HDP>(sv, v, stv, b, h, k0, s, hd);
    __syncthreads();
    grad_tiles<LD>(sw, sg, sq, sdo, sk, sv, m, l, d, hd, q0, k0, s, b, scale, mask, kpm,
                   ty, tx);
    __syncthreads();
    for (int t = 0; t < kTile; ++t) {
      const float g0 = sg[ty * kLdP + t], g1 = sg[(ty + 16) * kLdP + t];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = sk[t * LD + tx + 16 * j];
        aq[0][j] = fmaf(g0, kv, aq[0][j]);
        aq[1][j] = fmaf(g1, kv, aq[1][j]);
      }
    }
  }
  T* base = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < hd) base[row * sdq.s + c] = from_f<T>(aq[i][j] * scale);
    }
  }
}

// --------------------------------------------------------------- launchers

constexpr size_t tile_bytes(int hdp) { return (size_t)kTile * (hdp + 4) * sizeof(float); }
constexpr size_t sq_bytes() { return (size_t)kTile * kLdP * sizeof(float); }

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

template <typename T, int HDP>
cudaError_t launch_fwd(const Args& a) {
  static size_t configured[kMaxDevices] = {};
  const int tiles = (a.s + kTile - 1) / kTile;
  const size_t smem = 3 * tile_bytes(HDP) + sq_bytes();
  cudaError_t e = allow_smem(attention_fwd_tiled<T, HDP>, smem, a.device, configured);
  if (e != cudaSuccess) return e;
  attention_fwd_tiled<T, HDP><<<a.bh * tiles, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.mask, a.kpm, static_cast<T*>(a.out), a.st[0], a.st[1], a.st[2], a.st[3], a.heads,
      a.s, a.hd, tiles, a.scale);
  return cudaGetLastError();
}

template <typename T, int HDP>
cudaError_t launch_bwd(const Args& a) {
  static size_t configured[3][kMaxDevices] = {};
  const int tiles = (a.s + kTile - 1) / kTile;
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k);
  const T *v = static_cast<const T*>(a.v), *dout = static_cast<const T*>(a.dout);
  const size_t s1 = 4 * tile_bytes(HDP);
  cudaError_t e = allow_smem(attention_bwd_stats<T, HDP>, s1, a.device, configured[0]);
  if (e != cudaSuccess) return e;
  attention_bwd_stats<T, HDP><<<a.bh * tiles, kThreads, s1, a.stream>>>(
      q, k, v, a.mask, a.kpm, dout, a.stats, a.st[0], a.st[1], a.st[2], a.st[3], a.bh,
      a.heads, a.s, a.hd, tiles, a.scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t s2 = 4 * tile_bytes(HDP) + 2 * sq_bytes() + 3 * kTile * sizeof(float);
  e = allow_smem(attention_bwd_dkdv<T, HDP>, s2, a.device, configured[1]);
  if (e != cudaSuccess) return e;
  attention_bwd_dkdv<T, HDP><<<a.bh * tiles, kThreads, s2, a.stream>>>(
      q, k, v, a.mask, a.kpm, dout, a.stats, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.st[0], a.st[1], a.st[2], a.st[3], a.st[5], a.st[6], a.bh, a.heads, a.s, a.hd, tiles,
      a.scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t s3 = 4 * tile_bytes(HDP) + 2 * sq_bytes();
  e = allow_smem(attention_bwd_dq<T, HDP>, s3, a.device, configured[2]);
  if (e != cudaSuccess) return e;
  attention_bwd_dq<T, HDP><<<a.bh * tiles, kThreads, s3, a.stream>>>(
      q, k, v, a.mask, a.kpm, dout, a.stats, static_cast<T*>(a.dq), a.st[0], a.st[1],
      a.st[2], a.st[3], a.st[4], a.bh, a.heads, a.s, a.hd, tiles, a.scale);
  return cudaGetLastError();
}

// hd padded to 32, 64 or 128 (16 columns a thread-column step)
template <typename T>
cudaError_t dispatch(const Args& a, bool fwd) {
  if (a.hd <= 32) return fwd ? launch_fwd<T, 32>(a) : launch_bwd<T, 32>(a);
  if (a.hd <= 64) return fwd ? launch_fwd<T, 64>(a) : launch_bwd<T, 64>(a);
  if (a.hd <= 128) return fwd ? launch_fwd<T, 128>(a) : launch_bwd<T, 128>(a);
  return cudaErrorInvalidValue;
}

Strides strides_at(const long long* st, int i) { return {st[3 * i], st[3 * i + 1], st[3 * i + 2]}; }

}  // namespace

extern "C" {

// dtype 0 = fp32, 1 = bf16. q, k, v are read through element strides (b, h, s)
// with hd contiguous; strides holds (b, h, s) of q, k, v and out. mask (s, s)
// and kpm (b, s) are fp32 and may be null. hd <= 128.
int cmh_attention_tiled_fwd(int dtype, const void* q, const void* k, const void* v,
                            const void* mask, const void* kpm, void* out,
                            const long long* strides, int b, int heads, int s, int hd,
                            float scale, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (b == 0 || heads == 0 || s == 0) return cudaSuccess;
  Args a{q, k, v, nullptr, static_cast<const float*>(mask), static_cast<const float*>(kpm),
         out, nullptr, nullptr, nullptr, nullptr, {}, b * heads, heads, s, hd, device, scale,
         static_cast<cudaStream_t>(stream)};
  for (int i = 0; i < 4; ++i) a.st[i] = strides_at(strides, i);
  return dtype == 1 ? dispatch<__nv_bfloat16>(a, true) : dispatch<float>(a, true);
}

// strides holds (b, h, s) of q, k, v, dout, dq, dk, dv; stats is fp32 scratch
// of 3 b heads s floats (row max, row sum, D), written by the first launch.
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
  return dtype == 1 ? dispatch<__nv_bfloat16>(a, false) : dispatch<float>(a, false);
}

}  // extern "C"
