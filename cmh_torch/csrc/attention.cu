// Self-attention for short sequences: softmax(scale * Q K^T + mask +
// kpm_bias) V per (batch, head), and its backward. Two designs, chosen by
// dtype alone:
//
// - bf16 (the serving and training dtype): attention_fwd_mma and
//   attention_bwd_mma, on the tensor cores (mma.sync m16n8k16 bf16 with fp32
//   accumulators, operands through ldmatrix; the forward's logits alone are
//   fp32 FMA chains on the CUDA cores, see attention_fwd_mma), reading q, k,
//   v and dout in place through element strides and writing (B, S, H, hd)
//   memory;
// - fp32 (the parity checks, where tensor cores have no fp32 product):
//   attention_fwd_kernel and attention_bwd_kernel, CUDA-core FMAs over fp32
//   tiles, (B, H, S, hd) contiguous in and out.
//
// Both replace cmh_tpu/ops/attention_pallas.py:_fwd_kernel (called from
// _attention_fwd) and _bwd_kernel (from _attention_bwd), with the same
// arithmetic: logits are the fp32 dot of the inputs times scale, then + the
// optional (S, S) fp32 mask, then + the optional (B, S) fp32 key-padding bias
// (0 or -inf); the row softmax is fp32 (max, expf(x - max), a true division by
// the sum; a row with every key masked gives NaN, as jax.nn.softmax does); the
// forward rounds the probabilities to the input dtype before the PV product,
// which accumulates in fp32; the backward keeps them unrounded.
//
// Bound on the card: bytes. Per (batch, head) the forward does 4 S^2 hd flops
// against 8 S hd bytes (about 25 flops per byte in bf16 at S = 50), the
// backward 10 S^2 hd against 14 S hd, far below the 295 at which the tensor
// cores would limit. The designs keep the (S, S) logits out of device memory:
// one block per (batch, head) holds its tiles in shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

// Raise kernel's dynamic shared-memory limit to smem bytes on device, once per
// (kernel, device): the attribute belongs to the device that is current, and
// each launcher keeps its own configured[] table.
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t smem, int device,
                       size_t (&configured)[kMaxDevices]) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem <= configured[device]) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) configured[device] = smem;
  return e;
}

// ---------------------------------------------------------------- fp32 kernels
//
// Q, K and V as fp32 in shared memory (rows padded to hd + 1 words, so threads
// of a warp that read different rows hit different banks) plus the fp32
// logits; products on CUDA cores.

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     const float* __restrict__ kpm, T* __restrict__ out,
                     int heads, int s, int hd, float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* sq = smem;
  float* sk = sq + s * ld;
  float* sv = sk + s * ld;
  float* sl = sv + s * ld;          // (s, s) logits, then probabilities

  const long bh = blockIdx.x;       // b * heads + h
  const int b = (int)(bh / heads);
  const long base = bh * s * hd;
  const int n = s * hd;

  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / hd, c = i - r * hd;
    sq[r * ld + c] = q[base + i];
    sk[r * ld + c] = k[base + i];
    sv[r * ld + c] = v[base + i];
  }
  __syncthreads();

  // logits: a warp covers neighbouring key columns j of one query row i
  for (int i = threadIdx.x; i < s * s; i += kThreads) {
    const int r = i / s, c = i - r * s;
    const float* qr = sq + r * ld;
    const float* kr = sk + c * ld;
    float acc = 0.f;
    for (int t = 0; t < hd; ++t) acc = fmaf(qr[t], kr[t], acc);
    float lg = acc * scale;
    if (mask) lg += mask[r * s + c];
    if (kpm) lg += kpm[(long)b * s + c];
    sl[i] = lg;
  }
  __syncthreads();

  // row softmax, one warp per row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < s; r += kThreads / 32) {
    float* row = sl + r * s;
    float m = -INFINITY;
    for (int c = lane; c < s; c += 32) m = fmaxf(m, row[c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int c = lane; c < s; c += 32) {
      const float e = expf(row[c] - m);
      row[c] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int c = lane; c < s; c += 32) row[c] = row[c] / sum;
  }
  __syncthreads();

  // out = P V: a warp covers neighbouring head dims of one query row
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / hd, c = i - r * hd;
    const float* pr = sl + r * s;
    float acc = 0.f;
    for (int j = 0; j < s; ++j) acc = fmaf(pr[j], sv[j * ld + c], acc);
    out[base + i] = acc;
  }
}

// dV = W^T dO; dW = dO V^T; dlog = W * (dW - rowsum(dW * W)); dQ = dlog K *
// scale; dK = dlog^T Q * scale, all fp32. Q, K, V and dO as fp32 in shared
// memory plus two (S, S) tiles, W and dW (then dlog): 127 KB at S = 77, so the
// launch opts in above 48 KB.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     const float* __restrict__ kpm, const T* __restrict__ dout,
                     T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                     int heads, int s, int hd, float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* sq = smem;
  float* sk = sq + s * ld;
  float* sv = sk + s * ld;
  float* sd = sv + s * ld;          // dO
  float* sw = sd + s * ld;          // (s, s) W
  float* sg = sw + s * s;           // (s, s) dW, then dlog

  const long bh = blockIdx.x;
  const int b = (int)(bh / heads);
  const long base = bh * s * hd;
  const int n = s * hd;

  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / hd, c = i - r * hd;
    sq[r * ld + c] = q[base + i];
    sk[r * ld + c] = k[base + i];
    sv[r * ld + c] = v[base + i];
    sd[r * ld + c] = dout[base + i];
  }
  __syncthreads();

  // logits into W, and dW = dO V^T
  for (int i = threadIdx.x; i < s * s; i += kThreads) {
    const int r = i / s, c = i - r * s;
    const float* qr = sq + r * ld;
    const float* kr = sk + c * ld;
    const float* dr = sd + r * ld;
    const float* vr = sv + c * ld;
    float acc = 0.f, g = 0.f;
    for (int t = 0; t < hd; ++t) {
      acc = fmaf(qr[t], kr[t], acc);
      g = fmaf(dr[t], vr[t], g);
    }
    float lg = acc * scale;
    if (mask) lg += mask[r * s + c];
    if (kpm) lg += kpm[(long)b * s + c];
    sw[i] = lg;
    sg[i] = g;
  }
  __syncthreads();

  // per row: fp32 softmax (unrounded), then dlog = W (dW - sum(dW W))
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < s; r += kThreads / 32) {
    float* row = sw + r * s;
    float* grow = sg + r * s;
    float m = -INFINITY;
    for (int c = lane; c < s; c += 32) m = fmaxf(m, row[c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int c = lane; c < s; c += 32) {
      const float e = expf(row[c] - m);
      row[c] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    float dot = 0.f;
    for (int c = lane; c < s; c += 32) {
      const float w = row[c] / sum;
      row[c] = w;
      dot += grow[c] * w;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    for (int c = lane; c < s; c += 32) grow[c] = row[c] * (grow[c] - dot);
  }
  __syncthreads();

  // dV[j, c] = sum_r W[r, j] dO[r, c]; dQ[r, c] = scale sum_j dlog[r, j] K[j, c];
  // dK[j, c] = scale sum_r dlog[r, j] Q[r, c]. A warp covers neighbouring c.
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / hd, c = i - r * hd;
    float av = 0.f, aq = 0.f, ak = 0.f;
    for (int j = 0; j < s; ++j) {
      av = fmaf(sw[j * s + r], sd[j * ld + c], av);
      aq = fmaf(sg[r * s + j], sk[j * ld + c], aq);
      ak = fmaf(sg[j * s + r], sq[j * ld + c], ak);
    }
    dv[base + i] = av;
    dq[base + i] = aq * scale;
    dk[base + i] = ak * scale;
  }
}

// ------------------------------------------------------- bf16 tensor-core kernels
//
// One block per (batch, head). The sequence is padded to SP = 16 KC rows
// (KC = ceil(S / 16)); rows past S are zero-filled in shared memory and key
// columns past S get -inf logits. Tiles stay bf16 in shared memory, rows
// padded to hd + 8 elements (so the eight 16-byte rows an ldmatrix reads fall
// in distinct banks), filled by 16-byte cp.async copies. A warp owns 16 query
// rows: its logits, probabilities and accumulators live in mma fragments
// (thread lane holds rows lane/4 and lane/4 + 8, columns 2 (lane % 4) + {0, 1}
// of each 16 x 8 tile). The copies, ldmatrix offsets, mma and the bf16
// pieces are in attention_mma.cuh, shared with attention_tiled.cu.

// rows [0, rows_pad) of one (batch, head) of a strided (B, H, S, HD) tensor
// into a bf16 tile with leading dimension LD; rows >= s are zero-filled
template <int HD, int LD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, Strides st,
                                          int b, int h, int s, int rows_pad,
                                          int tid, int nthreads) {
  constexpr int CH = HD / 8;
  const bf16* base = src + b * st.b + h * st.h;
  for (int i = tid; i < rows_pad * CH; i += nthreads) {
    const int r = i / CH, c = i - r * CH;
    const bool ok = r < s;
    cp_async16(dst + r * LD + c * 8, ok ? base + r * st.s + c * 8 : src, ok);
  }
}

// Logits of one warp's 16 query rows (fp32, NT n-tiles of 8 keys in mma
// accumulator layout) into probabilities, in place: * scale, + mask,
// + key-padding bias, then the row softmax. Key columns >= s get -inf. The
// sum runs in the fp32 kernel's (and torch.softmax's) order: per lane
// L = c mod 32 the sequential sum over c = L, L + 32, ..., then a butterfly
// over L with offsets 16, 8, 4, 2, 1. Thread t of a quad holds the columns
// c = 8 j + 2 t + e, so offsets 16 and 8 (bits of j) and 1 (e) add within the
// thread and offsets 4 and 2 (bits of t) across the quad. Only the first NTV
// n-tiles hold keys below S; the rest come out 0.
template <int NT, int NTV = NT>
__device__ __forceinline__ void softmax_rows(float (&x)[NT][4], int r0, int s, int b,
                                             const float* __restrict__ mask,
                                             const float* __restrict__ kpm,
                                             float scale, int t) {
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NTV; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * t + (e & 1), r = r0 + (e >> 1) * 8;
      float lg = x[j][e] * scale;
      if (c >= s) {
        lg = -INFINITY;
      } else {
        if (mask != nullptr && r < s) lg += __ldg(mask + (long)r * s + c);
        if (kpm != nullptr) lg += __ldg(kpm + (long)b * s + c);
      }
      x[j][e] = lg;
      m[e >> 1] = fmaxf(m[e >> 1], lg);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
  }
  float part[2][4][2] = {};   // [row half][j mod 4][e]: the lane partials
#pragma unroll
  for (int j = 0; j < NTV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[j][e] = expf(x[j][e] - m[e >> 1]);
      part[e >> 1][j & 3][e & 1] += x[j][e];
    }
  float sum[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float w[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      w[e] = (part[i][0][e] + part[i][2][e]) + (part[i][1][e] + part[i][3][e]);
      w[e] += __shfl_xor_sync(0xffffffffu, w[e], 2);
      w[e] += __shfl_xor_sync(0xffffffffu, w[e], 1);
    }
    sum[i] = w[0] + w[1];
  }
  // x / sum, correctly rounded as `/` is, from the correctly rounded
  // reciprocal and one fma correction (Markstein): 3 instructions, not ~8
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) inv[i] = __frcp_rn(sum[i]);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (j < NTV) {
        const float q = x[j][e] * inv[e >> 1];
        x[j][e] = fmaf(fmaf(-q, sum[e >> 1], x[j][e]), inv[e >> 1], q);
      } else {
        x[j][e] = 0.f;   // key columns all past S
      }
    }
}

// A warp's 16 x HD fp32 accumulators (times mul), rounded to bf16, through its
// 16-row shared-memory stage, into rows row0.. (< s) of one (batch, head) of
// dst in (B, S, H, HD) memory, with 16-byte stores.
template <int HD, int LD>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst,
                                           const float (&acc)[HD / 8][4], float mul,
                                           bf16* stage, int row0, int s, int b,
                                           int h, int heads, int lane) {
  constexpr int CH = HD / 8;
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
#pragma unroll
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i - r * CH, row = row0 + r;
    if (row < s)
      *reinterpret_cast<uint4*>(dst + (((long long)b * s + row) * heads + h) * HD + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * LD + c * 8);
  }
}

template <int KC> __host__ __device__ constexpr int fwd_warps() { return KC < 8 ? KC : 8; }

// Forward. Shared memory: Q and V as bf16 tiles, K as fp32 (2 SP (HD + 8)
// bf16 + SP (HD + 4) fp32: 35 KB at S = 50, hd = 64). A warp takes 16 query
// rows at a time. Its logits, in mma accumulator layout, are fp32 FMA chains
// over hd in order on the CUDA cores, as the fp32 kernel (and a plain fp32
// product) forms them: P is rounded to bf16, and tensor-core sums, which round
// differently, move a P across a rounding boundary often enough that about 4
// in 100,000 outputs land more than one bf16 step away (0.0041% at the vision
// shape on an H100). K is converted to fp32 once, as it is loaded, so each
// 16-byte read feeds 8 FMAs. The softmax stays in registers; P, rounded to bf16 in
// registers, is the A operand of P V on mma (V through ldmatrix.trans); the
// output is staged in the warp's own Q rows.
// fp32 logits of a warp's 16 query rows (rows g + 8 only when ROWS2) against
// the first NTV n-tiles of keys, each an FMA chain over hd in order from 0
template <int NT, int NTV, bool ROWS2, int HD, int LD, int LDF>
__device__ __forceinline__ void logits_fma(float (&x)[NT][4], const bf16* qt,
                                           const float* skf, int g, int t) {
  for (int k4 = 0; k4 < HD / 4; ++k4) {   // hd elements 4 k4 .. 4 k4 + 3
    const uint2 a0 = *reinterpret_cast<const uint2*>(qt + g * LD + 4 * k4);
    const uint2 a1 = *reinterpret_cast<const uint2*>(qt + (g + 8) * LD + 4 * k4);
    const float q0[4] = {bf16_lo(a0.x), bf16_hi(a0.x), bf16_lo(a0.y), bf16_hi(a0.y)};
    const float q1[4] = {bf16_lo(a1.x), bf16_hi(a1.x), bf16_lo(a1.y), bf16_hi(a1.y)};
#pragma unroll
    for (int j = 0; j < NTV; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 kv =
            *reinterpret_cast<const float4*>(skf + (8 * j + 2 * t + e) * LDF + 4 * k4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float kvi = i == 0 ? kv.x : i == 1 ? kv.y : i == 2 ? kv.z : kv.w;
          x[j][e] = fmaf(q0[i], kvi, x[j][e]);
          if (ROWS2) x[j][2 + e] = fmaf(q1[i], kvi, x[j][2 + e]);
        }
      }
  }
}

template <int KC, int HD>
constexpr size_t fwd_smem() {
  return 2 * 16 * KC * (HD + 8) * sizeof(bf16) + 16 * KC * (HD + 4) * sizeof(float);
}

// blocks per SM the register budget is cut for: 20 warps at the short
// sequences of the main path, no cut for the longer ones
template <int KC> __host__ __device__ constexpr int fwd_min_blocks() {
  return KC <= 4 ? 20 / fwd_warps<KC>() : 1;
}

template <int KC, int HD>
__global__ void __launch_bounds__(32 * fwd_warps<KC>(), fwd_min_blocks<KC>())
attention_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ mask,
                  const float* __restrict__ kpm, bf16* __restrict__ out,
                  Strides stq, Strides stk, Strides stv, int heads, int s,
                  float scale) {
  constexpr int SP = 16 * KC, LD = HD + 8, LDF = HD + 4, NT = 2 * KC, NW = fwd_warps<KC>();
  constexpr int CH = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sv = sq + SP * LD;
  float* skf = reinterpret_cast<float*>(sv + SP * LD);

  const int b = blockIdx.x / heads, h = blockIdx.x - b * heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  load_tile<HD, LD>(sq, q, stq, b, h, s, SP, tid, 32 * NW);
  load_tile<HD, LD>(sv, v, stv, b, h, s, SP, tid, 32 * NW);
  const bf16* kbase = k + b * stk.b + h * stk.h;
  for (int i = tid; i < SP * CH; i += 32 * NW) {
    const int r = i / CH, c = i - r * CH;
    uint4 w = make_uint4(0, 0, 0, 0);
    if (r < s) w = __ldg(reinterpret_cast<const uint4*>(kbase + r * stk.s + c * 8));
    float4* dst = reinterpret_cast<float4*>(skf + r * LDF + c * 8);
    dst[0] = make_float4(bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y), bf16_hi(w.y));
    dst[1] = make_float4(bf16_lo(w.z), bf16_hi(w.z), bf16_lo(w.w), bf16_hi(w.w));
  }
  cp_async_wait_all();
  __syncthreads();

  for (int tile = warp; tile < KC; tile += NW) {
    bf16* qt = sq + tile * 16 * LD;
    float x[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
    // when S <= 16 KC - 8 the last n-tile of keys and the last tile's rows
    // g + 8 are all padding
    if (s > 16 * KC - 8) {
      logits_fma<NT, NT, true, HD, LD, LDF>(x, qt, skf, g, t);
      softmax_rows<NT>(x, tile * 16 + g, s, b, mask, kpm, scale, t);
    } else {
      if (tile < KC - 1)
        logits_fma<NT, NT - 1, true, HD, LD, LDF>(x, qt, skf, g, t);
      else
        logits_fma<NT, NT - 1, false, HD, LD, LDF>(x, qt, skf, g, t);
      softmax_rows<NT, NT - 1>(x, tile * 16 + g, s, b, mask, kpm, scale, t);
    }

    float o[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const uint32_t pa[4] = {pack_bf16(x[2 * kc][0], x[2 * kc][1]),
                              pack_bf16(x[2 * kc][2], x[2 * kc][3]),
                              pack_bf16(x[2 * kc + 1][0], x[2 * kc + 1][1]),
                              pack_bf16(x[2 * kc + 1][2], x[2 * kc + 1][3])};
#pragma unroll
      for (int nn = 0; nn < HD / 16; ++nn) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, sv + kc * 16 * LD + bt_off(lane, LD) + nn * 16);
        mma_bf16(o[2 * nn], pa, vb[0], vb[1]);
        mma_bf16(o[2 * nn + 1], pa, vb[2], vb[3]);
      }
    }
    store_rows<HD, LD>(out, o, 1.f, qt, tile * 16, s, b, h, heads, lane);
  }
}

// Pieces of a warp's 16 rows of an fp32 (SP, SP) tile (fragments x) into NP
// bf16 tiles of SP x LP at dst, dst + SP LP, ...
template <int KC, int NP>
__device__ __forceinline__ void store_pieces(bf16* dst, const float (&x)[2 * KC][4],
                                             int r0, int t) {
  constexpr int SP = 16 * KC, LP = SP + 8;
#pragma unroll
  for (int j = 0; j < 2 * KC; ++j) {
    uint32_t top[NP], bot[NP];
    split_pair<NP>(x[j][0], x[j][1], top);
    split_pair<NP>(x[j][2], x[j][3], bot);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      *reinterpret_cast<uint32_t*>(dst + p * SP * LP + r0 * LP + 8 * j + 2 * t) = top[p];
      *reinterpret_cast<uint32_t*>(dst + p * SP * LP + (r0 + 8) * LP + 8 * j + 2 * t) = bot[p];
    }
  }
}

// acc (16 key rows of tile `tile` x HD) += X^T B, X an fp32 (SP, SP) tile held
// as NP bf16 pieces in shared memory (rows = query, contracted), B a bf16
// (SP, HD) tile (rows = query). Smallest pieces first.
template <int KC, int HD, int NP>
__device__ __forceinline__ void transposed_product(float (&acc)[HD / 8][4],
                                                   const bf16* pieces, const bf16* bt,
                                                   int tile, int lane) {
  constexpr int SP = 16 * KC, LP = SP + 8, LD = HD + 8;
#pragma unroll
  for (int qc = 0; qc < KC; ++qc) {
    uint32_t a[NP][4];
#pragma unroll
    for (int p = 0; p < NP; ++p)
      ldsm_x4_trans(a[p], pieces + p * SP * LP + qc * 16 * LP + at_off(lane, LP) + tile * 16);
#pragma unroll
    for (int nn = 0; nn < HD / 16; ++nn) {
      uint32_t bb[4];
      ldsm_x4_trans(bb, bt + qc * 16 * LD + bt_off(lane, LD) + nn * 16);
#pragma unroll
      for (int p = NP - 1; p >= 0; --p) {
        mma_bf16(acc[2 * nn], a[p], bb[0], bb[1]);
        mma_bf16(acc[2 * nn + 1], a[p], bb[2], bb[3]);
      }
    }
  }
}

constexpr int kPieces = 3;   // bf16 pieces of W and dlog in dV, dQ and dK

template <int KC, int HD, int NP>
constexpr size_t bwd_smem() {
  constexpr size_t SP = 16 * KC, tile = SP * (HD + 8), piece = SP * (SP + 8);
  return (3 * tile + (2 * tile > NP * piece ? 2 * tile : NP * piece)) * sizeof(bf16);
}

// Backward. Shared memory: Q, dO, a stage for the outputs, then K and V,
// whose space the NP bf16 pieces of W, later of dlog, reuse once dQ is done
// (55 KB at S = 50, hd = 64; 160 KB at S = 128). Warp w owns query rows and
// key rows 16 w .. 16 w + 15. Per warp: S = Q K^T and dW = dO V^T on mma
// (exact bf16 products, fp32 sums); W = softmax(S) unrounded; dlog =
// W (dW - rowsum(dW W)) in registers; dQ = scale dlog K with dlog split into
// NP bf16 pieces in registers. dV = W^T dO and dK = scale dlog^T Q contract
// over query rows that other warps own, so the pieces go through shared
// memory: W's first (dV), then dlog's (dK), in one buffer.
template <int KC, int HD, int NP>
__global__ void __launch_bounds__(32 * KC)
attention_bwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ mask,
                  const float* __restrict__ kpm, const bf16* __restrict__ dout,
                  bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                  Strides stq, Strides stk, Strides stv, Strides sto, int heads,
                  int s, float scale) {
  constexpr int SP = 16 * KC, LD = HD + 8, NT = 2 * KC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdo = sq + SP * LD;
  bf16* stage = sdo + SP * LD;
  bf16* sk = stage + SP * LD;
  bf16* sv = sk + SP * LD;
  bf16* pieces = sk;

  const int b = blockIdx.x / heads, h = blockIdx.x - b * heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16 + g;
  load_tile<HD, LD>(sq, q, stq, b, h, s, SP, tid, 32 * KC);
  load_tile<HD, LD>(sk, k, stk, b, h, s, SP, tid, 32 * KC);
  load_tile<HD, LD>(sv, v, stv, b, h, s, SP, tid, 32 * KC);
  load_tile<HD, LD>(sdo, dout, sto, b, h, s, SP, tid, 32 * KC);
  cp_async_wait_all();
  __syncthreads();

  float w[NT][4], dw[NT][4];
  {
    uint32_t qa[HD / 16][4], da[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      ldsm_x4(qa[kk], sq + warp * 16 * LD + a_off(lane, LD) + kk * 16);
      ldsm_x4(da[kk], sdo + warp * 16 * LD + a_off(lane, LD) + kk * 16);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) w[j][e] = dw[j][e] = 0.f;
#pragma unroll
    for (int j2 = 0; j2 < KC; ++j2)
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t kb[4], vb[4];
        ldsm_x4(kb, sk + j2 * 16 * LD + b_off(lane, LD) + kk * 16);
        ldsm_x4(vb, sv + j2 * 16 * LD + b_off(lane, LD) + kk * 16);
        mma_bf16(w[2 * j2], qa[kk], kb[0], kb[1]);
        mma_bf16(w[2 * j2 + 1], qa[kk], kb[2], kb[3]);
        mma_bf16(dw[2 * j2], da[kk], vb[0], vb[1]);
        mma_bf16(dw[2 * j2 + 1], da[kk], vb[2], vb[3]);
      }
  }
  softmax_rows<NT>(w, r0, s, b, mask, kpm, scale, t);
  // padded query rows take no part in dV and dK
  float dot[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (r0 + (e >> 1) * 8 >= s) w[j][e] = 0.f;
      dot[e >> 1] += dw[j][e] * w[j][e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    dot[i] += __shfl_xor_sync(0xffffffffu, dot[i], 1);
    dot[i] += __shfl_xor_sync(0xffffffffu, dot[i], 2);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dw[j][e] = w[j][e] * (dw[j][e] - dot[e >> 1]);   // dlog

  float acc[HD / 8][4];
  // dQ = scale dlog K: dlog's pieces straight from the fragments
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    uint32_t p0[NP], p1[NP], p2[NP], p3[NP];
    split_pair<NP>(dw[2 * kc][0], dw[2 * kc][1], p0);
    split_pair<NP>(dw[2 * kc][2], dw[2 * kc][3], p1);
    split_pair<NP>(dw[2 * kc + 1][0], dw[2 * kc + 1][1], p2);
    split_pair<NP>(dw[2 * kc + 1][2], dw[2 * kc + 1][3], p3);
#pragma unroll
    for (int nn = 0; nn < HD / 16; ++nn) {
      uint32_t kb[4];
      ldsm_x4_trans(kb, sk + kc * 16 * LD + bt_off(lane, LD) + nn * 16);
#pragma unroll
      for (int p = NP - 1; p >= 0; --p) {
        const uint32_t a[4] = {p0[p], p1[p], p2[p], p3[p]};
        mma_bf16(acc[2 * nn], a, kb[0], kb[1]);
        mma_bf16(acc[2 * nn + 1], a, kb[2], kb[3]);
      }
    }
  }
  bf16* my_stage = stage + warp * 16 * LD;
  store_rows<HD, LD>(dq, acc, scale, my_stage, warp * 16, s, b, h, heads, lane);
  __syncthreads();                       // K and V are free: W's pieces
  store_pieces<KC, NP>(pieces, w, r0, t);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  transposed_product<KC, HD, NP>(acc, pieces, sdo, warp, lane);
  store_rows<HD, LD>(dv, acc, 1.f, my_stage, warp * 16, s, b, h, heads, lane);
  __syncthreads();                       // dlog's pieces over W's
  store_pieces<KC, NP>(pieces, dw, r0, t);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  transposed_product<KC, HD, NP>(acc, pieces, sq, warp, lane);
  store_rows<HD, LD>(dk, acc, scale, my_stage, warp * 16, s, b, h, heads, lane);
}

// Largest KC (S <= 16 KC) each bf16 kernel is built for, by head dim
template <int HD> constexpr int max_kc_fwd() { return HD == 32 ? 13 : 11; }
template <int HD> constexpr int max_kc_bwd() { return HD == 32 ? 9 : 8; }

struct FwdArgs {
  const bf16 *q, *k, *v;
  const float *mask, *kpm;
  bf16* out;
  Strides sq, sk, sv;
  int bh, heads, s, device;
  float scale;
  cudaStream_t st;
};

struct BwdArgs {
  const bf16 *q, *k, *v, *dout;
  const float *mask, *kpm;
  bf16 *dq, *dk, *dv;
  Strides sq, sk, sv, so;
  int bh, heads, s, device;
  float scale;
  cudaStream_t st;
};

template <int HD, int KC = 1>
cudaError_t launch_fwd_mma(int kc, const FwdArgs& a) {
  if constexpr (KC > max_kc_fwd<HD>()) {
    return cudaErrorInvalidValue;
  } else {
    if (kc != KC) return launch_fwd_mma<HD, KC + 1>(kc, a);
    static size_t configured[kMaxDevices] = {};
    constexpr size_t smem = fwd_smem<KC, HD>();
    cudaError_t e = allow_smem(attention_fwd_mma<KC, HD>, smem, a.device,
                               configured);
    if (e != cudaSuccess) return e;
    attention_fwd_mma<KC, HD><<<a.bh, 32 * fwd_warps<KC>(), smem, a.st>>>(
        a.q, a.k, a.v, a.mask, a.kpm, a.out, a.sq, a.sk, a.sv, a.heads, a.s, a.scale);
    return cudaGetLastError();
  }
}

template <int HD, int KC = 1>
cudaError_t launch_bwd_mma(int kc, const BwdArgs& a) {
  if constexpr (KC > max_kc_bwd<HD>()) {
    return cudaErrorInvalidValue;
  } else {
    if (kc != KC) return launch_bwd_mma<HD, KC + 1>(kc, a);
    static size_t configured[kMaxDevices] = {};
    constexpr size_t smem = bwd_smem<KC, HD, kPieces>();
    cudaError_t e = allow_smem(attention_bwd_mma<KC, HD, kPieces>, smem,
                               a.device, configured);
    if (e != cudaSuccess) return e;
    attention_bwd_mma<KC, HD, kPieces><<<a.bh, 32 * KC, smem, a.st>>>(
        a.q, a.k, a.v, a.mask, a.kpm, a.dout, a.dq, a.dk, a.dv, a.sq, a.sk, a.sv,
        a.so, a.heads, a.s, a.scale);
    return cudaGetLastError();
  }
}

Strides strides_at(const long long* st, int i) { return {st[3 * i], st[3 * i + 1], st[3 * i + 2]}; }

}  // namespace

extern "C" {

// ---- fp32: (B, H, S, hd) contiguous in and out

// Dynamic shared memory the fp32 forward needs for one (batch, head).
long cmh_attention_smem_bytes(int s, int hd) {
  return (long)(3 * s * (hd + 1) + s * s) * (long)sizeof(float);
}

// Dynamic shared memory the fp32 backward needs for one (batch, head).
long cmh_attention_bwd_smem_bytes(int s, int hd) {
  return (long)(4 * s * (hd + 1) + 2 * s * s) * (long)sizeof(float);
}

// mask (s, s) and kpm (b, s) are fp32 and may be null.
int cmh_attention_fwd_f32(const void* q, const void* k, const void* v,
                          const void* mask, const void* kpm, void* out, int b,
                          int heads, int s, int hd, float scale, int device,
                          void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (b == 0 || heads == 0 || s == 0) return cudaSuccess;
  static size_t configured[kMaxDevices] = {};
  const size_t smem = (size_t)cmh_attention_smem_bytes(s, hd);
  e = allow_smem(attention_fwd_kernel<float>, smem, device, configured);
  if (e != cudaSuccess) return e;
  attention_fwd_kernel<float><<<b * heads, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(mask),
      static_cast<const float*>(kpm), static_cast<float*>(out), heads, s, hd, scale);
  return cudaGetLastError();
}

int cmh_attention_bwd_f32(const void* q, const void* k, const void* v,
                          const void* mask, const void* kpm, const void* dout,
                          void* dq, void* dk, void* dv, int b, int heads, int s,
                          int hd, float scale, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (b == 0 || heads == 0 || s == 0) return cudaSuccess;
  static size_t configured[kMaxDevices] = {};
  const size_t smem = (size_t)cmh_attention_bwd_smem_bytes(s, hd);
  e = allow_smem(attention_bwd_kernel<float>, smem, device, configured);
  if (e != cudaSuccess) return e;
  attention_bwd_kernel<float><<<b * heads, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(mask),
      static_cast<const float*>(kpm), static_cast<const float*>(dout),
      static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), heads,
      s, hd, scale);
  return cudaGetLastError();
}

// ---- bf16: inputs read in place through element strides, outputs in
// (B, S, H, hd) memory. strides holds (b, h, s) for q, k, v (and dout).
// Every pointer and stride must keep rows on 16-byte boundaries.

int cmh_attention_fwd_bf16(const void* q, const void* k, const void* v,
                           const void* mask, const void* kpm, void* out,
                           const long long* strides, int b, int heads, int s,
                           int hd, float scale, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (b == 0 || heads == 0 || s == 0) return cudaSuccess;
  const FwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const float*>(mask),
                  static_cast<const float*>(kpm), static_cast<bf16*>(out),
                  strides_at(strides, 0), strides_at(strides, 1), strides_at(strides, 2),
                  b * heads, heads, s, device, scale, static_cast<cudaStream_t>(stream)};
  const int kc = (s + 15) / 16;
  if (hd == 64) return launch_fwd_mma<64>(kc, a);
  if (hd == 32) return launch_fwd_mma<32>(kc, a);
  return cudaErrorInvalidValue;
}

int cmh_attention_bwd_bf16(const void* q, const void* k, const void* v,
                           const void* mask, const void* kpm, const void* dout,
                           void* dq, void* dk, void* dv, const long long* strides,
                           int b, int heads, int s, int hd, float scale, int device,
                           void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (b == 0 || heads == 0 || s == 0) return cudaSuccess;
  const BwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                  static_cast<const float*>(mask), static_cast<const float*>(kpm),
                  static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                  strides_at(strides, 0), strides_at(strides, 1), strides_at(strides, 2),
                  strides_at(strides, 3), b * heads, heads, s, device, scale,
                  static_cast<cudaStream_t>(stream)};
  const int kc = (s + 15) / 16;
  if (hd == 64) return launch_bwd_mma<64>(kc, a);
  if (hd == 32) return launch_bwd_mma<32>(kc, a);
  return cudaErrorInvalidValue;
}

}  // extern "C"
