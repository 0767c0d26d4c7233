// Self-attention for short sequences: softmax(scale * Q K^T + mask +
// kpm_bias) V per (batch, head), layout (B, H, S, hd) contiguous, and its
// backward (attention_bwd_kernel below).
//
// Replaces the TPU kernel cmh_tpu/ops/attention_pallas.py:_fwd_kernel
// (called from _attention_fwd). Same arithmetic: logits are the fp32 dot of the
// inputs times scale, then + the optional (S, S) fp32 mask, then + the
// optional (B, S) fp32 key-padding bias (0 or -inf); the row softmax is fp32;
// the probabilities are rounded to the input dtype before the PV product,
// which accumulates in fp32; the output is written in the input dtype.
//
// Bound on the card: at S = 50 or 32 and hd = 64 the work per (batch, head)
// is small (4 S^2 hd flops against 8 S hd bytes, about 25 flops per byte in
// bf16), so it is bound by bytes, as the TPU kernel was. The design keeps the
// (S, S) logits out of device memory: one block per (batch, head) holds Q, K
// and V as fp32 in shared memory (rows padded to hd + 1 words, so threads of
// a warp that read different rows hit different banks) plus the fp32 logits,
// then writes only the output. Products run on CUDA cores in fp32; an
// mma.sync or wgmma version is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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
    sq[r * ld + c] = to_f(q[base + i]);
    sk[r * ld + c] = to_f(k[base + i]);
    sv[r * ld + c] = to_f(v[base + i]);
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

  // row softmax, one warp per row; probabilities rounded to T
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
    for (int c = lane; c < s; c += 32) row[c] = to_f(from_f<T>(row[c] / sum));
  }
  __syncthreads();

  // out = P V: a warp covers neighbouring head dims of one query row
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / hd, c = i - r * hd;
    const float* pr = sl + r * s;
    float acc = 0.f;
    for (int j = 0; j < s; ++j) acc = fmaf(pr[j], sv[j * ld + c], acc);
    out[base + i] = from_f<T>(acc);
  }
}

// Self-attention backward. Replaces cmh_tpu/ops/attention_pallas.py:_bwd_kernel
// (called from _attention_bwd). Same arithmetic, all fp32: the logits and the
// softmax W are recomputed as in the forward, but W is NOT rounded to the
// input dtype; dV = W^T dO; dW = dO V^T; dlog = W * (dW - rowsum(dW * W));
// dQ = dlog K * scale; dK = dlog^T Q * scale; each written in the input dtype.
// Key-padded columns have W = 0, so their dlog is 0.
//
// Bound on the card: bytes, as the forward (five S^2 hd products per
// (batch, head) against 7 S hd elements moved). One block per (batch, head)
// holds Q, K, V and dO as fp32 in shared memory (rows padded to hd + 1) plus
// two (S, S) fp32 tiles, W and dW (then dlog): 127 KB at S = 77, hd = 64,
// above the 48 KB default, so the launch opts in. Products run on CUDA cores.
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
    sq[r * ld + c] = to_f(q[base + i]);
    sk[r * ld + c] = to_f(k[base + i]);
    sv[r * ld + c] = to_f(v[base + i]);
    sd[r * ld + c] = to_f(dout[base + i]);
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
    dv[base + i] = from_f<T>(av);
    dq[base + i] = from_f<T>(aq * scale);
    dk[base + i] = from_f<T>(ak * scale);
  }
}

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const float* mask, const float* kpm, const void* dout,
                       void* dq, void* dk, void* dv, int bh, int heads, int s,
                       int hd, float scale, size_t smem, cudaStream_t st) {
  static size_t configured = 0;   // largest dynamic smem allowed so far
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        attention_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  attention_bwd_kernel<T><<<bh, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, kpm, static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), heads, s,
      hd, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* mask, const float* kpm, void* out, int bh,
                   int heads, int s, int hd, float scale, size_t smem,
                   cudaStream_t st) {
  static size_t configured = 0;   // largest dynamic smem allowed so far
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        attention_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  attention_fwd_kernel<T><<<bh, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, kpm, static_cast<T*>(out), heads, s, hd,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for one (batch, head).
long cmh_attention_smem_bytes(int s, int hd) {
  return (long)(3 * s * (hd + 1) + s * s) * (long)sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16. mask (s, s) and kpm (b, s) are fp32 and
// may be null.
int cmh_attention_fwd(const void* q, const void* k, const void* v,
                      const void* mask, const void* kpm, void* out, int b,
                      int heads, int s, int hd, float scale, int dtype,
                      int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (b == 0) return cudaSuccess;
  const size_t smem = (size_t)cmh_attention_smem_bytes(s, hd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  const float* p = static_cast<const float*>(kpm);
  if (dtype == 0)
    return launch<float>(q, k, v, m, p, out, b * heads, heads, s, hd, scale,
                         smem, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, m, p, out, b * heads, heads, s, hd,
                                 scale, smem, st);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory the backward needs for one (batch, head).
long cmh_attention_bwd_smem_bytes(int s, int hd) {
  return (long)(4 * s * (hd + 1) + 2 * s * s) * (long)sizeof(float);
}

// Backward: dout, dq, dk, dv have q's dtype and (b, heads, s, hd) layout.
int cmh_attention_bwd(const void* q, const void* k, const void* v,
                      const void* mask, const void* kpm, const void* dout,
                      void* dq, void* dk, void* dv, int b, int heads, int s,
                      int hd, float scale, int dtype, int device,
                      void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (b == 0) return cudaSuccess;
  const size_t smem = (size_t)cmh_attention_bwd_smem_bytes(s, hd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  const float* p = static_cast<const float*>(kpm);
  if (dtype == 0)
    return launch_bwd<float>(q, k, v, m, p, dout, dq, dk, dv, b * heads, heads,
                             s, hd, scale, smem, st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(q, k, v, m, p, dout, dq, dk, dv,
                                     b * heads, heads, s, hd, scale, smem, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
