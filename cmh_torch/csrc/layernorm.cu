// LayerNorm over the last axis, fp32 statistics, output in x's dtype, and its
// backward (layernorm_bwd_kernel below).
//
// Replaces the TPU kernel cmh_tpu/ops/layernorm_pallas.py:_fwd_kernel
// (called from _layernorm_fwd). Same arithmetic: mean and mean of squares in fp32,
// flax's fast variance max(E[x^2] - E[x]^2, 0), rsqrt(var + 1e-5) and
// y = (x - mu) * inv * gamma + beta, with gamma and beta in fp32.
//
// Bound on the card: bytes. Each row is read once and written once (about
// 2 flops per byte). The design:
// - one warp per row, 16-byte vector loads: a lane owns vectors
//   j = lane + 32 i (i < NV), so each load instruction of a warp reads 512
//   contiguous bytes, and the row stays in registers between the reduction
//   and the write (warp-shuffle reductions, no shared memory);
// - persistent warps: the wrapper launches a grid that is resident at once
//   (cmh_layernorm_blocks_per_sm blocks on each SM) and each warp walks
//   rows with a grid stride. A lane owns the same columns in every
//   row, so it loads its gamma and beta once, with 16-byte loads, into
//   registers (2 * NV * V floats: 48 at d = 768 in bf16);
// - the next row in flight: a warp issues the loads of its next row before
//   it reduces and writes the current one (a register double buffer).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kFwdWarps = 4;      // warps (rows in flight) per block, forward
constexpr int kFwdMinBlocks = 4;  // resident blocks an SM the registers must allow
constexpr int kBwdWarps = 8;      // fewer, larger blocks: fewer partial rows to sum
constexpr int kBwdMinBlocks = 1;
constexpr int kMaxDevices = 64;

template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 store(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static float2 unpack(uint32_t u) {
    __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&u);
    return __bfloat1622float2(h);
  }
  __device__ static uint32_t pack(float a, float b) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  __device__ static void load(const uint4& r, float* f) {
    float2 a = unpack(r.x), b = unpack(r.y), c = unpack(r.z), d = unpack(r.w);
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
    f[4] = c.x; f[5] = c.y; f[6] = d.x; f[7] = d.y;
  }
  __device__ static uint4 store(const float* f) {
    return make_uint4(pack(f[0], f[1]), pack(f[2], f[3]),
                      pack(f[4], f[5]), pack(f[6], f[7]));
  }
};

// The lane's vectors of one row (raw 16-byte words, unpacked where used).
template <int NV>
__device__ __forceinline__ void load_row(uint4 (&r)[NV], const void* row,
                                         int lane, int nvec) {
  const uint4* p = static_cast<const uint4*>(row);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = lane + 32 * i;
    if (j < nvec) r[i] = p[j];
  }
}

// gamma or beta for the lane's columns, 16 bytes a load (src 16-byte aligned).
template <int NV, int V>
__device__ __forceinline__ void load_param(float (&p)[NV][V], const float* src,
                                           int lane, int nvec) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = lane + 32 * i;
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < nvec) f = *reinterpret_cast<const float4*>(src + j * V + k);
      p[i][k] = f.x; p[i][k + 1] = f.y; p[i][k + 2] = f.z; p[i][k + 3] = f.w;
    }
  }
}

__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

template <typename T, int NV>
__global__ void __launch_bounds__(kFwdWarps * 32, kFwdMinBlocks)
layernorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, T* __restrict__ y,
                     int rows, int d) {
  constexpr int V = Vec<T>::N;
  const int lane = threadIdx.x & 31, nvec = d / V;
  const long stride = (long)gridDim.x * kFwdWarps;
  long row = (long)blockIdx.x * kFwdWarps + (threadIdx.x >> 5);
  float g[NV][V], b[NV][V];
  load_param(g, gamma, lane, nvec);
  load_param(b, beta, lane, nvec);

  uint4 cur[NV], nxt[NV];
  if (row < rows) load_row(cur, x + row * d, lane, nvec);
  for (; row < rows; row += stride) {
    if (row + stride < rows) load_row(nxt, x + (row + stride) * d, lane, nvec);
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (lane + 32 * i < nvec) {
        float v[V];
        Vec<T>::load(cur[i], v);
#pragma unroll
        for (int e = 0; e < V; ++e) { s += v[e]; ss += v[e] * v[e]; }
      }
    }
    warp_sum2(s, ss);
    const float mu = s / d;
    const float var = fmaxf(ss / d - mu * mu, 0.f);
    const float inv = rsqrtf(var + 1e-5f);

    uint4* yr = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = lane + 32 * i;
      if (j < nvec) {
        float v[V];
        Vec<T>::load(cur[i], v);
#pragma unroll
        for (int e = 0; e < V; ++e) v[e] = (v[e] - mu) * inv * g[i][e] + b[i][e];
        yr[j] = Vec<T>::store(v);
      }
      cur[i] = nxt[i];
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* g, const float* b, void* y,
                   int rows, int d, int blocks, cudaStream_t st) {
  const int nv = (d / Vec<T>::N + 31) / 32;
  const dim3 grid(std::min(blocks, (rows + kFwdWarps - 1) / kFwdWarps)), block(kFwdWarps * 32);
  const T* xi = static_cast<const T*>(x);
  T* yo = static_cast<T*>(y);
  switch (nv) {
#define CASE(N) case N: layernorm_fwd_kernel<T, N><<<grid, block, 0, st>>>(xi, g, b, yo, rows, d); break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// LayerNorm backward. Replaces cmh_tpu/ops/layernorm_pallas.py:_bwd_kernel
// (called from _layernorm_bwd). Same arithmetic in fp32: the statistics are
// recomputed from x with the forward's fast variance; xhat = (x - mu) * inv;
// dy = dO * gamma; dx = inv * (dy - mean(dy) - xhat * mean(dy * xhat)),
// written in x's dtype; dgamma = sum over rows of dO * xhat, dbeta = sum of dO.
//
// Bound on the card: bytes (x and dO read once, dx written once). The row
// pass is the forward's design: persistent warps, gamma in registers, the
// next row's x and dO loaded while the current row is finished. A lane also
// keeps its columns' dgamma/dbeta sums in registers over all its rows.
//
// dgamma/dbeta in one launch, with no float atomics (the same bits on every
// run): each block adds its warps' sums in warp order into one (2, d)
// partial row; the launch is cooperative, so every block is resident, and
// after a grid barrier (one integer word) each block sums a slice of the
// 2 d columns over all the partial rows, in a fixed order, so the sum is
// spread over the card.

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until all `blocks` blocks of the (cooperative) grid have arrived;
// what each wrote before is then visible to all. `word` is 0 between calls:
// every block adds 1 to it except the last, which adds 2^32 - (blocks - 1),
// so it is 0 again exactly when every block has arrived, and stays 0 for the
// next call with no reset. A grid that is somehow not resident at once traps
// after 5 s rather than spinning forever.
__device__ void grid_barrier(unsigned* word, int blocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(word, blockIdx.x + 1 == (unsigned)blocks ? 1u - (unsigned)blocks : 1u);
    const unsigned long long t0 = globaltimer();
    while (ld_acquire(word) != 0u) {
      if (globaltimer() - t0 > 5000000000ull) __trap();
      __nanosleep(32);
    }
  }
  __syncthreads();
}

// out[c] = the sum of the block's warps' acc for column c, in warp order
// (red holds kWarps * d floats).
template <int kWarps, int NV, int V>
__device__ __forceinline__ void add_warps(const float (&acc)[NV][V], float* red,
                                          float* out, int d, int lane, int nvec) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = lane + 32 * i;
    if (j < nvec) {
#pragma unroll
      for (int k = 0; k < V; k += 4)
        *reinterpret_cast<float4*>(red + warp * d + j * V + k) =
            make_float4(acc[i][k], acc[i][k + 1], acc[i][k + 2], acc[i][k + 3]);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += kWarps * 32) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w * d + c];
    out[c] = t;
  }
  __syncthreads();
}

template <typename T, int NV>
__global__ void __launch_bounds__(kBwdWarps * 32, kBwdMinBlocks)
layernorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const T* __restrict__ dout, T* __restrict__ dx,
                     float* __restrict__ part, unsigned* __restrict__ sync,
                     float* __restrict__ dgamma, float* __restrict__ dbeta,
                     int rows, int d) {
  constexpr int V = Vec<T>::N, kThreads = kBwdWarps * 32;
  extern __shared__ __align__(16) float red[];   // max(kBwdWarps * d, kThreads) floats
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nvec = d / V;
  const long stride = (long)gridDim.x * kBwdWarps;
  long row = (long)blockIdx.x * kBwdWarps + warp;
  float g[NV][V], ag[NV][V], ab[NV][V];
  load_param(g, gamma, lane, nvec);
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < V; ++e) { ag[i][e] = 0.f; ab[i][e] = 0.f; }

  uint4 cx[NV], cd[NV], nx[NV], nd[NV];
  if (row < rows) {
    load_row(cx, x + row * d, lane, nvec);
    load_row(cd, dout + row * d, lane, nvec);
  }
  for (; row < rows; row += stride) {
    const long next = row + stride;
    if (next < rows) {
      load_row(nx, x + next * d, lane, nvec);
      load_row(nd, dout + next * d, lane, nvec);
    }
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (lane + 32 * i < nvec) {
        float xv[V];
        Vec<T>::load(cx[i], xv);
#pragma unroll
        for (int e = 0; e < V; ++e) { s += xv[e]; ss += xv[e] * xv[e]; }
      }
    }
    warp_sum2(s, ss);
    const float mu = s / d;
    const float var = fmaxf(ss / d - mu * mu, 0.f);
    const float inv = rsqrtf(var + 1e-5f);

    float s1 = 0.f, s2 = 0.f;       // sum(dy), sum(dy * xhat)
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (lane + 32 * i < nvec) {
        float xv[V], dv[V];
        Vec<T>::load(cx[i], xv);
        Vec<T>::load(cd[i], dv);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xh = (xv[e] - mu) * inv;
          const float dy = dv[e] * g[i][e];
          ag[i][e] += dv[e] * xh;
          ab[i][e] += dv[e];
          s1 += dy;
          s2 += dy * xh;
        }
      }
    }
    warp_sum2(s1, s2);
    const float m1 = s1 / d, m2 = s2 / d;
    uint4* out = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = lane + 32 * i;
      if (j < nvec) {
        float xv[V], dv[V];
        Vec<T>::load(cx[i], xv);
        Vec<T>::load(cd[i], dv);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xh = (xv[e] - mu) * inv;
          const float dy = dv[e] * g[i][e];
          xv[e] = inv * (dy - m1 - xh * m2);
        }
        out[j] = Vec<T>::store(xv);
      }
      cx[i] = nx[i];
      cd[i] = nd[i];
    }
  }

  // the block's partial row: dgamma, then dbeta, each summed over the warps
  // in warp order
  const int cols = 2 * d;
  float* mine = part + (long)blockIdx.x * cols;
  add_warps<kBwdWarps>(ag, red, mine, d, lane, nvec);
  add_warps<kBwdWarps>(ab, red, mine + d, d, lane, nvec);

  const int nb = gridDim.x;
  grid_barrier(sync, nb);

  // Slices of sw columns (the fewest columns that give every block at most
  // one slice, 4 to 32); thread (stream si, column ci) of a slice sums the
  // partial rows si, si + streams, ... in order, then the streams are added
  // by a fixed butterfly inside the warp and in warp order across warps.
  int sw = 4;
  while (sw < 32 && (cols + sw - 1) / sw > nb) sw *= 2;
  const int streams = kThreads / sw, ci = threadIdx.x % sw, si = threadIdx.x / sw;
  for (int c0 = blockIdx.x * sw; c0 < cols; c0 += nb * sw) {
    const int c = c0 + ci;
    float t = 0.f;
    for (int k0 = si; k0 < nb; k0 += 16 * streams) {
      float v[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int k = k0 + q * streams;
        v[q] = (c < cols && k < nb) ? __ldcg(part + (long)k * cols + c) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 16; ++q) t += v[q];
    }
    for (int o = 16; o >= sw; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane < sw) red[warp * sw + lane] = t;
    __syncthreads();
    if (threadIdx.x < sw && c < cols) {
      float u = 0.f;
#pragma unroll
      for (int w = 0; w < kBwdWarps; ++w) u += red[w * sw + threadIdx.x];
      if (c < d) dgamma[c] = u; else dbeta[c - d] = u;
    }
    __syncthreads();
  }
}

// One instantiation's cooperative launch; dynamic shared memory above 48 KB
// needs an opt-in, once per (instantiation, device).
template <typename T, int NV>
cudaError_t launch_bwd_nv(void** args, int blocks, size_t smem, int device,
                          cudaStream_t st) {
  static size_t configured[kMaxDevices] = {};
  const void* fn = reinterpret_cast<const void*>(layernorm_bwd_kernel<T, NV>);
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > configured[device]) {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    configured[device] = smem;
  }
  return cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kBwdWarps * 32), args, smem, st);
}

template <typename T>
cudaError_t launch_bwd(const void* x, const float* g, const void* dout,
                       void* dx, float* part, unsigned* sync, float* dgamma,
                       float* dbeta, int rows, int d, int blocks, int device,
                       cudaStream_t st) {
  const int nv = (d / Vec<T>::N + 31) / 32;
  const size_t smem = (size_t)std::max(kBwdWarps * d, kBwdWarps * 32) * sizeof(float);
  const T* xi = static_cast<const T*>(x);
  const T* di = static_cast<const T*>(dout);
  T* dxo = static_cast<T*>(dx);
  blocks = std::max(1, std::min(blocks, (rows + kBwdWarps - 1) / kBwdWarps));
  void* args[] = {&xi, &g, &di, &dxo, &part, &sync, &dgamma, &dbeta, &rows, &d};
  switch (nv) {
#define CASE(N) case N: return launch_bwd_nv<T, N>(args, blocks, smem, device, st);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Resident blocks an SM that the wrapper may launch for the forward
// (bwd = 0) or the backward (bwd = 1): the grid is this times the SM count.
int cmh_layernorm_blocks_per_sm(int bwd) { return bwd ? kBwdMinBlocks : kFwdMinBlocks; }

// Warps (rows in flight) a block of the forward or the backward.
int cmh_layernorm_warps_per_block(int bwd) { return bwd ? kBwdWarps : kFwdWarps; }

// dtype: 0 = float32, 1 = bfloat16. d must be a multiple of 16 bytes'
// worth of elements and at most 8 vectors per lane (the wrapper checks);
// gamma and beta 16-byte aligned. blocks >= 1 is the most blocks of the
// persistent grid (at most one warp a row is launched).
int cmh_layernorm_fwd(const void* x, const void* gamma, const void* beta,
                      void* y, int rows, int d, int blocks, int dtype, int device,
                      void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (blocks < 1) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  if (dtype == 0) return launch<float>(x, g, b, y, rows, d, blocks, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, g, b, y, rows, d, blocks, st);
  return cudaErrorInvalidValue;
}

// Backward. dout and dx have x's dtype and shape; part is (blocks, 2, d) fp32
// scratch; sync is one uint32 word that is 0 before the call and is 0 again
// after it (calls that share it must not overlap); dgamma and dbeta
// are (d,) fp32. blocks >= 1 is the most blocks of the cooperative grid,
// which must be resident at once: at most cmh_layernorm_blocks_per_sm(1)
// times the SM count (the launch fails otherwise). Dynamic shared memory is
// kBwdWarps * d floats, at most 64 KB for the widths the wrapper accepts.
int cmh_layernorm_bwd(const void* x, const void* gamma, const void* dout,
                      void* dx, void* part, void* sync, void* dgamma,
                      void* dbeta, int rows, int d, int blocks, int dtype,
                      int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (blocks < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  float* p = static_cast<float*>(part);
  unsigned* s = static_cast<unsigned*>(sync);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  if (dtype == 0)
    return launch_bwd<float>(x, g, dout, dx, p, s, dg, db, rows, d, blocks, device, st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, g, dout, dx, p, s, dg, db, rows, d,
                                     blocks, device, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
