// LayerNorm over the last axis, fp32 statistics, output in x's dtype, and its
// backward (layernorm_bwd_kernel below).
//
// Replaces the TPU kernel cmh_tpu/ops/layernorm_pallas.py:_fwd_kernel
// (called from _layernorm_fwd). Same arithmetic: mean and mean of squares in fp32,
// flax's fast variance max(E[x^2] - E[x]^2, 0), rsqrt(var + 1e-5) and
// y = (x - mu) * inv * gamma + beta, with gamma and beta in fp32.
//
// Bound on the card: bytes. Each row is read once and written once (about
// 2 flops per byte), so the design is one warp per row, 16-byte vector loads
// with neighbouring lanes on neighbouring addresses, the row held in
// registers between the reduction and the write (NV vectors per lane), and
// warp-shuffle reductions: no shared memory and no second read.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per block

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

template <typename T, int NV>
__global__ void __launch_bounds__(kWarps * 32)
layernorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, T* __restrict__ y,
                     int rows, int d) {
  constexpr int V = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nvec = d / V;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);

  float v[NV][V];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = lane + i * 32;
    if (j < nvec) {
      Vec<T>::load(xr[j], v[i]);
#pragma unroll
      for (int e = 0; e < V; ++e) { s += v[i][e]; ss += v[i][e] * v[i][e]; }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  const float mu = s / d;
  const float var = fmaxf(ss / d - mu * mu, 0.f);
  const float inv = rsqrtf(var + 1e-5f);

  uint4* yr = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = lane + i * 32;
    if (j < nvec) {
      float o[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int c = j * V + e;
        o[e] = (v[i][e] - mu) * inv * gamma[c] + beta[c];
      }
      yr[j] = Vec<T>::store(o);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* g, const float* b, void* y,
                   int rows, int d, cudaStream_t st) {
  const int nv = (d / Vec<T>::N + 31) / 32;
  const dim3 grid((rows + kWarps - 1) / kWarps), block(kWarps * 32);
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
// Bound on the card: bytes (x and dO read once, dx written once). One warp
// per row with the row of x and of dO in registers, as in the forward. Each
// block walks rows with a grid stride and keeps its lanes' dgamma/dbeta
// partials in registers (a lane owns the same columns in every row); the
// block then sums its warps in a fixed order through shared memory and
// writes one (d,) partial per block. A second kernel, layernorm_bwd_reduce,
// sums the blocks' partials column by column in block order: no float
// atomics, so the result is the same on every run. One cmh_layernorm_bwd
// call launches both kernels, and the wrapper counts it as one launch.
template <typename T, int NV>
__global__ void __launch_bounds__(kWarps * 32)
layernorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const T* __restrict__ dout, T* __restrict__ dx,
                     float* __restrict__ part_g, float* __restrict__ part_b,
                     int rows, int d) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float red[];    // (2, d): the block's dgamma, dbeta
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nvec = d / V;
  float ag[NV][V], ab[NV][V];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < V; ++e) { ag[i][e] = 0.f; ab[i][e] = 0.f; }

  for (long row = (long)blockIdx.x * kWarps + warp; row < rows;
       row += (long)gridDim.x * kWarps) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
    const uint4* dr = reinterpret_cast<const uint4*>(dout + row * d);
    float xv[NV][V], dv[NV][V];
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = lane + i * 32;
      if (j < nvec) {
        Vec<T>::load(xr[j], xv[i]);
        Vec<T>::load(dr[j], dv[i]);
#pragma unroll
        for (int e = 0; e < V; ++e) { s += xv[i][e]; ss += xv[i][e] * xv[i][e]; }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    const float mu = s / d;
    const float var = fmaxf(ss / d - mu * mu, 0.f);
    const float inv = rsqrtf(var + 1e-5f);

    float s1 = 0.f, s2 = 0.f;       // sum(dy), sum(dy * xhat)
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = lane + i * 32;
      if (j < nvec) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xh = (xv[i][e] - mu) * inv;
          const float dy = dv[i][e] * gamma[j * V + e];
          ag[i][e] += dv[i][e] * xh;
          ab[i][e] += dv[i][e];
          s1 += dy;
          s2 += dy * xh;
          xv[i][e] = xh;            // keep xhat for dx
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float m1 = s1 / d, m2 = s2 / d;
    uint4* out = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = lane + i * 32;
      if (j < nvec) {
        float o[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float dy = dv[i][e] * gamma[j * V + e];
          o[e] = inv * (dy - m1 - xv[i][e] * m2);
        }
        out[j] = Vec<T>::store(o);
      }
    }
  }

  // the block's partial sums: warps add in a fixed order
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int j = lane + i * 32;
        if (j < nvec) {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const int c = j * V + e;
            red[c] = (w == 0 ? 0.f : red[c]) + ag[i][e];
            red[d + c] = (w == 0 ? 0.f : red[d + c]) + ab[i][e];
          }
        }
      }
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < d; c += kWarps * 32) {
    part_g[(long)blockIdx.x * d + c] = red[c];
    part_b[(long)blockIdx.x * d + c] = red[d + c];
  }
}

// dgamma[c] = sum over blocks of part_g[blk, c], in block order (likewise dbeta).
__global__ void layernorm_bwd_reduce(const float* __restrict__ part_g,
                                     const float* __restrict__ part_b,
                                     float* __restrict__ dgamma,
                                     float* __restrict__ dbeta, int blocks,
                                     int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float g = 0.f, b = 0.f;
  for (int k = 0; k < blocks; ++k) {
    g += part_g[(long)k * d + c];
    b += part_b[(long)k * d + c];
  }
  dgamma[c] = g;
  dbeta[c] = b;
}

template <typename T>
cudaError_t launch_bwd(const void* x, const float* g, const void* dout,
                       void* dx, float* part_g, float* part_b, float* dgamma,
                       float* dbeta, int rows, int d, int blocks,
                       cudaStream_t st) {
  const int nv = (d / Vec<T>::N + 31) / 32;
  const size_t smem = 2 * (size_t)d * sizeof(float);
  const T* xi = static_cast<const T*>(x);
  const T* di = static_cast<const T*>(dout);
  T* dxo = static_cast<T*>(dx);
  switch (nv) {
#define CASE(N) case N: layernorm_bwd_kernel<T, N><<<blocks, kWarps * 32, smem, st>>>( \
      xi, g, di, dxo, part_g, part_b, rows, d); break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  layernorm_bwd_reduce<<<(d + 255) / 256, 256, 0, st>>>(part_g, part_b, dgamma,
                                                       dbeta, blocks, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. d must be a multiple of 16 bytes'
// worth of elements and at most 8 vectors per lane (the wrapper checks).
int cmh_layernorm_fwd(const void* x, const void* gamma, const void* beta,
                      void* y, int rows, int d, int dtype, int device,
                      void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (rows == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  if (dtype == 0) return launch<float>(x, g, b, y, rows, d, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, g, b, y, rows, d, st);
  return cudaErrorInvalidValue;
}

// Backward. dout and dx have x's dtype and shape; part_g and part_b are
// (blocks, d) fp32 scratch; dgamma and dbeta are (d,) fp32. blocks >= 1 is
// the grid of the row pass (the wrapper picks it). Dynamic shared memory is
// 2 * d floats, at most 16 KB for the widths the wrapper accepts.
int cmh_layernorm_bwd(const void* x, const void* gamma, const void* dout,
                      void* dx, void* part_g, void* part_b, void* dgamma,
                      void* dbeta, int rows, int d, int blocks, int dtype,
                      int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (blocks < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  float* pg = static_cast<float*>(part_g);
  float* pb = static_cast<float*>(part_b);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  if (dtype == 0)
    return launch_bwd<float>(x, g, dout, dx, pg, pb, dg, db, rows, d, blocks, st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, g, dout, dx, pg, pb, dg, db, rows, d,
                                     blocks, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
