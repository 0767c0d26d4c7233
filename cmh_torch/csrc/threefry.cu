// JAX's threefry2x32 random bits and flax's dropout, drawn on the card.
//
// Replaces no Pallas kernel: cmh_tpu draws its random bits with XLA's own
// threefry2x32 (jax/_src/prng.py) and applies flax.linen.Dropout in plain
// jnp. The port used to draw its dropout masks on the host and copy them
// over; these kernels compute each mask element where it is used, from the
// key and the element's flat index, and never store a mask.
//
// The stream (jax 0.9, partitionable mode): the bits of flat C-order index
// i under key (k0, k1) are y0 ^ y1, where (y0, y1) = threefry2x32(k0, k1;
// hi32(i), lo32(i)). Threefry-2x32 is 20 rounds of add, rotate and xor, a
// key injection every 4 rounds (Salmon et al., SC'11). flax's Dropout keeps
// an element where the float32 uniform made from its bits,
// ((bits >> 9) | 0x3F800000) as a float minus 1, is below keep_prob, and
// writes x / keep_prob there (keep_prob rounded to x's dtype) and 0 elsewhere.
//
// The index is the element's flat index in cmh_tpu's array at that dropout
// site. A tensor that is one part of that array along one dimension (a
// tensor-parallel shard of the heads, a data-parallel block of rows) passes
// the whole size of that dimension and its start: local element
// ((outer, mid, inner)) with mid < part is whole element
// ((outer, start + mid, inner)), so each part draws exactly its elements of
// the whole mask.
//
// Bound on the card: memory, at these rates. An element costs 72 32-bit
// integer operations in the generator (20 rounds of add, rotate and xor; five
// injections of two adds; two initial adds), one xor, and about 5 more to form
// the counter, the uniform and the select; ptxas fuses some (IADD3, LOP3), and
// the card issued them at about 21 T a second (2^26 words in 0.235 ms on an
// H100 80GB HBM3 at 700 W, chip_smoke.py phase 18), so at the 67 T/s of its
// 32-bit pipes the bytes (4 a word; 8 or 4 an fp32 or bf16 element, read and
// written) bound it. Design: one thread an element, a grid-stride loop, the
// rotations as funnel shifts, the key words as arguments in registers; the
// part's index map only where the tensor is a part.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
}

__device__ __forceinline__ void round4(uint32_t& x0, uint32_t& x1, int a, int b,
                                       int c, int d) {
  x0 += x1; x1 = rotl(x1, a); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, b); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, c); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, d); x1 ^= x0;
}

// word 1 XOR word 2 of threefry2x32 of the counter (hi, lo)
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint64_t counter) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = static_cast<uint32_t>(counter >> 32) + k0;
  uint32_t x1 = static_cast<uint32_t>(counter) + k1;
  round4(x0, x1, 13, 15, 26, 6);
  x0 += k1; x1 += k2 + 1u;
  round4(x0, x1, 17, 29, 16, 24);
  x0 += k2; x1 += k0 + 2u;
  round4(x0, x1, 13, 15, 26, 6);
  x0 += k0; x1 += k1 + 3u;
  round4(x0, x1, 17, 29, 16, 24);
  x0 += k1; x1 += k2 + 4u;
  round4(x0, x1, 13, 15, 26, 6);
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

__global__ void threefry_bits_kernel(uint32_t k0, uint32_t k1, uint64_t offset,
                                     int64_t n, uint32_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = threefry_bits(k0, k1, offset + static_cast<uint64_t>(i));
  }
}

template <typename T> struct Elem;
template <> struct Elem<float> {
  __device__ static float load(const float* p) { return *p; }
  __device__ static void store(float* p, float v) { *p = v; }
};
template <> struct Elem<__nv_bfloat16> {
  __device__ static float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  __device__ static void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
};

// out = keep ? x / scale : 0 at every element of the part. keep_prob is the
// float32 threshold of the uniform; scale is keep_prob rounded to T, as a
// float. inner, part, whole, start describe the part (part == whole and
// start == 0 for a whole array).
template <typename T>
__global__ void dropout_kernel(uint32_t k0, uint32_t k1, const T* __restrict__ x,
                               T* __restrict__ out, int64_t n, float keep_prob,
                               float scale, int64_t inner, int64_t part,
                               int64_t whole, int64_t start) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const bool is_part = part != whole;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    int64_t g = i;
    if (is_part) {
      const int64_t in = i % inner, t = i / inner;
      g = ((t / part) * whole + start + t % part) * inner + in;
    }
    const uint32_t bits = threefry_bits(k0, k1, static_cast<uint64_t>(g));
    const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
    const float v = Elem<T>::load(x + i);
    Elem<T>::store(out + i, u < keep_prob ? __fdiv_rn(v, scale) : 0.0f);
  }
}

int grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  const int64_t cap = 132 * 16;   // a grid-stride loop past 16 blocks an SM
  return static_cast<int>(blocks < 1 ? 1 : (blocks > cap ? cap : blocks));
}

template <typename T>
int launch_dropout(uint32_t k0, uint32_t k1, const void* x, void* out, int64_t n,
                   float keep_prob, float scale, int64_t inner, int64_t part,
                   int64_t whole, int64_t start, cudaStream_t stream) {
  constexpr int kThreads = 256;
  dropout_kernel<T><<<grid_for(n, kThreads), kThreads, 0, stream>>>(
      k0, k1, static_cast<const T*>(x), static_cast<T*>(out), n, keep_prob, scale,
      inner, part, whole, start);
  return static_cast<int>(cudaGetLastError());
}

int dropout(uint32_t k0, uint32_t k1, const void* x, void* out, int64_t n,
            float keep_prob, float scale, int64_t inner, int64_t part, int64_t whole,
            int64_t start, int dtype, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
      ? launch_dropout<float>(k0, k1, x, out, n, keep_prob, scale, inner, part, whole,
                              start, s)
      : launch_dropout<__nv_bfloat16>(k0, k1, x, out, n, keep_prob, scale, inner, part,
                                      whole, start, s);
}

}  // namespace

extern "C" {

// uint32 bits of the flat indices offset … offset + n − 1 into out (n words).
int cmh_threefry_bits(uint32_t k0, uint32_t k1, uint64_t offset, int64_t n, void* out,
                      void* stream) {
  if (n <= 0) return 0;
  constexpr int kThreads = 256;
  threefry_bits_kernel<<<grid_for(n, kThreads), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      k0, k1, offset, n, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// flax's Dropout of x (n contiguous elements; dtype 0 = float32, 1 = bfloat16).
int cmh_dropout_fwd(uint32_t k0, uint32_t k1, const void* x, void* out, int64_t n,
                    float keep_prob, float scale, int64_t inner, int64_t part,
                    int64_t whole, int64_t start, int dtype, void* stream) {
  return dropout(k0, k1, x, out, n, keep_prob, scale, inner, part, whole, start, dtype,
                 stream);
}

// Its backward: the same mask, derived again from the key, on the incoming
// gradient (the transpose of select(mask, x / kp, 0) is select(mask, g / kp, 0)).
int cmh_dropout_bwd(uint32_t k0, uint32_t k1, const void* grad, void* out, int64_t n,
                    float keep_prob, float scale, int64_t inner, int64_t part,
                    int64_t whole, int64_t start, int dtype, void* stream) {
  return dropout(k0, k1, grad, out, n, keep_prob, scale, inner, part, whole, start,
                 dtype, stream);
}

}  // extern "C"
