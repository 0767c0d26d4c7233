// JAX's threefry2x32 random bits and flax's dropout, drawn on the card.
//
// Replaces no Pallas kernel: cmh_tpu draws its random bits with XLA's own
// threefry2x32 (jax/_src/prng.py) and applies flax.linen.Dropout in plain
// jnp. These kernels compute each mask element where it is used, from the
// key and the element's flat index, and never store a mask.
//
// The stream (jax 0.9, partitionable mode): the bits of flat C-order index
// i under key (k0, k1) are y0 ^ y1, where (y0, y1) = threefry2x32(k0, k1;
// hi32(i), lo32(i)). Threefry-2x32 is 20 rounds of add, rotate and xor, a
// key injection every 4 rounds (Salmon et al., SC'11). flax's Dropout keeps
// an element where the float32 uniform made from its bits,
// ((bits >> 9) | 0x3F800000) as a float minus 1, is below keep_prob, and
// writes x / keep_prob there (keep_prob rounded to x's dtype) and 0 elsewhere.
// That uniform is (bits >> 9) / 2^23 exactly, so the test is the integer
// compare (bits >> 9) < below, below = ceil(keep_prob · 2^23).
//
// The index is the element's flat index in cmh_tpu's array at that dropout
// site. A tensor that is one part of that array along one dimension (a
// tensor-parallel shard of the heads, a data-parallel block of rows) maps
// its local element i to whole index base + i + (i / period) · gap, where
// period = part · inner and gap = (whole − part) · inner local elements.
//
// Bound on the card: 32-bit integer instructions. A word costs 20 rounds of
// add, rotate and xor, the key injections and the output xor, 73 operations,
// against 4 bytes written (4 to 8 more an element read and written for the
// dropout); an SM issues at most 128 thread-instructions a clock, and the
// rotate (SHF) and the xor (LOP3) can only go to the ALU pipe, which takes
// half of that. Design (tools/threefry_variants.py times each choice):
//   - the rotation as one funnel shift by an immediate and the xor as one
//     LOP3; ptxas places the rounds' adds on the FMA pipe (IMAD.IADD), and
//     x0's key injections go there too as an IMAD by a 1 it cannot see,
//     which leaves 42 ALU instructions a word. Each rotation as one
//     IMAD.WIDE.U32 by 2^r on the FMA pipe instead (its halves' OR and the
//     xor one LOP3) took 53% longer: the wide multiply issues at a fraction
//     of IMAD's rate;
//   - 32-bit counters: the host splits a call where its whole indices cross a
//     multiple of 2^32 (ops/random.py:launches), so hi32 is a launch constant,
//     x0's first value and the key injections are kernel arguments, and the
//     part map is one multiply-high division by a launch constant;
//   - several elements a thread, one 16-byte load and store (4 fp32, 8 bf16,
//     4 words), a head and a tail of single elements for an unaligned start
//     and a ragged n;
//   - the division as a reciprocal product with two FMA residual corrections,
//     which the host proves equal to IEEE division at every input of the
//     dtype before it asks for it (cmh_dropout_division_mismatches), with one
//     branch a vector to __fdiv_rn for inputs past its range, inf and NaN.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// A launch's constants: x0's first value, x1's offset, the key injections
// and a 1 that ptxas cannot see (add_on_fma).
struct Key {
  uint32_t x0, x1;
  uint32_t inj0[5], inj1[5];
  uint32_t one;
};

Key make_key(uint32_t k0, uint32_t k1, uint32_t hi, uint32_t lo) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const uint32_t ks[3] = {k0, k1, k2};
  Key k;
  k.x0 = hi + k0;
  k.x1 = lo + k1;
  for (int s = 0; s < 5; ++s) {
    k.inj0[s] = ks[(s + 1) % 3];
    k.inj1[s] = ks[(s + 2) % 3] + static_cast<uint32_t>(s + 1);
  }
  k.one = 1;
  return k;
}

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
}

// four rounds: x0 += x1 (IMAD.IADD, FMA pipe, as ptxas places it), x1
// rotated (SHF, ALU pipe) and xor x0 (LOP3, ALU pipe)
__device__ __forceinline__ void round4(uint32_t& x0, uint32_t& x1, int a, int b, int c,
                                       int d) {
  x0 += x1; x1 = rotl(x1, a) ^ x0;
  x0 += x1; x1 = rotl(x1, b) ^ x0;
  x0 += x1; x1 = rotl(x1, c) ^ x0;
  x0 += x1; x1 = rotl(x1, d) ^ x0;
}

// x += c as an IMAD by the host's 1, on the FMA pipe: a plain add ptxas
// folds into the next round's add, a three-input IADD3 on the ALU pipe
__device__ __forceinline__ void add_on_fma(uint32_t& x, uint32_t c, uint32_t one) {
  asm("mad.lo.u32 %0, %0, %1, %2;" : "+r"(x) : "r"(one), "r"(c));
}

// word 1 XOR word 2 of threefry2x32 of the counter (hi, lo + j), hi and lo
// folded into the key's x0 and x1
__device__ __forceinline__ uint32_t threefry_bits(const Key& k, uint32_t j) {
  uint32_t x0 = k.x0, x1 = k.x1 + j;
  round4(x0, x1, 13, 15, 26, 6);
  add_on_fma(x0, k.inj0[0], k.one); x1 += k.inj1[0];
  round4(x0, x1, 17, 29, 16, 24);
  add_on_fma(x0, k.inj0[1], k.one); x1 += k.inj1[1];
  round4(x0, x1, 13, 15, 26, 6);
  add_on_fma(x0, k.inj0[2], k.one); x1 += k.inj1[2];
  round4(x0, x1, 17, 29, 16, 24);
  add_on_fma(x0, k.inj0[3], k.one); x1 += k.inj1[3];
  round4(x0, x1, 13, 15, 26, 6);
  add_on_fma(x0, k.inj0[4], k.one); x1 += k.inj1[4];
  return x0 ^ x1;
}

// Elements a thread and their 16-byte word.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  }
  __device__ static void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ static float get(const float* p) { return *p; }
  __device__ static void put(float* p, float v) { *p = v; }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[8]) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      u[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  }
  __device__ static float get(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  __device__ static void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
};

// The dropout's constants: the keep test, the divisor and the part map.
struct Drop {
  uint32_t below;       // kept where (bits >> 9) < below
  float scale, rcp;     // keep_prob rounded to x's dtype, as a float; 1 / scale
  float rcp_s;          // rcp · 2^-32
  float fast_max;       // |x| up to this takes the reciprocal path (−1: none)
  uint32_t r0;          // the launch's first element's offset in its period
  uint32_t magic, gap;  // (r0 + j) / period = ((r0 + j) · magic) >> shift
  int shift;
};

// x / scale, rounded as IEEE division rounds it where the host proved it so:
// the product by the correctly rounded reciprocal and two corrections
// q −= e · rcp by the residual e = q · scale − x, which one FMA gives
// exactly once it is scaled by 2^32 out of the subnormal range (written so
// that −0 keeps its sign)
__device__ __forceinline__ float fast_quotient(float v, const Drop& d) {
  const float vs = v * 0x1p32f;
  float q = v * d.rcp;
  q = fmaf(-fmaf(q * 0x1p32f, d.scale, -vs), d.rcp_s, q);
  return fmaf(-fmaf(q * 0x1p32f, d.scale, -vs), d.rcp_s, q);
}

// whether fast_quotient may take v: |v| up to fast_max (not inf or NaN)
__device__ __forceinline__ bool fast(float v, const Drop& d) {
  return fabsf(v) <= d.fast_max;
}

__device__ __forceinline__ float quotient(float v, const Drop& d) {
  return fast(v, d) ? fast_quotient(v, d) : __fdiv_rn(v, d.scale);
}

// the counter's low word, less the launch's first, of the launch's element j
template <bool kPart>
__device__ __forceinline__ uint32_t counter(uint32_t j, const Drop& d) {
  if (!kPart) return j;
  const uint32_t q = static_cast<uint32_t>(
      (static_cast<uint64_t>(d.r0 + j) * d.magic) >> d.shift);
  return j + q * d.gap;
}

template <typename T, bool kPart>
__device__ __forceinline__ void drop_one(const Key& k, const Drop& d, const T* x, T* out,
                                         uint32_t j) {
  const uint32_t bits = threefry_bits(k, counter<kPart>(j, d));
  Vec<T>::put(out + j, (bits >> 9) < d.below ? quotient(Vec<T>::get(x + j), d) : 0.0f);
}

// out = keep ? x / scale : 0 over the launch's n elements; head elements
// come before the first 16-byte boundary of x (and of out, aligned alike)
template <typename T, bool kPart>
__global__ void __launch_bounds__(kThreads) dropout_kernel(
    const __grid_constant__ Key k, const __grid_constant__ Drop d, const T* __restrict__ x,
    T* __restrict__ out, uint32_t n, uint32_t head) {
  constexpr int V = Vec<T>::kN;
  const uint32_t tid = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t nv = (n - head) / V;
  for (uint32_t v = tid; v < nv; v += gridDim.x * blockDim.x) {
    const uint32_t j = head + v * V;
    float a[V];
    uint32_t bits[V];
    bool slow = false;
    Vec<T>::load(x + j, a);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      bits[e] = threefry_bits(k, counter<kPart>(j + e, d));
      slow |= !fast(a[e], d);
    }
    // one branch a vector, which only a lane holding an input the
    // reciprocal may not take (or every lane, for an unproved divisor) takes
    if (slow) {
#pragma unroll
      for (int e = 0; e < V; ++e) a[e] = __fdiv_rn(a[e], d.scale);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) a[e] = fast_quotient(a[e], d);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) a[e] = (bits[e] >> 9) < d.below ? a[e] : 0.0f;
    Vec<T>::store(out + j, a);
  }
  if (tid < head) drop_one<T, kPart>(k, d, x, out, tid);
  if (tid < n - head - nv * V) drop_one<T, kPart>(k, d, x, out, head + nv * V + tid);
}

// the bits of the launch's n counters, 4 words a 16-byte store
__global__ void __launch_bounds__(kThreads) threefry_bits_kernel(
    const __grid_constant__ Key k, uint32_t* __restrict__ out, uint32_t n, uint32_t head) {
  const uint32_t tid = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t nv = (n - head) / 4;
  for (uint32_t v = tid; v < nv; v += gridDim.x * blockDim.x) {
    const uint32_t j = head + v * 4;
    *reinterpret_cast<uint4*>(out + j) = make_uint4(
        threefry_bits(k, j), threefry_bits(k, j + 1), threefry_bits(k, j + 2),
        threefry_bits(k, j + 3));
  }
  if (tid < head) out[tid] = threefry_bits(k, tid);
  const uint32_t t = head + nv * 4 + tid;
  if (t < n) out[t] = threefry_bits(k, t);
}

// How many inputs of the dtype (every float32 bit pattern, or every
// bfloat16) the reciprocal path divides otherwise than IEEE division, and
// the least and the greatest |x| bit pattern among them: out[0], out[1], out[2]
// (out[1] starts at ~0).
template <typename T>
__global__ void __launch_bounds__(kThreads) division_check_kernel(
    const __grid_constant__ Drop d, unsigned long long* out) {
  const uint64_t total = sizeof(T) == 4 ? (1ull << 32) : (1ull << 16);
  unsigned long long bad = 0, least = ~0ull, most = 0;
  for (uint64_t i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += static_cast<uint64_t>(gridDim.x) * blockDim.x) {
    const uint32_t u = static_cast<uint32_t>(i);
    const float v = sizeof(T) == 4 ? __uint_as_float(u) : __uint_as_float(u << 16);
    float got = quotient(v, d), want = __fdiv_rn(v, d.scale);
    if (sizeof(T) == 2) {
      got = __bfloat162float(__float2bfloat16_rn(got));
      want = __bfloat162float(__float2bfloat16_rn(want));
    }
    if (__float_as_uint(got) != __float_as_uint(want) && !(got != got && want != want)) {
      const unsigned long long a = __float_as_uint(v) & 0x7FFFFFFFu;
      ++bad;
      least = a < least ? a : least;
      most = a > most ? a : most;
    }
  }
  if (bad) {
    atomicAdd(out, bad);
    atomicMin(out + 1, least);
    atomicMax(out + 2, most);
  }
}

int grid_for(uint32_t items) {
  const uint32_t blocks = (items + kThreads - 1) / kThreads;
  const uint32_t cap = 132 * 16;   // a grid-stride loop past 16 blocks an SM
  return static_cast<int>(blocks < 1 ? 1 : (blocks > cap ? cap : blocks));
}

// elements of size `size` before the first 16-byte boundary at or after p
uint32_t head_of(const void* p, uint32_t n, uint32_t size) {
  const uint32_t h = static_cast<uint32_t>((16 - reinterpret_cast<uintptr_t>(p) % 16) % 16) / size;
  return h < n ? h : n;
}

Drop make_drop(uint32_t below, float scale, int fast, uint32_t period, uint32_t r0,
               uint32_t magic, int shift, uint32_t gap) {
  Drop d;
  d.below = below;
  d.scale = scale;
  d.rcp = 1.0f / scale;
  d.rcp_s = d.rcp * 0x1p-32f;
  // the quotient up to 2^92, so that q · 2^32 stays finite
  d.fast_max = fast ? scale * 0x1p92f : -1.0f;
  d.r0 = r0;
  d.magic = magic;
  d.gap = gap;
  d.shift = shift;
  return d;
}

template <typename T>
int launch_dropout(const Key& k, const Drop& d, bool part, const void* x, void* out,
                   uint32_t n, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(out)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);   // x and out must align alike
  const uint32_t head = head_of(x, n, sizeof(T));
  const int grid = grid_for((n - head) / Vec<T>::kN);
  const T* xs = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (part)
    dropout_kernel<T, true><<<grid, kThreads, 0, stream>>>(k, d, xs, o, n, head);
  else
    dropout_kernel<T, false><<<grid, kThreads, 0, stream>>>(k, d, xs, o, n, head);
  return static_cast<int>(cudaGetLastError());
}

int dropout(uint32_t k0, uint32_t k1, uint32_t hi, uint32_t lo, const void* x, void* out,
            uint32_t n, uint32_t below, float scale, int fast, uint32_t period, uint32_t r0,
            uint32_t magic, int shift, uint32_t gap, int dtype, void* stream) {
  if (n == 0) return 0;
  const Key k = make_key(k0, k1, hi, lo);
  const Drop d = make_drop(below, scale, fast, period, r0, magic, shift, gap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_dropout<float>(k, d, period != 0, x, out, n, s)
                    : launch_dropout<__nv_bfloat16>(k, d, period != 0, x, out, n, s);
}

}  // namespace

extern "C" {

// uint32 bits of the counters (hi, lo) … (hi, lo + n − 1) into out (n words);
// lo + n − 1 < 2^32, and n < 2^31
int cmh_threefry_bits(uint32_t k0, uint32_t k1, uint32_t hi, uint32_t lo, void* out,
                      uint32_t n, void* stream) {
  if (n == 0) return 0;
  const uint32_t head = head_of(out, n, 4);
  threefry_bits_kernel<<<grid_for((n - head) / 4), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      make_key(k0, k1, hi, lo), static_cast<uint32_t*>(out), n, head);
  return static_cast<int>(cudaGetLastError());
}

// flax's Dropout of x (n contiguous elements; dtype 0 = float32, 1 = bfloat16;
// out aligned as x is modulo 16 bytes). The launch's element j has counter
// (hi, lo + j + ((r0 + j) / period) · gap), or (hi, lo + j) when period is 0;
// r0 + n ≤ 2^31, and ((r0 + j) · magic) >> shift is (r0 + j) / period.
// fast: the host proved the reciprocal path for this scale and dtype.
int cmh_dropout_fwd(uint32_t k0, uint32_t k1, uint32_t hi, uint32_t lo, const void* x,
                    void* out, uint32_t n, uint32_t below, float scale, int fast,
                    uint32_t period, uint32_t r0, uint32_t magic, int shift, uint32_t gap,
                    int dtype, void* stream) {
  return dropout(k0, k1, hi, lo, x, out, n, below, scale, fast, period, r0, magic, shift, gap,
                 dtype, stream);
}

// Its backward: the same mask, derived again from the key, on the incoming
// gradient (the transpose of select(mask, x / kp, 0) is select(mask, g / kp, 0)).
int cmh_dropout_bwd(uint32_t k0, uint32_t k1, uint32_t hi, uint32_t lo, const void* grad,
                    void* out, uint32_t n, uint32_t below, float scale, int fast,
                    uint32_t period, uint32_t r0, uint32_t magic, int shift, uint32_t gap,
                    int dtype, void* stream) {
  return dropout(k0, k1, hi, lo, grad, out, n, below, scale, fast, period, r0, magic, shift,
                 gap, dtype, stream);
}

// Counts on the card how many inputs of the dtype the reciprocal path divides
// by scale otherwise than IEEE division does: out (3 device uint64, zero,
// ~0, zero) gets the count and the least and greatest |x| bits among them.
int cmh_dropout_division_mismatches(float scale, int dtype, void* out, void* stream) {
  const Drop d = make_drop(0, scale, 1, 0, 0, 0, 0, 0);
  auto* o = static_cast<unsigned long long*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    division_check_kernel<float><<<132 * 16, kThreads, 0, s>>>(d, o);
  else
    division_check_kernel<__nv_bfloat16><<<256, kThreads, 0, s>>>(d, o);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
