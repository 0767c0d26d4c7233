// Helpers of the bf16 tensor-core attention kernels, shared by attention.cu
// (one block per (batch, head)) and attention_tiled.cu (row tiles for long
// sequences): 16-byte cp.async copies, ldmatrix and its lane offsets,
// mma.sync m16n8k16 bf16 with fp32 accumulators, bf16 packing and
// unpacking, and the split of fp32 values into bf16 pieces. Everything here
// has internal linkage, so each source gets its own copy.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

struct Strides { long long b, h, s; };   // element strides; hd is contiguous

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// cp.async groups: close the copies issued so far into one group; wait until
// at most N of this thread's groups are still in flight
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 products, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) as the sum of NP bf16 pairs, largest first: each piece is the bf16
// rounding of what the earlier ones left (an exact fp32 difference). Three
// pieces carry all 24 bits of an fp32 value above about 2^-110.
template <int NP>
__device__ __forceinline__ void split_pair(float x, float y, uint32_t (&out)[NP]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
    out[p] = *reinterpret_cast<const uint32_t*>(&v);
    x -= __low2float(v);
    y -= __high2float(v);
  }
}

// ldmatrix lane offsets into a row-major bf16 tile with leading dimension ld
// A operand (16 x 16 at row 0, col 0) of a row-major M x K tile
__device__ __forceinline__ int a_off(int lane, int ld) {
  return (lane & 15) * ld + (lane >> 4) * 8;
}
// B operands of two n-tiles (16 rows of an N x K tile = two n-tiles of 8)
__device__ __forceinline__ int b_off(int lane, int ld) {
  return ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
}
// B operands of two n-tiles through .trans, from a K x N tile (rows = k)
__device__ __forceinline__ int bt_off(int lane, int ld) {
  return (lane & 15) * ld + (lane >> 4) * 8;
}
// A operand through .trans, from a K x M tile (rows = k): A = tile^T
__device__ __forceinline__ int at_off(int lane, int ld) {
  return ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

}  // namespace
