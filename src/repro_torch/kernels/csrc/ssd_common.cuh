// Helpers shared by the Mamba-2 SSD kernels (ssd_chunk.cu, the forward, and
// ssd_chunk_bwd.cu, its backward): warp-level mma.sync in bf16 and TF32, the
// split of a float32 into a TF32 part and the rest, 16-byte cp.async,
// ldmatrix, and the store of a row from a permuted accumulator. build.py puts
// this directory on the include path and hashes the headers a source
// includes with the source.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ssd_common {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// the four 8 x 8 bf16 matrices transposed: lane (g, q) gets rows 2q and 2q + 1
// of column g of each (low and high half)
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// not volatile: ptxas may interleave products on independent accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v = big + small: big is v rounded to TF32 (half a TF32 ulp added, the low
// 13 bits cleared: round to nearest, ties away), small = v - big exactly;
// the tensor core reads only the top 19 bits of small, so v is kept to about
// 2^-21 of itself. Integer ops, not cvt.rna.tf32 (a slower pipe on sm_90).
__device__ __forceinline__ void split(float v, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big));
}

// the low and the high bf16 of a pair as float32 bits (exact in TF32)
__device__ __forceinline__ uint32_t bf16_lo(uint32_t pair) { return pair << 16; }
__device__ __forceinline__ uint32_t bf16_hi(uint32_t pair) { return pair & 0xffff0000u; }

// one output row's columns of this lane from accumulators acc[u][2 half],
// acc[u][2 half + 1]: column 16q + u and 16q + 8 + u, u = 0..7 (16 floats in
// a row); a row of hp < 64 stores only its columns below hp
__device__ __forceinline__ void store_cols(float* row, int hp, int q, const float (&acc)[8][4],
                                           int half) {
  float v[16];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    v[u] = acc[u][2 * half];
    v[8 + u] = acc[u][2 * half + 1];
  }
  if (hp == 64) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      reinterpret_cast<float4*>(row + 16 * q)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (16 * q + i < hp) row[16 * q + i] = v[i];
    }
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

}  // namespace ssd_common
