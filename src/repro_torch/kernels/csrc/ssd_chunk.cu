// Mamba-2 intra-chunk SSD (state-space duality) over chunk tiles.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_chunk.py: ssd_chunk
// (pallas_call at :72). For each tile z (one chunk of one sequence) and
// head h, with cum the inclusive prefix sum of the per-step log decay a:
//
//   y[z, l, h, :]  = sum_{m <= l} (C_l . B_m) exp(cum_l - cum_m) x[z, m, h, :]
//   st[z, h, :, :] = sum_l exp(cum_last - cum_l) B_l (outer) x[z, l, h, :]
//
// x (nb, Lc, nh, hp) and a (nb, Lc, nh) float32, contiguous; B and C
// (nb, Lc, g, n) float32 or bfloat16 with any strides but a contiguous last
// axis (a stride-0 head axis from expand() included); head h reads group
// h / (nh / g). y (nb, Lc, nh, hp) and st (nb, nh, n, hp) float32. The sum
// over m <= l touches only causal pairs, and exp(cum_l - cum_m) is computed
// only there, so no inf * 0 arises above the diagonal. The inter-chunk
// recurrence stays outside, as the TPU kernel's docstring splits it.
//
// Bound on an H100: at the Mamba-2 2.7B prefill shapes (Lc 256, nh 80,
// hp 64, n 128, one group), the kernel moves x in, y and st out (21 + 21 +
// 10.5 MB at 1024 tokens, 16 us at 3.35 TB/s) but computes about 2.7
// GFLOP in float32 (C.B^T once per tile, then Lc^2/2 * hp and Lc * n * hp
// multiply-adds per head), 40 us at 67 TFLOP/s: operations bound it.
//
// Design (simple, right first; float32 CUDA cores, no tensor cores): the
// grid is (head groups of 8, row tiles of 64 + 2 state blocks, tiles). A
// "y" block computes G = C.B^T for its 64 rows against every column up to
// the diagonal once (B and C are shared by all heads of a group), keeps G in
// shared memory, and then for each of its heads forms the masked decayed
// 64 x 64 tile P = G * exp(cum_l - cum_m) and accumulates P.x in registers.
// A "state" block accumulates B^T.(w x) over the chunk for 4 heads,
// w = exp(cum_last - cum_l) folded into x as it is staged. Each thread of
// the 16 x 16 grid owns a 4 x 4 (state: 8 x 4) tile of contiguous rows and
// columns, so every step of the inner products reads its operands as
// float4s: the tiles that are read along rows (C, B, P) are stored
// transposed, padded by 4 floats to spread the banks. The prefix sums take
// one warp per head with shuffles.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid, each thread a 4 x 4 (or 8 x 4) tile
constexpr int kTL = 64;        // rows (l) per tile
constexpr int kTM = 64;        // columns (m) per tile
constexpr int kHT = 8;         // heads per block group = warps per block
constexpr int kHS = 4;         // heads per state block
constexpr int kSB = kHT / kHS; // state blocks per group
constexpr int kMaxLc = 256;
constexpr int kMaxN = 128;
constexpr int kMaxHp = 64;
constexpr int kLdT = kTL + 4;   // transposed tiles: rows of 64, padded to shift banks
constexpr int kLdB = kMaxN + 4; // B rows of the state phase, zero past n
constexpr int kLdX = kMaxHp;    // x rows, zero past hp

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

struct Shape {
  int nb, lc, nh, hp, n, rep;
  long long sb0, sb1, sb2;  // strides of B and C, in elements
};

inline int imax(int p, int q) { return p > q ? p : q; }

inline size_t smem_bytes(const Shape& s) {
  const int region = imax(2 * s.n * kLdT,                          // C^T and B^T tiles
                          imax(kTM * kLdX + kTM * kLdT,             // x and P^T tiles
                               kTL * kLdB + kTL * kLdX));           // B and weighted x
  return sizeof(float) * ((size_t)kHT * s.lc + (size_t)s.lc * kLdT + region);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ a,
                 const T* __restrict__ bm, const T* __restrict__ cm,
                 float* __restrict__ y, float* __restrict__ st, Shape s) {
  extern __shared__ __align__(16) float smem[];
  const int lc = s.lc, nh = s.nh, hp = s.hp, n = s.n;
  float* cum = smem;               // (kHT, lc)
  float* gt = cum + kHT * lc;      // G^T (lc, kLdT): gt[m][l] = C_l . B_m
  float* region = gt + lc * kLdT;  // tiles, reused by each phase

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int h0 = blockIdx.x * kHT;
  const long long z = blockIdx.z;
  const int n_lt = (lc + kTL - 1) / kTL;

  // prefix sums of a over the chunk, one warp per head
  if (h0 + warp < nh) {
    float carry = 0.f;
    for (int c0 = 0; c0 < lc; c0 += 32) {
      const int l = c0 + lane;
      float v = l < lc ? a[(z * lc + l) * nh + h0 + warp] : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += t;
      }
      v += carry;
      if (l < lc) cum[warp * lc + l] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();

  if ((int)blockIdx.y < n_lt) {
    // ---------------- y block: rows [l0, l0 + l_cnt) ----------------
    // thread (tx, ty) owns rows 4 ty .. 4 ty + 3 and columns 4 tx .. 4 tx + 3
    const int l0 = blockIdx.y * kTL;
    const int l_cnt = min(kTL, lc - l0);
    const int m_end = l0 + l_cnt;  // causal: columns below the last row
    float* ct = region;             // C^T (n, kLdT)
    float* bt = region + n * kLdT;  // B^T (n, kLdT)
    float* xs = region;             // x (kTM, kLdX), once G is built
    float* pt = region + kTM * kLdX;  // P^T (kTM, kLdT)
    int cur_grp = -1;
    for (int hh = 0; hh < kHT && h0 + hh < nh; ++hh) {
      const int h = h0 + hh;
      const int grp = h / s.rep;
      if (grp != cur_grp) {
        // G[l, m] = C_l . B_m for this group, stored transposed
        __syncthreads();  // the region is free
        for (int i = tid; i < kTL * n; i += kThreads) {
          const int l = i / n, k = i - l * n;
          ct[k * kLdT + l] = l < l_cnt ? to_f(cm[z * s.sb0 + (l0 + l) * s.sb1 + grp * s.sb2 + k]) : 0.f;
        }
        for (int m0 = 0; m0 < m_end; m0 += kTM) {
          const int m_cnt = min(kTM, m_end - m0);
          __syncthreads();  // the previous B tile is consumed
          for (int i = tid; i < kTM * n; i += kThreads) {
            const int j = i / n, k = i - j * n;
            bt[k * kLdT + j] = j < m_cnt ? to_f(bm[z * s.sb0 + (m0 + j) * s.sb1 + grp * s.sb2 + k]) : 0.f;
          }
          __syncthreads();
          float acc[4][4] = {};
#pragma unroll 4
          for (int k = 0; k < n; ++k) {
            const float4 c4 = ld4(ct + k * kLdT + 4 * ty);
            const float4 b4 = ld4(bt + k * kLdT + 4 * tx);
            const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
            const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] += cv[i] * bv[j];
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (4 * tx + j < m_cnt) {
              *reinterpret_cast<float4*>(gt + (m0 + 4 * tx + j) * kLdT + 4 * ty) =
                  make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
            }
          }
        }
        cur_grp = grp;
      }

      const float* ch = cum + hh * lc;
      float yacc[4][4] = {};
      for (int m0 = 0; m0 < m_end; m0 += kTM) {
        const int m_cnt = min(kTM, m_end - m0);
        __syncthreads();  // G is complete; the previous x and P tiles are consumed
        for (int i = tid; i < kTM * kLdX; i += kThreads) {
          const int j = i / kLdX, p = i - j * kLdX;
          xs[i] = j < m_cnt && p < hp ? x[((z * lc + m0 + j) * nh + h) * hp + p] : 0.f;
        }
        for (int i = tid; i < kTM * kTL; i += kThreads) {
          const int j = i / kTL, l = i - j * kTL;
          const int lg = l0 + l, mg = m0 + j;
          float pv = 0.f;
          if (l < l_cnt && j < m_cnt && mg <= lg) pv = gt[mg * kLdT + l] * expf(ch[lg] - ch[mg]);
          pt[j * kLdT + l] = pv;
        }
        __syncthreads();
#pragma unroll 4
        for (int j = 0; j < m_cnt; ++j) {
          const float4 p4 = ld4(pt + j * kLdT + 4 * ty);
          const float4 x4 = ld4(xs + j * kLdX + 4 * tx);
          const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
          const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int c = 0; c < 4; ++c) yacc[i][c] += pv[i] * xv[c];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = 4 * ty + i;
        if (l >= l_cnt) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = 4 * tx + c;
          if (p < hp) y[((z * lc + l0 + l) * nh + h) * hp + p] = yacc[i][c];
        }
      }
    }
  } else {
    // ---------------- state block: kHS heads, the whole chunk ----------------
    // thread (tx, ty) owns state rows 8 ty .. 8 ty + 7 and columns 4 tx .. 4 tx + 3
    const int hs0 = ((int)blockIdx.y - n_lt) * kHS;
    float* bs = region;               // B (kTL, kLdB)
    float* xw = region + kTL * kLdB;  // decayed x (kTL, kLdX)
    for (int hh = hs0; hh < hs0 + kHS && h0 + hh < nh; ++hh) {
      const int h = h0 + hh;
      const int grp = h / s.rep;
      const float* ch = cum + hh * lc;
      const float c_last = ch[lc - 1];
      float acc[8][4] = {};
      for (int l0 = 0; l0 < lc; l0 += kTL) {
        const int l_cnt = min(kTL, lc - l0);
        __syncthreads();  // the previous tiles are consumed
        for (int i = tid; i < kTL * kLdB; i += kThreads) {
          const int l = i / kLdB, k = i - l * kLdB;
          bs[i] = l < l_cnt && k < n ? to_f(bm[z * s.sb0 + (l0 + l) * s.sb1 + grp * s.sb2 + k]) : 0.f;
        }
        for (int i = tid; i < kTL * kLdX; i += kThreads) {
          const int l = i / kLdX, p = i - l * kLdX;
          float v = 0.f;
          if (l < l_cnt && p < hp) {
            v = x[((z * lc + l0 + l) * nh + h) * hp + p] * expf(c_last - ch[l0 + l]);
          }
          xw[i] = v;
        }
        __syncthreads();
#pragma unroll 4
        for (int l = 0; l < l_cnt; ++l) {
          const float4 b0 = ld4(bs + l * kLdB + 8 * ty);
          const float4 b1 = ld4(bs + l * kLdB + 8 * ty + 4);
          const float4 x4 = ld4(xw + l * kLdX + 4 * tx);
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
          const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][c] += bv[i] * xv[c];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = 8 * ty + i;
        if (r >= n) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = 4 * tx + c;
          if (p < hp) st[((z * nh + h) * n + r) * hp + p] = acc[i][c];
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* a, const void* b, const void* c, void* y,
           void* st, const Shape& s, cudaStream_t stream) {
  const size_t smem = smem_bytes(s);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s.nh + kHT - 1) / kHT, (s.lc + kTL - 1) / kTL + kSB, s.nb);
  ssd_chunk_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<float*>(y),
      static_cast<float*>(st), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bc_dtype: 0 = float32, 1 = bfloat16 (x and a are float32). Lc <= 256,
// n <= 128, hp <= 64, nh a multiple of g. Returns a cudaError_t.
extern "C" int ssd_chunk_fwd(const void* x, const void* a, const void* b, const void* c,
                             void* y, void* st, int bc_dtype, int nb, int lc, int nh,
                             int hp, int n, int g, long long sb0, long long sb1,
                             long long sb2, void* stream) {
  if (lc <= 0 || lc > kMaxLc || n <= 0 || n > kMaxN || hp <= 0 || hp > kMaxHp ||
      g <= 0 || nh % g != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb == 0 || nh == 0) return 0;
  const Shape s{nb, lc, nh, hp, n, nh / g, sb0, sb1, sb2};
  cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  if (bc_dtype == 0) return launch<float>(x, a, b, c, y, st, s, stream_);
  if (bc_dtype == 1) return launch<__nv_bfloat16>(x, a, b, c, y, st, s, stream_);
  return static_cast<int>(cudaErrorInvalidValue);
}
