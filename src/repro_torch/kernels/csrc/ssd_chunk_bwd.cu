// Backward of the Mamba-2 intra-chunk SSD (csrc/ssd_chunk.cu), on the float32
// CUDA cores, free of atomics.
//
// Replaces no Pallas kernel: the JAX package differentiates its jnp
// _ssd_chunked (repro/models/mamba.py:67) with jax.value_and_grad. This is the
// gradient of ssd_chunk's three outputs (y, the chunk states st, the prefix
// sums cum) for one chunk tile z and head h, group g(h) = h / (nh / g), with
// L_lm = exp(cum_l - cum_m) and G_lm = C_l . B_m on causal pairs m <= l,
// M = G * L, dM_lm = dy_l . x_m, w_m = exp(cum_last - cum_m):
//
//   dx_m   = sum_{l >= m} M_lm dy_l + w_m dst^T B_m
//   dC_l   = sum_{m <= l} dG_lm B_m,  dG = dM * L summed over the group's heads
//   dB_m   = sum_{l >= m} dG_lm C_l + w_m dst x_m (summed likewise)
//   u_m    = w_m B_m^T dst x_m = x_m . (w_m dst^T B_m)
//   dcum_j = dcum_j + rowsum_j(dM * M) - colsum_j(dM * M) - u_j + [j = last] sum_m u_m
//   da_k   = sum_{l >= k} dcum_l
//
// (ssd_chunk_bwd_ref in ref.py is the same list in PyTorch.) x, a, dy, dst and
// dcum float32 contiguous (dcum may be null); B and C (nb, Lc, g, n) float32 or
// bfloat16 with any strides but a contiguous last axis. dx, da float32; dB, dC
// contiguous (nb, Lc, g, n) in B's dtype, each rounded once from its f32 sum.
// exp is taken only on causal pairs, so no inf * 0 arises above the diagonal.
//
// Work. Tiles are 64 tokens; n_lt = ceil(Lc / 64) row tiles and as many
// column tiles. A CTA of 256 threads owns (chunk z, head block hb, column
// tile c): the hblk heads of hb lie in one group and share B and C, so
//   * G over the CTA's (row tile r >= c, c) pairs is formed once for all its
//     heads (kept in a global scratch tile, read back from L2 per head);
//   * dG = dM * L is summed over the block's heads in shared memory, and
//     multiplied by C and B once per pair at the end: the head sum that dB
//     and dC need costs one product per pair, not one per head;
//   * each head's dx over column tile c is complete in the CTA (its sum runs
//     over the rows l >= m, all in this CTA's pairs), and so is the column
//     sum of dM * M and u for the tile's rows.
// What crosses CTAs goes through per-CTA partials in global scratch, summed
// in a fixed order by two small kernels after the main one: dC's rows (each
// row tile gets a partial from each column tile c <= r and each head block),
// dB's rows (one partial per head block), and the row sums of dM * M (one
// per column tile) with the sums of u, which the last kernel adds to dcum and
// turns into da by a reverse scan. No float atomics: two calls give the same
// bits.
//
// Products are 64 x 64 (or 64 x 128) register-tiled f32 FMA loops over
// shared-memory tiles (rows padded to 68 / 132 floats): each thread holds a
// 4 x 4 block and reads float4s that are broadcast or conflict-free within
// each quarter warp. Grid (nb * n_heads_blocks, n_lt) with the column tile
// in y, so the CTAs of column tile 0, which walk every row tile, start
// first. Shared memory 178,688 B: one CTA (8 warps) per SM.
//
// Bound on an H100: operations. At the Mamba-2 2.7B training shape (32 chunk
// tiles of 256, 80 heads of 64, n 128, one group) one call reads x, dy, dst,
// a, dcum, B and C and writes dx, da, dB and dC (about 0.13 GB), and does
// about 0.11 TFLOP on causal pairs (chip_smoke.py computes both from the
// shapes): well above the bytes at the TF32 tensor-core rate, and far above
// them on the f32 CUDA cores used here. Moving the per-head products
// (dM, M^T dy, dst^T B, x dst^T) to the tensor cores as the forward's split
// TF32 passes is the redesign this kernel leaves open.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kT = 64;         // rows of a row tile = columns of a column tile
constexpr int kMaxLc = 256;
constexpr int kMaxN = 128;
constexpr int kMaxHp = 64;
constexpr int kMaxLt = kMaxLc / kT;
constexpr int kLd = kT + 4;       // 68 floats: rows 4 banks apart
constexpr int kLdB = kMaxN + 4;   // 132 floats
constexpr int kTile = kT * kLd;   // floats of a padded 64 x 64 tile
constexpr int kPart = kT * kMaxN; // floats of a dB / dC partial (64 x 128)

// shared memory, in floats
constexpr int kOffB = 0;                              // B rows of tile c [64][132]
constexpr int kOffDg = kOffB + kT * kLdB;             // dG summed over heads [4][64][68]
constexpr int kOffX = kOffDg + kMaxLt * kTile;        // x [64][68]
constexpr int kOffDy = kOffX + kTile;                 // dy [64][68]
constexpr int kOffM = kOffDy + kTile;                 // M [64][68]
constexpr int kOffW = kOffM + kTile;                  // dst half, C half [64][68]
constexpr int kOffCum = kOffW + kTile;                // cum [256]
constexpr int kOffCol = kOffCum + kMaxLc;             // column partials [16][64]
constexpr int kOffU = kOffCol + 16 * kT;              // u [64]
constexpr int kOffRd = kOffU + kT;                    // diagonal row sums [64]
constexpr int kSmemFloats = kOffRd + kT;
constexpr int kSmem = kSmemFloats * 4;
static_assert(kSmem <= 232448, "fits one SM's shared memory");

struct Args {
  const float* x;
  const float* a;
  const void* b;
  const void* c;
  const float* dy;
  const float* dst;
  const float* dcum;  // (nb, lc, nh) or null
  float* dx;
  float* da;
  void* db;  // (nb, lc, g, n) contiguous, B's dtype
  void* dc;
  float* gscr;     // (nb, nhb, npairs, 64, 64): G per (column, row) tile pair
  float* dbpart;   // (nb, nhb, n_lt, 64, 128)
  float* dcpart;   // (nb, nhb, npairs, 64, 128)
  float* rowpart;  // (nb, n_lt, n_lt * 64, nh): row sums of dM * M per column tile
  float* usum;     // (nb, n_lt, nh)
  int nb, lc, nh, hp, n, g, rep, hblk, nhb, n_lt, npairs;
  long long sb0, sb1, sb2;  // strides of B and C, in elements
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// index of the tile pair (column tile c, row tile r >= c), column-major
__host__ __device__ __forceinline__ int pair_index(int c, int r, int n_lt) {
  return c * n_lt - c * (c - 1) / 2 + (r - c);
}

// rows [row0, row0 + 64) of a float32 matrix with row stride rs, columns
// [0, 64), into a [64][kLd] tile: zeros where row >= row_end or col >= cols
__device__ __forceinline__ void stage_f32(float* dst, const float* src, long long rs, int row0,
                                          int row_end, int cols, int tid) {
  for (int i = tid; i < kT * kT; i += kThreads) {
    const int r = i >> 6, k = i & 63;
    dst[r * kLd + k] = row0 + r < row_end && k < cols ? src[(row0 + r) * rs + k] : 0.f;
  }
}

// rows [row0, row0 + 64), columns [col0, col0 + W) of B or C into a float32
// tile with leading dimension ld: zeros past lc and n
template <typename T, int W>
__device__ __forceinline__ void stage_bc(float* dst, int ld, const T* src, long long rs,
                                         int row0, int lc, int col0, int n, int tid) {
  for (int i = tid; i < kT * W; i += kThreads) {
    const int r = i / W, k = i - r * W, kk = col0 + k;
    dst[r * ld + k] = row0 + r < lc && kk < n ? to_f(src[(row0 + r) * rs + kk]) : 0.f;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_main_kernel(const Args args) {
  extern __shared__ __align__(16) float sm[];
  float* bs = sm + kOffB;
  float* dgs = sm + kOffDg;
  float* xs = sm + kOffX;
  float* dys = sm + kOffDy;
  float* ms = sm + kOffM;
  float* ws = sm + kOffW;
  float* cum = sm + kOffCum;
  float* colp = sm + kOffCol;
  float* us = sm + kOffU;
  float* rowd = sm + kOffRd;

  const int lc = args.lc, nh = args.nh, hp = args.hp, n = args.n, n_lt = args.n_lt;
  const int hb = blockIdx.x % args.nhb;
  const long long z = blockIdx.x / args.nhb;
  const int c = blockIdx.y;
  const int nr = n_lt - c;  // row tiles c .. n_lt - 1
  const int h0 = hb * args.hblk, grp = h0 / args.rep;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15, lane = tid & 31;
  const T* bsrc = static_cast<const T*>(args.b) + z * args.sb0 + grp * args.sb2;
  const T* csrc = static_cast<const T*>(args.c) + z * args.sb0 + grp * args.sb2;
  const long long rs = (long long)nh * hp;  // row stride of x and dy
  float* gtiles = args.gscr + ((z * args.nhb + hb) * args.npairs) * kT * kT;

  // ---- B's rows of tile c; dG's head sum zeroed
  stage_bc<T, kMaxN>(bs, kLdB, bsrc, args.sb1, c * kT, lc, 0, n, tid);
  for (int i = tid; i < nr * kTile; i += kThreads) dgs[i] = 0.f;

  // ---- G = C_r . B_c^T for each pair, once for the block's heads:
  // thread (ty, tx) holds rows l = ty + 16i, columns m = tx + 16j
  for (int rr = 0; rr < nr; ++rr) {
    const int r = c + rr;
    float acc[4][4] = {};
    for (int half = 0; half * kT < n; ++half) {
      __syncthreads();  // ws is free
      stage_bc<T, kT>(ws, kLd, csrc, args.sb1, r * kT, lc, half * kT, n, tid);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kT; k += 4) {
        float4 av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = ld4(ws + (ty + 16 * i) * kLd + k);
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = ld4(bs + (tx + 16 * j) * kLdB + half * kT + k);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] += av[i].x * bv[j].x + av[i].y * bv[j].y + av[i].z * bv[j].z +
                         av[i].w * bv[j].w;
          }
        }
      }
    }
    float* gt = gtiles + pair_index(c, r, n_lt) * kT * kT;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) gt[(ty + 16 * i) * kT + tx + 16 * j] = acc[i][j];
    }
  }

  // dB's state term over the block's heads: rows m = 4ty + i, columns
  // k = tx + 16j + 64 half (j + 4 half)
  float dbacc[4][8] = {};

  for (int hi = 0; hi < args.hblk; ++hi) {
    const int h = h0 + hi;
    __syncthreads();  // the previous head is done with cum, xs, us, rowd
    if (tid < 32) {   // prefix sums of a over the chunk; rows past lc hold the total
      float carry = 0.f;
      for (int i = 0; i < kMaxLc / 32; ++i) {
        const int l = 32 * i + lane;
        float v = l < lc ? args.a[(z * lc + l) * nh + h] : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float t = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += t;
        }
        v += carry;
        cum[l] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    const float* xsrc = args.x + (z * lc * nh + h) * hp;
    stage_f32(xs, xsrc, rs, c * kT, lc, hp, tid);
    __syncthreads();
    const float c_last = cum[lc - 1];
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __expf(c_last - cum[c * kT + 4 * ty + i]);

    // ---- the state's terms: dx_m = w_m dst^T B_m and dB_m += w_m dst x_m
    // (dx rows m = 4ty + i, columns p = 4tx + j)
    float dxa[4][4] = {};
    const float* dsrc = args.dst + (z * nh + h) * (long long)n * hp;
    for (int half = 0; half * kT < n; ++half) {
      __syncthreads();  // ws is free
      stage_f32(ws, dsrc, hp, half * kT, n, hp, tid);  // dst rows k, columns p
      __syncthreads();
#pragma unroll 2
      for (int k = 0; k < kT; k += 4) {
        float4 bm[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) bm[i] = ld4(bs + (4 * ty + i) * kLdB + half * kT + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 wv = ld4(ws + (k + kk) * kLd + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float bv = at(bm[i], kk);
            dxa[i][0] += bv * wv.x;
            dxa[i][1] += bv * wv.y;
            dxa[i][2] += bv * wv.z;
            dxa[i][3] += bv * wv.w;
          }
        }
      }
      float t[4][4] = {};
#pragma unroll 2
      for (int p = 0; p < kT; p += 4) {
        float4 xv[4], dv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = ld4(xs + (4 * ty + i) * kLd + p);
#pragma unroll
        for (int j = 0; j < 4; ++j) dv[j] = ld4(ws + (tx + 16 * j) * kLd + p);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            t[i][j] += xv[i].x * dv[j].x + xv[i].y * dv[j].y + xv[i].z * dv[j].z +
                       xv[i].w * dv[j].w;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // a half past n holds zeros; the unrolled index stays static
          if (half == 0) dbacc[i][j] += w[i] * t[i][j];
          else dbacc[i][4 + j] += w[i] * t[i][j];
        }
      }
    }
    // u_m = x_m . (w_m dst^T B_m), reduced over the 16 lanes of a row
    float u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 xv = ld4(xs + (4 * ty + i) * kLd + 4 * tx);
#pragma unroll
      for (int j = 0; j < 4; ++j) dxa[i][j] *= w[i];
      float s = xv.x * dxa[i][0] + xv.y * dxa[i][1] + xv.z * dxa[i][2] + xv.w * dxa[i][3];
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      u[i] = s;
    }
    if (tx == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) us[4 * ty + i] = u[i];
    }

    // ---- the pairs (r, c): dM, M, dG, the sums of dM * M, and dx += M^T dy
    float colacc = 0.f;  // thread m < 64: colsum_m of dM * M
    const float* dysrc = args.dy + (z * lc * nh + h) * hp;
    for (int rr = 0; rr < nr; ++rr) {
      const int r = c + rr;
      __syncthreads();  // dys, ms and colp are free
      stage_f32(dys, dysrc, rs, r * kT, lc, hp, tid);
      const float* gt = gtiles + pair_index(c, r, n_lt) * kT * kT;
      float gv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) gv[i][j] = gt[(ty + 16 * i) * kT + tx + 16 * j];
      }
      __syncthreads();
      // dM rows l = ty + 16i, columns m = tx + 16j
      float dm[4][4] = {};
#pragma unroll 4
      for (int p = 0; p < kT; p += 4) {
        float4 av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = ld4(dys + (ty + 16 * i) * kLd + p);
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = ld4(xs + (tx + 16 * j) * kLd + p);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            dm[i][j] += av[i].x * bv[j].x + av[i].y * bv[j].y + av[i].z * bv[j].z +
                        av[i].w * bv[j].w;
          }
        }
      }
      float rowr[4] = {}, colr[4] = {};
      float* dg = dgs + rr * kTile;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = ty + 16 * i;
        const float cl = cum[r * kT + l];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = tx + 16 * j;
          // exp only on causal pairs
          const float L = rr > 0 || m <= l ? __expf(cl - cum[c * kT + m]) : 0.f;
          const float mv = gv[i][j] * L, dgv = dm[i][j] * L, rv = dm[i][j] * mv;
          ms[l * kLd + m] = mv;
          dg[l * kLd + m] += dgv;
          rowr[i] += rv;
          colr[j] += rv;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) colp[ty * kT + tx + 16 * j] = colr[j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int off = 1; off < 16; off <<= 1) {
          rowr[i] += __shfl_xor_sync(0xffffffffu, rowr[i], off);
        }
      }
      if (tx == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = ty + 16 * i;
          if (rr == 0) {
            rowd[l] = rowr[i];
          } else if (r * kT + l < lc) {
            args.rowpart[((z * n_lt + c) * n_lt * kT + r * kT + l) * nh + h] = rowr[i];
          }
        }
      }
      __syncthreads();  // ms, dg and colp are written
      if (tid < kT) {
        for (int t = 0; t < 16; ++t) colacc += colp[t * kT + tid];
      }
      // dx rows m = 4ty + i, columns p = 4tx + j: += sum_l M_lm dy_l
#pragma unroll 4
      for (int l = 0; l < kT; ++l) {
        const float4 mv = ld4(ms + l * kLd + 4 * ty);
        const float4 dv = ld4(dys + l * kLd + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = at(mv, i);
          dxa[i][0] += a * dv.x;
          dxa[i][1] += a * dv.y;
          dxa[i][2] += a * dv.z;
          dxa[i][3] += a * dv.w;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = c * kT + 4 * ty + i;
      if (m >= lc) continue;
      float* row = args.dx + ((z * lc + m) * nh + h) * hp;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (4 * tx + j < hp) row[4 * tx + j] = dxa[i][j];
      }
    }
    __syncthreads();  // us and rowd are written
    if (tid < kT) {   // the tile's own rows: + rowsum - colsum - u
      const int m = c * kT + tid;
      if (m < lc) {
        args.rowpart[((z * n_lt + c) * n_lt * kT + m) * nh + h] = rowd[tid] - colacc - us[tid];
      }
    }
    if (tid < 32) {  // sum of u over the tile, in a fixed order
      float s = us[lane] + us[lane + 32];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) args.usum[(z * n_lt + c) * nh + h] = s;
    }
  }

  // ---- dB's partial over tile c: the state term + sum_r dG_r^T C_r
  // (rows m = 4ty + i, columns k = tx + 16j + 64 half)
  float* dbp = args.dbpart + ((z * args.nhb + hb) * n_lt + c) * kPart;
  for (int half = 0; half * kT < n; ++half) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = half == 0 ? dbacc[i][j] : dbacc[i][4 + j];
    }
    for (int rr = 0; rr < nr; ++rr) {
      __syncthreads();  // ws is free (and dgs complete, at the first pass)
      stage_bc<T, kT>(ws, kLd, csrc, args.sb1, (c + rr) * kT, lc, half * kT, n, tid);
      __syncthreads();
      const float* dg = dgs + rr * kTile;
#pragma unroll 4
      for (int l = 0; l < kT; ++l) {
        const float4 gv = ld4(dg + l * kLd + 4 * ty);
        float cv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) cv[j] = ws[l * kLd + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = at(gv, i);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a * cv[j];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) dbp[(4 * ty + i) * kMaxN + half * kT + tx + 16 * j] = acc[i][j];
    }
  }

  // ---- dC's partial of each pair: dG_r . B_c (rows l = ty + 16i of tile r,
  // columns k = 4tx + j + 64 half)
  for (int rr = 0; rr < nr; ++rr) {
    const float* dg = dgs + rr * kTile;
    float* dcp = args.dcpart + ((z * args.nhb + hb) * args.npairs + pair_index(c, c + rr, n_lt)) *
                                   kPart;
    for (int half = 0; half * kT < n; ++half) {
      float acc[4][4] = {};
#pragma unroll 2
      for (int m = 0; m < kT; m += 4) {
        float4 gv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) gv[i] = ld4(dg + (ty + 16 * i) * kLd + m);
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) {
          const float4 bv = ld4(bs + (m + mm) * kLdB + half * kT + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float a = at(gv[i], mm);
            acc[i][0] += a * bv.x;
            acc[i][1] += a * bv.y;
            acc[i][2] += a * bv.z;
            acc[i][3] += a * bv.w;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        *reinterpret_cast<float4*>(dcp + (ty + 16 * i) * kMaxN + half * kT + 4 * tx) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
  }
}

// dB and dC of row tile t of group grp: the head blocks' partials summed in
// order (and, for dC, the column tiles c <= t in order), rounded once
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_bc_kernel(const Args args) {
  const int t = blockIdx.x, grp = blockIdx.y;
  const long long z = blockIdx.z;
  const int n = args.n, n_lt = args.n_lt;
  const int hb0 = grp * args.rep / args.hblk, hb1 = (grp + 1) * args.rep / args.hblk;
  T* db = static_cast<T*>(args.db);
  T* dc = static_cast<T*>(args.dc);
  for (int e = threadIdx.x; e < kT * n; e += kThreads) {
    const int row = e / n, k = e - row * n, l = t * kT + row;
    if (l >= args.lc) break;
    const int off = row * kMaxN + k;
    float sb = 0.f, sc = 0.f;
    for (int hb = hb0; hb < hb1; ++hb) {
      const long long base = z * args.nhb + hb;
      sb += args.dbpart[(base * n_lt + t) * kPart + off];
      for (int c = 0; c <= t; ++c) {
        sc += args.dcpart[(base * args.npairs + pair_index(c, t, n_lt)) * kPart + off];
      }
    }
    const long long o = ((z * args.lc + l) * args.g + grp) * n + k;
    from_f(db + o, sb);
    from_f(dc + o, sc);
  }
}

// dcum and da for 32 heads of chunk z: thread (hx, seg) sums rows of its
// segment of the chunk, the segments' totals carry the reverse scan
__global__ void __launch_bounds__(kThreads) ssd_bwd_da_kernel(const Args args) {
  __shared__ float d[kMaxLc][33];
  __shared__ float tot[8][32];
  const int hx = threadIdx.x, seg = threadIdx.y;
  const int h = blockIdx.x * 32 + hx;
  const long long z = blockIdx.y;
  const int lc = args.lc, nh = args.nh, n_lt = args.n_lt;
  const int len = (lc + 7) / 8, l0 = seg * len, l1 = min(lc, l0 + len);
  float s = 0.f;
  if (h < nh) {
    float last = 0.f;
    if (l1 == lc) {
      for (int c = 0; c < n_lt; ++c) last += args.usum[(z * n_lt + c) * nh + h];
    }
    for (int l = l0; l < l1; ++l) {
      float v = args.dcum != nullptr ? args.dcum[(z * lc + l) * nh + h] : 0.f;
      for (int c = 0; c <= l / kT; ++c) {
        v += args.rowpart[((z * n_lt + c) * n_lt * kT + l) * nh + h];
      }
      if (l == lc - 1) v += last;
      d[l][hx] = v;
      s += v;
    }
  }
  tot[seg][hx] = s;
  __syncthreads();
  if (h >= nh) return;
  float run = 0.f;
  for (int k = 7; k > seg; --k) run += tot[k][hx];
  for (int l = l1 - 1; l >= l0; --l) {
    run += d[l][hx];
    args.da[(z * lc + l) * nh + h] = run;
  }
}

template <typename T>
cudaError_t prepare() {  // once: the dynamic shared-memory cap
  static cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_main_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  return err;
}

// op 0: launch; op 1: *out = resident CTAs per SM of the main kernel;
// op 2: *out = its dynamic shared memory
template <typename T>
int run(const Args& args, int op, int* out, cudaStream_t stream) {
  cudaError_t err = prepare<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (op == 2) {
    *out = kSmem;
    return 0;
  }
  if (op == 1) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, ssd_bwd_main_kernel<T>, kThreads, kSmem));
  }
  ssd_bwd_main_kernel<T><<<dim3(args.nb * args.nhb, args.n_lt), kThreads, kSmem, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_bc_kernel<T><<<dim3(args.n_lt, args.g, args.nb), kThreads, 0, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_da_kernel<<<dim3((args.nh + 31) / 32, args.nb), dim3(32, 8), 0, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const Args& args, int bc_dtype, int op, int* out, cudaStream_t stream) {
  if (bc_dtype == 0) return run<float>(args, op, out, stream);
  if (bc_dtype == 1) return run<__nv_bfloat16>(args, op, out, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// bc_dtype: 0 = float32, 1 = bfloat16. Lc <= 256, n <= 128, hp <= 64, nh a
// multiple of g, nh / g a multiple of hblk. dcum may be null. The scratch
// buffers are sized as the Args fields say (ssd_chunk.bwd_plan). Launches
// three kernels on `stream`, allocates nothing; returns a cudaError_t.
extern "C" int ssd_chunk_bwd(const void* x, const void* a, const void* b, const void* c,
                             const void* dy, const void* dst, const void* dcum, void* dx,
                             void* da, void* db, void* dc, void* gscr, void* dbpart,
                             void* dcpart, void* rowpart, void* usum, int bc_dtype, int nb,
                             int lc, int nh, int hp, int n, int g, int hblk, long long sb0,
                             long long sb1, long long sb2, void* stream) {
  if (lc <= 0 || lc > kMaxLc || n <= 0 || n > kMaxN || hp <= 0 || hp > kMaxHp || g <= 0 ||
      nh % g != 0 || hblk <= 0 || (nh / g) % hblk != 0 || nb > 65535 || g > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb == 0 || nh == 0) return 0;
  const int n_lt = (lc + kT - 1) / kT;
  const Args args{static_cast<const float*>(x), static_cast<const float*>(a), b, c,
                  static_cast<const float*>(dy), static_cast<const float*>(dst),
                  static_cast<const float*>(dcum), static_cast<float*>(dx),
                  static_cast<float*>(da), db, dc, static_cast<float*>(gscr),
                  static_cast<float*>(dbpart), static_cast<float*>(dcpart),
                  static_cast<float*>(rowpart), static_cast<float*>(usum), nb, lc, nh, hp, n,
                  g, nh / g, hblk, nh / hblk, n_lt, n_lt * (n_lt + 1) / 2, sb0, sb1, sb2};
  return dispatch(args, bc_dtype, 0, nullptr, static_cast<cudaStream_t>(stream));
}

// Resident CTAs per SM (op 1) or dynamic shared memory in bytes (op 2) of the
// main kernel's instantiation for bc_dtype. Returns a cudaError_t.
extern "C" int ssd_chunk_bwd_info(int bc_dtype, int op, int* out) {
  if (op != 1 && op != 2) return static_cast<int>(cudaErrorInvalidValue);
  const Args none{};
  return dispatch(none, bc_dtype, op, out, nullptr);
}
