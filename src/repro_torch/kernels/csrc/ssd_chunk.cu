// Mamba-2 intra-chunk SSD (state-space duality) over chunk tiles, on the
// tensor cores at float32 accuracy.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_chunk.py: ssd_chunk
// (pallas_call at :72). For each tile z (one chunk of one sequence) and
// head h, with cum the inclusive prefix sum of the per-step log decay a:
//
//   y[z, l, h, :]  = sum_{m <= l} (C_l . B_m) exp(cum_l - cum_m) x[z, m, h, :]
//   st[z, h, :, :] = sum_l exp(cum_last - cum_l) B_l (outer) x[z, l, h, :]
//
// and, when asked, cum[z, l, h] itself. x (nb, Lc, nh, hp) and a (nb, Lc, nh)
// float32, contiguous; B and C (nb, Lc, g, n) float32 or bfloat16 with any
// strides but a contiguous last axis; head h reads group h / (nh / g). y, st
// (nb, nh, n, hp) and cum float32. Lc <= 256, n <= 128, hp <= 64. The sum over
// m <= l touches only causal pairs and exp(cum_l - cum_m) is computed only
// there, so no inf * 0 arises above the diagonal. The inter-chunk recurrence
// stays outside, as the TPU kernel's docstring splits it.
//
// Bound on an H100: bytes. At the Mamba-2 2.7B prefill shapes (Lc 256, nh 80,
// hp 64, n 128, one bf16 group) the kernel reads x (21 MB at 1024 tokens), a
// and B/C, and writes y (21 MB) and st (10.5 MB): 53 MB, 16 us at 3.35 TB/s.
// Its 2.7 GFLOP take 5.5 us at the 495 TFLOP/s TF32 peak, 16.5 us even as
// three TF32 passes; on float32 CUDA cores they took 40 us, which is why the
// products run on the tensor cores here.
//
// Products (warp-level mma.sync, f32 accumulate; no operand leaves float32
// accuracy):
//   * G = C.B^T: bf16 B/C in one m16n8k16 bf16 pass (a product of two bf16
//     values is exact in f32), fragments by ldmatrix; float32 B/C in three
//     m16n8k8 TF32 passes over split operands (below).
//   * P.x and B^T.(w x), w = exp(cum_last - cum_l): each float32 operand is
//     split into big = tf32(v) and small = v - big (the tensor core reads
//     small to TF32), and the product is small.big + big.small + big.big
//     (3xTF32, as CUTLASS names it). A bf16 operand is exact in TF32, so
//     B^T.(w x) takes two passes for bf16 B.
//     Single-pass TF32 keeps about three decimal digits and misses the
//     float32 tolerance; tests/test_torch_ssd_plan.py models both.
//   * P = G * exp(cum_l - cum_m) never leaves registers: the accumulator
//     fragment of G is the A fragment of P.x once the k index of each 8-column
//     block is permuted (k slot q <-> column 2q, slot q + 4 <-> column 2q + 1),
//     and x's B fragment is read with the same permutation. The output
//     columns are permuted too (column j of n-tile u is hp column 8j + u), so
//     a lane's x operands for all eight n-tiles are two float4s of one row
//     (x is staged with its 16-byte chunks XOR-swizzled against bank
//     conflicts), and a lane's 16 outputs of a row are 16 contiguous floats.
//   * exp goes through __expf (ex2.approx): about 2^-22 of the result where
//     the decay matters; cvt.rna.tf32 is avoided (a slow pipe on sm_90): the
//     split rounds with an integer add and a mask.
//
// Work and balance. Row and column tiles are 64 tokens; n_lt = ceil(Lc / 64)
// row tiles. The grid is (P, nh, nb) with P = ceil(n_lt / 2), and the P CTAs
// of one (chunk, head) form a thread-block cluster. CTA p takes row tiles
// n_lt - 1 - p and p (one, where they coincide), so each CTA walks the same
// number of causal (row, column) tile steps at Lc 256 (5 of the 10);
// tile_schedule in ssd_chunk.py is the same list. Each CTA is 4 warps; warp w
// owns rows 16w .. 16w + 15 of the current row tile, computes its 16 x 64 G
// tile straight into registers, forms P, and adds P.x into its 16 x 64 y
// accumulators. Every warp runs every product of a step (a diagonal step
// masks P right of the warp's rows): the step ends at a barrier, so the
// warp with the full diagonal sets its time anyway, and no branch on the
// warp index makes ptxas wrap each mma in a collective fallback.
// G is recomputed per head: as one bf16 pass it is a fifth of a step's
// tensor-core passes, while sharing it across heads would keep a second
// head's y and state accumulators live (another 96 registers a thread).
//
// The chunk state in the same CTA: on a diagonal step (c == r) the staged x
// and B tile is also the state's, and warp w adds B^T.(w x) for state rows
// 32w .. 32w + 31 into registers. The diagonals of a cluster's CTAs are
// every column tile once, so the state reads no x of its own (the old
// kernel's state blocks read x a second time). The cluster then sums its P
// partial states through distributed shared memory (no atomics: two calls
// give the same bits), each CTA for half of st's rows.
//
// Occupancy: 1,280 B of static and 102,400 B of dynamic shared memory per
// CTA for bf16 B/C, so two CTAs share an SM (the old kernel held all of G^T
// for one CTA per SM); float32 B/C take 167,936 B, one CTA per SM.
//
// Overlap. Each step's x and B tile is staged with 16-byte cp.async into a
// ring of two stages (a row tile's C with its first step), so the next step's
// loads run under this step's products; rows past Lc and columns past n or hp
// land as zeros. Inputs whose rows are not 16-byte aligned are staged
// element by element instead (the launcher decides from the pointers and
// strides; no path is taken after a failure).
//
// The prefix sums: one warp scans a over the chunk (8 rounds of 32 at Lc 256,
// shuffles), while the first loads are in flight; CTA 0 writes cum when
// asked, so the caller needs no cumsum of its own.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>

#include "ssd_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace ssd_common;

constexpr int kThreads = 128;  // 4 warps
constexpr int kT = 64;         // rows of a row tile = columns of a column tile
constexpr int kMaxLc = 256;
constexpr int kMaxN = 128;
constexpr int kMaxHp = 64;

template <typename T> struct Tile;
template <> struct Tile<__nv_bfloat16> {
  static constexpr int kLd = kMaxN + 8;  // 272 B rows: ldmatrix rows fall in distinct banks
  static constexpr int kK = 16;          // k of one m16n8k16 step
};
template <> struct Tile<float> {
  static constexpr int kLd = kMaxN + 4;  // 528 B rows: 4g + q spreads lanes over 32 banks
  static constexpr int kK = 8;           // k of one m16n8k8 step
};

template <typename T> constexpr int kBcBytes = kT * Tile<T>::kLd * (int)sizeof(T);
constexpr int kXBytes = kT * kMaxHp * 4;  // x rows unpadded, chunks swizzled
template <typename T> constexpr int kStageBytes = kXBytes + kBcBytes<T>;
// two C tiles (one per row tile), then two stages of (x, B)
template <typename T> constexpr int kSmem = 2 * kBcBytes<T> + 2 * kStageBytes<T>;
constexpr int kPartBytes = kMaxN * kMaxHp * 4;  // a partial state, in the stages after the loop
static_assert(kPartBytes <= 2 * kStageBytes<__nv_bfloat16>, "partial state fits the stages");

struct Args {
  const float* x;
  const float* a;
  const void* b;
  const void* c;
  float* y;
  float* st;
  float* cum;  // (nb, lc, nh) or null
  int nb, lc, nh, hp, n, rep;
  long long sb0, sb1, sb2;  // strides of B and C, in elements
  int vec_x, vec_bc;        // rows 16-byte aligned: stage with cp.async
};

// Split products run pass-major (small.big over every accumulator,
// then big.small, then big.big), so two products on one accumulator stand
// 8 or 16 products apart instead of back to back.

// The x tile is 64 rows of 64 floats with no padding; chunk c (16 bytes) of
// row r sits at chunk c ^ xswz(r). A warp's float4 reads of rows 8i + 2q
// (+ 1), chunks 2g and 2g + 1, then touch 32 distinct banks per 8 lanes.
__device__ __forceinline__ int xswz(int r) { return ((r >> 1) & 1) | (((r >> 2) & 1) << 2); }

// columns 8g .. 8g + 7 of x rows r and r + 1 (two float4s each, at xc0, xc1)
__device__ __forceinline__ void load_x(float4 (&v)[4], const float* xs, int r, int xc0,
                                       int xc1) {
  const float* row = xs + r * kMaxHp;
  v[0] = *reinterpret_cast<const float4*>(row + xc0);
  v[1] = *reinterpret_cast<const float4*>(row + xc1);
  v[2] = *reinterpret_cast<const float4*>(row + kMaxHp + xc0);
  v[3] = *reinterpret_cast<const float4*>(row + kMaxHp + xc1);
}

// those columns times w0 (row r) and w1 (row r + 1), split into the B
// operands of n-tiles 0..7: fragment row 0 from row r, 1 from row r + 1
__device__ __forceinline__ void split_x(const float4 (&v)[4], float w0, float w1,
                                        uint32_t (&big)[8][2], uint32_t (&small)[8][2]) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float4 lo = v[2 * k], hi = v[2 * k + 1];
    const float w = k ? w1 : w0;
    const float e[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int u = 0; u < 8; ++u) split(e[u] * w, big[u][k], small[u][k]);
  }
}

// rows [row0, row0 + 64) of a (rows, cols) matrix into a tile with leading
// dimension ld (elements): columns [0, cols_pad) where rows < row_end and
// columns < cols hold data, zeros elsewhere. 16-byte copies when vec. With
// Swz, the 16-byte chunk c of row r lands at chunk c ^ xswz(r) (the x tile).
template <typename T, bool Swz>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src, long long row_stride,
                                           int row0, int row_end, int cols, int cols_pad,
                                           bool vec, int tid) {
  constexpr int E = 16 / (int)sizeof(T);
  if (vec) {
    const int chunks = cols_pad / E;
    for (int i = tid; i < kT * chunks; i += kThreads) {
      const int r = i / chunks, ch = i - r * chunks, k = ch * E;
      const bool ok = row0 + r < row_end && k < cols;
      const int bytes = ok ? min(cols - k, E) * (int)sizeof(T) : 0;
      const int kd = Swz ? (ch ^ xswz(r)) * E : k;
      cp_async16(dst + r * ld + kd, ok ? src + (row0 + r) * row_stride + k : src, bytes);
    }
  } else {
    for (int i = tid; i < kT * cols_pad; i += kThreads) {
      const int r = i / cols_pad, k = i - r * cols_pad;
      const int kd = Swz ? ((k / E) ^ xswz(r)) * E + k % E : k;
      dst[r * ld + kd] = row0 + r < row_end && k < cols ? src[(row0 + r) * row_stride + k]
                                                         : T(0.f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const Args args) {
  using Tl = Tile<T>;
  constexpr int kLd = Tl::kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float cum[kMaxLc];
  __shared__ float wl[kT];  // exp(cum_last - cum_l) of the diagonal tile's rows

  const int lc = args.lc, nh = args.nh, hp = args.hp, n = args.n;
  const int rank = blockIdx.x, n_ranks = gridDim.x;
  const int h = blockIdx.y;
  const long long z = blockIdx.z;
  const int grp = h / args.rep;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  // this lane's x columns 8g .. 8g + 7 as two float4s of a row 8i + 2q (+ 1)
  const int xc0 = 4 * ((2 * g) ^ xswz(2 * q)), xc1 = 4 * ((2 * g + 1) ^ xswz(2 * q));

  T* c_tiles = reinterpret_cast<T*>(smem);  // [2][kT][kLd]
  unsigned char* stages = smem + 2 * kBcBytes<T>;
  const T* bsrc = static_cast<const T*>(args.b) + z * args.sb0 + grp * args.sb2;
  const T* csrc = static_cast<const T*>(args.c) + z * args.sb0 + grp * args.sb2;
  const float* xsrc = args.x + (z * lc * nh + h) * hp;
  const long long x_stride = (long long)nh * hp;

  // the schedule (tile_schedule in ssd_chunk.py): row tiles ra, then rb
  const int n_lt = (lc + kT - 1) / kT;
  const int ra = n_lt - 1 - rank, rb = rank;
  const int steps = (ra + 1) + (rb != ra ? rb + 1 : 0);
  const int npad = (n + Tl::kK - 1) / Tl::kK * Tl::kK;  // G's depth

  auto stage_x = [&](int s) { return reinterpret_cast<float*>(stages + (s & 1) * kStageBytes<T>); };
  auto stage_b = [&](int s) {
    return reinterpret_cast<T*>(stages + (s & 1) * kStageBytes<T> + kXBytes);
  };
  auto col_tile = [&](int s) { return s <= ra ? s : s - ra - 1; };
  auto load_step = [&](int s) {
    const int c0 = col_tile(s) * kT;
    if (s == 0 || s == ra + 1) {  // the first step of a row tile brings its C
      const int r = s == 0 ? ra : rb;
      stage_rows<T, false>(c_tiles + (s == 0 ? 0 : kT * kLd), kLd, csrc, args.sb1, r * kT, lc,
                           n, kMaxN, args.vec_bc, tid);
    }
    stage_rows<float, true>(stage_x(s), kMaxHp, xsrc, x_stride, c0, lc, hp, kMaxHp, args.vec_x,
                            tid);
    stage_rows<T, false>(stage_b(s), kLd, bsrc, args.sb1, c0, lc, n, kMaxN, args.vec_bc, tid);
  };

  load_step(0);
  cp_async_commit();
  if (steps > 1) load_step(1);
  cp_async_commit();

  // prefix sums of a over the chunk, under the first loads; rows past lc
  // hold the total, so every exponent below stays finite
  if (warp == 0) {
    float av[kMaxLc / 32];  // all loads in flight before the first shuffle
#pragma unroll
    for (int i = 0; i < kMaxLc / 32; ++i) {
      const int l = 32 * i + lane;
      av[i] = l < lc ? args.a[(z * lc + l) * nh + h] : 0.f;
    }
    float carry = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxLc / 32; ++i) {
      const int l = 32 * i + lane;
      float v = av[i];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += t;
      }
      v += carry;
      cum[l] = v;
      if (args.cum != nullptr && rank == 0 && l < lc) args.cum[(z * lc + l) * nh + h] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }

  float yacc[8][4];
  float sacc[2][8][4];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      yacc[u][j] = 0.f;
      sacc[0][u][j] = 0.f;
      sacc[1][u][j] = 0.f;
    }
  }

  // Every warp runs every product of a step (on a diagonal step the blocks
  // right of its rows are masked to zero, not skipped), so no branch depends
  // on the warp and the mma and ldmatrix need no collective fallback.
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<1>();
    __syncthreads();
    const int r = s <= ra ? ra : rb;
    const int c = col_tile(s);
    const float* xs = stage_x(s);
    const T* bs = stage_b(s);
    const T* cs = c_tiles + (s <= ra ? 0 : kT * kLd);
    const bool diag = c == r;
    if (diag) {
      const float c_last = cum[lc - 1];
      for (int i = tid; i < kT; i += kThreads) wl[i] = __expf(c_last - cum[c * kT + i]);
    }

    // ---- y rows r * 64 + 16 * warp .. + 15 against column tile c
    float acc[8][4];  // G, then P
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[t][j] = 0.f;
    }
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int k0 = 0; k0 < kMaxN; k0 += 16) {  // columns past n are zeros
        uint32_t af[4];
        ldsm_x4(af, cs + (16 * warp + (lane & 15)) * kLd + k0 + (lane >> 4) * 8);
#pragma unroll
        for (int t = 0; t < 8; t += 2) {
          uint32_t bf[4];
          const int i = lane >> 3;
          ldsm_x4(bf, bs + (8 * t + (lane & 7) + (i >> 1) * 8) * kLd + k0 + (i & 1) * 8);
          mma_bf16(acc[t], af, bf[0], bf[1]);
          mma_bf16(acc[t + 1], af, bf[2], bf[3]);
        }
      }
    } else {
      const float* crow = reinterpret_cast<const float*>(cs) + (16 * warp + g) * kLd;
      const float* brow = reinterpret_cast<const float*>(bs) + g * kLd;
      for (int k0 = 0; k0 < npad; k0 += 8) {
        uint32_t ab[4], as[4];
        split(crow[k0 + q], ab[0], as[0]);
        split(crow[8 * kLd + k0 + q], ab[1], as[1]);
        split(crow[k0 + q + 4], ab[2], as[2]);
        split(crow[8 * kLd + k0 + q + 4], ab[3], as[3]);
        uint32_t bb[8][2], bsm[8][2];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          split(brow[8 * t * kLd + k0 + q], bb[t][0], bsm[t][0]);
          split(brow[8 * t * kLd + k0 + q + 4], bb[t][1], bsm[t][1]);
        }
#pragma unroll
        for (int t = 0; t < 8; ++t) mma_tf32(acc[t], as, bb[t][0], bb[t][1]);
#pragma unroll
        for (int t = 0; t < 8; ++t) mma_tf32(acc[t], ab, bsm[t][0], bsm[t][1]);
#pragma unroll
        for (int t = 0; t < 8; ++t) mma_tf32(acc[t], ab, bb[t][0], bb[t][1]);
      }
    }

    // P = G * exp(cum_l - cum_m) on causal pairs, in place; exp only there
    const int l0 = r * kT + 16 * warp + g, l1 = l0 + 8;
    const float cl0 = cum[l0], cl1 = cum[l1];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int m = c * kT + 8 * t + 2 * q + j;
        const float cm = cum[m];
        acc[t][j] = m <= l0 ? acc[t][j] * __expf(cl0 - cm) : 0.f;
        acc[t][2 + j] = m <= l1 ? acc[t][2 + j] * __expf(cl1 - cm) : 0.f;
      }
    }

    // y += P.x. k slot q of block t is column 8t + 2q, slot q + 4 column
    // 8t + 2q + 1; output column 8j + u of the tile is column j of n-tile u,
    // so this lane's x operands of all 8 n-tiles are two float4s of a row;
    // block t + 1's are read while block t's products run.
    float4 nx[4];
    load_x(nx, xs, 2 * q, xc0, xc1);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float4 cx[4] = {nx[0], nx[1], nx[2], nx[3]};
      if (t + 1 < 8) load_x(nx, xs, 8 * (t + 1) + 2 * q, xc0, xc1);
      uint32_t pb[4], ps[4];
      split(acc[t][0], pb[0], ps[0]);
      split(acc[t][2], pb[1], ps[1]);
      split(acc[t][1], pb[2], ps[2]);
      split(acc[t][3], pb[3], ps[3]);
      uint32_t xb[8][2], xsm[8][2];
      split_x(cx, 1.f, 1.f, xb, xsm);
#pragma unroll
      for (int u = 0; u < 8; ++u) mma_tf32(yacc[u], ps, xb[u][0], xb[u][1]);
#pragma unroll
      for (int u = 0; u < 8; ++u) mma_tf32(yacc[u], pb, xsm[u][0], xsm[u][1]);
#pragma unroll
      for (int u = 0; u < 8; ++u) mma_tf32(yacc[u], pb, xb[u][0], xb[u][1]);
    }

    if (diag) {  // the row tile is complete: this lane holds columns 16q .. 16q + 15
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int l = half ? l1 : l0;
        if (l < lc) store_cols(args.y + ((z * lc + l) * nh + h) * hp, hp, q, yacc, half);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          yacc[u][2 * half] = 0.f;
          yacc[u][2 * half + 1] = 0.f;
        }
      }
    }

    // ---- the state over this diagonal tile: rows 32 * warp .. + 31 of
    // B^T.(w x), its k (the tile's rows) permuted as in P.x
    if (diag) {
      __syncthreads();  // wl is written
      const int n_k8 = min(8, (lc - c * kT + 7) / 8);
      for (int kk = 0; kk < n_k8; ++kk) {
        const int r0 = 8 * kk + 2 * q, r1 = r0 + 1;
        uint32_t ab[2][4], as[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int kb = 32 * warp + 16 * mt + g;
          const float v[4] = {to_f(bs[r0 * kLd + kb]), to_f(bs[r0 * kLd + kb + 8]),
                              to_f(bs[r1 * kLd + kb]), to_f(bs[r1 * kLd + kb + 8])};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if constexpr (sizeof(T) == 2) {
              ab[mt][j] = __float_as_uint(v[j]);  // bf16 is exact in TF32
              as[mt][j] = 0u;
            } else {
              split(v[j], ab[mt][j], as[mt][j]);
            }
          }
        }
        float4 xv[4];
        load_x(xv, xs, r0, xc0, xc1);
        uint32_t xb[8][2], xsm[8][2];
        split_x(xv, wl[r0], wl[r1], xb, xsm);
        if constexpr (sizeof(T) == 4) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int u = 0; u < 8; ++u) mma_tf32(sacc[mt][u], as[mt], xb[u][0], xb[u][1]);
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int u = 0; u < 8; ++u) mma_tf32(sacc[mt][u], ab[mt], xsm[u][0], xsm[u][1]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int u = 0; u < 8; ++u) mma_tf32(sacc[mt][u], ab[mt], xb[u][0], xb[u][1]);
        }
      }
    }

    __syncthreads();  // the stage is consumed
    if (s + 2 < steps) load_step(s + 2);
    cp_async_commit();
  }

  // ---- the cluster's partial states, summed through distributed shared
  // memory: warp w's state rows belong to rank w * P / 4, which adds the
  // other ranks' partials of those rows to its own and writes them
  const int owner = warp * n_ranks / (kThreads / 32);
  float4* part = reinterpret_cast<float4*>(stages);  // fragment order, 32 KB
  if (n_ranks > 1) {
    cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        part[((warp * 2 + mt) * 8 + u) * 32 + lane] =
            make_float4(sacc[mt][u][0], sacc[mt][u][1], sacc[mt][u][2], sacc[mt][u][3]);
      }
    }
    cluster.sync();
    if (owner == rank) {
      for (int other = 0; other < n_ranks; ++other) {
        if (other == rank) continue;
        const float4* remote = cluster.map_shared_rank(part, other);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const float4 v = remote[((warp * 2 + mt) * 8 + u) * 32 + lane];
            sacc[mt][u][0] += v.x;
            sacc[mt][u][1] += v.y;
            sacc[mt][u][2] += v.z;
            sacc[mt][u][3] += v.w;
          }
        }
      }
    }
    cluster.sync();  // every partial stays alive until it is read
  }
  if (owner == rank) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int k = 32 * warp + 16 * mt + g + 8 * half;
        if (k < n) store_cols(args.st + ((z * nh + h) * n + k) * hp, hp, q, sacc[mt], half);
      }
    }
  }
}

template <typename T>
cudaError_t prepare() {  // once: the dynamic shared-memory cap
  static cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem<T>);
  return err;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// op 0: launch; op 1: *out = resident CTAs per SM; op 2: *out = dynamic shared memory
template <typename T>
int run(const Args& args, int op, int* out, cudaStream_t stream) {
  cudaError_t err = prepare<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (op == 2) {
    *out = kSmem<T>;
    return 0;
  }
  if (op == 1) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, ssd_chunk_kernel<T>, kThreads, kSmem<T>));
  }
  const int n_lt = (args.lc + kT - 1) / kT;
  const unsigned ranks = (n_lt + 1) / 2;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = ranks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, args.nh, args.nb);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem<T>;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ssd_chunk_kernel<T>, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const Args& args, int bc_dtype, int op, int* out, cudaStream_t stream) {
  if (bc_dtype == 0) return run<float>(args, op, out, stream);
  if (bc_dtype == 1) return run<__nv_bfloat16>(args, op, out, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// bc_dtype: 0 = float32, 1 = bfloat16 (x and a are float32). Lc <= 256,
// n <= 128, hp <= 64, nh a multiple of g. cum may be null. Launches ONE
// kernel on `stream`, allocates nothing; returns a cudaError_t.
extern "C" int ssd_chunk_fwd(const void* x, const void* a, const void* b, const void* c,
                             void* y, void* st, void* cum, int bc_dtype, int nb, int lc,
                             int nh, int hp, int n, int g, long long sb0, long long sb1,
                             long long sb2, void* stream) {
  if (lc <= 0 || lc > kMaxLc || n <= 0 || n > kMaxN || hp <= 0 || hp > kMaxHp ||
      g <= 0 || nh % g != 0 || nh > 65535 || nb > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb == 0 || nh == 0) return 0;
  const long long es = bc_dtype == 1 ? 2 : 4;
  const bool vec_bc = aligned16(b) && aligned16(c) && (sb0 * es) % 16 == 0 &&
                      (sb1 * es) % 16 == 0 && (g == 1 || (sb2 * es) % 16 == 0);
  const bool vec_x = aligned16(x) && hp % 4 == 0;
  const Args args{static_cast<const float*>(x), static_cast<const float*>(a), b, c,
                  static_cast<float*>(y), static_cast<float*>(st), static_cast<float*>(cum),
                  nb, lc, nh, hp, n, nh / g, sb0, sb1, sb2, vec_x, vec_bc};
  return dispatch(args, bc_dtype, 0, nullptr, static_cast<cudaStream_t>(stream));
}

// Resident CTAs per SM (op 1) or dynamic shared memory in bytes (op 2) of the
// instantiation for bc_dtype. Returns a cudaError_t.
extern "C" int ssd_chunk_info(int bc_dtype, int op, int* out) {
  if (op != 1 && op != 2) return static_cast<int>(cudaErrorInvalidValue);
  const Args none{};
  return dispatch(none, bc_dtype, op, out, nullptr);
}
