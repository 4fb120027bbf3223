// Backward of the Mamba-2 intra-chunk SSD (csrc/ssd_chunk.cu), on the tensor
// cores at float32 accuracy, free of atomics.
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
// Bound on an H100: bytes, as chip_smoke.py's ssd_bwd_bound counts them. At
// the Mamba-2 2.7B training shape (32 chunk tiles of 256, 80 heads of 64, n
// 128, one bf16 group, dcum given) one call reads x, dy, dst, a, dcum, B and C
// once and writes dx, da, dB and dC once: 0.60 GB, 0.180 ms at 3.35 TB/s. Its
// products on causal pairs, per head (dM = dy.x^T, M^T.dy, w dst^T B,
// w x dst^T) and per group (C.B^T in bf16, dG^T.C, dG.B), are 43.8 GFLOP:
// 0.088 ms at the 495 TFLOP/s TF32 rate, 0.654 ms on the 67 TFLOP/s float32
// CUDA cores. So the products run on the tensor cores (the CUDA-core kernel
// this one replaced took 3.80 ms). As split passes (below) and in whole 64 x
// 64 tiles, the tensor cores do about 3.4x the counted work, on warp-level
// mma.sync: this design is bound by its products, not by the bytes.
//
// Plan (ssd_chunk.bwd_plan). Tiles are 64 tokens; n_lt = ceil(Lc / 64) row
// tiles and as many column tiles. A CTA owns (chunk z, head block hb, column
// tile c): the hblk heads of hb lie in one group and share B and C, so
//   * G^T over the CTA's (row tile r >= c, c) pairs is formed once for all its
//     heads and kept in shared memory (neither recomputed per head nor sent
//     through device memory);
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
// turns into da by a reverse scan. Those two take a thread per output slot
// (per row and head), so the partials' loads of many warps are in flight at
// once. No float atomics: two calls give the same bits. Grid (nb * head
// blocks, n_lt) with the column tile in y, so the CTAs of column tile 0,
// which walk every row tile, start first.
//
// Products (warp-level mma.sync, f32 accumulate; no operand leaves float32
// accuracy), in the frame of the column tile: rows m, columns l.
//   * G^T = B_c.C_r^T: bf16 B/C in one m16n8k16 pass (a product of two bf16
//     values is exact in f32), fragments by ldmatrix; float32 B/C in three
//     m16n8k8 TF32 passes over split operands.
//   * f32 x f32 products (dM^T = x.dy^T, dx += M^T.dy, w x.dst^T for dB's
//     state term): each operand split into big = tf32(v) and small = v - big
//     (ssd_common.cuh's split, the forward's), the product small.big +
//     big.small + big.big (3xTF32). Single-pass TF32 keeps about three
//     decimal digits and misses the float32 tolerance;
//     tests/test_torch_ssd_bwd_tc.py models both.
//   * products with a bf16 operand (B_c.dst, dG^T.C, dG.B_c) take two passes:
//     bf16 is exact in TF32.
//   * M^T = G^T * L never leaves registers: the accumulator fragment of
//     dM^T and G^T is the A fragment of M^T.dy once the k index of each
//     8-column block is permuted (slot q <-> column 2q, slot q + 4 <-> column
//     2q + 1), as the forward turns G into P. dy is read with the same
//     permutation, and dx's columns are permuted as the forward's y (column j
//     of n-tile u is hp column 8j + u), so a lane's dy operands of all eight
//     n-tiles are two float4s of a row. The products over hp (dM^T, w x.dst^T)
//     take their k as p = 16k' + 4q .. + 3 over two k-blocks, one float4 of x,
//     dy or dst per lane and k'.
//   * each dst or dy tile is split once, by all threads, as its step begins:
//     its big parts stay in the ring stage and its small parts go to one
//     tile beside the ring, where eight warps would otherwise split each value
//     eight times (four row blocks, two fragment layouts).
//   * f32 tiles keep 64 floats a row with their 16-byte chunks XOR-swizzled
//     (swz_s for x, dy, dst and the small parts; swz_d for G^T, dG^T, f32 C
//     and f32 B_c; swz_c for bf16 C and B_c), so each of the access patterns
//     above hits 32 banks; the patterns and their coverage are mirrored in
//     tests/test_torch_ssd_bwd_tc.py.
//
// Work in a CTA: 8 warps, warp w owns rows m 16 (w & 3) .. + 15 and columns
// l 32 (w >> 2) .. + 31 of every pair, so G^T and dG^T are read and summed
// only by their owner. Per head: the state's two products over dst's two
// halves of n (each warp takes 32 of a half's 64 k), then one step per row
// tile r: dM^T, M^T, dG^T += dM^T * L, the row and column sums of dM * M, and
// dx += M^T.dy over the warp's 32 l. The two warps of a row block hold
// partial dx over their halves of l, summed at the head's end through the
// x tile, which is no longer read. Every warp runs every product of a step
// (on the diagonal pair the entries above it are masked, not skipped): no
// branch on the warp index makes ptxas wrap an mma in a collective fallback.
// At the end, dC_r = dG_r.B_c (warp: 16 l, 64 n) and dB = the state term +
// sum_r dG_r^T.C_r (warp: the same 16 m and 64 n it summed the state term in).
//
// Overlap. Every tile the CTA streams (C's tiles at the start and the end; per
// head dst's halves and dy's row tiles) goes through a ring of two 16 KB
// stages by 16-byte cp.async: as step s begins, tile s + 1 is issued into the
// stage step s - 1 read, so it loads under step s's products. x of the next
// head comes with the load issued as a head's first step begins, into a
// second x tile for bf16 B/C (float32 B/C: after the head's end, waited for
// by the next head's first step); a with its second. Each thread copies one
// fixed chunk of four rows of every tile (the swizzles depend on the row mod
// 8 only), so the copies carry no index arithmetic. Rows past Lc and columns
// past n or hp land as zeros. Inputs whose rows are not 16-byte aligned are
// staged element by element (the launcher decides from the pointers and
// strides).
//
// Occupancy: one CTA of 8 warps per SM. G^T and dG^T of up to four pairs
// take 128 KB, B_c 16 KB (bf16; f32 32 KB), the x tiles, the ring and the
// small parts 80 KB (f32: one x tile, 64 KB), cum, a and the row sums 3 KB:
// 232,448 B of dynamic shared memory, all an SM gives a CTA, so two CTAs do
// not fit (the forward's two per SM hold no per-pair state across heads).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ssd_common.cuh"

namespace {

using namespace ssd_common;

constexpr int kThreads = 256;  // 8 warps: wm = warp & 3 (16 rows m), wl = warp >> 2 (32 columns l)
constexpr int kT = 64;         // rows of a row tile = columns of a column tile
constexpr int kMaxLc = 256;
constexpr int kMaxN = 128;
constexpr int kMaxHp = 64;
constexpr int kMaxLt = kMaxLc / kT;
constexpr int kTileF = kT * kT;    // floats of a 64 x 64 tile
constexpr int kStage = kTileF * 4;  // bytes of a ring stage, an x tile, a G^T tile
constexpr int kRing = 2;
constexpr int kPart = kT * kMaxN;  // floats of a dB / dC partial (64 x 128)

template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> {
  static constexpr int kSwzB = 3;   // B_c rows of 16 chunks: ldmatrix's 8 rows in distinct banks
  static constexpr int kCJobs = 1;  // ring stages of one C tile (64 x 128 bf16)
  static constexpr int kXTiles = 2;  // x of the next head loads during this one
};
template <> struct Cfg<float> {
  static constexpr int kSwzB = 2;   // rows of 32 chunks, swz_d on each row's low chunk bits
  static constexpr int kCJobs = 2;  // halves of 64 columns
  static constexpr int kXTiles = 1;
};

// shared memory, in bytes
constexpr int kOffG = 0;                           // G^T per pair [4][64][64], swz_d
constexpr int kOffDg = kOffG + kMaxLt * kStage;    // dG^T summed over heads, the same
constexpr int kOffB = kOffDg + kMaxLt * kStage;    // B rows of tile c [64][128], kSwzB
template <typename T> constexpr int kOffX = kOffB + kT * kMaxN * (int)sizeof(T);
template <typename T> constexpr int kOffRing = kOffX<T> + Cfg<T>::kXTiles * kStage;
// the small parts of the step's dst or dy tile (the big parts stay in its
// stage); at a head's end, its column sums and u
template <typename T> constexpr int kOffSmall = kOffRing<T> + kRing * kStage;
template <typename T> constexpr int kOffCum = kOffSmall<T> + kStage;   // cum [256]
template <typename T> constexpr int kOffA = kOffCum<T> + kMaxLc * 4;   // a of a head [256]
template <typename T> constexpr int kOffRowp = kOffA<T> + kMaxLc * 4;  // row sums per row block [4][64]
template <typename T> constexpr int kSmem = kOffRowp<T> + 4 * kT * 4;
static_assert(kSmem<__nv_bfloat16> <= 232448 && kSmem<float> <= 232448,
              "fits one SM's shared memory");
static_assert(kThreads == kMaxLc && kTileF % (4 * kThreads) == 0, "a's and the split's thread maps");

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
  float* dbpart;   // (nb, nhb, n_lt, 64, 128)
  float* dcpart;   // (nb, nhb, npairs, 64, 128)
  float* rowpart;  // (nb, n_lt, n_lt * 64, nh): row sums of dM * M per column tile
  float* usum;     // (nb, n_lt, nh)
  int nb, lc, nh, hp, n, g, rep, hblk, nhb, n_lt, npairs;
  long long sb0, sb1, sb2;  // strides of B and C, in elements
  int vec_f, vec_bc;        // rows 16-byte aligned: stage with cp.async
};

__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// index of the tile pair (column tile c, row tile r >= c), column-major
__host__ __device__ __forceinline__ int pair_index(int c, int r, int n_lt) {
  return c * n_lt - c * (c - 1) / 2 + (r - c);
}

// Chunk swizzles of tiles with 16 chunks of 16 bytes a row: chunk ch of row r
// lies at ch ^ swz(r). A row spans two 128-byte rounds of the 32 banks, so
// only the low three bits of a chunk pick its banks, and the swizzles act on
// those: each access of a phase (8 lanes of float4s, 16 of float2s, 32 of
// floats) lands on distinct banks.
//   swz_s (x, dy, dst): a float4 of rows r, r + 1 (r even) at chunks 4k' + q,
//     and of rows 8t + 2q (+ 1) at chunk 2g (+ 1);
//   swz_d (G^T, dG^T, f32 C): a float2 of rows 4i .. 4i + 3 at chunks 2t, 2t + 1,
//     floats of rows 8t + 2q (+ 1) at 8 consecutive columns, and of rows
//     8u .. 8u + 7 at 4 consecutive columns;
//   swz_c (bf16 C): ldmatrix's 8 rows at one chunk.
template <int S> __device__ __forceinline__ int swz(int r) {
  if constexpr (S == 1) return ((r >> 1) & 1) | ((((r >> 2) ^ r) & 1) << 2);
  if constexpr (S == 2) return (((r >> 1) & 1) << 2) | (((r ^ (r >> 2)) & 1) << 1) | (r & 1);
  if constexpr (S == 3) return r & 7;
  return 0;
}
// float index of (row r, column k) in a 64-float row tile under swz_d
__device__ __forceinline__ int at_d(int r, int k) {
  return r * kT + ((((k >> 2) ^ swz<2>(r)) << 2) | (k & 3));
}

// rows [row0, row0 + 64) of a matrix of E with row stride rs, columns
// [col0, col0 + W), into a tile with leading dimension ld and chunk swizzle
// S: zeros where row >= row_end or column >= cols. 16-byte cp.async when vec.
template <typename E, int W, int S>
__device__ __forceinline__ void stage(E* dst, int ld, const E* src, long long rs, int row0,
                                      int row_end, int col0, int cols, bool vec, int tid) {
  constexpr int kE = 16 / (int)sizeof(E), kCh = W / kE;
  if (vec) {
    for (int i = tid; i < kT * kCh; i += kThreads) {
      const int r = i / kCh, ch = i - r * kCh, k = col0 + ch * kE;
      const bool ok = row0 + r < row_end && k < cols;
      const int bytes = ok ? min(cols - k, kE) * (int)sizeof(E) : 0;
      cp_async16(dst + r * ld + (ch ^ swz<S>(r)) * kE, ok ? src + (row0 + r) * rs + k : src,
                 bytes);
    }
  } else {
    for (int i = tid; i < kT * W; i += kThreads) {
      const int r = i / W, kk = i - r * W, k = col0 + kk;
      dst[r * ld + ((kk / kE) ^ swz<S>(r)) * kE + kk % kE] =
          row0 + r < row_end && k < cols ? src[(row0 + r) * rs + k] : E(0.f);
    }
  }
}

// A ring tile: rows [row0, row0 + 64) of a matrix of E with row stride rs,
// 256 bytes of columns from col0, into 64 rows of 16 chunks under swizzle S;
// zeros where row >= row_end or column >= cols. Thread t copies chunk t % 16
// of rows t / 16 + 16j, j = 0..3: the swizzles depend on row % 8 only, so its
// destination and source advance by fixed steps and the copies carry no
// index arithmetic.
template <typename E, int S>
__device__ __forceinline__ void stage_ring(E* dst, const E* src, long long rs, int row0,
                                           int row_end, int col0, int cols, bool vec, int tid) {
  constexpr int kE = 16 / (int)sizeof(E), kW = 16 * kE;
  const int r = tid >> 4, ch = tid & 15, k = col0 + ch * kE;
  if (vec) {
    E* d = dst + r * kW + (ch ^ swz<S>(r)) * kE;
    const E* s = src + (row0 + r) * rs + k;
    const int bytes = k < cols ? min(cols - k, kE) * (int)sizeof(E) : 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = row0 + r + 16 * j < row_end && bytes > 0;
      cp_async16(d + j * 16 * kW, ok ? s + 16 * j * rs : src, ok ? bytes : 0);
    }
  } else {
    stage<E, kW, S>(dst, kW, src, rs, row0, row_end, col0, cols, false, tid);
  }
}

// the 16 columns 8g .. 8g + 7 of tile rows r and r + 1 (swz_s): v[0], v[1] of
// row r, v[2], v[3] of row r + 1
__device__ __forceinline__ void load_pf(float4 (&v)[4], const float* t, int r, int g) {
  const float4* p0 = reinterpret_cast<const float4*>(t + r * kT);
  const float4* p1 = reinterpret_cast<const float4*>(t + (r + 1) * kT);
  v[0] = p0[(2 * g) ^ swz<1>(r)];
  v[1] = p0[(2 * g + 1) ^ swz<1>(r)];
  v[2] = p1[(2 * g) ^ swz<1>(r + 1)];
  v[3] = p1[(2 * g + 1) ^ swz<1>(r + 1)];
}

// chunk 4k' + q of tile row r (swz_s): columns 16k' + 4q .. + 3
__device__ __forceinline__ float4 load_p4(const float* t, int r, int kp, int q) {
  return reinterpret_cast<const float4*>(t + r * kT)[(4 * kp + q) ^ swz<1>(r)];
}

// element (r, col) of the B_c tile: rows of 128 elements, chunks under kSwzB
template <typename T> __device__ __forceinline__ int at_b(int r, int col) {
  constexpr int kE = 16 / (int)sizeof(T);
  return r * kMaxN + (((col / kE) ^ swz<Cfg<T>::kSwzB>(r)) * kE) + col % kE;
}

// the B operands of n-tiles 0..7 over rows r (k slot q) and r + 1 (slot q + 4),
// columns 8g .. 8g + 7, from a split tile's big and small parts
__device__ __forceinline__ void pf_operands(const float* big, const float* small, int r, int g,
                                            uint32_t (&bb)[8][2], uint32_t (&bsm)[8][2]) {
  float4 v[4], w[4];
  load_pf(v, big, r, g);
  load_pf(w, small, r, g);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float e[8] = {v[2 * k].x, v[2 * k].y, v[2 * k].z, v[2 * k].w,
                        v[2 * k + 1].x, v[2 * k + 1].y, v[2 * k + 1].z, v[2 * k + 1].w};
    const float f[8] = {w[2 * k].x, w[2 * k].y, w[2 * k].z, w[2 * k].w,
                        w[2 * k + 1].x, w[2 * k + 1].y, w[2 * k + 1].z, w[2 * k + 1].w};
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      bb[u][k] = __float_as_uint(e[u]);
      bsm[u][k] = __float_as_uint(f[u]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_main_kernel(const Args args) {
  using Cf = Cfg<T>;
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(128) unsigned char smem[];
  float* gts = reinterpret_cast<float*>(smem + kOffG);
  float* dgs = reinterpret_cast<float*>(smem + kOffDg);
  T* bs = reinterpret_cast<T*>(smem + kOffB);
  const float* bsf = reinterpret_cast<const float*>(bs);  // f32 B/C
  float* xbuf = reinterpret_cast<float*>(smem + kOffX<T>);
  unsigned char* ring = smem + kOffRing<T>;
  float* smallp = reinterpret_cast<float*>(smem + kOffSmall<T>);
  float* cum = reinterpret_cast<float*>(smem + kOffCum<T>);
  float* abuf = reinterpret_cast<float*>(smem + kOffA<T>);
  float* rowp = reinterpret_cast<float*>(smem + kOffRowp<T>);
  // at a head's end: the two column halves' sums of dM * M, their u, and u
  float* colp = smallp;
  float* upart = smallp + 2 * kT;
  float* us = smallp + 4 * kT;

  const int lc = args.lc, nh = args.nh, hp = args.hp, n = args.n, n_lt = args.n_lt;
  const int hblk = args.hblk;
  const int hb = blockIdx.x % args.nhb;
  const long long z = blockIdx.x / args.nhb;
  const int c = blockIdx.y;
  const int nr = n_lt - c;  // row tiles c .. n_lt - 1
  const int h0 = hb * hblk, grp = h0 / args.rep;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3, wm = warp & 3, wl = warp >> 2;
  const int m0 = 16 * wm + g;  // this lane's rows m0, m0 + 8 of the column tile
  const T* bsrc = static_cast<const T*>(args.b) + z * args.sb0 + grp * args.sb2;
  const T* csrc = static_cast<const T*>(args.c) + z * args.sb0 + grp * args.sb2;
  const long long rs = (long long)nh * hp;  // row stride of x and dy
  const bool vec_f = args.vec_f, vec_bc = args.vec_bc;

  // the tiles through the ring, in order: C's (start), per head dst's two
  // halves and dy's row tiles c .. n_lt - 1, C's again (end)
  const int ncj = nr * Cf::kCJobs, per_head = 2 + nr;
  const int n_jobs = 2 * ncj + hblk * per_head;
  auto stage_c = [&](unsigned char* st, int jc) {
    const int r = c + jc / Cf::kCJobs;
    stage_ring<T, kBf16 ? 3 : 2>(reinterpret_cast<T*>(st), csrc, args.sb1, r * kT, lc,
                                 (jc % Cf::kCJobs) * kT, n, vec_bc, tid);
  };
  auto issue = [&](int j) {
    if (j >= n_jobs) return;
    unsigned char* st = ring + (j % kRing) * kStage;
    const int jh = j - ncj;
    if (jh < 0) {
      stage_c(st, j);
    } else if (jh >= hblk * per_head) {
      stage_c(st, jh - hblk * per_head);
    } else {
      const int hi = jh / per_head, k = jh - hi * per_head, h = h0 + hi;
      float* t = reinterpret_cast<float*>(st);
      if (k < 2) {  // dst rows 64k .. of head h: (n, hp) contiguous
        stage_ring<float, 1>(t, args.dst + (z * nh + h) * (long long)n * hp, hp, k * kT, n, 0, hp,
                             vec_f, tid);
      } else {
        stage_ring<float, 1>(t, args.dy + (z * lc * nh + h) * hp, rs, (c + k - 2) * kT, lc, 0, hp,
                             vec_f, tid);
      }
    }
  };
  auto stage_x = [&](int hi) {
    stage_ring<float, 1>(xbuf + (Cf::kXTiles == 2 ? (hi & 1) * kTileF : 0),
                         args.x + (z * lc * nh + h0 + hi) * hp, rs, c * kT, lc, 0, hp, vec_f, tid);
  };
  auto stage_a = [&](int hi) {  // a of head h0 + hi over the chunk; zeros past lc
    const int l = tid;
    const float* src = args.a + (z * lc + min(l, lc - 1)) * nh + h0 + hi;
    cp_async4(abuf + l, src, l < lc ? 4 : 0);
  };

  // ---- prologue: B's rows of tile c, the first head's x and a, the first tile
  for (int i = tid; i < kMaxLt * kTileF; i += kThreads) dgs[i] = 0.f;
  stage<T, kMaxN, Cf::kSwzB>(bs, kMaxN, bsrc, args.sb1, c * kT, lc, 0, n, vec_bc, tid);
  stage_x(0);
  stage_a(0);
  issue(0);
  cp_async_commit();
  // Step s consumes tile s. At its start the one group in flight holds tile s
  // (and what came with it): wait for it; after the barrier every warp is done
  // with step s - 1, whose stage takes tile s + 1, one step ahead of its
  // products. The caller may add to that group before commit().
  int step = 0;
  auto begin = [&]() -> float* {
    cp_async_wait<0>();
    __syncthreads();
    issue(step + 1);
    return reinterpret_cast<float*>(ring + (step % kRing) * kStage);
  };
  auto commit = [&]() {
    cp_async_commit();
    ++step;
  };
  // a dst or dy tile split once for all warps: big stays, small goes to smallp
  auto split_tile = [&](float* t) {
#pragma unroll
    for (int j = 0; j < kTileF / (4 * kThreads); ++j) {
      const int i = 4 * (tid + j * kThreads);
      const float4 v = *reinterpret_cast<const float4*>(t + i);
      uint32_t b[4], sm4[4];
      split(v.x, b[0], sm4[0]);
      split(v.y, b[1], sm4[1]);
      split(v.z, b[2], sm4[2]);
      split(v.w, b[3], sm4[3]);
      *reinterpret_cast<float4*>(t + i) = make_float4(
          __uint_as_float(b[0]), __uint_as_float(b[1]), __uint_as_float(b[2]), __uint_as_float(b[3]));
      *reinterpret_cast<float4*>(smallp + i) =
          make_float4(__uint_as_float(sm4[0]), __uint_as_float(sm4[1]), __uint_as_float(sm4[2]),
                      __uint_as_float(sm4[3]));
    }
  };

  // ---- G^T_r = B_c . C_r^T for each pair, once for the block's heads:
  // rows m0, m0 + 8, columns l = 32 wl + 8t + 2q (+ 1)
  for (int rr = 0; rr < nr; ++rr) {
    float acc[4][4] = {};
#pragma unroll
    for (int half = 0; half < Cf::kCJobs; ++half) {
      const T* ct = reinterpret_cast<const T*>(begin());
      commit();
      if constexpr (kBf16) {
#pragma unroll
        for (int k0 = 0; k0 < kMaxN; k0 += 16) {  // columns past n are zeros
          uint32_t af[4];
          ldsm_x4(af, bs + at_b<T>(16 * wm + (lane & 15), k0 + (lane >> 4) * 8));
#pragma unroll
          for (int t = 0; t < 4; t += 2) {
            const int i = lane >> 3, row = 32 * wl + 8 * t + (lane & 7) + (i >> 1) * 8;
            uint32_t bf[4];
            ldsm_x4(bf, ct + row * kMaxN + (((k0 >> 3) + (i & 1)) ^ swz<3>(row)) * 8);
            mma_bf16(acc[t], af, bf[0], bf[1]);
            mma_bf16(acc[t + 1], af, bf[2], bf[3]);
          }
        }
      } else {
#pragma unroll 2
        for (int k0 = 0; k0 < kT; k0 += 8) {
          const int kc = half * kT + k0 + q;
          uint32_t ab[4], as[4];
          split(bsf[at_b<T>(m0, kc)], ab[0], as[0]);
          split(bsf[at_b<T>(m0 + 8, kc)], ab[1], as[1]);
          split(bsf[at_b<T>(m0, kc + 4)], ab[2], as[2]);
          split(bsf[at_b<T>(m0 + 8, kc + 4)], ab[3], as[3]);
          uint32_t bb[4][2], bsm[4][2];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int row = 32 * wl + 8 * t + g;
            split(ct[at_d(row, k0 + q)], bb[t][0], bsm[t][0]);
            split(ct[at_d(row, k0 + q + 4)], bb[t][1], bsm[t][1]);
          }
#pragma unroll
          for (int t = 0; t < 4; ++t) mma_tf32(acc[t], as, bb[t][0], bb[t][1]);
#pragma unroll
          for (int t = 0; t < 4; ++t) mma_tf32(acc[t], ab, bsm[t][0], bsm[t][1]);
#pragma unroll
          for (int t = 0; t < 4; ++t) mma_tf32(acc[t], ab, bb[t][0], bb[t][1]);
        }
      }
    }
    float* gt = gts + rr * kTileF;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int l = 32 * wl + 8 * t + 2 * q;
      *reinterpret_cast<float2*>(gt + at_d(m0, l)) = make_float2(acc[t][0], acc[t][1]);
      *reinterpret_cast<float2*>(gt + at_d(m0 + 8, l)) = make_float2(acc[t][2], acc[t][3]);
    }
  }

  // dB's state term over the block's heads, then dB itself: rows m0, m0 + 8,
  // columns n = 64 half + 32 wl + 8u + 2q (+ 1)
  float dbacc[2][4][4] = {};
  float rowd = 0.f;  // thread tid < 64: rowsum_tid of dM * M over the diagonal pair
  // thread tid < 64: the row blocks' sums of row tid of pair rr, in order
  auto row_sums = [&](int rr, int h) {
    const float s = rowp[tid] + rowp[kT + tid] + rowp[2 * kT + tid] + rowp[3 * kT + tid];
    const int r = c + rr;
    if (rr == 0) {
      rowd = s;
    } else if (r * kT + tid < lc) {
      args.rowpart[((z * n_lt + c) * n_lt * kT + r * kT + tid) * nh + h] = s;
    }
  };

  for (int hi = 0; hi < hblk; ++hi) {
    const int h = h0 + hi;
    const float* xs = xbuf + (Cf::kXTiles == 2 ? (hi & 1) * kTileF : 0);
    // dx rows m0 (acc[u][0], [1]), m0 + 8 ([2], [3]); column j of n-tile u is p 8j + u
    float dxa[8][4] = {};
    float w0 = 0.f, w1 = 0.f;

    // ---- the state's terms over dst's two halves of n: dx_m = w_m dst^T B_m
    // (this warp's 32 of the half's 64 k) and dB_m += w_m dst x_m (its 32 of
    // the half's 64 n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float* ds = begin();
      if (half == 0 && Cf::kXTiles == 2 && hi + 1 < hblk) stage_x(hi + 1);
      if (half == 1 && hi + 1 < hblk) stage_a(hi + 1);  // this head's a is scanned
      commit();
      if (half == 0 && warp == 0) {  // prefix sums of a over the chunk; rows past lc hold the total
        float carry = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxLc / 32; ++i) {
          float v = abuf[32 * i + lane];
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const float t = __shfl_up_sync(0xffffffffu, v, off);
            if (lane >= off) v += t;
          }
          v += carry;
          cum[32 * i + lane] = v;
          carry = __shfl_sync(0xffffffffu, v, 31);
        }
      }
      split_tile(ds);
      __syncthreads();
      if (half == 0) {
        const float c_last = cum[lc - 1];
        w0 = __expf(c_last - cum[c * kT + m0]);
        w1 = __expf(c_last - cum[c * kT + m0 + 8]);
      }
      // dx += B_c[:, n] . dst[n, :] over n = 64 half + 32 wl + 8t + (slot q <-> 2q, q + 4 <-> 2q + 1)
#pragma unroll
      for (int t = 0; t < 4; t += 2) {
        uint32_t a2[2][4], as2[2][4];
        if constexpr (kBf16) {
          uint32_t af[4];
          ldsm_x4(af, bs + at_b<T>(16 * wm + (lane & 15),
                                   half * kT + 32 * wl + 8 * t + (lane >> 4) * 8));
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            a2[k][0] = bf16_lo(af[2 * k]);
            a2[k][1] = bf16_lo(af[2 * k + 1]);
            a2[k][2] = bf16_hi(af[2 * k]);
            a2[k][3] = bf16_hi(af[2 * k + 1]);
          }
        } else {
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int col = half * kT + 32 * wl + 8 * (t + k) + 2 * q;
            const float2 v0 = *reinterpret_cast<const float2*>(bsf + at_b<T>(m0, col));
            const float2 v1 = *reinterpret_cast<const float2*>(bsf + at_b<T>(m0 + 8, col));
            split(v0.x, a2[k][0], as2[k][0]);
            split(v1.x, a2[k][1], as2[k][1]);
            split(v0.y, a2[k][2], as2[k][2]);
            split(v1.y, a2[k][3], as2[k][3]);
          }
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          uint32_t db[8][2], dsm[8][2];
          pf_operands(ds, smallp, 32 * wl + 8 * (t + k) + 2 * q, g, db, dsm);
          if constexpr (!kBf16) {
#pragma unroll
            for (int u = 0; u < 8; ++u) mma_tf32(dxa[u], as2[k], db[u][0], db[u][1]);
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) mma_tf32(dxa[u], a2[k], dsm[u][0], dsm[u][1]);
#pragma unroll
          for (int u = 0; u < 8; ++u) mma_tf32(dxa[u], a2[k], db[u][0], db[u][1]);
        }
      }
      // dB += (w x) . dst^T over p (k = 16k' + 4q .. + 3 over two k-blocks),
      // n = 64 half + 32 wl + 8u + g
#pragma unroll 2
      for (int kp = 0; kp < 4; ++kp) {
        const float4 xa = load_p4(xs, m0, kp, q), xb = load_p4(xs, m0 + 8, kp, q);
        uint32_t ab[2][4], as[2][4];
        split(w0 * xa.x, ab[0][0], as[0][0]);
        split(w1 * xb.x, ab[0][1], as[0][1]);
        split(w0 * xa.y, ab[0][2], as[0][2]);
        split(w1 * xb.y, ab[0][3], as[0][3]);
        split(w0 * xa.z, ab[1][0], as[1][0]);
        split(w1 * xb.z, ab[1][1], as[1][1]);
        split(w0 * xa.w, ab[1][2], as[1][2]);
        split(w1 * xb.w, ab[1][3], as[1][3]);
        uint32_t bb[2][4][2], bsm[2][4][2];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int row = 32 * wl + 8 * u + g;
          const float4 vb = load_p4(ds, row, kp, q), vs = load_p4(smallp, row, kp, q);
          bb[0][u][0] = __float_as_uint(vb.x);
          bb[0][u][1] = __float_as_uint(vb.y);
          bb[1][u][0] = __float_as_uint(vb.z);
          bb[1][u][1] = __float_as_uint(vb.w);
          bsm[0][u][0] = __float_as_uint(vs.x);
          bsm[0][u][1] = __float_as_uint(vs.y);
          bsm[1][u][0] = __float_as_uint(vs.z);
          bsm[1][u][1] = __float_as_uint(vs.w);
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
#pragma unroll
          for (int u = 0; u < 4; ++u) mma_tf32(dbacc[half][u], as[k], bb[k][u][0], bb[k][u][1]);
#pragma unroll
          for (int u = 0; u < 4; ++u) mma_tf32(dbacc[half][u], ab[k], bsm[k][u][0], bsm[k][u][1]);
#pragma unroll
          for (int u = 0; u < 4; ++u) mma_tf32(dbacc[half][u], ab[k], bb[k][u][0], bb[k][u][1]);
        }
      }
    }

    // the state's dx times w_m; u_m = x_m . that, partial over this warp's k
    float u0 = 0.f, u1 = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 xa = load_p4(xs, m0, q, k), xb = load_p4(xs, m0 + 8, q, k);
      const float ea[4] = {xa.x, xa.y, xa.z, xa.w}, eb[4] = {xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // column 16q + 4k + i: n-tile (4k + i) % 8, column 2q + k / 2
        const int u = (4 * k + i) & 7, j = k >> 1;
        dxa[u][j] *= w0;
        dxa[u][2 + j] *= w1;
        u0 += ea[i] * dxa[u][j];
        u1 += eb[i] * dxa[u][2 + j];
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      u0 += __shfl_xor_sync(0xffffffffu, u0, off);
      u1 += __shfl_xor_sync(0xffffffffu, u1, off);
    }

    // ---- the pairs (r, c): dM^T, M^T, dG^T, the sums of dM * M, dx += M^T dy
    float col0 = 0.f, col1 = 0.f;  // this lane's part of colsum_m of dM * M, rows m0, m0 + 8
    for (int rr = 0; rr < nr; ++rr) {
      const int r = c + rr;
      float* ys = begin();
      commit();
      if (rr > 0 && tid < kT) row_sums(rr - 1, h);
      split_tile(ys);
      __syncthreads();
      // dM^T rows m0 (+ 8), columns l = 32 wl + 8t + 2q (+ 1): x_m . dy_l over p
      float dm[4][4] = {};
#pragma unroll 2
      for (int kp = 0; kp < 4; ++kp) {
        const float4 xa = load_p4(xs, m0, kp, q), xb = load_p4(xs, m0 + 8, kp, q);
        uint32_t ab[2][4], as[2][4];
        split(xa.x, ab[0][0], as[0][0]);
        split(xb.x, ab[0][1], as[0][1]);
        split(xa.y, ab[0][2], as[0][2]);
        split(xb.y, ab[0][3], as[0][3]);
        split(xa.z, ab[1][0], as[1][0]);
        split(xb.z, ab[1][1], as[1][1]);
        split(xa.w, ab[1][2], as[1][2]);
        split(xb.w, ab[1][3], as[1][3]);
        uint32_t bb[2][4][2], bsm[2][4][2];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int row = 32 * wl + 8 * t + g;
          const float4 vb = load_p4(ys, row, kp, q), vs = load_p4(smallp, row, kp, q);
          bb[0][t][0] = __float_as_uint(vb.x);
          bb[0][t][1] = __float_as_uint(vb.y);
          bb[1][t][0] = __float_as_uint(vb.z);
          bb[1][t][1] = __float_as_uint(vb.w);
          bsm[0][t][0] = __float_as_uint(vs.x);
          bsm[0][t][1] = __float_as_uint(vs.y);
          bsm[1][t][0] = __float_as_uint(vs.z);
          bsm[1][t][1] = __float_as_uint(vs.w);
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
#pragma unroll
          for (int t = 0; t < 4; ++t) mma_tf32(dm[t], as[k], bb[k][t][0], bb[k][t][1]);
#pragma unroll
          for (int t = 0; t < 4; ++t) mma_tf32(dm[t], ab[k], bsm[k][t][0], bsm[k][t][1]);
#pragma unroll
          for (int t = 0; t < 4; ++t) mma_tf32(dm[t], ab[k], bb[k][t][0], bb[k][t][1]);
        }
      }
      // M^T = G^T * L (in place of G^T), dG^T += dM^T * L, R = dM^T * M^T:
      // exp only on causal pairs
      float gv[4][4], rsum[4][2];
      const float* gt = gts + rr * kTileF;
      float* dg = dgs + rr * kTileF;
      const float cm0 = cum[c * kT + m0], cm1 = cum[c * kT + m0 + 8];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int l = 32 * wl + 8 * t + 2 * q;
        const float2 g0 = *reinterpret_cast<const float2*>(gt + at_d(m0, l));
        const float2 g1 = *reinterpret_cast<const float2*>(gt + at_d(m0 + 8, l));
        float2 d0 = *reinterpret_cast<const float2*>(dg + at_d(m0, l));
        float2 d1 = *reinterpret_cast<const float2*>(dg + at_d(m0 + 8, l));
        const float gg[4] = {g0.x, g0.y, g1.x, g1.y};
        float dd[4] = {d0.x, d0.y, d1.x, d1.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float cl = cum[r * kT + l + e];
          const float l0 = rr > 0 || m0 <= l + e ? __expf(cl - cm0) : 0.f;
          const float l1 = rr > 0 || m0 + 8 <= l + e ? __expf(cl - cm1) : 0.f;
          gv[t][e] = gg[e] * l0;
          gv[t][2 + e] = gg[2 + e] * l1;
          dd[e] += dm[t][e] * l0;
          dd[2 + e] += dm[t][2 + e] * l1;
          const float r0 = dm[t][e] * gv[t][e], r1 = dm[t][2 + e] * gv[t][2 + e];
          col0 += r0;
          col1 += r1;
          rsum[t][e] = r0 + r1;
        }
        *reinterpret_cast<float2*>(dg + at_d(m0, l)) = make_float2(dd[0], dd[1]);
        *reinterpret_cast<float2*>(dg + at_d(m0 + 8, l)) = make_float2(dd[2], dd[3]);
      }
      // rowsum_l of dM * M (a sum over m): over g here, over the row blocks
      // in the next step (row_sums)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            rsum[t][e] += __shfl_xor_sync(0xffffffffu, rsum[t][e], off);
          }
        }
      }
      if (g == 0) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          *reinterpret_cast<float2*>(rowp + wm * kT + 32 * wl + 8 * t + 2 * q) =
              make_float2(rsum[t][0], rsum[t][1]);
        }
      }
      // dx += M^T . dy over this warp's l: k-block t (slot q <-> l 8t + 2q,
      // q + 4 <-> 8t + 2q + 1) is n-tile t of the accumulators
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        uint32_t pb[4], ps[4];
        split(gv[t][0], pb[0], ps[0]);
        split(gv[t][2], pb[1], ps[1]);
        split(gv[t][1], pb[2], ps[2]);
        split(gv[t][3], pb[3], ps[3]);
        uint32_t yb[8][2], ysm[8][2];
        pf_operands(ys, smallp, 32 * wl + 8 * t + 2 * q, g, yb, ysm);
#pragma unroll
        for (int u = 0; u < 8; ++u) mma_tf32(dxa[u], ps, yb[u][0], yb[u][1]);
#pragma unroll
        for (int u = 0; u < 8; ++u) mma_tf32(dxa[u], pb, ysm[u][0], ysm[u][1]);
#pragma unroll
        for (int u = 0; u < 8; ++u) mma_tf32(dxa[u], pb, yb[u][0], yb[u][1]);
      }
    }

    // ---- the head's end: the two column halves' dx summed through the x
    // tile (no longer read), colsum and u over the two halves, dcum's terms
    // of the tile's own rows
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      col0 += __shfl_xor_sync(0xffffffffu, col0, off);
      col1 += __shfl_xor_sync(0xffffffffu, col1, off);
    }
    __syncthreads();  // the last pair is done: x, the small parts and rowp are free
    if (tid < kT) row_sums(nr - 1, h);
    float4* park = reinterpret_cast<float4*>(const_cast<float*>(xs));
    if (wl == 1) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        park[(wm * 8 + u) * 32 + lane] = make_float4(dxa[u][0], dxa[u][1], dxa[u][2], dxa[u][3]);
      }
    }
    if (q == 0) {
      colp[wl * kT + m0] = col0;
      colp[wl * kT + m0 + 8] = col1;
      upart[wl * kT + m0] = u0;
      upart[wl * kT + m0 + 8] = u1;
    }
    __syncthreads();
    if (wl == 0) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float4 v = park[(wm * 8 + u) * 32 + lane];
        dxa[u][0] += v.x;
        dxa[u][1] += v.y;
        dxa[u][2] += v.z;
        dxa[u][3] += v.w;
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = c * kT + m0 + 8 * half;
        if (m < lc) store_cols(args.dx + ((z * lc + m) * nh + h) * hp, hp, q, dxa, half);
      }
    }
    if (tid < kT) {  // the tile's own rows: + rowsum - colsum - u
      us[tid] = upart[tid] + upart[kT + tid];
      const float colacc = colp[tid] + colp[kT + tid];
      const int m = c * kT + tid;
      if (m < lc) {
        args.rowpart[((z * n_lt + c) * n_lt * kT + m) * nh + h] = rowd - colacc - us[tid];
      }
    }
    if (tid < 32) {  // sum of u over the tile, in a fixed order
      float s = (upart[lane] + upart[kT + lane]) + (upart[lane + 32] + upart[kT + lane + 32]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) args.usum[(z * n_lt + c) * nh + h] = s;
    }
    if (Cf::kXTiles == 1 && hi + 1 < hblk) {  // x of the next head, once this one's is read
      __syncthreads();
      stage_x(hi + 1);
      cp_async_commit();
    }
  }

  // ---- dC's partial of each pair: dG_r . B_c (rows l = 16 (warp & 3) + g (+ 8)
  // of tile r, columns n = 64 (warp >> 2) + 8u + 2q (+ 1)); k = m, slot q <-> 8t + 2q
  {
    const int l0 = 16 * wm + g, n0 = 64 * wl;
    for (int rr = 0; rr < nr; ++rr) {
      const float* dg = dgs + rr * kTileF;
      float acc[8][4] = {};
#pragma unroll 2
      for (int t = 0; t < 8; ++t) {
        const int mr = 8 * t + 2 * q;
        uint32_t ab[4], as[4];
        split(dg[at_d(mr, l0)], ab[0], as[0]);
        split(dg[at_d(mr, l0 + 8)], ab[1], as[1]);
        split(dg[at_d(mr + 1, l0)], ab[2], as[2]);
        split(dg[at_d(mr + 1, l0 + 8)], ab[3], as[3]);
        uint32_t bb[8][2], bsm[8][2];
        if constexpr (kBf16) {
#pragma unroll
          for (int u = 0; u < 8; u += 4) {
            uint32_t bf[4];
            ldsm_x4_trans(bf, bs + at_b<T>(8 * t + (lane & 7), n0 + 8 * (u + (lane >> 3))));
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              bb[u + i][0] = bf16_lo(bf[i]);
              bb[u + i][1] = bf16_hi(bf[i]);
            }
          }
        } else {
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            split(bsf[at_b<T>(mr, n0 + 8 * u + g)], bb[u][0], bsm[u][0]);
            split(bsf[at_b<T>(mr + 1, n0 + 8 * u + g)], bb[u][1], bsm[u][1]);
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) mma_tf32(acc[u], as, bb[u][0], bb[u][1]);
        if constexpr (!kBf16) {
#pragma unroll
          for (int u = 0; u < 8; ++u) mma_tf32(acc[u], ab, bsm[u][0], bsm[u][1]);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) mma_tf32(acc[u], ab, bb[u][0], bb[u][1]);
      }
      float* dcp = args.dcpart +
                   ((z * args.nhb + hb) * args.npairs + pair_index(c, c + rr, n_lt)) * kPart;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int col = n0 + 8 * u + 2 * q;
        *reinterpret_cast<float2*>(dcp + l0 * kMaxN + col) = make_float2(acc[u][0], acc[u][1]);
        *reinterpret_cast<float2*>(dcp + (l0 + 8) * kMaxN + col) =
            make_float2(acc[u][2], acc[u][3]);
      }
    }
  }

  // ---- dB's partial over tile c: the state term + sum_r dG_r^T . C_r
  // (k = l, slot q <-> 8t + 2q)
  for (int rr = 0; rr < nr; ++rr) {
    const float* dg = dgs + rr * kTileF;
#pragma unroll
    for (int half = 0; half < Cf::kCJobs; ++half) {
      const T* ct = reinterpret_cast<const T*>(begin());
      commit();
#pragma unroll 2
      for (int t = 0; t < 8; ++t) {
        const float2 v0 = *reinterpret_cast<const float2*>(dg + at_d(m0, 8 * t + 2 * q));
        const float2 v1 = *reinterpret_cast<const float2*>(dg + at_d(m0 + 8, 8 * t + 2 * q));
        uint32_t ab[4], as[4];
        split(v0.x, ab[0], as[0]);
        split(v1.x, ab[1], as[1]);
        split(v0.y, ab[2], as[2]);
        split(v1.y, ab[3], as[3]);
        if constexpr (kBf16) {
#pragma unroll
          for (int hn = 0; hn < 2; ++hn) {
            uint32_t bf[4];
            const int row = 8 * t + (lane & 7), ch = 8 * hn + 4 * wl + (lane >> 3);
            ldsm_x4_trans(bf, ct + row * kMaxN + (ch ^ swz<3>(row)) * 8);
            uint32_t bb[4][2];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              bb[u][0] = bf16_lo(bf[u]);
              bb[u][1] = bf16_hi(bf[u]);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) mma_tf32(dbacc[hn][u], as, bb[u][0], bb[u][1]);
#pragma unroll
            for (int u = 0; u < 4; ++u) mma_tf32(dbacc[hn][u], ab, bb[u][0], bb[u][1]);
          }
        } else {
          const float* cf = reinterpret_cast<const float*>(ct);
          uint32_t bb[4][2], bsm[4][2];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int col = 32 * wl + 8 * u + g;
            split(cf[at_d(8 * t + 2 * q, col)], bb[u][0], bsm[u][0]);
            split(cf[at_d(8 * t + 2 * q + 1, col)], bb[u][1], bsm[u][1]);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) mma_tf32(dbacc[half][u], as, bb[u][0], bb[u][1]);
#pragma unroll
          for (int u = 0; u < 4; ++u) mma_tf32(dbacc[half][u], ab, bsm[u][0], bsm[u][1]);
#pragma unroll
          for (int u = 0; u < 4; ++u) mma_tf32(dbacc[half][u], ab, bb[u][0], bb[u][1]);
        }
      }
    }
  }
  float* dbp = args.dbpart + ((z * args.nhb + hb) * n_lt + c) * kPart;
#pragma unroll
  for (int hn = 0; hn < 2; ++hn) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int col = 64 * hn + 32 * wl + 8 * u + 2 * q;
      *reinterpret_cast<float2*>(dbp + m0 * kMaxN + col) = make_float2(dbacc[hn][u][0],
                                                                       dbacc[hn][u][1]);
      *reinterpret_cast<float2*>(dbp + (m0 + 8) * kMaxN + col) =
          make_float2(dbacc[hn][u][2], dbacc[hn][u][3]);
    }
  }
}

// dB and dC of 256 of the 64 x 128 slots of row tile t of group grp: the
// head blocks' partials summed in order (and, for dC, the column tiles c <= t
// in order), rounded once. A thread a slot, so the partials' loads of many
// warps are in flight at once.
constexpr int kBcCtas = kPart / kThreads;  // CTAs per row tile
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_bc_kernel(const Args args) {
  const int t = blockIdx.x / kBcCtas, grp = blockIdx.y;
  const long long z = blockIdx.z;
  const int n = args.n, n_lt = args.n_lt;
  const int hb0 = grp * args.rep / args.hblk, hb1 = (grp + 1) * args.rep / args.hblk;
  T* db = static_cast<T*>(args.db);
  T* dc = static_cast<T*>(args.dc);
  const int off = (blockIdx.x % kBcCtas) * kThreads + threadIdx.x;
  const int row = off / kMaxN, k = off % kMaxN, l = t * kT + row;
  if (l >= args.lc || k >= n) return;
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

// dcum and da for kDaHeads heads of chunk z: each (row, head) gathers its
// terms (the threads take the rows in turn, so their loads are in flight
// together), then thread (hx, seg) sums the rows of its segment of the chunk
// and the segments' totals carry the reverse scan
constexpr int kDaHeads = 8;
constexpr int kDaSegs = kThreads / kDaHeads;
__global__ void __launch_bounds__(kThreads) ssd_bwd_da_kernel(const Args args) {
  __shared__ float d[kMaxLc][kDaHeads + 1];
  __shared__ float tot[kDaSegs][kDaHeads];
  const int hx = threadIdx.x % kDaHeads, seg = threadIdx.x / kDaHeads;
  const int h = blockIdx.x * kDaHeads + hx;
  const long long z = blockIdx.y;
  const int lc = args.lc, nh = args.nh, n_lt = args.n_lt;
  const int len = (lc + kDaSegs - 1) / kDaSegs, l0 = min(lc, seg * len), l1 = min(lc, l0 + len);
  if (h < nh) {
    for (int l = seg; l < lc; l += kDaSegs) {
      float v = args.dcum != nullptr ? args.dcum[(z * lc + l) * nh + h] : 0.f;
      for (int c = 0; c <= l / kT; ++c) {
        v += args.rowpart[((z * n_lt + c) * n_lt * kT + l) * nh + h];
      }
      if (l == lc - 1) {
        float last = 0.f;
        for (int c = 0; c < n_lt; ++c) last += args.usum[(z * n_lt + c) * nh + h];
        v += last;
      }
      d[l][hx] = v;
    }
  }
  __syncthreads();
  float s = 0.f;
  if (h < nh) {
    for (int l = l0; l < l1; ++l) s += d[l][hx];
  }
  tot[seg][hx] = s;
  __syncthreads();
  if (h >= nh) return;
  float run = 0.f;
  for (int k = kDaSegs - 1; k > seg; --k) run += tot[k][hx];
  for (int l = l1 - 1; l >= l0; --l) {
    run += d[l][hx];
    args.da[(z * lc + l) * nh + h] = run;
  }
}

template <typename T>
cudaError_t prepare() {  // once: the dynamic shared-memory cap
  static cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_main_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem<T>);
  return err;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// op 0: launch; op 1: *out = resident CTAs per SM of the main kernel;
// op 2: *out = its dynamic shared memory
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
        out, ssd_bwd_main_kernel<T>, kThreads, kSmem<T>));
  }
  ssd_bwd_main_kernel<T><<<dim3(args.nb * args.nhb, args.n_lt), kThreads, kSmem<T>, stream>>>(
      args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_bc_kernel<T><<<dim3(args.n_lt * kBcCtas, args.g, args.nb), kThreads, 0, stream>>>(
      args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_da_kernel<<<dim3((args.nh + kDaHeads - 1) / kDaHeads, args.nb), kThreads, 0, stream>>>(
      args);
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
                             void* da, void* db, void* dc, void* dbpart, void* dcpart,
                             void* rowpart, void* usum, int bc_dtype, int nb, int lc, int nh,
                             int hp, int n, int g, int hblk, long long sb0, long long sb1,
                             long long sb2, void* stream) {
  if (lc <= 0 || lc > kMaxLc || n <= 0 || n > kMaxN || hp <= 0 || hp > kMaxHp || g <= 0 ||
      nh % g != 0 || hblk <= 0 || (nh / g) % hblk != 0 || nb > 65535 || g > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb == 0 || nh == 0) return 0;
  const int n_lt = (lc + kT - 1) / kT;
  const long long es = bc_dtype == 1 ? 2 : 4;
  const bool vec_bc = aligned16(b) && aligned16(c) && (sb0 * es) % 16 == 0 &&
                      (sb1 * es) % 16 == 0 && (g == 1 || (sb2 * es) % 16 == 0);
  const bool vec_f = aligned16(x) && aligned16(dy) && aligned16(dst) && hp % 4 == 0;
  const Args args{static_cast<const float*>(x), static_cast<const float*>(a), b, c,
                  static_cast<const float*>(dy), static_cast<const float*>(dst),
                  static_cast<const float*>(dcum), static_cast<float*>(dx),
                  static_cast<float*>(da), db, dc, static_cast<float*>(dbpart),
                  static_cast<float*>(dcpart), static_cast<float*>(rowpart),
                  static_cast<float*>(usum), nb, lc, nh, hp, n, g, nh / g, hblk, nh / hblk, n_lt,
                  n_lt * (n_lt + 1) / 2, sb0, sb1, sb2, vec_f, vec_bc};
  return dispatch(args, bc_dtype, 0, nullptr, static_cast<cudaStream_t>(stream));
}

// Resident CTAs per SM (op 1) or dynamic shared memory in bytes (op 2) of the
// main kernel's instantiation for bc_dtype. Returns a cudaError_t.
extern "C" int ssd_chunk_bwd_info(int bc_dtype, int op, int* out) {
  if (op != 1 && op != 2) return static_cast<int>(cudaErrorInvalidValue);
  const Args none{};
  return dispatch(none, bc_dtype, op, out, nullptr);
}
