// One-token GQA decode attention through a block table, forward only.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py:
// paged_attention (pallas_call at :128). Same contract: q (b, hq, d); keys
// and values in blocks of bt tokens, looked up through block_table
// (b, max_blocks) int32, an entry of -1 read as block 0; only the first
// context_lens[b] tokens attend (the table covers at most max_blocks * bt);
// softmax with running max, sum and accumulator in f32; a row with context
// 0 gives zeros. Query head h reads kv head h / (hq / hkv).
// q * (1 / sqrt(d)) is rounded to the input dtype before the dot products,
// as the plain version (ref.py) and the JAX oracle do.
//
// Layouts: the C entry takes a K base pointer, a V base pointer and the
// element stride between consecutive blocks; inside a block the layout is
// (bt, hkv, d), contiguous. One kernel thus reads, without a copy, the JAX
// pool layout (n, 2, bt, hkv, d) (K = pool[:, 0], V = pool[:, 1]), one
// layer l of the port's fused pool (n, 2L, bt, hkv, d) (K = pool[:, 2l],
// V = pool[:, 2l + 1]) and a dense decode cache (b, max_len, hkv, d) cut
// into blocks of bt tokens.
//
// Bound on an H100: bytes. Llama-3.1-8B at a context of 1040 tokens reads
// 2 * 1040 * 8 * 128 * 2 bytes = 4.3 MB of K and V per layer, 1.3 us at
// 3.35 TB/s. At a group of 4 that is about 8 FLOP per byte read, far below
// the ~295 at which bf16 tensor cores would become the limit, so the
// products run on the CUDA cores and no tensor core is needed.
//
// Design: ONE launch. The grid is (S, hkv, b) and each (row, kv head) is
// one thread-block cluster of S CTAs. The wrapper picks S from the SM
// count, the resident CTAs per SM and the clusters that fit at once
// (paged_attention.py: plan_splits; 16 at Llama's decode shape). On the
// card each CTA reads its row's context and takes an even share of its
// pool blocks (split_ranges in paged_attention.py is the same formula):
// nb = ceil(ctx / bt), S_r = min(S, nb) active splits, split s takes blocks
// [s * nb / S_r, (s + 1) * nb / S_r); a CTA with s >= S_r has no block. So
// only the context, never the table's width, decides the work, and the
// grid depends on shapes alone (a captured call replays with any context).
//
// A CTA walks its blocks as tiles of at most kTile = 16 rows of this kv
// head (one pool block at bt 16); warp w takes tiles w, w + 8, ... Each
// warp copies its tiles' K and V rows with 16-byte cp.async.cg into its own
// ring of kWarpStages shared-memory stages, one commit group per tile (rows
// past the context as zeros), and waits only on its own copies
// (cp.async.wait_group, then __syncwarp): the CTA's first 8 * kWarpStages
// tiles are all in flight before any warp waits, and no __syncthreads sits
// in the loop. The warp reads its tiles' table entries itself (the GPU form
// of Pallas's scalar prefetch), the next tile's while it computes this one.
// Every warp runs the CTA's rounds, so the loop is warp-uniform and its
// shuffles need no collective fallback.
//
// The softmax is taken per tile, not per token: d / 8 (bf16) or d / 4 (f32)
// lanes score a row, one 16-byte chunk each, against all G query heads
// held in registers (q rounded to T, then f32); a butterfly of shuffles
// sums the row's chunks while halving the heads a lane carries (5 shuffles
// for G 4 at d 128, not 16); log2(e) is folded into the f32 score after the
// rounded-q product. Then each head's tile max and sum take four shuffles
// over the 16 rows, P is formed with exp2f, the accumulator is rescaled
// once per tile and P.V adds the tile's rows into the g x d outputs, d / 32
// columns per lane.
//
// The merges are in the same launch, with no spin, no atomics and no
// scratch in device memory. The CTA's warps leave their partials in their
// own stages and the CTA merges them in warp order; with S_r == 1 that is
// the output. Otherwise each CTA writes its partial (max, sum, g x d
// accumulator, f32) to its shared memory, the cluster meets at a barrier,
// CTA s merges outputs [s * per, (s + 1) * per) from the S_r partials in
// split order, read through distributed shared memory, and a second
// barrier keeps every partial alive until all are read. The result depends
// on the context and S, never on the order in which CTAs run or on the
// layout. A row of context 0 is written as zeros by its split 0, and its
// cluster never meets.

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16;          // rows of one kv head in a stage
constexpr int kRingBytes = 65536;  // the K/V stages' budget
constexpr int kMaxCluster = 16;    // splits: one thread-block cluster per (row, kv head)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T> struct Traits;
template <> struct Traits<float> {
  static constexpr int kVec = 4;  // elements in 16 bytes
  __device__ static void unpack(const uint4& u, float* o) {
    o[0] = __uint_as_float(u.x); o[1] = __uint_as_float(u.y);
    o[2] = __uint_as_float(u.z); o[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* x) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]), __float_as_uint(x[2]),
                      __float_as_uint(x[3]));
  }
  __device__ static float to_f(float x) { return x; }
  __device__ static float from_f(float x) { return x; }
};
template <> struct Traits<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void unpack(const uint4& u, float* o) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __low2float(h[i]);
      o[2 * i + 1] = __high2float(h[i]);
    }
  }
  __device__ static uint4 pack(const float* x) {  // rounds each to bf16
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    return u;
  }
  __device__ static float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 from_f(float x) { return __float2bfloat16(x); }
};

// Compile-time shape of one instantiation: element type, head_dim D, group
// G (query heads per kv head, rounded up to a power of two; the runtime
// g <= G guards the rest).
template <typename T, int D, int G> struct Shape {
  static constexpr int kVec = Traits<T>::kVec;
  static constexpr int kCpr = D / kVec;  // 16-byte chunks per row (>= 2)
  // scoring: a lane takes one 16-byte chunk of a row, kLpr = kCpr lanes a
  // row, 32 / kLpr rows per step; after the butterfly a lane holds kHeld
  // heads' scores
  static constexpr int kLpr = kCpr;
  static constexpr int kSteps = kTile / (32 / kLpr);
  static constexpr int kHeld = G / kLpr > 1 ? G / kLpr : 1;
  static constexpr int kStageBytes = 2 * kTile * D * (int)sizeof(T);  // K and V
  static constexpr int kFit = kRingBytes / (kWarps * kStageBytes);
  static constexpr int kWarpStages = kFit < 1 ? 1 : (kFit > 2 ? 2 : kFit);
  static constexpr int kSmem = kWarps * kWarpStages * kStageBytes;  // dynamic
  static constexpr int kCols = D / 32 > 0 ? D / 32 : 1;  // P.V columns a lane owns
  static constexpr int kOut = (G * D + kThreads - 1) / kThreads;  // merged outputs a thread owns
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  long long block_stride;  // elements between consecutive blocks
  const int* table;        // (b, max_blocks)
  const int* ctx_lens;     // (b,)
  void* o;                 // (b, hq, d)
  int b, hq, hkv, bt, max_blocks, splits;
  float scale;
};

// 16 bytes from gmem, or 16 zero bytes where src_bytes is 0 (gmem unread)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// n consecutive elements of shared memory as f32, in one load where they
// make 8 or 16 bytes (a lane's P.V columns of one V row)
template <typename T, int N>
__device__ __forceinline__ void load_cols(const T* src, float* dst) {
  constexpr int kBytes = N * (int)sizeof(T);
  if constexpr (kBytes == 16 || kBytes == 8) {
    using V = typename std::conditional<kBytes == 16, uint4, uint2>::type;
    const V raw = *reinterpret_cast<const V*>(src);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = Traits<T>::to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = Traits<T>::to_f(src[i]);
  }
}

// Sums each of the CNT values of v over the lanes that differ in bits O,
// O / 2, ..., 1, halving the values a lane carries at each level while it
// carries more than one: the lane with bit O set keeps the upper half and
// sends the lower. On return v[0, max(1, CNT / (2 O))) hold the sums of
// values head, head + 1, ... (head is added to).
template <int O, int CNT>
__device__ __forceinline__ void butterfly(float* v, int lane, int& head) {
  if constexpr (O >= 1) {
    if constexpr (CNT > 1) {
      constexpr int H = CNT / 2;
      const bool up = lane & O;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[i + H];
        const float keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      head += up ? H : 0;
      butterfly<O / 2, H>(v, lane, head);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      butterfly<O / 2, 1>(v, lane, head);
    }
  }
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads, G >= 8 ? 1 : 2) paged_attention_kernel(Args args) {
  using Sh = Shape<T, D, G>;
  using Tr = Traits<T>;
  constexpr int kVec = Sh::kVec, kCpr = Sh::kCpr, kLpr = Sh::kLpr;
  constexpr int kCols = Sh::kCols, kWS = Sh::kWarpStages;
  extern __shared__ __align__(128) unsigned char ring[];  // per warp: kWS x (K tile, V tile)
  __shared__ float s_sc[kWarps][G][kTile];  // a tile's scores
  __shared__ float s_p[kWarps][G][kTile];   // and its P
  __shared__ float s_wm[kWarps][G], s_wl[kWarps][G];
  __shared__ float s_cm[G], s_cl[G], s_ca[G * D];  // this CTA's partial, for the cluster

  const int split = blockIdx.x, hk = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hq = args.hq, hkv = args.hkv, bt = args.bt, g = hq / hkv, S = args.splits;
  // this lane's 16-byte chunk `sub` of q for every head, loaded beside the
  // context; the lane scores row rr of each step
  const int rr = lane / kLpr, sub = lane % kLpr;
  uint4 qp[G];
  const T* qrow = static_cast<const T*>(args.q) + ((long long)bi * hq + (long long)hk * g) * D;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    qp[gi] = gi < g ? __ldg(reinterpret_cast<const uint4*>(qrow + gi * D) + sub)
                    : make_uint4(0, 0, 0, 0);
  }
  const int ctx = max(0, min(args.ctx_lens[bi], args.max_blocks * bt));
  T* out = static_cast<T*>(args.o) + ((long long)bi * hq + (long long)hk * g) * D;
  if (ctx == 0) {  // zeros, as the Pallas kernel gives; written by split 0 alone
    if (split == 0) {
      for (int idx = tid; idx < g * D; idx += kThreads) out[idx] = Tr::from_f(0.f);
    }
    return;
  }
  // the split's blocks: paged_attention.py split_ranges
  const int nb = (ctx + bt - 1) / bt;
  const int s_act = min(S, nb);
  // with one active split nothing is merged and the rest of the cluster
  // leaves; otherwise every CTA of the cluster stays for the two cluster
  // barriers, the inactive ones (split >= S_r) with no tile
  if (s_act == 1 && split > 0) return;
  const bool active = split < s_act;
  const int b_lo = active ? (int)((long long)split * nb / s_act) : 0;
  const int b_hi = active ? (int)((long long)(split + 1) * nb / s_act) : 1;
  const int tpb = (bt + kTile - 1) / kTile;  // tiles per pool block
  const int last_rows = min(bt, ctx - (b_hi - 1) * bt);
  const int n_tiles =
      active ? (b_hi - 1 - b_lo) * tpb + (last_rows + kTile - 1) / kTile : 0;

  const T* __restrict__ kbase = static_cast<const T*>(args.k);
  const T* __restrict__ vbase = static_cast<const T*>(args.v);
  const int* trow = args.table + (long long)bi * args.max_blocks;
  const long long row_stride = (long long)hkv * D;
  const long long head_off = (long long)hk * D;
  unsigned char* my_ring = ring + warp * kWS * Sh::kStageBytes;

  // tile i: its table column, first row in the block, rows below the context
  auto col_of = [&](int i) { return b_lo + i / tpb; };
  auto row0_of = [&](int i) { return (i % tpb) * kTile; };
  auto rows_of = [&](int i) {
    return min(min(kTile, bt - row0_of(i)), ctx - (col_of(i) * bt + row0_of(i)));
  };
  // this warp copies tile i's K and V rows into its stage st, the rows past
  // the tile's n as zeros, so that nothing later branches on n (the caller
  // commits)
  auto stage_tile = [&](int i, int st, int blk) {
    const int n = rows_of(i);
    T* sk = reinterpret_cast<T*>(my_ring + st * Sh::kStageBytes);
    const long long base =
        (long long)blk * args.block_stride + row0_of(i) * row_stride + head_off;
#pragma unroll 4
    for (int u = lane; u < 2 * kTile * kCpr; u += 32) {
      const int r = u % (kTile * kCpr);  // u / (kTile * kCpr): K or V
      const int j = r / kCpr, c = r % kCpr;
      const long long src = base + (j < n ? j : 0) * row_stride + c * kVec;
      cp_async16(sk + u * kVec, (u < kTile * kCpr ? kbase : vbase) + src, j < n ? 16 : 0);
    }
  };
  auto block_at = [&](int i) { return max(__ldg(trow + col_of(i)), 0); };

  // prologue: this warp's first kWS tiles in flight before anything waits
  int blk[kWS];
#pragma unroll
  for (int k = 0; k < kWS; ++k) {
    const int i = warp + k * kWarps;
    blk[k] = i < n_tiles ? block_at(i) : 0;
  }
#pragma unroll
  for (int k = 0; k < kWS; ++k) {
    const int i = warp + k * kWarps;
    if (i < n_tiles) stage_tile(i, k, blk[k]);
    cp_async_commit();
  }
  // q * scale rounded to T (the contract's rounding point), then as f32
  float qf[G][kVec];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    Tr::unpack(qp[gi], qf[gi]);
#pragma unroll
    for (int e = 0; e < kVec; ++e) qf[gi][e] *= args.scale;
    Tr::unpack(Tr::pack(qf[gi]), qf[gi]);
  }

  float m[G], l[G], acc[G][kCols];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[gi][e] = 0.f;
  }
  const int j = lane & (kTile - 1);  // the row a lane takes in the softmax
  const int col0 = lane * kCols;     // the P.V columns a lane owns
  const bool owns = col0 < D;

  // every warp runs the CTA's rounds, so the shuffles below sit in control
  // flow the compiler can see is warp-uniform; a warp without a tile in a
  // round scores stale data and masks all of it (n = 0)
  const int rounds = (n_tiles + kWarps - 1) / kWarps;
  for (int k = 0; k < rounds; ++k) {
    const int i = warp + k * kWarps;
    const int st = k % kWS;
    const int next = i + kWS * kWarps;
    const int next_blk = next < n_tiles ? block_at(next) : 0;  // read ahead of the wait
    cp_async_wait<kWS - 1>();
    __syncwarp();
    const T* sk = reinterpret_cast<const T*>(my_ring + st * Sh::kStageBytes);
    const T* sv = sk + kTile * D;
    const int n = i < n_tiles ? rows_of(i) : 0;

    // scores: kLpr lanes per row, 32 / kLpr rows per step, every head; the
    // row's partial sums meet in a butterfly that halves the heads a lane
    // carries at each level
#pragma unroll
    for (int step = 0; step < Sh::kSteps; ++step) {
      const int row = step * (32 / kLpr) + rr;
      float kf[kVec];
      Tr::unpack(*reinterpret_cast<const uint4*>(sk + row * D + sub * kVec), kf);
      float v[G];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        v[gi] = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) v[gi] += qf[gi][e] * kf[e];
      }
      int head = 0;
      butterfly<kLpr / 2, G>(v, lane, head);
#pragma unroll
      for (int h = 0; h < Sh::kHeld; ++h) s_sc[warp][head + h][row] = v[h] * kLog2e;
    }
    __syncwarp();
    // the tile's softmax, every head at once: max and sum over the 16 rows
    float alpha[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const float x = j < n ? s_sc[warp][gi][j] : kNegInf;
      float mx = x;
#pragma unroll
      for (int off = kTile / 2; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[gi], mx);
      const float p = j < n ? exp2f(x - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int off = kTile / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      alpha[gi] = exp2f(m[gi] - m_new);
      l[gi] = l[gi] * alpha[gi] + sum;
      m[gi] = m_new;
      if (lane < kTile) s_p[warp][gi][j] = p;
    }
    __syncwarp();
    // P.V: one rescale per tile, then the tile's rows
    if (owns && n > 0) {
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
#pragma unroll
        for (int e = 0; e < kCols; ++e) acc[gi][e] *= alpha[gi];
      }
#pragma unroll
      for (int r = 0; r < kTile; ++r) {  // rows past n hold zeros and P 0
        float vf[kCols];
        load_cols<T, kCols>(sv + r * D + col0, vf);
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          const float p = s_p[warp][gi][r];
#pragma unroll
          for (int e = 0; e < kCols; ++e) acc[gi][e] += p * vf[e];
        }
      }
    }
    __syncwarp();  // the stage and P are read before they are written again
    if (next < n_tiles) stage_tile(next, st, next_blk);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncwarp();

  // the warps' partials: each in its own first stage, then merged in warp order
  float* wacc = reinterpret_cast<float*>(my_ring);
  if (owns) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
#pragma unroll
      for (int e = 0; e < kCols; ++e) wacc[gi * D + col0 + e] = acc[gi][e];
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      s_wm[warp][gi] = m[gi];
      s_wl[warp][gi] = l[gi];
    }
  }
  __syncthreads();
  float cm[Sh::kOut], cl[Sh::kOut], ca[Sh::kOut];  // this CTA's partial, per owned output
#pragma unroll
  for (int r = 0; r < Sh::kOut; ++r) {
    const int idx = tid + r * kThreads;
    cm[r] = kNegInf;
    cl[r] = 0.f;
    ca[r] = 0.f;
    if (idx < g * D) {
      const int gi = idx / D;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) cm[r] = fmaxf(cm[r], s_wm[w][gi]);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = exp2f(s_wm[w][gi] - cm[r]);
        cl[r] += s_wl[w][gi] * f;
        ca[r] += reinterpret_cast<const float*>(ring + w * kWS * Sh::kStageBytes)[idx] * f;
      }
    }
  }

  if (s_act == 1) {
#pragma unroll
    for (int r = 0; r < Sh::kOut; ++r) {
      const int idx = tid + r * kThreads;
      if (idx < g * D) out[idx] = Tr::from_f(ca[r] / fmaxf(cl[r], 1e-30f));
    }
    return;
  }

  // this split's partial in its own shared memory; after the cluster
  // barrier CTA `split` merges outputs [split * per, (split + 1) * per) from
  // the S_r partials in split order, read through distributed shared
  // memory; the second barrier keeps every partial alive until all are read
#pragma unroll
  for (int r = 0; r < Sh::kOut; ++r) {
    const int idx = tid + r * kThreads;
    if (idx < g * D) {
      s_ca[idx] = ca[r];
      if (idx % D == 0) {
        s_cm[idx / D] = cm[r];
        s_cl[idx / D] = cl[r];
      }
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int per = (g * D + S - 1) / S;
  for (int idx = split * per + tid; idx < min((split + 1) * per, g * D); idx += kThreads) {
    const int gi = idx / D;
    float pm[kMaxCluster], pl[kMaxCluster], pa[kMaxCluster];
#pragma unroll
    for (int u = 0; u < kMaxCluster; ++u) {
      pm[u] = kNegInf;
      pl[u] = 0.f;
      pa[u] = 0.f;
      if (u < s_act) {
        pm[u] = *cluster.map_shared_rank(&s_cm[gi], u);
        pl[u] = *cluster.map_shared_rank(&s_cl[gi], u);
        pa[u] = *cluster.map_shared_rank(&s_ca[idx], u);
      }
    }
    float mx = kNegInf;
#pragma unroll
    for (int u = 0; u < kMaxCluster; ++u) mx = fmaxf(mx, pm[u]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int u = 0; u < kMaxCluster; ++u) {
      const float f = exp2f(pm[u] - mx);
      den += pl[u] * f;
      num += pa[u] * f;
    }
    out[idx] = Tr::from_f(num / fmaxf(den, 1e-30f));
  }
  cluster.sync();
}

template <typename T, int D, int G>
cudaError_t prepare() {  // once: the dynamic shared-memory cap, clusters of up to 16
  static cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(paged_attention_kernel<T, D, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Shape<T, D, G>::kSmem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(paged_attention_kernel<T, D, G>,
                                cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  return err;
}

// op 0: launch; op 1: *out = resident CTAs per SM; op 2: *out = dynamic
// shared memory; op 3: *out = clusters of args.splits CTAs resident at once
template <typename T, int D, int G>
int run(const Args& args, int op, int* out, cudaStream_t stream) {
  using Sh = Shape<T, D, G>;
  cudaError_t err = prepare<T, D, G>();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (op == 2) {
    *out = Sh::kSmem;
    return 0;
  }
  if (op == 1) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, paged_attention_kernel<T, D, G>, kThreads, Sh::kSmem));
  }
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = args.splits;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(args.splits, args.hkv, args.b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Sh::kSmem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  if (op == 3) {
    return static_cast<int>(cudaOccupancyMaxActiveClusters(
        out, (void*)paged_attention_kernel<T, D, G>, &cfg));
  }
  err = cudaLaunchKernelEx(&cfg, paged_attention_kernel<T, D, G>, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int run_g(const Args& args, int g, int op, int* out, cudaStream_t s) {
  if (g <= 1) return run<T, D, 1>(args, op, out, s);
  if (g <= 2) return run<T, D, 2>(args, op, out, s);
  if (g <= 4) return run<T, D, 4>(args, op, out, s);
  if (g <= 8) return run<T, D, 8>(args, op, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int run_d(const Args& args, int d, int g, int op, int* out, cudaStream_t s) {
  switch (d) {
    case 16: return run_g<T, 16>(args, g, op, out, s);
    case 32: return run_g<T, 32>(args, g, op, out, s);
    case 64: return run_g<T, 64>(args, g, op, out, s);
    case 128: return run_g<T, 128>(args, g, op, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(const Args& args, int dtype, int d, int g, int op, int* out, cudaStream_t s) {
  if (g < 1 || g > 8) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return run_d<float>(args, d, g, op, out, s);
  if (dtype == 1) return run_d<__nv_bfloat16>(args, d, g, op, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d in {16, 32, 64, 128}; hq / hkv <= 8.
// block_stride in elements. splits: CTAs per (row, kv head), 1 to 16, one
// thread-block cluster. Launches ONE kernel on `stream`, allocates nothing;
// returns a cudaError_t.
extern "C" int paged_attention_fwd(const void* q, const void* k, const void* v,
                                   long long block_stride, const void* table,
                                   const void* ctx, void* o, int dtype, int b, int hq,
                                   int hkv, int d, int bt, int max_blocks, int splits,
                                   float scale, void* stream) {
  if ((d != 16 && d != 32 && d != 64 && d != 128) || hkv <= 0 || hq % hkv != 0 ||
      hq / hkv > 8 || bt <= 0 || max_blocks <= 0 || splits <= 0 ||
      splits > kMaxCluster || hkv > 65535 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0) return 0;
  const Args args{q, k, v, block_stride, static_cast<const int*>(table),
                  static_cast<const int*>(ctx), o, b, hq, hkv, bt, max_blocks, splits, scale};
  return dispatch(args, dtype, d, hq / hkv, 0, nullptr, static_cast<cudaStream_t>(stream));
}

// Resident CTAs per SM of the instantiation that takes (dtype, d, group),
// from cudaOccupancyMaxActiveBlocksPerMultiprocessor at its block size and
// dynamic shared memory. Returns a cudaError_t.
extern "C" int paged_attention_ctas_per_sm(int dtype, int d, int group, int* out) {
  const Args none{};
  return dispatch(none, dtype, d, group, 1, out, nullptr);
}

// Dynamic shared memory (the K/V stages) of that instantiation, in bytes.
extern "C" int paged_attention_smem(int dtype, int d, int group, int* out) {
  const Args none{};
  return dispatch(none, dtype, d, group, 2, out, nullptr);
}

// Clusters of `splits` CTAs of that instantiation that can be resident at
// once (cudaOccupancyMaxActiveClusters). Returns a cudaError_t.
extern "C" int paged_attention_max_clusters(int dtype, int d, int group, int splits, int* out) {
  if (splits <= 0 || splits > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  Args one{};
  one.splits = splits;
  one.hkv = 1;
  one.b = 1;
  return dispatch(one, dtype, d, group, 3, out, nullptr);
}
