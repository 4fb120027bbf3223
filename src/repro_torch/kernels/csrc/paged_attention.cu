// One-token GQA decode attention through a block table, forward only.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py:
// paged_attention (pallas_call at :128). Same contract: q (b, hq, d); keys
// and values in blocks of bt tokens, looked up through block_table
// (b, max_blocks) int32, an entry of -1 read as block 0; only the first
// context_lens[b] tokens attend (the table covers at most max_blocks * bt);
// softmax with running max, sum and accumulator in f32; a row with context
// 0 gives zeros. Query head h reads kv head h / (hq / hkv). Optionally
// (lse not null) each head's log-sum-exp of its scaled scores, f32, natural
// log, -inf at context 0: what a caller needs to merge partial attentions
// over several shards of one sequence. The merges below already keep it;
// storing it adds a store, not a pass. It is a template flag (kLse), so
// serving's instantiations (lse null) are the code they were without it,
// and the occupancy queries below read those.
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
// the ~295 at which bf16 tensor cores would become the limit. What the
// kernel waits on is latency (the context, the table entry, the K/V rows
// in turn) and, at 2 CTAs per SM, the instructions its warps issue: scoring
// a 16-key tile against 4 heads on the CUDA cores took about a thousand
// (unpack, FMAs, butterfly shuffles), 2.0-2.6 us of a 9-10 us call.
//
// Two kernels, by dtype. bf16 (every served model): the tensor cores,
// mma.sync m16n8k16 with the group's up to 8 query heads as the products'
// N, a whole group a CTA (paged_mma_kernel, below: a tile is 2 d/16
// products and a few shuffles). float32 (reduced test models): the CUDA
// cores (paged_attention_kernel), a whole group a CTA too.
//
// An fp8 cache (K/V in e4m3, q in float32 or bf16) runs the tensor-core
// kernel too, with the contract of JAX's decode after _dequant
// (repro/models/attention.py:221-245): K and V are read as bf16 (every
// e4m3 value, subnormals and NaN included, is exact in bf16), q * scale is
// formed in f32 from q and rounded to bf16 once, P is rounded to bf16 for
// P.V, and the output is in q's dtype. A tile's e4m3 rows arrive by the
// same 16-byte cp.async as bf16 ones, half the bytes, into the upper half
// of the warp's bf16 stage; after the wait the warp widens them in place
// into the swizzled bf16 layout the ldmatrix loads read (K's bf16 rows lie
// below the raw bytes; V's cover them, so the warp holds V's raw chunks in
// registers before any lane writes). The float32 CUDA-core kernel never
// runs for fp8.
//
// Design: ONE launch. The grid is (S, hkv, b) and each (row, kv head) is
// one thread-block cluster of S CTAs. The
// wrapper picks S from the SM count, the resident CTAs per SM and the
// clusters that fit at once (paged_attention.py: plan_splits; 16 at the
// paths' decode shapes, b 1 and 8 kv heads). On the
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
// In the float32 kernel the softmax is taken per tile, not per token: d / 4
// lanes score a row, one 16-byte chunk each (a row of d 80 is 20 chunks: 32
// lanes take it, the ones past the last chunk adding zeros, so that the
// butterfly pairs lanes of one row), against all G query heads held in
// registers (q rounded to T, then f32); a butterfly of shuffles sums the
// row's chunks while halving the heads a lane carries; log2(e) is folded
// into the f32 score after the rounded-q product. Then each head's tile
// max and sum take four shuffles over the 16 rows, P is formed with exp2f,
// the accumulator is rescaled once per tile and P.V adds the tile's rows
// into the g x d outputs, 1, 2 or 4 columns per lane (d 80: 4 columns on
// 20 lanes).
//
// The merges are in the same launch, with no spin, no atomics and no
// scratch in device memory. The CTA's warps leave their partials in their
// own stages and the CTA merges them in warp order; with S_r == 1 that is
// the output. Otherwise each active split pushes its partial (max, sum, and
// the f32 accumulator of outputs [s * per, (s + 1) * per)) into CTA s's
// shared memory with remote stores, one cluster barrier makes every push
// visible, and CTA s merges its outputs from its own shared memory in split
// order. (Pulling the partials after a barrier, as the earlier design did,
// waits for a round trip of remote loads and needs a second barrier to keep
// them alive.) The result depends
// on the context and S, never on the order in which CTAs run or on the
// layout. A row of context 0 is written as zeros by its split 0, and its
// cluster never meets.

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
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
constexpr float kLn2 = 0.6931471805599453f;

// The C entry's dtype codes: q (and output) type and K/V storage type.
constexpr int kF32 = 0;       // q, K, V float32: the CUDA-core kernel
constexpr int kBf16 = 1;      // q, K, V bf16: the tensor-core kernel
constexpr int kF32E4m3 = 2;   // q float32, K/V e4m3: the tensor-core kernel
constexpr int kBf16E4m3 = 3;  // q bf16, K/V e4m3: the tensor-core kernel
template <int Code> struct Kinds;
template <> struct Kinds<kBf16> { using Q = __nv_bfloat16; using KV = __nv_bfloat16; };
template <> struct Kinds<kF32E4m3> { using Q = float; using KV = __nv_fp8_e4m3; };
template <> struct Kinds<kBf16E4m3> { using Q = __nv_bfloat16; using KV = __nv_fp8_e4m3; };

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
template <> struct Traits<__nv_bfloat16> {  // the tensor-core kernel's outputs
  __device__ static float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 from_f(float x) { return __float2bfloat16(x); }
};

// Compile-time shape of one instantiation: element type, head_dim D, and G,
// the group rounded up to a power of two (the runtime count <= G guards
// the rest).
template <typename T, int D, int G> struct Shape {
  static constexpr int kVec = Traits<T>::kVec;
  static constexpr int kCpr = D / kVec;  // 16-byte chunks per row (>= 4; 20 at d 80)
  // scoring: a lane takes one 16-byte chunk of a row, kLpr lanes a row (kCpr
  // rounded up to a power of two, so that the butterfly below pairs lanes
  // of one row; lanes sub >= kCpr add zeros), 32 / kLpr rows per step;
  // after the butterfly a lane holds kHeld heads' scores
  static constexpr int kLpr = kCpr <= 2 ? 2 : kCpr <= 4 ? 4 : kCpr <= 8 ? 8 : kCpr <= 16 ? 16 : 32;
  static constexpr int kSteps = kTile / (32 / kLpr);
  static constexpr int kHeld = G / kLpr > 1 ? G / kLpr : 1;
  static constexpr int kStageBytes = 2 * kTile * D * (int)sizeof(T);  // K and V
  static constexpr int kFit = kRingBytes / (kWarps * kStageBytes);
  static constexpr int kWarpStages = kFit < 1 ? 1 : (kFit > 2 ? 2 : kFit);
  static constexpr int kSmem = kWarps * kWarpStages * kStageBytes;  // dynamic
  // P.V columns a lane owns: the least power of two that leaves at most 32
  // owners (d 80: 4 columns on 20 lanes)
  static constexpr int kCols = D <= 32 ? 1 : D <= 64 ? 2 : 4;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  long long block_stride;  // elements between consecutive blocks
  const int* table;        // (b, max_blocks)
  const int* ctx_lens;     // (b,)
  void* o;                 // (b, hq, d)
  float* lse;              // (b, hq) natural log-sum-exp of the scores, or null
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

// 2^x as one MUFU.EX2 (exp2f adds a range check for results below 2^-126,
// which no softmax weight here needs)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// barrier.cluster in two halves: every CTA of a cluster that merges arrives
// as soon as it knows it will (right after its context is read) and waits
// just before it first writes into another CTA's shared memory, by when all
// have long started; the wait then costs nothing
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The CTA's warps left their partials (max, sum per head; the g x d
// accumulator, f32, at the start of each warp's ring space, warp_bytes
// apart). Merge them in warp order, then, with more than one active split,
// merge the cluster's splits and write the outputs: each split pushes its
// partial of the outputs [s * per, (s + 1) * per) into CTA s's shared
// memory (remote stores, no round trip), one cluster barrier makes them
// visible, and CTA s merges them from its own shared memory in split order.
template <typename T, int D, int G, bool kLse>
__device__ __forceinline__ void merge_partials(const unsigned char* ring, int warp_bytes,
                                               float (*s_wm)[G], float (*s_wl)[G], float* s_cm,
                                               float* s_cl, T* out, float* lse, int g, int S,
                                               int s_act, int split, int tid) {
  using Tr = Traits<T>;
  constexpr int kOut = (G * D + kThreads - 1) / kThreads;  // merged outputs a thread owns
  __shared__ float s_in[G * D + kMaxCluster];  // the splits' partials of this CTA's outputs
  __shared__ float s_in_m[kMaxCluster][G], s_in_l[kMaxCluster][G];  // and their max, sum
  float cm[kOut], cl[kOut], ca[kOut];  // this CTA's partial, per owned output
#pragma unroll
  for (int r = 0; r < kOut; ++r) {
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
        const float f = ex2(s_wm[w][gi] - cm[r]);
        cl[r] += s_wl[w][gi] * f;
        ca[r] += reinterpret_cast<const float*>(ring + w * warp_bytes)[idx] * f;
      }
    }
  }

  if (s_act == 1) {
#pragma unroll
    for (int r = 0; r < kOut; ++r) {
      const int idx = tid + r * kThreads;
      if (idx < g * D) out[idx] = Tr::from_f(ca[r] / fmaxf(cl[r], 1e-30f));
      // the maxima and sums are in log2 units (log2 e folded into the scores)
      if (kLse && idx < g * D && idx % D == 0) {
        lse[idx / D] = (cm[r] + log2f(cl[r])) * kLn2;
      }
    }
    return;
  }

#pragma unroll
  for (int r = 0; r < kOut; ++r) {
    const int idx = tid + r * kThreads;
    if (idx < g * D && idx % D == 0) {
      s_cm[idx / D] = cm[r];
      s_cl[idx / D] = cl[r];
    }
  }
  __syncthreads();
  cg::cluster_group cluster = cg::this_cluster();
  const int per = (g * D + S - 1) / S;
  cluster_wait();
  if (split < s_act) {  // an inactive split has nothing to send
#pragma unroll
    for (int r = 0; r < kOut; ++r) {
      const int idx = tid + r * kThreads;
      if (idx < g * D) {
        const int owner = idx / per;
        *cluster.map_shared_rank(&s_in[split * per + idx - owner * per], owner) = ca[r];
      }
    }
    for (int t = tid; t < S * g; t += kThreads) {
      const int owner = t / g, gi = t % g;
      *cluster.map_shared_rank(&s_in_m[split][gi], owner) = s_cm[gi];
      *cluster.map_shared_rank(&s_in_l[split][gi], owner) = s_cl[gi];
    }
  }
  cluster.sync();  // the pushes are visible; nothing remote is read after it
  const int lo = split * per, hi = min(lo + per, g * D);
  for (int idx = lo + tid; idx < hi; idx += kThreads) {
    const int gi = idx / D, k = idx - lo;
    float mx = kNegInf;
#pragma unroll
    for (int u = 0; u < kMaxCluster; ++u) {
      if (u < s_act) mx = fmaxf(mx, s_in_m[u][gi]);
    }
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int u = 0; u < kMaxCluster; ++u) {
      if (u < s_act) {
        const float f = ex2(s_in_m[u][gi] - mx);
        den += s_in_l[u][gi] * f;
        num += s_in[u * per + k] * f;
      }
    }
    out[idx] = Tr::from_f(num / fmaxf(den, 1e-30f));
    if (kLse && idx % D == 0) lse[gi] = (mx + log2f(den)) * kLn2;
  }
}

template <typename T, int D, int G, bool kLse>
__global__ void __launch_bounds__(kThreads, G >= 8 ? 1 : 2) paged_attention_kernel(Args args) {
  using Sh = Shape<T, D, G>;
  using Tr = Traits<T>;
  constexpr int kVec = Sh::kVec, kCpr = Sh::kCpr, kLpr = Sh::kLpr;
  constexpr int kCols = Sh::kCols, kWS = Sh::kWarpStages;
  extern __shared__ __align__(128) unsigned char ring[];  // per warp: kWS x (K tile, V tile)
  __shared__ float s_sc[kWarps][G][kTile];  // a tile's scores
  __shared__ float s_p[kWarps][G][kTile];   // and its P
  __shared__ float s_wm[kWarps][G], s_wl[kWarps][G];
  __shared__ float s_cm[G], s_cl[G];  // this CTA's max and sum per head, for the cluster

  const int split = blockIdx.x, hk = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hq = args.hq, hkv = args.hkv, bt = args.bt, g = hq / hkv, S = args.splits;
  const long long head0 = (long long)hk * g;
  // this lane's 16-byte chunk `sub` of q for every head, loaded beside the
  // context; the lane scores row rr of each step
  const int rr = lane / kLpr, sub = lane % kLpr;
  const bool scores = sub < kCpr;  // lanes past the row's chunks add zeros
  uint4 qp[G];
  const T* qrow = static_cast<const T*>(args.q) + ((long long)bi * hq + head0) * D;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    qp[gi] = gi < g && scores ? __ldg(reinterpret_cast<const uint4*>(qrow + gi * D) + sub)
                              : make_uint4(0, 0, 0, 0);
  }
  const int ctx = max(0, min(args.ctx_lens[bi], args.max_blocks * bt));
  T* out = static_cast<T*>(args.o) + ((long long)bi * hq + head0) * D;
  float* lse = kLse ? args.lse + (long long)bi * hq + head0 : nullptr;
  if (ctx == 0) {  // zeros and an lse of -inf: written by split 0 alone
    if (split == 0) {
      for (int idx = tid; idx < g * D; idx += kThreads) out[idx] = Tr::from_f(0.f);
      if (kLse && tid < g) lse[tid] = __int_as_float(0xff800000);  // -inf
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
  if (s_act > 1) cluster_arrive();  // waited for before the first remote write
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
      Tr::unpack(scores ? *reinterpret_cast<const uint4*>(sk + row * D + sub * kVec)
                        : make_uint4(0, 0, 0, 0), kf);
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
  merge_partials<T, D, G, kLse>(ring, kWS * Sh::kStageBytes, s_wm, s_wl, s_cm, s_cl, out, lse, g,
                          S, s_act, split, tid);
}

// bf16: the tensor cores. A warp takes its tiles of 16 keys as mma.sync
// m16n8k16 products with the group's 8 query heads as N: S^T (16 keys x 8
// heads) = K . Q^T over d / 16 k-steps, and O^T (d x 8 heads) += V^T . P^T
// over d / 16 row tiles, K and V read from the stage by ldmatrix (V
// transposed), Q^T held in registers as the B fragments. Each lane's
// scores, softmax state and O^T entries belong to the same two heads (2 tq,
// 2 tq + 1), so max, sum and the rescale stay in the lane and its 7
// neighbours of equal tq (3 shuffles each); P is rounded to bf16 and
// turned into P^T's B fragments by movmatrix. Per tile a warp issues 2 d/16
// products, where the CUDA-core scoring of 4 heads took about a thousand
// instructions, and a CTA takes a whole group of up to 8 heads.
constexpr int kMmaHeads = 8;  // the products' N: a CTA holds a whole group

template <int D>
struct MmaShape {
  static constexpr int kCpr = D / 8;  // 16-byte chunks per row
  // staged rows of 32, 64, 128 or 256 bytes: chunk c of row j sits at chunk
  // c ^ (j % kSwz), so that the 8 rows one ldmatrix reads fall in 8 bank
  // groups; rows of 160 bytes (d 80) already spread, unswizzled
  static constexpr int kSwz = (kCpr & (kCpr - 1)) == 0 ? (kCpr < 8 ? kCpr : 8) : 1;
  static constexpr int kSteps = D / 16;  // k16 steps of S^T, m16 tiles of O^T
  static constexpr int kStageBytes = 2 * kTile * D * 2;  // K and V
  static constexpr int kFit = kRingBytes / (kWarps * kStageBytes);
  static constexpr int kWarpStages = kFit < 1 ? 1 : (kFit > 2 ? 2 : kFit);
  static constexpr int kSmem = kWarps * kWarpStages * kStageBytes;  // dynamic
};

template <int D>
__device__ __forceinline__ int swz(int j, int c) {
  return c ^ (j & (MmaShape<D>::kSwz - 1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}
// c (+)= a . b, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two e4m3 values (the low byte first) as a bf16 pair, exactly
__device__ __forceinline__ uint32_t widen2(unsigned short two) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(two, __NV_E4M3);
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
  return pack2(f.x, f.y);
}
// 16 e4m3 values as 16 bf16 in two 16-byte chunks, lo and hi
__device__ __forceinline__ void widen16(const uint4& raw, __nv_bfloat16* lo,
                                        __nv_bfloat16* hi) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = widen2(static_cast<unsigned short>(w[i] & 0xffffu));
    o[2 * i + 1] = widen2(static_cast<unsigned short>(w[i] >> 16));
  }
  *reinterpret_cast<uint4*>(lo) = make_uint4(o[0], o[1], o[2], o[3]);
  *reinterpret_cast<uint4*>(hi) = make_uint4(o[4], o[5], o[6], o[7]);
}

// An fp8 stage's raw rows -> the bf16 stage the ldmatrix loads read. The
// stage is a bf16 K tile then a bf16 V tile (kTile x D each, chunks
// swizzled by row); cp.async left the e4m3 K rows, then the e4m3 V rows,
// unswizzled in the V tile's place. K's bf16 rows lie below every raw
// byte; V's cover both raw tiles, so each lane holds its V chunks in
// registers and the warp meets (after all K reads) before any V write.
template <int D>
__device__ __forceinline__ void widen_stage(unsigned char* stage, int lane) {
  constexpr int kRaw = D / 16, kUnits = kTile * kRaw, kPer = (kUnits + 31) / 32;
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(stage);
  __nv_bfloat16* sv = sk + kTile * D;
  const unsigned char* rk = stage + kTile * D * 2;
  const unsigned char* rv = rk + kTile * D;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int u = lane + 32 * p;
    if (u < kUnits) {
      const int j = u / kRaw, c = u % kRaw;
      widen16(*reinterpret_cast<const uint4*>(rk + j * D + c * 16),
              sk + j * D + swz<D>(j, 2 * c) * 8, sk + j * D + swz<D>(j, 2 * c + 1) * 8);
    }
  }
  uint4 held[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int u = lane + 32 * p;
    if (u < kUnits) {
      held[p] = *reinterpret_cast<const uint4*>(rv + (u / kRaw) * D + (u % kRaw) * 16);
    }
  }
  __syncwarp();
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int u = lane + 32 * p;
    if (u < kUnits) {
      const int j = u / kRaw, c = u % kRaw;
      widen16(held[p], sv + j * D + swz<D>(j, 2 * c) * 8, sv + j * D + swz<D>(j, 2 * c + 1) * 8);
    }
  }
}

__device__ __forceinline__ float2 to_f2(const float2& x) { return x; }
__device__ __forceinline__ float2 to_f2(const __nv_bfloat162& x) {
  return __bfloat1622float2(x);
}

// Code: kBf16 (q, K, V bf16), kF32E4m3 or kBf16E4m3 (q float32 or bf16 and
// the output in q's type; K/V e4m3, widened to bf16 in shared memory)
template <int Code, int D, bool kLse>
__global__ void __launch_bounds__(kThreads, 2) paged_mma_kernel(Args args) {
  using Sh = MmaShape<D>;
  using T = typename Kinds<Code>::Q;
  using KV = typename Kinds<Code>::KV;
  using Tr = Traits<T>;
  constexpr bool kFp8 = sizeof(KV) == 1;
  using QIn = typename std::conditional<std::is_same<T, float>::value, float2,
                                        __nv_bfloat162>::type;
  constexpr int G = kMmaHeads, kCpr = Sh::kCpr, kWS = Sh::kWarpStages;
  extern __shared__ __align__(128) unsigned char ring[];  // per warp: kWS x (K tile, V tile)
  __shared__ float s_wm[kWarps][G], s_wl[kWarps][G];
  __shared__ float s_cm[G], s_cl[G];  // this CTA's max and sum per head, for the cluster

  const int split = blockIdx.x, hk = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // a fragment's row group and column pair
  const int hq = args.hq, hkv = args.hkv, bt = args.bt, g = hq / hkv, S = args.splits;
  const long long head0 = (long long)hk * g;
  // the row's context and q are read at once; q is converted only after
  // the first K/V copies are issued
  const int ctx_in = args.ctx_lens[bi];
  // q for Q^T's B fragments: k-step ks, head gq, dims 16 ks + 2 tq (+1) and
  // 8 further; heads past the group are zeros
  const T* qrow = static_cast<const T*>(args.q) + ((long long)bi * hq + head0) * D;
  QIn qin[Sh::kSteps][2];
#pragma unroll
  for (int ks = 0; ks < Sh::kSteps; ++ks) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      qin[ks][h] = gq < g ? __ldg(reinterpret_cast<const QIn*>(
                                qrow + gq * D + 16 * ks + 8 * h + 2 * tq))
                          : QIn{};
    }
  }
  const int ctx = max(0, min(ctx_in, args.max_blocks * bt));
  T* out = static_cast<T*>(args.o) + ((long long)bi * hq + head0) * D;
  float* lse = kLse ? args.lse + (long long)bi * hq + head0 : nullptr;
  if (ctx == 0) {  // zeros and an lse of -inf: written by split 0 alone
    if (split == 0) {
      for (int idx = tid; idx < g * D; idx += kThreads) out[idx] = Tr::from_f(0.f);
      if (kLse && tid < g) lse[tid] = __int_as_float(0xff800000);  // -inf
    }
    return;
  }
  // the split's blocks: paged_attention.py split_ranges
  const int nb = (ctx + bt - 1) / bt;
  const int s_act = min(S, nb);
  if (s_act == 1 && split > 0) return;
  if (s_act > 1) cluster_arrive();  // waited for before the first remote write
  const bool active = split < s_act;
  const int b_lo = active ? (int)((long long)split * nb / s_act) : 0;
  const int b_hi = active ? (int)((long long)(split + 1) * nb / s_act) : 1;
  const int tpb = (bt + kTile - 1) / kTile;  // tiles per pool block
  const int last_rows = min(bt, ctx - (b_hi - 1) * bt);
  const int n_tiles =
      active ? (b_hi - 1 - b_lo) * tpb + (last_rows + kTile - 1) / kTile : 0;

  const KV* __restrict__ kbase = static_cast<const KV*>(args.k);
  const KV* __restrict__ vbase = static_cast<const KV*>(args.v);
  const int* trow = args.table + (long long)bi * args.max_blocks;
  const long long row_stride = (long long)hkv * D;
  const long long head_off = (long long)hk * D;
  unsigned char* my_ring = ring + warp * kWS * Sh::kStageBytes;

  auto col_of = [&](int i) { return b_lo + i / tpb; };
  auto row0_of = [&](int i) { return (i % tpb) * kTile; };
  auto rows_of = [&](int i) {
    return min(min(kTile, bt - row0_of(i)), ctx - (col_of(i) * bt + row0_of(i)));
  };
  // tile i's K and V rows into stage st, rows past n as zeros: bf16 rows
  // swizzled where ldmatrix reads them, e4m3 rows as they are into the V
  // tile's place (widen_stage moves them)
  auto stage_tile = [&](int i, int st, int blk) {
    const int n = rows_of(i);
    unsigned char* stage = my_ring + st * Sh::kStageBytes;
    const long long base =
        (long long)blk * args.block_stride + row0_of(i) * row_stride + head_off;
    if constexpr (kFp8) {
      constexpr int kRaw = D / 16;  // 16-byte chunks of an e4m3 row
      unsigned char* raw = stage + kTile * D * 2;
#pragma unroll 4
      for (int u = lane; u < 2 * kTile * kRaw; u += 32) {
        const int half = u / (kTile * kRaw);  // 0: K, 1: V
        const int r = u % (kTile * kRaw);
        const int j = r / kRaw, c = r % kRaw;
        const long long src = base + (j < n ? j : 0) * row_stride + c * 16;
        cp_async16(raw + half * kTile * D + j * D + c * 16, (half ? vbase : kbase) + src,
                   j < n ? 16 : 0);
      }
    } else {
      __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(stage);
#pragma unroll 4
      for (int u = lane; u < 2 * kTile * kCpr; u += 32) {
        const int half = u / (kTile * kCpr);  // 0: K, 1: V
        const int r = u % (kTile * kCpr);
        const int j = r / kCpr, c = r % kCpr;
        const long long src = base + (j < n ? j : 0) * row_stride + c * 8;
        cp_async16(sk + half * kTile * D + j * D + swz<D>(j, c) * 8,
                   (half ? vbase : kbase) + src, j < n ? 16 : 0);
      }
    }
  };
  auto block_at = [&](int i) { return max(__ldg(trow + col_of(i)), 0); };

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
  // Q^T's B fragments: q * scale, formed in f32 from q as it came (bf16
  // or float32, never rounded first), rounded to bf16 once (the contract's
  // rounding point)
  uint32_t qb[Sh::kSteps][2];
#pragma unroll
  for (int ks = 0; ks < Sh::kSteps; ++ks) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 f = to_f2(qin[ks][h]);
      qb[ks][h] = pack2(f.x * args.scale, f.y * args.scale);
    }
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // heads 2 tq, 2 tq + 1
  float o[Sh::kSteps][4];  // O^T: rows 16 mt + gq (+ 8), heads 2 tq (+ 1)
#pragma unroll
  for (int mt = 0; mt < Sh::kSteps; ++mt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[mt][e] = 0.f;
  }
  // the ldmatrix row and chunk each lane addresses: K as A (keys x dims),
  // V^T as A through the transposing load (rows of V are keys)
  const int k_row = (lane & 7) + ((lane >> 3) & 1) * 8, k_half = lane >> 4;
  const int v_row = (lane & 7) + (lane >> 4) * 8, v_half = (lane >> 3) & 1;

  const int rounds = (n_tiles + kWarps - 1) / kWarps;
  for (int k = 0; k < rounds; ++k) {
    const int i = warp + k * kWarps;
    const int st = k % kWS;
    const int next = i + kWS * kWarps;
    const int next_blk = next < n_tiles ? block_at(next) : 0;  // read ahead of the wait
    cp_async_wait<kWS - 1>();
    __syncwarp();
    const int n = i < n_tiles ? rows_of(i) : 0;
    if constexpr (kFp8) {  // warp-uniform n
      if (n > 0) widen_stage<D>(my_ring + st * Sh::kStageBytes, lane);
      __syncwarp();
    }
    const __nv_bfloat16* sk =
        reinterpret_cast<const __nv_bfloat16*>(my_ring + st * Sh::kStageBytes);
    const __nv_bfloat16* sv = sk + kTile * D;

    // a warp without a tile this round (n == 0, warp-uniform) skips the
    // products: its stage holds no staged rows, and 0 x NaN is NaN
    if (n > 0) {
      // S^T = K . Q^T: c[0..1] keys gq, c[2..3] keys gq + 8; heads 2 tq, 2 tq + 1
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < Sh::kSteps; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, sk + k_row * D + swz<D>(k_row, 2 * ks + k_half) * 8);
        mma_bf16(c, a, qb[ks][0], qb[ks][1]);
      }
      // the tile's softmax per head, over its 16 keys: the lane's two keys,
      // then the lanes of equal tq
      const bool in0 = gq < n, in1 = gq + 8 < n;
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float x0 = in0 ? c[h] * kLog2e : kNegInf;
        const float x1 = in1 ? c[2 + h] * kLog2e : kNegInf;
        float mx = fmaxf(x0, x1);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        }
        const float m_new = fmaxf(m[h], mx);
        c[h] = in0 ? ex2(x0 - m_new) : 0.f;
        c[2 + h] = in1 ? ex2(x1 - m_new) : 0.f;
        float sum = c[h] + c[2 + h];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        alpha[h] = ex2(m[h] - m_new);
        l[h] = l[h] * alpha[h] + sum;
        m[h] = m_new;
      }
      // P^T's B fragments: P (keys x heads) packed as 8 x 8 bf16 tiles, transposed
      const uint32_t p_lo = transpose8x8(pack2(c[0], c[1]));  // keys 0-7
      const uint32_t p_hi = transpose8x8(pack2(c[2], c[3]));  // keys 8-15
      // O^T += V^T . P^T, one rescale per tile
#pragma unroll
      for (int mt = 0; mt < Sh::kSteps; ++mt) {
        o[mt][0] *= alpha[0];
        o[mt][1] *= alpha[1];
        o[mt][2] *= alpha[0];
        o[mt][3] *= alpha[1];
        uint32_t a[4];
        ldsm_x4_t(a, sv + v_row * D + swz<D>(v_row, 2 * mt + v_half) * 8);
        mma_bf16(o[mt], a, p_lo, p_hi);
      }
    }
    __syncwarp();  // the stage is read before it is written again
    if (next < n_tiles) stage_tile(next, st, next_blk);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncwarp();

  // the warp's partial: O^T into its first stage as (head, d), f32
  float* wacc = reinterpret_cast<float*>(my_ring);
#pragma unroll
  for (int mt = 0; mt < Sh::kSteps; ++mt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      wacc[(2 * tq + (e & 1)) * D + 16 * mt + gq + 8 * (e >> 1)] = o[mt][e];
    }
  }
  if (gq == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s_wm[warp][2 * tq + h] = m[h];
      s_wl[warp][2 * tq + h] = l[h];
    }
  }
  __syncthreads();
  merge_partials<T, D, G, kLse>(ring, kWS * Sh::kStageBytes, s_wm, s_wl, s_cm, s_cl, out, lse, g,
                          S, s_act, split, tid);
}

// The kernel that takes (Code, D, G) and its dynamic shared memory: bf16
// and every e4m3 cache on the tensor cores, float32 on the CUDA cores; a
// whole group a CTA in both.
template <int Code, int D, int G, bool kLse>
struct Kernel {
  static constexpr bool kMma = Code != kF32;
  static void (*fn())(Args) {
    if constexpr (kMma) {
      return paged_mma_kernel<Code, D, kLse>;
    } else {
      return paged_attention_kernel<float, D, G, kLse>;
    }
  }
  static constexpr int smem() {
    if constexpr (kMma) {
      return MmaShape<D>::kSmem;
    } else {
      return Shape<float, D, G>::kSmem;
    }
  }
  static constexpr int kSmem = smem();
};

template <int Code, int D, int G, bool kLse>
cudaError_t prepare() {  // once: the dynamic shared-memory cap, clusters of up to 16
  static cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(Kernel<Code, D, G, kLse>::fn(),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Kernel<Code, D, G, kLse>::kSmem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(Kernel<Code, D, G, kLse>::fn(),
                                cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  return err;
}

// op 0: launch; op 1: *out = resident CTAs per SM; op 2: *out = dynamic
// shared memory; op 3: *out = clusters of args.splits CTAs resident at once
template <int Code, int D, int G, bool kLse>
int run(const Args& args, int op, int* out, cudaStream_t stream) {
  using K = Kernel<Code, D, G, kLse>;
  cudaError_t err = prepare<Code, D, G, kLse>();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (op == 2) {
    *out = K::kSmem;
    return 0;
  }
  if (op == 1) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, K::fn(), kThreads, K::kSmem));
  }
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = args.splits;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(args.splits, args.hkv, args.b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = K::kSmem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  if (op == 3) {
    return static_cast<int>(cudaOccupancyMaxActiveClusters(out, (void*)K::fn(), &cfg));
  }
  err = cudaLaunchKernelEx(&cfg, K::fn(), args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// g: the group. The tensor-core kernel takes every group in one
// instantiation; float32 in the least power of two that holds it
template <int Code, int D, bool kLse>
int run_g(const Args& args, int g, int op, int* out, cudaStream_t s) {
  if constexpr (Code != kF32) {
    return run<Code, D, kMmaHeads, kLse>(args, op, out, s);
  } else {
    if (g <= 1) return run<Code, D, 1, kLse>(args, op, out, s);
    if (g <= 2) return run<Code, D, 2, kLse>(args, op, out, s);
    if (g <= 4) return run<Code, D, 4, kLse>(args, op, out, s);
    return run<Code, D, 8, kLse>(args, op, out, s);
  }
}

// kLse: the instantiation that stores the lse; serving's (lse null) is
// the same code as before the lse existed
template <int Code, bool kLse>
int run_d(const Args& args, int d, int g, int op, int* out, cudaStream_t s) {
  switch (d) {
    case 16: return run_g<Code, 16, kLse>(args, g, op, out, s);
    case 32: return run_g<Code, 32, kLse>(args, g, op, out, s);
    case 64: return run_g<Code, 64, kLse>(args, g, op, out, s);
    case 80: return run_g<Code, 80, kLse>(args, g, op, out, s);
    case 128: return run_g<Code, 128, kLse>(args, g, op, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(const Args& args, int dtype, int d, int g, int op, int* out, cudaStream_t s) {
  if (g < 1 || g > 8) return static_cast<int>(cudaErrorInvalidValue);
  const bool lse = args.lse != nullptr;
  switch (dtype) {
    case kF32: return lse ? run_d<kF32, true>(args, d, g, op, out, s)
                          : run_d<kF32, false>(args, d, g, op, out, s);
    case kBf16: return lse ? run_d<kBf16, true>(args, d, g, op, out, s)
                           : run_d<kBf16, false>(args, d, g, op, out, s);
    case kF32E4m3: return lse ? run_d<kF32E4m3, true>(args, d, g, op, out, s)
                              : run_d<kF32E4m3, false>(args, d, g, op, out, s);
    case kBf16E4m3: return lse ? run_d<kBf16E4m3, true>(args, d, g, op, out, s)
                               : run_d<kBf16E4m3, false>(args, d, g, op, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, K, V alike); 2 = q float32 and K/V
// e4m3, 3 = q bfloat16 and K/V e4m3 (the output in q's type); d in {16,
// 32, 64, 80, 128}; hq / hkv <= 8.
// block_stride in elements. lse: null, or (b, hq) float32 that receives
// each head's natural log-sum-exp of its scaled scores (-inf at context 0).
// splits: CTAs per (row, kv head), 1 to 16, one
// thread-block cluster. Launches ONE kernel on `stream`, allocates nothing;
// returns a cudaError_t.
extern "C" int paged_attention_fwd(const void* q, const void* k, const void* v,
                                   long long block_stride, const void* table,
                                   const void* ctx, void* o, void* lse, int dtype, int b,
                                   int hq, int hkv, int d, int bt, int max_blocks, int splits,
                                   float scale, void* stream) {
  if ((d != 16 && d != 32 && d != 64 && d != 80 && d != 128) || hkv <= 0 || hq % hkv != 0 ||
      hq / hkv > 8 || bt <= 0 || max_blocks <= 0 || splits <= 0 ||
      splits > kMaxCluster || hkv > 65535 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0) return 0;
  const Args args{q, k, v, block_stride, static_cast<const int*>(table),
                  static_cast<const int*>(ctx), o, static_cast<float*>(lse), b, hq, hkv, bt,
                  max_blocks, splits, scale};
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
