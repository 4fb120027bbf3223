// Causal / non-causal GQA flash attention, forward, in two routes; its
// gradient is flash_attention_bwd.cu.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:
// flash_attention (pallas_call at :135). Same contract: q (b, sq, hq, d),
// k and v (b, skv, hkv, d), out (b, sq, hq, d) in the input dtype; scale
// 1/sqrt(d) applied to the f32 scores; online softmax with running max, sum
// and accumulator in f32; keys at kpos >= skv masked with -1e30; causal mask
// qpos >= kpos aligned at position 0; denominator floor 1e-30; tiles
// entirely above the diagonal issue no loads and no products. Query head h
// reads kv head h / (hq / hkv). The wrapper (flash_attention.py) picks the
// route from dtype and head_dim alone; neither route falls back on the other.
// Both routes take an optional lse (b, hq, sq) f32 output, null when serving:
// each row's log-sum-exp of its scaled, masked scores in natural log (the
// wgmma route's exp2-domain max and sum converted), which the backward reads
// to recompute P.
//
// Bound on an H100: operations. At the main path's prefill shapes (one
// layer of Llama-3.1-8B, sq = skv = 1024, hq = 32, d = 128) the causal work
// is 4*b*hq*sq*skv*d/2 = 8.6 GFLOP, 8.7 us at 989 TFLOP/s, against 21 MB of
// q, k, v and out, 6 us at 3.35 TB/s.
//
// Route "wgmma" (flash_attention_wgmma_fwd; bf16, d = 64, 80 or 128): the
// tensor cores, fed by TMA. A work item is (q tile of 128 rows, q head,
// batch); items are numbered longest causal q tile first.
//   * Persistent grid: at most one CTA of 384 threads per SM (the wrapper
//     passes the SM count), each walking its items in a snake over the
//     longest-first order (round r takes items r * ctas + c, reversed in odd
//     rounds), which balances the long and short causal tiles as well as a
//     greedy schedule at the paths' shapes (flash_attention.py: cta_items).
//     A grid of one CTA per item (the route's first design) ran 448 CTAs for Arctic's
//     56 heads, 3.4 waves on 132 SMs, each CTA paying its own barrier set-up,
//     Q load and pipeline fill; here Q is double-buffered, so the producer
//     loads the next item's Q and first K/V tiles while the consumers finish
//     this one, and the epilogue of one item overlaps the next one's loads.
//   * TMA: one rank-4 tensor map per operand over the (b, s, h, d) layout as
//     it lies (dims d, h, s, b; row stride h*d*2 bytes). d 64 and 128: boxes
//     of 64 columns under the 128-byte swizzle, one or two a tile. d 80: the
//     160-byte row exceeds the 128-byte swizzle span and is no multiple of
//     it, so a tile is five boxes of 16 columns under the 32-byte swizzle;
//     each box is one k16 step of Q.K^T and one 16-column atom of P.V's N,
//     so no column is padded. Rows past sq or skv arrive as zeros; keys there
//     still score 0, so they stay masked.
//   * Warp specialisation: a producer warpgroup (one thread issues the loads,
//     setmaxnreg gives its registers to the consumers) keeps Q (two tiles)
//     and a ring of two K/V stages in flight with mbarrier expect-tx /
//     complete-tx; warpgroups 0 and 1 each own 64 query rows. ptxas still
//     compiles the consumers within 65536 / 384 = 168 registers, so S (64),
//     P (32) and O (64 at d = 128) must fit there: each tile's first Q.K^T
//     step writes S without reading it, which ends S's life at P's packing.
//   * K and V tiles are released apart (K after its Q.K^T, V after its
//     P.V), so the producer refills a K stage while P.V still reads V.
//   * Tried and dropped (flash_probe, PERF.md): "pingpong", the two
//     consumer warpgroups taking turns on the tensor cores through named
//     barriers, ran 9-29 % slower at the paths' shapes in both orders tried.
//   * S = Q.K^T: wgmma m64n128k16 with Q and K read from shared memory
//     (K-major), d/16 k-steps; the score tile stays in registers, row max
//     and sum across the four threads of a quad, one rescale of O per tile;
//     2^x with scale*log2(e) folded in, one MUFU.EX2 each (ex2.approx.ftz:
//     exp2f adds a range check and two multiplies around it for results
//     below 2^-126, which a probability that small does not need).
//   * O += P.V: wgmma m64n64k16 per 64-column box (d 64, 128) or one
//     m64n80k16 over the five boxes (d 80), P from registers (two
//     neighbouring n8 accumulator groups packed to bf16x2 are one k16 A
//     fragment) and V read from shared memory as it lies, N-contiguous
//     (MN-major, transpose bit).
//   * Only the diagonal tile and the tile holding skv are masked.
// Numerics: P is rounded to bf16 for the tensor cores (the JAX kernel keeps
// P in f32 for P.V), so the result is not bit-equal to the plain version;
// the sum l is taken from the f32 P. chip_smoke.py prints the max |err|.
//
// Route "cuda_cores" (flash_attention_fwd; f32, or bf16 at any multiple of
// 16 up to 128): the first design, a simple kernel that is right, on the f32
// CUDA cores far below the tensor-core bound. One thread block per (q tile
// of 16 rows, q head, batch), four warps of four query rows each. K/V tiles
// of 32 keys are staged in shared memory (rows padded so that the 32 lanes,
// one key each, hit 32 banks); the q tile is held scaled in f32 and read as
// float4 broadcasts. Each lane scores its own key against its warp's four
// rows, the warp reduces max and sum with shuffles, and P.V accumulates d/32
// output columns per lane.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 4;  // query rows per warp
constexpr int kBQ = kWarps * kRows;
constexpr int kBKV = 32;  // keys per tile: one per lane
constexpr int kMaxD = 128;
constexpr int kMaxCols = kMaxD / 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// four consecutive key elements starting at a multiple of 4
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  o[0] = p[0]; o[1] = p[1]; o[2] = p[2]; o[3] = p[3];
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(p);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(p + 2);
  o[0] = __low2float(a); o[1] = __high2float(a);
  o[2] = __low2float(b); o[3] = __high2float(b);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                 int sq, int skv, int hq, int hkv, int d, int causal, float scale) {
  constexpr int kpad = sizeof(T) == 4 ? 1 : 2;  // odd word stride between key rows
  const int ldk = d + kpad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // (kBQ, d) f32, pre-scaled
  T* ks = reinterpret_cast<T*>(qs + kBQ * d);       // (kBKV, ldk)
  T* vs = ks + kBKV * ldk;                          // (kBKV, d)

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const long long bi = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = warp * kRows;

  for (int i = tid; i < kBQ * d; i += kWarps * 32) {
    const int r = i / d;
    const int c = i - r * d;
    const int qp = q0 + r;
    float x = 0.f;
    if (qp < sq) x = to_f(q[((bi * sq + qp) * hq + h) * d + c]);
    qs[i] = x * scale;
  }

  float m[kRows], l[kRows], acc[kRows][kMaxCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxCols; ++i) acc[r][i] = 0.f;
  }

  // causal: keys past the tile's last query row are never needed
  const int kv_end = causal ? min(skv, q0 + kBQ) : skv;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kBKV) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int i = tid; i < kBKV * d; i += kWarps * 32) {
      const int j = i / d;
      const int c = i - j * d;
      const int kp = kv0 + j;
      T kx = from_f<T>(0.f), vx = from_f<T>(0.f);
      if (kp < skv) {
        const long long off = ((bi * skv + kp) * hkv + hk) * d + c;
        kx = k[off];
        vx = v[off];
      }
      ks[j * ldk + c] = kx;
      vs[j * d + c] = vx;
    }
    __syncthreads();

    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const T* krow = ks + lane * ldk;
    for (int c = 0; c < d; c += 4) {
      float k4[4];
      load4(krow + c, k4);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 q4 = *reinterpret_cast<const float4*>(qs + (row0 + r) * d + c);
        s[r] += q4.x * k4[0] + q4.y * k4[1] + q4.z * k4[2] + q4.w * k4[3];
      }
    }

    const int kp = kv0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + row0 + r;
      const bool valid = kp < skv && (!causal || qp >= kp);
      const float sv = valid ? s[r] : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float p = valid ? expf(sv - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < kMaxCols; ++i) acc[r][i] *= alpha;
      s[r] = p;
    }

    for (int j = 0; j < kBKV; ++j) {
      float vj[kMaxCols];
#pragma unroll
      for (int i = 0; i < kMaxCols; ++i) {
        const int c = lane + 32 * i;
        vj[i] = c < d ? to_f(vs[j * d + c]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(0xffffffffu, s[r], j);
#pragma unroll
        for (int i = 0; i < kMaxCols; ++i) acc[r][i] += pj * vj[i];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + row0 + r;
    if (qp >= sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    if (lse != nullptr && lane == 0) lse[(bi * hq + h) * sq + qp] = m[r] + logf(denom);
    T* orow = o + ((bi * sq + qp) * hq + h) * d;
#pragma unroll
    for (int i = 0; i < kMaxCols; ++i) {
      const int c = lane + 32 * i;
      if (c < d) orow[c] = from_f<T>(acc[r][i] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int b, int sq,
           int skv, int hq, int hkv, int d, int causal, float scale,
           cudaStream_t stream) {
  constexpr int kpad = sizeof(T) == 4 ? 1 : 2;
  const size_t smem = kBQ * d * sizeof(float) +
                      kBKV * (d + kpad) * sizeof(T) + kBKV * d * sizeof(T);
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_fwd_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse), sq, skv, hq,
      hkv, d, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; lse (b, hq, sq) f32 or null. Returns a
// cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int dtype, int b, int sq, int skv,
                                   int hq, int hkv, int d, int causal,
                                   float scale, void* stream) {
  if (d % 16 != 0 || d > kMaxD || hkv <= 0 || hq % hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, o, lse, b, sq, skv, hq, hkv, d, causal, scale, s);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, o, lse, b, sq, skv, hq, hkv, d, causal, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// Route "wgmma": bf16, d = 64, 80 or 128, tensor cores fed by TMA.
// ---------------------------------------------------------------------------

namespace wgmma_route {

using namespace hopper;

constexpr int kBQ = 128;  // query rows per work item: two consumer warpgroups of 64
constexpr int kBKV = 128;  // keys per K/V tile
constexpr int kStages = 2;  // K/V tiles in flight
constexpr int kPvParts = 2;  // P.V issued in parts, each part's exps beside the last one's product
constexpr int kThreads = 384;  // warpgroups 0, 1: consumers; warpgroup 2: the producer
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A Q, K or V tile of 128 rows as TMA boxes. d 64 and 128: boxes of 64
// columns (128 B rows, the widest under the 128-byte swizzle), one or two a
// tile. d 80: a 160-byte row is wider than the 128-byte swizzle span and no
// multiple of it, so the tile is five boxes of 16 columns (32 B rows) under
// the 32-byte swizzle, each box one k16 step of Q.K^T and one 16-column
// atom of P.V's N.
template <int D>
struct Tile {
  static constexpr bool kWide = D % 64 == 0;
  static constexpr int kBoxCols = kWide ? 64 : 16;
  static constexpr int kRowBytes = kBoxCols * 2;
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kBoxBytes = kRowBytes * 128;
  static constexpr int kBytes = kBoxes * kBoxBytes;
  static constexpr int kGroupBytes = 8 * kRowBytes;  // an 8-row core group
  static constexpr uint64_t kLayout = kWide ? 1 : 3;  // descriptor: 128-byte or 32-byte swizzle
  static constexpr int kAcc = D / 2;  // O accumulator registers a consumer thread holds
};
static_assert(Tile<80>::kBoxes == 5 && Tile<128>::kBoxes == 2 && Tile<64>::kBoxes == 1, "boxes");

template <int D>
struct Smem {  // byte offsets from a 1024-aligned base (the widest swizzle atom)
  static constexpr int kT = Tile<D>::kBytes;
  static constexpr int kQ = 0;  // two Q tiles: the next work item's loads while this one runs
  static constexpr int kK = kQ + 2 * kT;
  static constexpr int kV = kK + kStages * kT;
  static constexpr int kBar = kV + kStages * kT;
  // barriers: q_full[2], q_empty[2], then k_full, v_full, k_empty, v_empty [stages]
  static constexpr int kBytes = kBar + 8 * (4 + 4 * kStages) + 1024;  // + alignment slack
};

// K-major (Q, K): 8-row groups kGroupBytes apart; a k16 step lies inside one
// swizzle row (32 B of a 128 B row, or the whole 32 B row), so the leading
// offset is not read.
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  using T = Tile<D>;
  return smem_desc(addr, T::kWide ? 0 : 16, T::kGroupBytes, T::kLayout);
}
// MN-major (V, N = d contiguous): a k16 step is two 8-row groups kGroupBytes
// apart along K (the stride offset). Along N, d 64 / 128 take one 64-column
// swizzle atom per instruction (the leading offset is not read; it carries
// the K offset as before); d 80 spans its five 16-column boxes, one atom
// each, kBoxBytes apart (the leading offset).
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  using T = Tile<D>;
  return smem_desc(addr, T::kWide ? T::kGroupBytes : T::kBoxBytes, T::kGroupBytes, T::kLayout);
}
// byte offset of k16 step kk (columns 16 kk ...) inside a K-major tile
template <int D>
__device__ __forceinline__ uint32_t kstep_off(int kk) {
  using T = Tile<D>;
  return (kk * 16 / T::kBoxCols) * T::kBoxBytes + (kk * 16 % T::kBoxCols) * 2;
}

// S (64 x 128 f32) (+)= Q (64 x 16, smem) . K^T (16 x 128, smem), both K-major.
// The first k-step (kAcc false) writes S without reading it ("=f"), so the
// score registers are dead from P's packing to the next tile's Q.K^T.
#define FLASH_QK_ASM                                                               \
  "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"                                   \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "         \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
  "%64, %65, p, 1, 1, 0, 0;\n}\n"
#define FLASH_QK_REGS(c) \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]), \
  c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15]), c(d[16]), \
  c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]), \
  c(d[25]), c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31]), c(d[32]), \
  c(d[33]), c(d[34]), c(d[35]), c(d[36]), c(d[37]), c(d[38]), c(d[39]), c(d[40]), \
  c(d[41]), c(d[42]), c(d[43]), c(d[44]), c(d[45]), c(d[46]), c(d[47]), c(d[48]), \
  c(d[49]), c(d[50]), c(d[51]), c(d[52]), c(d[53]), c(d[54]), c(d[55]), c(d[56]), \
  c(d[57]), c(d[58]), c(d[59]), c(d[60]), c(d[61]), c(d[62]), c(d[63])

template <bool kAcc>
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da, uint64_t db) {
  if constexpr (kAcc) {
    asm volatile(FLASH_QK_ASM : FLASH_QK_REGS("+f") : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(FLASH_QK_ASM : FLASH_QK_REGS("=f") : "l"(da), "l"(db), "r"(0));
  }
}
#undef FLASH_QK_REGS
#undef FLASH_QK_ASM

// O (64 x 64 f32) += P (64 x 16, registers) . V (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_pv64(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 80 f32) += P (64 x 16, registers) . V (16 x 80, smem, MN-major)
__device__ __forceinline__ void wgmma_pv80(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// a use of every A fragment after the wait, so that no register of an
// in-flight product is reused for the exps issued beside it
__device__ __forceinline__ void keep_regs(const uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    asm volatile("" ::"r"(pa[kk][0]), "r"(pa[kk][1]), "r"(pa[kk][2]), "r"(pa[kk][3]) : "memory");
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One work item: a q tile of kBQ rows of one (q head, batch row), with the
// kv tiles it reads. Items are numbered longest q tile first
// (flash_attention.py: q_tile_order); CTA c of `ctas` takes item c of round
// 0, then each round the next `ctas` items, in reverse order every second
// round (a snake), so that the long and short causal tiles even out
// (flash_attention.py: cta_items).
struct Item {
  int h, bi, hk, q0, n_kv;
};

__device__ __forceinline__ int item_index(int round, int cta, int ctas) {
  return round * ctas + ((round & 1) ? ctas - 1 - cta : cta);
}

__device__ __forceinline__ Item decode_item(int x, int n_q_tiles, int hq, int b, int hkv,
                                            int skv, int causal) {
  Item it;
  const int per_tile = hq * b;
  const int qt = n_q_tiles - 1 - x / per_tile;
  const int rest = x % per_tile;
  it.h = rest % hq;
  it.bi = rest / hq;
  it.hk = it.h / (hq / hkv);
  it.q0 = qt * kBQ;
  const int n_kv_all = (skv + kBKV - 1) / kBKV;
  // causal: tiles past the q tile's last row are never loaded
  it.n_kv = causal ? min(n_kv_all, (it.q0 + kBQ - 1) / kBKV + 1) : n_kv_all;
  return it;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                   float* __restrict__ lse, int b, int sq, int skv, int hq, int hkv, int n_q_tiles, int causal,
                   float scale_log2) {
  using S = Smem<D>;
  using Tl = Tile<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + S::kBar, q_empty = q_full + 16;
  const uint32_t k_full = q_empty + 16, v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages, v_empty = k_empty + 8 * kStages;
  const int n_items = n_q_tiles * hq * b;
  const int cta = blockIdx.x, ctas = gridDim.x;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + 8 * i, 1);
      mbar_init(q_empty + 8 * i, 2 * 128);  // every consumer thread releases its Q tile
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 2 * 128);  // every consumer thread releases a K tile
      mbar_init(v_empty + 8 * s, 2 * 128);  // and a V tile
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---------------- producer: one thread issues every load ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      int it = 0;  // K/V tiles loaded so far, over all this CTA's items
      for (int r = 0;; ++r) {
        const int x = item_index(r, cta, ctas);
        if (x >= n_items) break;
        const Item w = decode_item(x, n_q_tiles, hq, b, hkv, skv, causal);
        const int qb = r & 1;
        if (r >= 2) mbar_wait(q_empty + 8 * qb, ((r >> 1) - 1) & 1);
        mbar_expect_tx(q_full + 8 * qb, Tl::kBytes);
        for (int c = 0; c < Tl::kBoxes; ++c) {
          tma_load(base + S::kQ + qb * S::kT + c * Tl::kBoxBytes, &tq, q_full + 8 * qb,
                   c * Tl::kBoxCols, w.h, w.q0, w.bi);
        }
        for (int j = 0; j < w.n_kv; ++j, ++it) {
          const int st = it % kStages;
          const uint32_t reuse = ((it / kStages) - 1) & 1;  // the tile this stage held
          const int kv0 = j * kBKV;
          const uint32_t kt = base + S::kK + st * S::kT, vt = base + S::kV + st * S::kT;
          if (it >= kStages) mbar_wait(k_empty + 8 * st, reuse);
          mbar_expect_tx(k_full + 8 * st, Tl::kBytes);
          for (int c = 0; c < Tl::kBoxes; ++c) {
            tma_load(kt + c * Tl::kBoxBytes, &tk, k_full + 8 * st, c * Tl::kBoxCols, w.hk, kv0,
                     w.bi);
          }
          if (it >= kStages) mbar_wait(v_empty + 8 * st, reuse);
          mbar_expect_tx(v_full + 8 * st, Tl::kBytes);
          for (int c = 0; c < Tl::kBoxes; ++c) {
            tma_load(vt + c * Tl::kBoxBytes, &tv, v_full + 8 * st, c * Tl::kBoxCols, w.hk, kv0,
                     w.bi);
          }
        }
      }
    }
  } else {
    // ---------------- consumers: 64 query rows per warpgroup ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    int it = 0;  // K/V tiles consumed so far, over all this CTA's items
    for (int r = 0;; ++r) {
      const int x = item_index(r, cta, ctas);
      if (x >= n_items) break;
      const Item w = decode_item(x, n_q_tiles, hq, b, hkv, skv, causal);
      const int qb = r & 1;
      const int row_lo = w.q0 + wg * 64;  // this warpgroup's first row
      const int qr = row_lo + warp * 16 + g;  // this thread's rows: qr and qr + 8
      const uint32_t q_tile = base + S::kQ + qb * S::kT + wg * 64 * Tl::kRowBytes;

      float o[Tl::kAcc];
#pragma unroll
      for (int i = 0; i < Tl::kAcc; ++i) o[i] = 0.f;
      // running max (raw score units) and this thread's part of the row sums
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

      mbar_wait(q_full + 8 * qb, (r >> 1) & 1);
      for (int j = 0; j < w.n_kv; ++j, ++it) {
        const int st = it % kStages;
        const uint32_t parity = (it / kStages) & 1;
        const int kv0 = j * kBKV;
        const uint32_t kt = base + S::kK + st * S::kT, vt = base + S::kV + st * S::kT;

        mbar_wait(k_full + 8 * st, parity);
        float s[64];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = kstep_off<D>(kk);
          if (kk == 0) {
            wgmma_qk<false>(s, kmajor_desc<D>(q_tile + off), kmajor_desc<D>(kt + off));
          } else {
            wgmma_qk<true>(s, kmajor_desc<D>(q_tile + off), kmajor_desc<D>(kt + off));
          }
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs<64>(s);
        mbar_arrive(k_empty + 8 * st);
        if (j == w.n_kv - 1) mbar_arrive(q_empty + 8 * qb);  // the item's last Q read

        // s[4j + e] is row qr + 8 * (e >> 1), key kv0 + 8j + 2t + (e & 1)
        if (kv0 + kBKV > skv || (causal && kv0 + kBKV - 1 > row_lo)) {
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            const int kp = kv0 + 8 * (i / 4) + 2 * t + (i % 2);
            const int qp = qr + 8 * ((i / 2) % 2);
            if (kp >= skv || (causal && kp > qp)) s[i] = kNegInf;
          }
        }
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < 64; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
        float alpha[2], neg_mc[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          alpha[h] = ex2((m[h] - mx[h]) * scale_log2);
          neg_mc[h] = -mx[h] * scale_log2;
          m[h] = mx[h];
        }
#pragma unroll
        for (int i = 0; i < Tl::kAcc; ++i) o[i] *= alpha[(i / 2) % 2];
        mbar_wait(v_full + 8 * st, parity);
        fence_regs<Tl::kAcc>(o);
        // P.V in kPvParts parts of the tile's keys: a part's exps, packed to
        // bf16 as the A fragments of its k16 steps (groups 2kk and 2kk + 1),
        // then its products; the next part's exps run beside them (the
        // register fence keeps the compiler from hoisting those exps above
        // the issue)
        uint32_t pa[8][4];
#pragma unroll
        for (int part = 0; part < kPvParts; ++part) {
          constexpr int kVals = 64 / kPvParts, kSteps = 8 / kPvParts;
          if (part > 0) fence_regs<kVals>(s + part * kVals);
#pragma unroll
          for (int i = part * kVals; i < (part + 1) * kVals; ++i) {
            const int h = (i / 2) % 2;
            s[i] = ex2(fmaf(s[i], scale_log2, neg_mc[h]));
            sum[h] += s[i];
          }
#pragma unroll
          for (int kk = part * kSteps; kk < (part + 1) * kSteps; ++kk) {
            pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
            pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
            pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
            pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
          }
          wgmma_fence();  // P and the rescaled O were written by this thread
#pragma unroll
          for (int kk = part * kSteps; kk < (part + 1) * kSteps; ++kk) {
            const uint32_t vrow = vt + kk * 16 * Tl::kRowBytes;
            if constexpr (Tl::kWide) {
#pragma unroll
              for (int c = 0; c < Tl::kBoxes; ++c) {
                wgmma_pv64(o + 32 * c, pa[kk], mnmajor_desc<D>(vrow + c * Tl::kBoxBytes));
              }
            } else {
              wgmma_pv80(o, pa[kk], mnmajor_desc<D>(vrow));
            }
          }
        }
        l[0] = l[0] * alpha[0] + sum[0];
        l[1] = l[1] * alpha[1] + sum[1];
        wgmma_commit();
        wgmma_wait0();
        fence_regs<Tl::kAcc>(o);
        keep_regs(pa);  // the products read P's registers until the wait
        mbar_arrive(v_empty + 8 * st);
      }

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        l[h] = fmaxf(l[h], 1e-30f);
        // the row's log-sum-exp in natural log: m is in raw score units and
        // l sums 2^((s - m) scale log2 e) = e^((s - m) scale)
        const int qp = qr + 8 * h;
        if (lse != nullptr && t == 0 && qp < sq) {
          lse[(static_cast<long long>(w.bi) * hq + w.h) * sq + qp] =
              (m[h] * scale_log2 + log2f(l[h])) * kLn2;
        }
        l[h] = 1.f / l[h];
      }
      // o[4J + e]: row qr + 8 (e >> 1), column 8J + 2t + (e & 1)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qp = qr + 8 * h;
        if (qp < sq) {
          __nv_bfloat16* orow =
              out + ((static_cast<long long>(w.bi) * sq + qp) * hq + w.h) * D;
#pragma unroll
          for (int J = 0; J < Tl::kAcc / 4; ++J) {
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * J + 2 * t) =
                __floats2bfloat162_rn(o[4 * J + 2 * h] * l[h], o[4 * J + 2 * h + 1] * l[h]);
          }
        }
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const uint64_t* q_dims,
           const uint64_t* q_strides, const uint64_t* kv_dims, const uint64_t* kv_strides,
           const uint32_t* box, int b, int sq, int skv, int hq, int hkv, int causal, float scale,
           int ctas, cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return kNoEncoder;
  const CUtensorMapSwizzle swz =
      Tile<D>::kWide ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap tq, tk, tv;
  int rc = encode(enc, &tq, q, q_dims, q_strides, box, swz);
  if (rc == 0) rc = encode(enc, &tk, k, kv_dims, kv_strides, box, swz);
  if (rc == 0) rc = encode(enc, &tv, v, kv_dims, kv_strides, box, swz);
  if (rc != 0) return rc;
  const int smem = Smem<D>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_q_tiles = (sq + kBQ - 1) / kBQ;
  const long long items = static_cast<long long>(n_q_tiles) * hq * b;
  const int grid = static_cast<int>(items < ctas ? items : ctas);
  flash_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), b, sq, skv, hq, hkv,
      n_q_tiles, causal, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgmma_route

// Dynamic shared memory of the wgmma route's CTA at head_dim d (0 if none).
extern "C" int flash_attention_wgmma_smem(int d) {
  switch (d) {
    case 64: return wgmma_route::Smem<64>::kBytes;
    case 80: return wgmma_route::Smem<80>::kBytes;
    case 128: return wgmma_route::Smem<128>::kBytes;
    default: return 0;
  }
}

// bf16 only, d = 64, 80 or 128, 16-byte aligned bases (the wrapper checks).
// The tensor-map arguments (dims d, h, s, b; byte strides of h, s, b; the
// box) come from flash_attention.py's tensor_map_args and are checked
// against the kernel's tiles here. ctas: the persistent grid's size, at
// most one CTA per SM (the wrapper passes the SM count); the grid is the
// smaller of it and the work items. Returns a cudaError_t, 9999 if libcuda
// has no cuTensorMapEncodeTiled, or 10000 + its CUresult if it refuses a map.
// lse: (b, hq, sq) f32 or null, as the other route's.
extern "C" int flash_attention_wgmma_fwd(const void* q, const void* k, const void* v, void* o,
                                         void* lse,
                                         const uint64_t* q_dims, const uint64_t* q_strides,
                                         const uint64_t* kv_dims, const uint64_t* kv_strides,
                                         const uint32_t* box, int b, int sq, int skv, int hq,
                                         int hkv, int d, int causal, float scale, int ctas,
                                         void* stream) {
  namespace w = wgmma_route;
  const int box_cols = d == 64 ? w::Tile<64>::kBoxCols
                       : d == 80 ? w::Tile<80>::kBoxCols
                       : d == 128 ? w::Tile<128>::kBoxCols : 0;
  if (box_cols == 0 || hkv <= 0 || hq % hkv != 0 || ctas <= 0 ||
      box[0] != static_cast<uint32_t>(box_cols) || box[1] != 1 || box[2] != w::kBQ ||
      box[3] != 1 || q_dims[0] != static_cast<uint64_t>(d) ||
      kv_dims[0] != static_cast<uint64_t>(d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b == 0 || sq == 0) return 0;
  if (skv == 0) {  // no keys: the plain version's empty softmax gives zeros
    return static_cast<int>(
        cudaMemsetAsync(o, 0, static_cast<size_t>(b) * sq * hq * d * 2, s));
  }
  switch (d) {
    case 64:
      return w::launch<64>(q, k, v, o, lse, q_dims, q_strides, kv_dims, kv_strides, box, b, sq, skv,
                           hq, hkv, causal, scale, ctas, s);
    case 80:
      return w::launch<80>(q, k, v, o, lse, q_dims, q_strides, kv_dims, kv_strides, box, b, sq, skv,
                           hq, hkv, causal, scale, ctas, s);
    default:
      return w::launch<128>(q, k, v, o, lse, q_dims, q_strides, kv_dims, kv_strides, box, b, sq, skv,
                            hq, hkv, causal, scale, ctas, s);
  }
}
