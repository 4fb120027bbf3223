// Causal / non-causal GQA flash attention, forward only, in two routes.
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
//
// Bound on an H100: operations. At the main path's prefill shapes (one
// layer of Llama-3.1-8B, sq = skv = 1024, hq = 32, d = 128) the causal work
// is 4*b*hq*sq*skv*d/2 = 8.6 GFLOP, 8.7 us at 989 TFLOP/s, against 21 MB of
// q, k, v and out, 6 us at 3.35 TB/s.
//
// Route "wgmma" (flash_attention_wgmma_fwd; bf16, d = 64 or 128): the
// tensor cores, fed by TMA. One CTA of 384 threads per (q tile of 128 rows,
// q head, batch); blocks are numbered longest q tile first, so under the
// causal mask the short tiles fill the tail of the last wave.
//   * TMA: one rank-4 tensor map per operand over the (b, s, h, d) layout as
//     it lies (dims d, h, s, b; row stride h*d*2 bytes), 128-byte swizzle, so
//     a box row is 64 bf16 and d = 128 is two boxes per tile. Rows past sq
//     or skv arrive as zeros; keys there still score 0, so they stay masked.
//   * Warp specialisation: a producer warpgroup (one thread issues the loads,
//     setmaxnreg gives its registers to the consumers) keeps a ring of two
//     K/V stages in flight with mbarrier expect-tx / complete-tx; warpgroups
//     0 and 1 each own 64 query rows. ptxas still compiles the consumers
//     within 65536 / 384 = 168 registers, so S (64), P (32) and O (64 at
//     d = 128) must fit there: each tile's first Q.K^T step writes S without
//     reading it, which ends S's life at P's packing (no spills).
//   * S = Q.K^T: wgmma m64n128k16 with Q and K read from shared memory
//     (K-major, 128-byte swizzle), d/16 k-steps; the score tile stays in
//     registers, row max and sum across the four threads of a quad, one
//     rescale of O per tile; exp2f with scale*log2(e) folded in.
//   * O += P.V: wgmma m64n64k16 with P from registers (two neighbouring n8
//     accumulator groups packed to bf16x2 are one k16 A fragment) and V read
//     from shared memory as it lies, N-contiguous (MN-major, transpose bit).
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
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
                 const T* __restrict__ v, T* __restrict__ o, int sq, int skv,
                 int hq, int hkv, int d, int causal, float scale) {
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
    T* orow = o + ((bi * sq + qp) * hq + h) * d;
#pragma unroll
    for (int i = 0; i < kMaxCols; ++i) {
      const int c = lane + 32 * i;
      if (c < d) orow[c] = from_f<T>(acc[r][i] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int b, int sq,
           int skv, int hq, int hkv, int d, int causal, float scale,
           cudaStream_t stream) {
  constexpr int kpad = sizeof(T) == 4 ? 1 : 2;
  const size_t smem = kBQ * d * sizeof(float) +
                      kBKV * (d + kpad) * sizeof(T) + kBKV * d * sizeof(T);
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_fwd_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, skv, hq, hkv, d,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int b, int sq, int skv,
                                   int hq, int hkv, int d, int causal,
                                   float scale, void* stream) {
  if (d % 16 != 0 || d > kMaxD || hkv <= 0 || hq % hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, o, b, sq, skv, hq, hkv, d, causal, scale, s);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, o, b, sq, skv, hq, hkv, d, causal, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// Route "wgmma": bf16, d = 64 or 128, tensor cores fed by TMA.
// ---------------------------------------------------------------------------

namespace wgmma_route {

constexpr int kBQ = 128;  // query rows per CTA: two consumer warpgroups of 64
constexpr int kBKV = 128;  // keys per K/V tile
constexpr int kStages = 2;  // K/V tiles in flight
constexpr int kThreads = 384;  // warpgroups 0, 1: consumers; warpgroup 2: the producer
constexpr int kBoxCols = 64;  // 128 B of bf16: the widest box row under the 128-byte swizzle
constexpr int kBoxBytes = kBoxCols * 128 * 2;  // one (128 rows, 64 cols) box
constexpr int kRowBytes = kBoxCols * 2;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kNoEncoder = 9999;  // return codes above cudaError_t's range
constexpr int kEncodeFailed = 10000;  // + the CUresult of cuTensorMapEncodeTiled

template <int D>
struct Smem {  // byte offsets from a 1024-aligned base (the swizzle atom)
  static constexpr int kChunks = D / kBoxCols;
  static constexpr int kTile = kChunks * kBoxBytes;  // a Q, K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  // barriers: q_full, k_full[stages], v_full[stages], empty[stages]
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}"
               ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the completion of the phase with this parity. A load or an
// arrival that never comes traps after 10 s instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const uint64_t t0 = globaltimer();
  while (!mbar_try(bar, parity)) {
    if (globaltimer() - t0 > 10000000000ull) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
        "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}
// K-major (Q, K): rows of 128 B, 8-row groups 1024 B apart; a k16 step lies
// inside one swizzle row, so the leading offset is not read.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) { return smem_desc(addr, 0, 1024); }
// MN-major (V, N = d contiguous): an n64 x k16 step is two 8-row groups
// 1024 B apart along K and one 128 B swizzle row along N, so only the
// K-group offset is read; both offsets carry it.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return smem_desc(addr, 1024, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep the compiler from moving accumulator registers across an async wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
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
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                   int b, int sq, int skv, int hq, int hkv, int n_q_tiles, int causal,
                   float scale_log2) {
  using S = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + S::kBar;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * kStages, empty = v_full + 8 * kStages;

  // linear block id -> (q tile, head, batch), the longest q tile first
  // (flash_attention.py: q_tile_order)
  const int per_tile = hq * b;
  const int x = blockIdx.x;
  const int qt = n_q_tiles - 1 - x / per_tile;
  const int rest = x % per_tile;
  const int h = rest % hq, bi = rest / hq;
  const int hk = h / (hq / hkv);
  const int q0 = qt * kBQ;
  const int n_kv_all = (skv + kBKV - 1) / kBKV;
  // causal: tiles past the q tile's last row are never loaded
  const int n_kv = causal ? min(n_kv_all, (q0 + kBQ - 1) / kBKV + 1) : n_kv_all;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);  // every consumer thread releases a stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---------------- producer: one thread issues every load ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, S::kTile);
      for (int c = 0; c < S::kChunks; ++c) {
        tma_load(base + S::kQ + c * kBoxBytes, &tq, q_full, c * kBoxCols, h, q0, bi);
      }
      for (int it = 0; it < n_kv; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(empty + 8 * st, ((it / kStages) - 1) & 1);
        const int kv0 = it * kBKV;
        const uint32_t kt = base + S::kK + st * S::kTile, vt = base + S::kV + st * S::kTile;
        mbar_expect_tx(k_full + 8 * st, S::kTile);
        for (int c = 0; c < S::kChunks; ++c) {
          tma_load(kt + c * kBoxBytes, &tk, k_full + 8 * st, c * kBoxCols, hk, kv0, bi);
        }
        mbar_expect_tx(v_full + 8 * st, S::kTile);
        for (int c = 0; c < S::kChunks; ++c) {
          tma_load(vt + c * kBoxBytes, &tv, v_full + 8 * st, c * kBoxCols, hk, kv0, bi);
        }
      }
    }
  } else {
    // ---------------- consumers: 64 query rows per warpgroup ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int row_lo = q0 + wg * 64;  // this warpgroup's first row
    const int qr = row_lo + warp * 16 + g;  // this thread's rows: qr and qr + 8
    const uint32_t q_tile = base + S::kQ + wg * 64 * kRowBytes;

    float o[S::kChunks][32];
#pragma unroll
    for (int c = 0; c < S::kChunks; ++c) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
    }
    // running max (raw score units) and this thread's part of the row sums
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_kv; ++it) {
      const int st = it % kStages;
      const uint32_t parity = (it / kStages) & 1;
      const int kv0 = it * kBKV;
      const uint32_t kt = base + S::kK + st * S::kTile, vt = base + S::kV + st * S::kTile;

      mbar_wait(k_full + 8 * st, parity);
      float s[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        if (kk == 0) {
          wgmma_qk<false>(s, kmajor_desc(q_tile + off), kmajor_desc(kt + off));
        } else {
          wgmma_qk<true>(s, kmajor_desc(q_tile + off), kmajor_desc(kt + off));
        }
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);

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
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f((m[r] - mx[r]) * scale_log2);
        neg_mc[r] = -mx[r] * scale_log2;
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int r = (i / 2) % 2;
        s[i] = exp2f(fmaf(s[i], scale_log2, neg_mc[r]));
        sum[r] += s[i];
      }
      l[0] = l[0] * alpha[0] + sum[0];
      l[1] = l[1] * alpha[1] + sum[1];
#pragma unroll
      for (int c = 0; c < S::kChunks; ++c) {
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i / 2) % 2];
      }
      // P as the A fragments of 8 k16 steps: groups 2kk and 2kk + 1
      uint32_t pa[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }

      mbar_wait(v_full + 8 * st, parity);
#pragma unroll
      for (int c = 0; c < S::kChunks; ++c) fence_regs(o[c]);
      wgmma_fence();  // P and the rescaled O were written by this thread
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
        for (int c = 0; c < S::kChunks; ++c) {
          wgmma_pv(o[c], pa[kk], mnmajor_desc(vt + c * kBoxBytes + kk * 16 * kRowBytes));
        }
      }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int c = 0; c < S::kChunks; ++c) fence_regs(o[c]);
      mbar_arrive(empty + 8 * st);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = qr + 8 * r;
      if (qp < sq) {
        __nv_bfloat16* orow = out + ((static_cast<long long>(bi) * sq + qp) * hq + h) * D;
#pragma unroll
        for (int c = 0; c < S::kChunks; ++c) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            *reinterpret_cast<__nv_bfloat162*>(orow + c * kBoxCols + 8 * j + 2 * t) =
                __floats2bfloat162_rn(o[c][4 * j + 2 * r] * l[r], o[c][4 * j + 2 * r + 1] * l[r]);
          }
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point query: no -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

int encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, const uint64_t* dims,
           const uint64_t* strides, const uint32_t* box) {
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, const uint64_t* q_dims,
           const uint64_t* q_strides, const uint64_t* kv_dims, const uint64_t* kv_strides,
           const uint32_t* box, int b, int sq, int skv, int hq, int hkv, int causal, float scale,
           cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return kNoEncoder;
  CUtensorMap tq, tk, tv;
  int rc = encode(enc, &tq, q, q_dims, q_strides, box);
  if (rc == 0) rc = encode(enc, &tk, k, kv_dims, kv_strides, box);
  if (rc == 0) rc = encode(enc, &tv, v, kv_dims, kv_strides, box);
  if (rc != 0) return rc;
  const int smem = Smem<D>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_q_tiles = (sq + kBQ - 1) / kBQ;
  const long long blocks = static_cast<long long>(n_q_tiles) * hq * b;
  flash_wgmma_kernel<D><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), b, sq, skv, hq, hkv, n_q_tiles, causal,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgmma_route

// Dynamic shared memory of the wgmma route's CTA at head_dim d (0 if none).
extern "C" int flash_attention_wgmma_smem(int d) {
  return d == 64 ? wgmma_route::Smem<64>::kBytes : d == 128 ? wgmma_route::Smem<128>::kBytes : 0;
}

// bf16 only, d = 64 or 128, 16-byte aligned bases (the wrapper checks). The
// tensor-map arguments (dims d, h, s, b; byte strides of h, s, b; the box)
// come from flash_attention.py's tensor_map_args and are checked against the
// kernel's tiles here. Returns a
// cudaError_t, 9999 if libcuda has no cuTensorMapEncodeTiled, or 10000 +
// its CUresult if it refuses a map.
extern "C" int flash_attention_wgmma_fwd(const void* q, const void* k, const void* v, void* o,
                                         const uint64_t* q_dims, const uint64_t* q_strides,
                                         const uint64_t* kv_dims, const uint64_t* kv_strides,
                                         const uint32_t* box, int b, int sq, int skv, int hq,
                                         int hkv, int d, int causal, float scale, void* stream) {
  namespace w = wgmma_route;
  if ((d != 64 && d != 128) || hkv <= 0 || hq % hkv != 0 || box[0] != w::kBoxCols ||
      box[1] != 1 || box[2] != w::kBQ || box[3] != 1 || q_dims[0] != static_cast<uint64_t>(d) ||
      kv_dims[0] != static_cast<uint64_t>(d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b == 0 || sq == 0) return 0;
  if (skv == 0) {  // no keys: the plain version's empty softmax gives zeros
    return static_cast<int>(
        cudaMemsetAsync(o, 0, static_cast<size_t>(b) * sq * hq * d * 2, s));
  }
  if (d == 64) {
    return w::launch<64>(q, k, v, o, q_dims, q_strides, kv_dims, kv_strides, box, b, sq, skv,
                         hq, hkv, causal, scale, s);
  }
  return w::launch<128>(q, k, v, o, q_dims, q_strides, kv_dims, kv_strides, box, b, sq, skv,
                        hq, hkv, causal, scale, s);
}
