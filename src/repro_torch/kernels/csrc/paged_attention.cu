// One-token GQA decode attention through a block table, forward only.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py:
// paged_attention (pallas_call at :128). Same contract: q (b, hq, d); keys
// and values in blocks of bt tokens, looked up through block_table
// (b, max_blocks) int32, an entry of -1 read as block 0; only the first
// context_lens[b] tokens attend (the table covers at most max_blocks * bt);
// online softmax with running max, sum and accumulator in f32; a row with
// context 0 gives zeros. Query head h reads kv head h / (hq / hkv).
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
// 3.35 TB/s; the arithmetic (4 * hq * ctx * d = 17 MFLOP) is far below.
//
// Design (simple, right first): one thread block per (kv head, batch row,
// split of the context), eight warps. One block per (kv head, row) alone
// would put Llama-3.1-8B's single-row decode on 8 of the 132 SMs, so the
// context is cut into splits of a few dozen tokens (flash decoding): each
// block writes its unnormalised partial (max, sum, accumulator) to scratch
// and a second small kernel merges the splits below the context. A token's
// K (or V) row of d elements is read as 16-byte vectors by d / (16 /
// sizeof(T)) neighbouring lanes, so a warp covers 32 / that many tokens per
// step, and every lane starts kUnroll K and V loads before it uses any.
// Each group of lanes keeps its own online softmax for all hq / hkv query
// heads of the kv head, so every K/V row is read once for the whole group;
// the groups are merged with shuffles, then the warps through shared
// memory. Blocks whose split starts past the context return at once.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;  // tokens in flight per lane group
constexpr float kNegInf = -1e30f;

template <typename T> struct Traits;
template <> struct Traits<float> {
  static constexpr int kVec = 4;  // elements in 16 bytes
  __device__ static void unpack(const uint4& u, float* o) {
    o[0] = __uint_as_float(u.x); o[1] = __uint_as_float(u.y);
    o[2] = __uint_as_float(u.z); o[3] = __uint_as_float(u.w);
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
  __device__ static float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 from_f(float x) { return __float2bfloat16(x); }
};

// LPT: lanes per token row (d / kVec); G: query heads per kv head, rounded up
// to a power of two (the runtime g <= G guards the rest).
struct Args {
  const void* q;
  const void* k;
  const void* v;
  long long block_stride;  // elements between consecutive blocks
  const int* table;        // (b, max_blocks)
  const int* ctx_lens;     // (b,)
  void* o;                 // (b, hq, d)
  float* part_m;           // (b, hkv, splits, g) when splits > 1
  float* part_l;
  float* part_acc;         // (b, hkv, splits, g, d)
  int b, hq, hkv, bt, max_blocks, splits, span;
  float scale;
};

template <typename T, int LPT, int G>
__global__ void __launch_bounds__(kWarps * 32) paged_attention_kernel(Args args) {
  const T* __restrict__ q = static_cast<const T*>(args.q);
  const T* __restrict__ k = static_cast<const T*>(args.k);
  const T* __restrict__ v = static_cast<const T*>(args.v);
  const long long block_stride = args.block_stride;
  const int hq = args.hq, hkv = args.hkv, bt = args.bt, g = hq / hkv;
  using Tr = Traits<T>;
  constexpr int kVec = Tr::kVec;
  constexpr int D = LPT * kVec;
  constexpr int kTpw = 32 / LPT;  // tokens per warp step
  __shared__ float sm_m[kWarps][G], sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];

  const int hk = blockIdx.x;
  const int bi = blockIdx.y;
  const int split = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int seg = lane / LPT;  // which token of the step
  const int sub = lane % LPT;  // which 16-byte slice of the row
  const int ctx_all = min(args.ctx_lens[bi], args.max_blocks * bt);
  const int start = split * args.span;
  if (args.splits > 1 && start >= ctx_all) return;  // the merge skips this split
  const int ctx = min(ctx_all, start + args.span);

  float qv[G][kVec];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      float x = 0.f;
      if (gi < g) {
        const T qx = q[((long long)bi * hq + hk * g + gi) * D + sub * kVec + e];
        x = Tr::to_f(Tr::from_f(Tr::to_f(qx) * args.scale));
      }
      qv[gi][e] = x;
    }
  }
  float m[G], l[G], acc[G][kVec];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[gi][e] = 0.f;
  }

  const int* trow = args.table + (long long)bi * args.max_blocks;
  const long long tok_stride = (long long)hkv * D;
  const long long col = (long long)hk * D + sub * kVec;
  constexpr int kStep = kWarps * kTpw;
  // the loop bound is warp-uniform: every lane reaches every shuffle
  for (int base = start + warp * kTpw; base < ctx; base += kStep * kUnroll) {
    uint4 kr[kUnroll], vr[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int tok = base + seg + u * kStep;
      ok[u] = tok < ctx;
      kr[u] = make_uint4(0, 0, 0, 0);
      vr[u] = make_uint4(0, 0, 0, 0);
      if (ok[u]) {
        const int blk = tok / bt;
        const long long off = (long long)max(trow[blk], 0) * block_stride +
                              (long long)(tok - blk * bt) * tok_stride + col;
        kr[u] = *reinterpret_cast<const uint4*>(k + off);
        vr[u] = *reinterpret_cast<const uint4*>(v + off);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[kVec], vf[kVec];
      Tr::unpack(kr[u], kf);
      Tr::unpack(vr[u], vf);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) s += qv[gi][e] * kf[e];
#pragma unroll
        for (int off = LPT / 2; off > 0; off >>= 1) {
          s += __shfl_xor_sync(0xffffffffu, s, off);
        }
        if (ok[u] && gi < g) {
          const float m_new = fmaxf(m[gi], s);
          const float alpha = expf(m[gi] - m_new);
          const float p = expf(s - m_new);
          l[gi] = l[gi] * alpha + p;
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[gi][e] = acc[gi][e] * alpha + p * vf[e];
          m[gi] = m_new;
        }
      }
    }
  }

  // merge the lane groups of the warp (lanes with the same slice)
#pragma unroll
  for (int off = LPT; off < 32; off <<= 1) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[gi], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[gi], off);
      const float m_n = fmaxf(m[gi], m_o);
      const float a = expf(m[gi] - m_n);
      const float b = expf(m_o - m_n);
      l[gi] = l[gi] * a + l_o * b;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[gi][e], off);
        acc[gi][e] = acc[gi][e] * a + acc_o * b;
      }
      m[gi] = m_n;
    }
  }
  if (seg == 0) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) sm_acc[warp][gi][sub * kVec + e] = acc[gi][e];
      if (sub == 0) {
        sm_m[warp][gi] = m[gi];
        sm_l[warp][gi] = l[gi];
      }
    }
  }
  __syncthreads();

  // merge the warps: the output itself, or this split's partial
  const long long part = ((long long)bi * hkv + hk) * args.splits + split;
  for (int idx = threadIdx.x; idx < g * D; idx += kWarps * 32) {
    const int gi = idx / D;
    const int c = idx - gi * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][gi]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w][gi] - mx);
      den += sm_l[w][gi] * f;
      num += sm_acc[w][gi][c] * f;
    }
    if (args.splits == 1) {
      static_cast<T*>(args.o)[((long long)bi * hq + hk * g + gi) * D + c] =
          Tr::from_f(num / fmaxf(den, 1e-30f));
    } else {
      args.part_acc[(part * g + gi) * D + c] = num;
      if (c == 0) {
        args.part_m[part * g + gi] = mx;
        args.part_l[part * g + gi] = den;
      }
    }
  }
}

// Merges the splits below each row's context: one block per (kv head, row),
// one thread per output element. A row of context 0 has none and gives zeros.
template <typename T>
__global__ void __launch_bounds__(kWarps * 128) paged_merge_kernel(Args args, int d) {
  const int hk = blockIdx.x;
  const int bi = blockIdx.y;
  const int g = args.hq / args.hkv;
  const int gi = threadIdx.x / d;
  const int c = threadIdx.x - gi * d;
  const int ctx = min(args.ctx_lens[bi], args.max_blocks * args.bt);
  const int n_act = ctx > 0 ? min(args.splits, (ctx + args.span - 1) / args.span) : 0;
  const long long part0 = ((long long)bi * args.hkv + hk) * args.splits;
  float mx = kNegInf;
#pragma unroll 4
  for (int s = 0; s < n_act; ++s) mx = fmaxf(mx, args.part_m[(part0 + s) * g + gi]);
  float den = 0.f, num = 0.f;
#pragma unroll 4
  for (int s = 0; s < n_act; ++s) {
    const float f = expf(args.part_m[(part0 + s) * g + gi] - mx);
    den += args.part_l[(part0 + s) * g + gi] * f;
    num += args.part_acc[((part0 + s) * g + gi) * d + c] * f;
  }
  static_cast<T*>(args.o)[((long long)bi * args.hq + hk * g + gi) * d + c] =
      Traits<T>::from_f(num / fmaxf(den, 1e-30f));
}

template <typename T, int LPT>
int launch_g(Args args, cudaStream_t stream) {
  constexpr int kPerIter = kWarps * (32 / LPT) * kUnroll;  // tokens a block reads per pass
  const int max_tokens = args.max_blocks * args.bt;
  args.span = (max_tokens + args.splits - 1) / args.splits;
  args.span = (args.span + kPerIter - 1) / kPerIter * kPerIter;
  const int g = args.hq / args.hkv;
  const dim3 grid(args.hkv, args.b, args.splits);
  if (g <= 1) paged_attention_kernel<T, LPT, 1><<<grid, kWarps * 32, 0, stream>>>(args);
  else if (g <= 2) paged_attention_kernel<T, LPT, 2><<<grid, kWarps * 32, 0, stream>>>(args);
  else if (g <= 4) paged_attention_kernel<T, LPT, 4><<<grid, kWarps * 32, 0, stream>>>(args);
  else if (g <= 8) paged_attention_kernel<T, LPT, 8><<<grid, kWarps * 32, 0, stream>>>(args);
  else return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || args.splits == 1) return static_cast<int>(err);
  constexpr int D = LPT * Traits<T>::kVec;
  paged_merge_kernel<T><<<dim3(args.hkv, args.b), g * D, 0, stream>>>(args, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Args& args, int d, cudaStream_t s) {
  constexpr int kV = Traits<T>::kVec;
  switch (d) {
    case 16: return launch_g<T, 16 / kV>(args, s);
    case 32: return launch_g<T, 32 / kV>(args, s);
    case 64: return launch_g<T, 64 / kV>(args, s);
    case 128: return launch_g<T, 128 / kV>(args, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d in {16, 32, 64, 128}; hq / hkv <= 8.
// block_stride in elements. splits > 1 cuts each row's table into that many
// spans and needs the scratch part_m, part_l (b, hkv, splits, g) and
// part_acc (b, hkv, splits, g, d), float32; with splits == 1 they may be
// null. Returns a cudaError_t.
extern "C" int paged_attention_fwd(const void* q, const void* k, const void* v,
                                   long long block_stride, const void* table,
                                   const void* ctx, void* o, void* part_m, void* part_l,
                                   void* part_acc, int dtype, int b, int hq, int hkv,
                                   int d, int bt, int max_blocks, int splits, float scale,
                                   void* stream) {
  if ((d != 16 && d != 32 && d != 64 && d != 128) || hkv <= 0 || hq % hkv != 0 ||
      hq / hkv > 8 || bt <= 0 || max_blocks <= 0 || splits <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0) return 0;
  const Args args{q, k, v, block_stride, static_cast<const int*>(table),
                  static_cast<const int*>(ctx), o, static_cast<float*>(part_m),
                  static_cast<float*>(part_l), static_cast<float*>(part_acc),
                  b, hq, hkv, bt, max_blocks, splits, 0, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(args, d, s);
  if (dtype == 1) return launch<__nv_bfloat16>(args, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
