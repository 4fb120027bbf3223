// Causal / non-causal GQA flash attention, forward only.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:
// flash_attention (pallas_call at :135). Same contract: q (b, sq, hq, d),
// k and v (b, skv, hkv, d), out (b, sq, hq, d) in the input dtype (f32 or
// bf16); scale 1/sqrt(d); online softmax with running max, sum and
// accumulator in f32; keys at kpos >= skv masked; causal mask qpos >= kpos
// aligned at position 0; tiles entirely above the diagonal are skipped, so
// no work is issued for them. Query head h reads kv head h / (hq / hkv).
//
// Bound on an H100: operations. At the main path's prefill shapes (one
// layer of Llama-3.1-8B, sq = skv = 1024, hq = 32, d = 128) the causal work
// is 4*b*hq*sq*skv*d/2 = 8.6 GFLOP, 8.7 us at 989 TFLOP/s, against 21 MB of
// q, k, v and out, 6 us at 3.35 TB/s.
//
// Design (a simple kernel that is right; no wgmma or TMA yet, so it runs on
// the f32 CUDA cores far below the tensor-core bound): one thread block per
// (q tile of 16 rows, q head, batch), four warps of four query rows each.
// K/V tiles of 32 keys are staged in shared memory (rows padded so that the
// 32 lanes, one key each, hit 32 banks); the q tile is held scaled in f32
// and read as float4 broadcasts. Each lane scores its own key against its
// warp's four rows, the warp reduces max and sum with shuffles, and P.V
// accumulates d/32 output columns per lane.

#include <cstdint>
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
