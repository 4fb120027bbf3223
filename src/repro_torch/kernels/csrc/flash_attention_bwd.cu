// Causal / non-causal GQA flash attention, backward, on the CUDA cores.
//
// Replaces no Pallas kernel: the JAX package trains through jax.grad of its
// jnp chunked flash attention (repro/models/attention.py:128-216), and its
// Pallas flash_attention (repro/kernels/flash_attention.py:135) has no
// backward. The port's forward is a CUDA kernel (flash_attention.cu), which
// autograd cannot differentiate, so its gradient is these three kernels,
// called from the torch.autograd.Function in kernels/ops.py. They compute
// what the plain version kernels/ref.py flash_attention_bwd_ref computes:
//
//   P  = exp(scale * Q K^T - lse)   recomputed from the forward's
//                                    log-sum-exp (natural log, f32)
//   D  = rowsum(dO * O)              (a) flash_bwd_delta_kernel
//   dV = P^T dO,  dS = P * (dO V^T - D),  dK = scale * dS^T Q
//                                    (b) flash_bwd_dkdv_kernel
//   dQ = scale * dS K                (c) flash_bwd_dq_kernel
//
// with the forward's contract: q, o, dO (b, sq, hq, d), k, v (b, skv, hkv,
// d), float32 or bfloat16, d a multiple of 16 up to 128; query head h reads
// kv head h / (hq / hkv); the causal mask qpos >= kpos aligned at position 0;
// f32 math, the gradients written once in the input dtype.
//
// Bound on an H100: operations. Per causal (query, key) pair the backward
// does 2.5 times the forward's 4 d multiply-adds counted as FLOPs (Q K^T,
// dO V^T, P^T dO, dS^T Q, dS K: 10 d), so at olmo-1b's training shape (b 4,
// s 2048, 16 heads of 128) a layer is 172 GFLOP: 0.17 ms at 989 TFLOP/s of
// bf16 tensor cores. This first design is a simple kernel that is right,
// on the f32 CUDA cores (67 TFLOP/s peak, 2.6 ms a layer at best; it
// recomputes Q K^T and dO V^T in both (b) and (c), 14 d a pair): a later
// redesign moves the products to the tensor cores.
//
// Design, both (b) and (c): tiles of 64 query rows by 64 keys, 256 threads
// (8 warps), every tile staged in shared memory as f32 with rows padded by
// 4 floats (the float4 reads of 8 lanes at 8 different rows then fall in 8
// different 16-byte bank groups: (d + 4) / 4 is odd). A thread holds a 8 x 2
// block of S and dP (8 rows or keys a warp apart, 2 keys or rows a lane
// apart) and a 8 x 4 block of its output (8 rows or keys, 4 columns
// 4 * lane ..), so an inner step is 64 FMAs against 6 float4 shared-memory
// reads, most of them broadcasts.
//   (b) one CTA per (batch row, kv head, kv tile), tiles numbered longest
//       first under the causal mask. It walks every q tile of every q head
//       of its GQA group that can see its keys, accumulates dK and dV in
//       registers (f32) and writes them once: no atomics, the group sum
//       inside the CTA, the same bits every run.
//   (c) one CTA per (batch row, q head, q tile), longest first, walking the
//       kv tiles up to the diagonal; dQ in registers, written once.
// Tiles wholly above the diagonal are skipped; only the diagonal tile and
// the ragged edges are masked, in both.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // query rows and keys per tile
constexpr int kPer = kTile / kWarps;  // rows (or keys) a thread owns: one a warp apart
constexpr int kMaxD = 128;
constexpr int kPad = 4;  // floats of padding after each staged row

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// four consecutive elements starting at a multiple of 4, as f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(p);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(p + 2);
  return make_float4(__low2float(a), __high2float(a), __low2float(b), __high2float(b));
}

template <typename T>
__device__ __forceinline__ void store4(T* p, float4 x, float scale) {
  p[0] = from_f<T>(x.x * scale);
  p[1] = from_f<T>(x.y * scale);
  p[2] = from_f<T>(x.z * scale);
  p[3] = from_f<T>(x.w * scale);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float4 fma4(float s, float4 x, float4 acc) {
  return make_float4(fmaf(s, x.x, acc.x), fmaf(s, x.y, acc.y), fmaf(s, x.z, acc.z),
                     fmaf(s, x.w, acc.w));
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage rows [pos0, pos0 + kTile) of head `head` of a (b, S, H, d) tensor
// into `dst` (kTile rows of ld floats); rows at or past S are zeros.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, long long bi,
                                      int pos0, int S, int H, int head, int d, int ld) {
  const int groups = d / 4;
  for (int i = threadIdx.x; i < kTile * groups; i += kThreads) {
    const int r = i / groups;
    const int c = (i - r * groups) * 4;
    const int pos = pos0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pos < S) x = load4(src + ((bi * S + pos) * H + head) * d + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = x;
  }
}

// (a) D = rowsum(dO * O) in f32, one warp per (batch row, position, q head);
// delta is (b, hq, sq).
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, long long rows, int sq, int hq, int d) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc += to_f(o[row * d + c]) * to_f(dout[row * d + c]);
  acc = warp_sum(acc);
  if (lane == 0) {
    const int h = static_cast<int>(row % hq);
    const long long bs = row / hq;  // bi * sq + pos
    const int pos = static_cast<int>(bs % sq);
    delta[(bs / sq * hq + h) * sq + pos] = acc;
  }
}

// (b) dK and dV of one kv tile of one (batch row, kv head), summed over the
// q heads of its group.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int sq, int skv, int hq,
                      int hkv, int d, int causal, float scale) {
  const int ld = d + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);  // (kTile, ld) each
  float* vs = ks + kTile * ld;
  float* qs = vs + kTile * ld;
  float* dos = qs + kTile * ld;
  float* ps = dos + kTile * ld;  // P[r][key], (kTile, kTile)
  float* dss = ps + kTile * kTile;  // dS[r][key]
  float* lse_s = dss + kTile * kTile;  // (kTile,)
  float* del_s = lse_s + kTile;

  const int hk = blockIdx.x % hkv;
  const long long bi = blockIdx.x / hkv;
  const int kv0 = blockIdx.y * kTile;  // tile 0, the longest under the mask, first
  const int group = hq / hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool has_cols = 4 * lane < d;

  stage(ks, k, bi, kv0, skv, hkv, hk, d, ld);
  stage(vs, v, bi, kv0, skv, hkv, hk, d, ld);

  // dK, dV rows: keys warp * kPer + i; columns 4 * lane .. 4 * lane + 3
  float4 dk_acc[kPer], dv_acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    dk_acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    dv_acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int n_q_tiles = (sq + kTile - 1) / kTile;
  // causal: a q tile whose last row precedes kv0 sees none of these keys
  const int qt0 = causal ? kv0 / kTile : 0;
  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    for (int qt = qt0; qt < n_q_tiles; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the last tile's readers are done (and K, V are staged)
      stage(qs, q, bi, q0, sq, hq, h, d, ld);
      stage(dos, dout, bi, q0, sq, hq, h, d, ld);
      if (threadIdx.x < kTile) {
        const int pos = q0 + threadIdx.x;
        const long long at = (bi * hq + h) * sq + pos;
        lse_s[threadIdx.x] = pos < sq ? lse[at] : 0.f;
        del_s[threadIdx.x] = pos < sq ? delta[at] : 0.f;
      }
      __syncthreads();

      // S and dP: rows warp + kWarps * i, keys lane + 32 * j
      float s[kPer][2], dp[kPer][2];
#pragma unroll
      for (int i = 0; i < kPer; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
      for (int c = 0; c < d; c += 4) {
        const float4 k0 = load4(ks + lane * ld + c), k1 = load4(ks + (lane + 32) * ld + c);
        const float4 v0 = load4(vs + lane * ld + c), v1 = load4(vs + (lane + 32) * ld + c);
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int r = warp + kWarps * i;
          const float4 qf = load4(qs + r * ld + c), of = load4(dos + r * ld + c);
          s[i][0] += dot4(qf, k0);
          s[i][1] += dot4(qf, k1);
          dp[i][0] += dot4(of, v0);
          dp[i][1] += dot4(of, v1);
        }
      }
      const bool edge = q0 + kTile > sq || kv0 + kTile > skv || (causal && kv0 + kTile - 1 > q0);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int r = warp + kWarps * i;
        const int qpos = q0 + r;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int key = lane + 32 * j;
          const int kpos = kv0 + key;
          const bool valid = !edge || (qpos < sq && kpos < skv && (!causal || qpos >= kpos));
          const float p = valid ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
          ps[r * kTile + key] = p;
          dss[r * kTile + key] = p * (dp[i][j] - del_s[r]);
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over this tile's rows
      if (has_cols) {
        const int rows = min(kTile, sq - q0);
        for (int r = 0; r < rows; ++r) {
          const float4 p0 = load4(ps + r * kTile + warp * kPer);
          const float4 p1 = load4(ps + r * kTile + warp * kPer + 4);
          const float4 s0 = load4(dss + r * kTile + warp * kPer);
          const float4 s1 = load4(dss + r * kTile + warp * kPer + 4);
          const float4 of = load4(dos + r * ld + 4 * lane);
          const float4 qf = load4(qs + r * ld + 4 * lane);
          const float pv[kPer] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
          const float sv[kPer] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            dv_acc[i] = fma4(pv[i], of, dv_acc[i]);
            dk_acc[i] = fma4(sv[i], qf, dk_acc[i]);
          }
        }
      }
    }
  }

  if (has_cols) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int kpos = kv0 + warp * kPer + i;
      if (kpos < skv) {
        const long long off = ((bi * skv + kpos) * hkv + hk) * d + 4 * lane;
        store4(dk + off, dk_acc[i], scale);
        store4(dv + off, dv_acc[i], 1.f);
      }
    }
  }
}

// (c) dQ of one q tile of one (batch row, q head).
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int sq, int skv, int hq, int hkv, int d, int causal,
                    float scale) {
  const int ld = d + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // (kTile, ld) each
  float* dos = qs + kTile * ld;
  float* ks = dos + kTile * ld;
  float* vs = ks + kTile * ld;
  float* dst = vs + kTile * ld;  // dS^T[key][r], (kTile, kTile)
  float* lse_s = dst + kTile * kTile;  // (kTile,)
  float* del_s = lse_s + kTile;

  const int h = blockIdx.x % hq;
  const long long bi = blockIdx.x / hq;
  const int n_q_tiles = (sq + kTile - 1) / kTile;
  const int q0 = (n_q_tiles - 1 - static_cast<int>(blockIdx.y)) * kTile;  // longest first
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool has_cols = 4 * lane < d;

  stage(qs, q, bi, q0, sq, hq, h, d, ld);
  stage(dos, dout, bi, q0, sq, hq, h, d, ld);
  if (threadIdx.x < kTile) {
    const int pos = q0 + threadIdx.x;
    const long long at = (bi * hq + h) * sq + pos;
    lse_s[threadIdx.x] = pos < sq ? lse[at] : 0.f;
    del_s[threadIdx.x] = pos < sq ? delta[at] : 0.f;
  }

  // dQ rows: warp * kPer + i; columns 4 * lane .. 4 * lane + 3
  float4 dq_acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) dq_acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  // causal: keys past the tile's last row are never needed
  const int kv_end = causal ? min(skv, q0 + kTile) : skv;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kTile) {
    __syncthreads();  // the last tile's readers are done (and Q, dO are staged)
    stage(ks, k, bi, kv0, skv, hkv, hk, d, ld);
    stage(vs, v, bi, kv0, skv, hkv, hk, d, ld);
    __syncthreads();

    // S and dP: keys warp + kWarps * i, rows lane + 32 * j
    float s[kPer][2], dp[kPer][2];
#pragma unroll
    for (int i = 0; i < kPer; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
    for (int c = 0; c < d; c += 4) {
      const float4 q0f = load4(qs + lane * ld + c), q1f = load4(qs + (lane + 32) * ld + c);
      const float4 o0f = load4(dos + lane * ld + c), o1f = load4(dos + (lane + 32) * ld + c);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int key = warp + kWarps * i;
        const float4 kf = load4(ks + key * ld + c), vf = load4(vs + key * ld + c);
        s[i][0] += dot4(q0f, kf);
        s[i][1] += dot4(q1f, kf);
        dp[i][0] += dot4(o0f, vf);
        dp[i][1] += dot4(o1f, vf);
      }
    }
    const bool edge = q0 + kTile > sq || kv0 + kTile > skv || (causal && kv0 + kTile - 1 > q0);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int key = warp + kWarps * i;
      const int kpos = kv0 + key;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = lane + 32 * j;
        const int qpos = q0 + r;
        const bool valid = !edge || (qpos < sq && kpos < skv && (!causal || qpos >= kpos));
        const float p = valid ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        dst[key * kTile + r] = p * (dp[i][j] - del_s[r]);
      }
    }
    __syncthreads();

    // dQ += dS K over this tile's keys
    if (has_cols) {
      const int keys = min(kTile, skv - kv0);
      for (int key = 0; key < keys; ++key) {
        const float4 d0 = load4(dst + key * kTile + warp * kPer);
        const float4 d1 = load4(dst + key * kTile + warp * kPer + 4);
        const float4 kf = load4(ks + key * ld + 4 * lane);
        const float dv[kPer] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
        for (int i = 0; i < kPer; ++i) dq_acc[i] = fma4(dv[i], kf, dq_acc[i]);
      }
    }
  }

  if (has_cols) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int qpos = q0 + warp * kPer + i;
      if (qpos < sq) store4(dq + ((bi * sq + qpos) * hq + h) * d + 4 * lane, dq_acc[i], scale);
    }
  }
}

// dynamic shared memory of (b) and (c) at head_dim d
size_t dkdv_smem(int d) {
  return (4 * kTile * (d + kPad) + 2 * kTile * kTile + 2 * kTile) * sizeof(float);
}
size_t dq_smem(int d) {
  return (4 * kTile * (d + kPad) + kTile * kTile + 2 * kTile) * sizeof(float);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o, const void* lse,
           const void* dout, void* delta, void* dq, void* dk, void* dv, int b, int sq,
           int skv, int hq, int hkv, int d, int causal, float scale, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const float* lp = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const long long rows = static_cast<long long>(b) * sq * hq;
  if (rows > 0) {
    const long long blocks = (rows + kWarps - 1) / kWarps;
    flash_bwd_delta_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const T*>(o), dop, dl, rows, sq, hq, d);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_kv_tiles = (skv + kTile - 1) / kTile;
  const int n_q_tiles = (sq + kTile - 1) / kTile;
  if (n_kv_tiles > 0) {
    const size_t smem = dkdv_smem(d);
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_bwd_dkdv_kernel<T><<<dim3(b * hkv, n_kv_tiles), kThreads, smem, stream>>>(
        qp, kp, vp, dop, lp, dl, static_cast<T*>(dk), static_cast<T*>(dv), sq, skv, hq, hkv,
        d, causal, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (n_q_tiles > 0) {
    const size_t smem = dq_smem(d);
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_bwd_dq_kernel<T><<<dim3(b * hq, n_q_tiles), kThreads, smem, stream>>>(
        qp, kp, vp, dop, lp, dl, static_cast<T*>(dq), sq, skv, hq, hkv, d, causal, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace

// Dynamic shared memory of kernel 1 (dK/dV) or 2 (dQ) at head_dim d.
extern "C" int flash_attention_bwd_smem(int kernel, int d) {
  return static_cast<int>(kernel == 1 ? dkdv_smem(d) : dq_smem(d));
}

// dtype: 0 = float32, 1 = bfloat16. q, o, dout, dq (b, sq, hq, d); k, v, dk,
// dv (b, skv, hkv, d); lse and the scratch delta (b, hq, sq) f32; all
// contiguous and 16-byte aligned (the wrapper checks). skv == 0 gives dq = 0.
// Launches (a), (b) and (c) in order on `stream`. Returns a cudaError_t.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* lse, const void* dout, void* delta, void* dq,
                                   void* dk, void* dv, int dtype, int b, int sq, int skv,
                                   int hq, int hkv, int d, int causal, float scale,
                                   void* stream) {
  if (d % 16 != 0 || d <= 0 || d > kMaxD || hkv <= 0 || hq % hkv != 0 || b < 0 || sq < 0 ||
      skv < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b == 0 || (sq == 0 && skv == 0)) return 0;
  if (skv == 0) {
    return static_cast<int>(
        cudaMemsetAsync(dq, 0, static_cast<size_t>(b) * sq * hq * d * (dtype == 0 ? 4 : 2), s));
  }
  if (dtype == 0) {
    return launch<float>(q, k, v, o, lse, dout, delta, dq, dk, dv, b, sq, skv, hq, hkv, d,
                         causal, scale, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, o, lse, dout, delta, dq, dk, dv, b, sq, skv, hq,
                                 hkv, d, causal, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
