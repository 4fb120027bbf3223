// Causal / non-causal GQA flash attention, backward, in two routes.
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
//   D  = rowsum(dO * O)              (a) flash_bwd_delta_kernel, bwd_stat_kernel
//   dV = P^T dO,  dS = P * (dO V^T - D),  dK = scale * dS^T Q
//                                    (b) flash_bwd_dkdv_kernel, bwd_dkdv_wgmma_kernel
//   dQ = scale * dS K                (c) flash_bwd_dq_kernel, bwd_dq_wgmma_kernel
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
// bf16 tensor cores. Both routes recompute Q K^T and dO V^T in (b) and (c),
// 14 d a pair, so that neither needs atomics. The wrapper
// (flash_attention.py) picks the route from dtype and head_dim alone, as
// the forward's; neither falls back on the other.
//
// Route "wgmma" (flash_attention_bwd_wgmma; bf16, d = 64, 80 or 128): the
// five products on the tensor cores, fed by TMA (namespace wgmma_route
// below). Each CTA is two consumer warpgroups of 64 rows (256 threads, at
// most 255 registers a thread, one CTA an SM); thread 0 also issues the
// loads. The TMA maps and swizzles are the forward's (d 64 / 128: boxes of
// 64 columns under the 128-byte swizzle; d 80: five boxes of 16 columns
// under the 32-byte swizzle), with boxes of 64 rows.
//   (a) bwd_stat_kernel: per row (lse * log2 e, D = rowsum(dO * O)) as a
//       float2, rows padded to a multiple of 128 with (+inf, 0), so that a
//       row past sq gets P = 0 with no mask and a tile's pairs arrive in one
//       512-byte bulk copy.
//   (b) bwd_dkdv_wgmma_kernel: one CTA per (batch row, kv head, 128 keys),
//       longest first under the causal mask; K and V stay in shared memory,
//       (q head, q tile of 64 rows) pairs stream through two stages of Q, dO
//       and their statistics on mbarriers. Per pair, each warpgroup: S^T =
//       K Q^T and dP^T = V dO^T (m64n64k16, both operands K-major in shared
//       memory); P^T = 2^(S^T scale log2 e - lse log2 e), dS^T = P^T (dP^T -
//       D) in registers; dV += P^T dO and dK += dS^T Q (P^T and dS^T as bf16
//       A fragments from registers, Q and dO MN-major). Every q head of the
//       GQA group passes through the CTA, so the group's sum stays in its
//       f32 accumulators: no atomics, the same bits every run.
//   (c) bwd_dq_wgmma_kernel: one CTA per (batch row, q head, 128 query
//       rows), longest first; Q and dO stay, kv tiles of 64 keys stream up
//       to the diagonal: S = Q K^T, dP = dO V^T, dQ += dS K (K MN-major).
//   A warpgroup skips the products of a tile that the causal mask empties
//   (a tile it did not need holds bytes it must not multiply); only the
//   diagonal tiles and the ragged key edge are masked. P and dS are rounded
//   to bf16 for the second products, so the result is not bit-equal to the
//   plain version (within the bf16 tolerance, FLASH_TOL in chip_smoke.py).
//   The dK/dV kernel holds dK, dV (d/2 each), S^T and dP^T (32 each) in
//   f32 registers: 246 registers at d 128, no spill.
//
// Route "cuda_cores" (flash_attention_bwd; f32, or bf16 at any multiple of
// 16 up to 128): the first design, a simple kernel that is right, on the f32
// CUDA cores (67 TFLOP/s peak, 2.6 ms a layer at best at olmo-1b's shape).
//
// Design of the cuda_cores route, both (b) and (c): tiles of 64 query rows by 64 keys, 256 threads
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

#include "hopper_common.cuh"

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

// ---------------------------------------------------------------------------
// Route "wgmma": bf16, d = 64, 80 or 128, tensor cores fed by TMA.
// ---------------------------------------------------------------------------

namespace wgmma_route {

using namespace hopper;

constexpr int kThreads = 256;  // two consumer warpgroups; thread 0 also issues the loads
constexpr int kM = 64;  // rows one warpgroup owns: wgmma's M
constexpr int kBlk = 2 * kM;  // keys (dK/dV) or query rows (dQ) of one CTA
constexpr int kStream = 64;  // rows of a streamed tile: query rows (dK/dV) or keys (dQ)
constexpr int kStages = 2;  // streamed tiles in flight
constexpr int kBoxRows = 64;  // rows of one TMA box
constexpr int kStatPad = kBlk;  // the row statistics are padded to a multiple of this
constexpr float kLog2e = 1.4426950408889634f;

// A tile of R rows of one head as TMA boxes, column box by column box. d 64
// and 128: boxes of 64 columns (128 B rows) under the 128-byte swizzle; d
// 80: five boxes of 16 columns (32 B rows) under the 32-byte swizzle (the
// forward's layouts, flash_attention.cu). A box holds kBoxRows rows, so a
// column of R rows is R / kBoxRows boxes stacked, which lie as one box of R
// rows would: the swizzle repeats every 8 rows.
template <int D, int R>
struct Tile {
  static constexpr bool kWide = D % 64 == 0;
  static constexpr int kBoxCols = kWide ? 64 : 16;
  static constexpr int kRowBytes = kBoxCols * 2;
  static constexpr int kCols = D / kBoxCols;
  static constexpr int kColBytes = R * kRowBytes;  // one column box over all R rows
  static constexpr int kBytes = kCols * kColBytes;
  static constexpr int kGroupBytes = 8 * kRowBytes;  // an 8-row core group
  static constexpr uint64_t kLayout = kWide ? 1 : 3;  // descriptor: 128-byte or 32-byte swizzle
  static_assert(R % kBoxRows == 0 && kBytes % 1024 == 0, "tiles keep 1024-byte alignment");
};

// dK/dV CTA: K and V (kBlk rows) resident; kStages stages of Q, dO
// (kStream rows) and the rows' (lse * log2 e, D) pairs. Byte offsets from a
// 1024-aligned base.
template <int D>
struct DkdvSmem {
  static constexpr int kBig = Tile<D, kBlk>::kBytes, kSmall = Tile<D, kStream>::kBytes;
  static constexpr int kStat = kStream * 8;
  static constexpr int kK = 0, kV = kBig;
  static constexpr int kQ = 2 * kBig;  // + stage * kSmall
  static constexpr int kDo = kQ + kStages * kSmall;
  static constexpr int kSt = kDo + kStages * kSmall;  // + stage * kStat
  static constexpr int kBar = kSt + kStages * kStat;  // kv_full, full[stages], empty[stages]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
};

// dQ CTA: Q and dO (kBlk rows) resident; kStages stages of K and V (kStream rows).
template <int D>
struct DqSmem {
  static constexpr int kBig = Tile<D, kBlk>::kBytes, kSmall = Tile<D, kStream>::kBytes;
  static constexpr int kQ = 0, kDo = kBig;
  static constexpr int kK = 2 * kBig;  // + stage * kSmall
  static constexpr int kV = kK + kStages * kSmall;
  static constexpr int kBar = kV + kStages * kSmall;  // q_full, full[stages], empty[stages]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// a contiguous copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar) : "memory");
}

// R rows of head `head` from sequence position pos0 of batch row bi, every
// column box, into the tile at dst; rows past the sequence arrive as zeros.
template <int D, int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int head, int pos0, int bi) {
  using T = Tile<D, R>;
#pragma unroll
  for (int c = 0; c < T::kCols; ++c) {
#pragma unroll
    for (int rb = 0; rb < R / kBoxRows; ++rb) {
      tma_load(dst + c * T::kColBytes + rb * kBoxRows * T::kRowBytes, map, bar,
               c * T::kBoxCols, head, pos0 + rb * kBoxRows, bi);
    }
  }
}

// K-major (the head dim is the product's K): 8-row groups kGroupBytes
// apart; a k16 step lies inside one swizzle row, so the leading offset is
// not read. kstep_off is where step kk (columns 16 kk ..) starts.
template <int D, int R>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  using T = Tile<D, R>;
  return smem_desc(addr, T::kWide ? 0 : 16, T::kGroupBytes, T::kLayout);
}
template <int D, int R>
__device__ __forceinline__ uint32_t kstep_off(int kk) {
  using T = Tile<D, R>;
  return (kk * 16 / T::kBoxCols) * T::kColBytes + (kk * 16 % T::kBoxCols) * 2;
}
// MN-major (the tile's rows are the product's K, the head dim its N): a k16
// step is two 8-row groups kGroupBytes apart (the stride offset). d 64 / 128
// take one 64-column swizzle atom per instruction; d 80 spans its five
// 16-column boxes, kColBytes apart (the leading offset).
template <int D, int R>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  using T = Tile<D, R>;
  return smem_desc(addr, T::kWide ? T::kGroupBytes : T::kColBytes, T::kGroupBytes, T::kLayout);
}

// a use of every A fragment after the wait, so that no register an
// in-flight product reads is reused before it completes
__device__ __forceinline__ void keep_regs(const uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    asm volatile("" ::"r"(a[kk][0]), "r"(a[kk][1]), "r"(a[kk][2]), "r"(a[kk][3]) : "memory");
  }
}

// C (64 x 64 f32) (+)= A (64 x 16, smem) . B^T (B: 64 x 16, smem), both
// K-major. The first k-step (kAcc false) writes C without reading it.
#define BWD_SS_ASM                                                                 \
  "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"                                   \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "         \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
  "%32, %33, p, 1, 1, 0, 0;\n}\n"
#define BWD_SS_REGS(c) \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]), \
  c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15]), c(d[16]), \
  c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]), \
  c(d[25]), c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31])

template <bool kAcc>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  if constexpr (kAcc) {
    asm volatile(BWD_SS_ASM : BWD_SS_REGS("+f") : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(BWD_SS_ASM : BWD_SS_REGS("=f") : "l"(da), "l"(db), "r"(0));
  }
}
#undef BWD_SS_REGS
#undef BWD_SS_ASM

// C (64 x 64 f32) += A (64 x 16, registers) . B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs64(float* d, const uint32_t (&a)[4], uint64_t db) {
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

// C (64 x 80 f32) += A (64 x 16, registers) . B (16 x 80, smem, MN-major)
__device__ __forceinline__ void wgmma_rs80(float* d, const uint32_t (&a)[4], uint64_t db) {
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

// C (64 x D) += A (64 x 64: four k16 fragments in registers) . B (64 x D,
// the streamed tile at `tile`, MN-major): d 64 / 128 one n64 product per
// 64-column box, d 80 one n80 product over its five boxes, per k16 step.
template <int D>
__device__ __forceinline__ void wgmma_rs_tile(float* c, const uint32_t (&a)[4][4],
                                              uint32_t tile) {
  using T = Tile<D, kStream>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t rows = tile + kk * 16 * T::kRowBytes;
    if constexpr (T::kWide) {
#pragma unroll
      for (int cb = 0; cb < T::kCols; ++cb) {
        wgmma_rs64(c + 32 * cb, a[kk], mnmajor_desc<D, kStream>(rows + cb * T::kColBytes));
      }
    } else {
      wgmma_rs80(c, a[kk], mnmajor_desc<D, kStream>(rows));
    }
  }
}

// C (64 x 64) = A (64 rows of a kBlk tile from `slab`, K-major) . B^T (B: the
// kStream-row tile at `tile`, K-major), over the head dim
template <int D>
__device__ __forceinline__ void wgmma_ss_tile(float (&c)[32], uint32_t slab, uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = kmajor_desc<D, kBlk>(slab + kstep_off<D, kBlk>(kk));
    const uint64_t db = kmajor_desc<D, kStream>(tile + kstep_off<D, kStream>(kk));
    if (kk == 0) {
      wgmma_ss<false>(c, da, db);
    } else {
      wgmma_ss<true>(c, da, db);
    }
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

// the A fragments of four k16 steps from a 64 x 64 accumulator: step kk is
// accumulator groups 2kk and 2kk + 1
__device__ __forceinline__ void pack_frags(const float (&c)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(c[8 * kk + 2 * r], c[8 * kk + 2 * r + 1]);
  }
}

// rows `row` and `row + 8` of a 64 x D accumulator (c[4J + 2h + e]: row
// row + 8h, column 8J + 2t + e) times `scale`, as bf16, rows past `limit` skipped
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float* c, int row,
                                           int limit, long long row_stride, int t,
                                           float scale) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row + 8 * h < limit) {
      __nv_bfloat16* dst = out + (row + 8 * h) * row_stride;
#pragma unroll
      for (int J = 0; J < D / 8; ++J) {
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * J + 2 * t) =
            __floats2bfloat162_rn(c[4 * J + 2 * h] * scale, c[4 * J + 2 * h + 1] * scale);
      }
    }
  }
}

// (a) The rows' statistics, (b, hq, sq_pad) float2: (lse * log2 e, D =
// rowsum(dO * O)); rows sq .. sq_pad - 1 get (+inf, 0), so that their P is
// 0 with no mask. One warp per row.
__global__ void __launch_bounds__(256)
bwd_stat_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, float2* __restrict__ stat, long long rows,
                int sq, int sq_pad, int hq, int d) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int pos = static_cast<int>(row % sq_pad);
  const long long bh = row / sq_pad;  // bi * hq + h
  if (pos >= sq) {
    if (lane == 0) stat[row] = make_float2(__int_as_float(0x7f800000), 0.f);
    return;
  }
  const long long at = ((bh / hq * sq + pos) * hq + bh % hq) * d;
  float acc = 0.f;
  for (int c = 2 * lane; c < d; c += 64) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + at + c));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + at + c));
    acc = fmaf(a.x, b.x, fmaf(a.y, b.y, acc));
  }
  acc = warp_sum(acc);
  if (lane == 0) stat[row] = make_float2(lse[bh * sq + pos] * kLog2e, acc);
}

// dK/dV: the loads of streamed pair i (q head h, query rows q0 ..) into
// stage i % kStages: Q, dO and the rows' statistics
template <int D>
__device__ __forceinline__ void dkdv_issue(uint32_t base, uint32_t full, const CUtensorMap* tq,
                                           const CUtensorMap* tdo, const float2* stat, int i,
                                           int h, int q0, int bi, int hq, int sq_pad) {
  using S = DkdvSmem<D>;
  using TS = Tile<D, kStream>;
  const int st = i % kStages;
  const uint32_t bar = full + 8 * st;
  mbar_expect_tx(bar, 2 * TS::kBytes + S::kStat);
  load_tile<D, kStream>(base + S::kQ + st * TS::kBytes, tq, bar, h, q0, bi);
  load_tile<D, kStream>(base + S::kDo + st * TS::kBytes, tdo, bar, h, q0, bi);
  bulk_load(base + S::kSt + st * S::kStat,
            stat + (static_cast<long long>(bi) * hq + h) * sq_pad + q0, S::kStat, bar);
}

// dQ: kv tile j (kv head hk) into stage j % kStages: K and V
template <int D>
__device__ __forceinline__ void dq_issue(uint32_t base, uint32_t full, const CUtensorMap* tk,
                                         const CUtensorMap* tv, int j, int hk, int bi) {
  using S = DqSmem<D>;
  using TS = Tile<D, kStream>;
  const int st = j % kStages;
  const uint32_t bar = full + 8 * st;
  mbar_expect_tx(bar, 2 * TS::kBytes);
  load_tile<D, kStream>(base + S::kK + st * TS::kBytes, tk, bar, hk, j * kStream, bi);
  load_tile<D, kStream>(base + S::kV + st * TS::kBytes, tv, bar, hk, j * kStream, bi);
}

// (b) dK and dV of kBlk keys of one (batch row, kv head), summed over the q
// heads of its group: warpgroup wg owns keys kv0 + 64 wg ..
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                      const float2* __restrict__ stat, __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int sq, int skv, int hq, int hkv,
                      int sq_pad, int causal, float scale, float scale_log2) {
  using S = DkdvSmem<D>;
  using TB = Tile<D, kBlk>;
  using TS = Tile<D, kStream>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_full = base + S::kBar, full = kv_full + 8, empty = full + 8 * kStages;
  const int hk = blockIdx.x % hkv;
  const int bi = blockIdx.x / hkv;
  const int kv0 = blockIdx.y * kBlk;  // tile 0, the longest under the mask, first
  const int group = hq / hkv;
  // causal: a q tile whose last row precedes kv0 sees none of these keys
  const int qt0 = causal ? kv0 / kStream : 0;
  const int per_head = max((sq + kStream - 1) / kStream - qt0, 0);
  const int n = group * per_head;  // streamed (q head, q tile) pairs

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kThreads);  // every thread releases each stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x == 0 && n > 0) {
    mbar_expect_tx(kv_full, 2 * TB::kBytes);
    load_tile<D, kBlk>(base + S::kK, &tk, kv_full, hk, kv0, bi);
    load_tile<D, kBlk>(base + S::kV, &tv, kv_full, hk, kv0, bi);
    for (int i = 0; i < n && i < kStages; ++i) {
      dkdv_issue<D>(base, full, &tq, &tdo, stat, i, hk * group + i / per_head,
                    (qt0 + i % per_head) * kStream, bi, hq, sq_pad);
    }
  }
  __syncwarp();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int key_lo = kv0 + wg * kM;  // this warpgroup's first key
  const int key = key_lo + warp * 16 + g;  // this thread's keys: key and key + 8
  const uint32_t k_slab = base + S::kK + wg * kM * TB::kRowBytes;
  const uint32_t v_slab = base + S::kV + wg * kM * TB::kRowBytes;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  if (n > 0) mbar_wait(kv_full, 0);
  for (int i = 0; i < n; ++i) {
    const int st = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const int q0 = (qt0 + i % per_head) * kStream;
    const uint32_t q_tile = base + S::kQ + st * TS::kBytes;
    const uint32_t do_tile = base + S::kDo + st * TS::kBytes;
    mbar_wait(full + 8 * st, parity);
    // causal: every row of the tile precedes every key of this warpgroup, so
    // its products are skipped (not run on a tile and zeroed)
    if (!(causal && q0 + kStream - 1 < key_lo)) {
      float s[32], dp[32];
      wgmma_fence();
      wgmma_ss_tile<D>(s, k_slab, q_tile);  // S^T = K Q^T
      wgmma_ss_tile<D>(dp, v_slab, do_tile);  // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait0();
      fence_regs<32>(s);
      fence_regs<32>(dp);
      // s[4j + e]: key `key` + 8 (e >> 1), q row q0 + 8j + 2t + (e & 1)
      const float2* st_s = reinterpret_cast<const float2*>(
          smem_raw + (base + S::kSt + st * S::kStat - smem_u32(smem_raw)));
      const bool diag = causal && q0 < key_lo + kM - 1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int c = 8 * j + 2 * t + e1;
          const float2 ld = st_s[c];
#pragma unroll
          for (int e0 = 0; e0 < 2; ++e0) {
            const int x = 4 * j + 2 * e0 + e1;
            float p = ex2(fmaf(s[x], scale_log2, -ld.x));
            if (diag && q0 + c < key + 8 * e0) p = 0.f;
            s[x] = p;
            dp[x] = p * (dp[x] - ld.y);
          }
        }
      }
      uint32_t pa[4][4], da[4][4];
      pack_frags(s, pa);
      pack_frags(dp, da);
      wgmma_fence();
      wgmma_rs_tile<D>(dv_acc, pa, do_tile);  // dV += P^T dO
      wgmma_rs_tile<D>(dk_acc, da, q_tile);  // dK += dS^T Q
      wgmma_commit();
      wgmma_wait0();
      fence_regs<D / 2>(dv_acc);
      fence_regs<D / 2>(dk_acc);
      keep_regs(pa);
      keep_regs(da);
    }
    mbar_arrive(empty + 8 * st);
    if (threadIdx.x == 0 && i + kStages < n) {
      mbar_wait(empty + 8 * st, parity);  // both warpgroups are done with the stage
      const int nx = i + kStages;
      dkdv_issue<D>(base, full, &tq, &tdo, stat, nx, hk * group + nx / per_head,
                    (qt0 + nx % per_head) * kStream, bi, hq, sq_pad);
    }
    __syncwarp();
  }

  const long long stride = static_cast<long long>(hkv) * D;
  const long long off = (static_cast<long long>(bi) * skv * hkv + hk) * D;
  store_rows<D>(dk + off, dk_acc, key, skv, stride, t, scale);
  store_rows<D>(dv + off, dv_acc, key, skv, stride, t, 1.f);
}

// (c) dQ of kBlk query rows of one (batch row, q head): warpgroup wg owns
// rows q0 + 64 wg ..; the kv tiles stream up to the diagonal.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const float2* __restrict__ stat, __nv_bfloat16* __restrict__ dq, int sq,
                    int skv, int hq, int hkv, int sq_pad, int causal, float scale,
                    float scale_log2) {
  using S = DqSmem<D>;
  using TB = Tile<D, kBlk>;
  using TS = Tile<D, kStream>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + S::kBar, full = q_full + 8, empty = full + 8 * kStages;
  const int h = blockIdx.x % hq;
  const int bi = blockIdx.x / hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlk;  // longest first
  const int hk = h / (hq / hkv);
  const int n_kv_all = (skv + kStream - 1) / kStream;
  // causal: keys past the tile's last row are never needed
  const int n = causal ? min(n_kv_all, (q0 + kBlk - 1) / kStream + 1) : n_kv_all;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, 2 * TB::kBytes);
    load_tile<D, kBlk>(base + S::kQ, &tq, q_full, h, q0, bi);
    load_tile<D, kBlk>(base + S::kDo, &tdo, q_full, h, q0, bi);
    for (int j = 0; j < n && j < kStages; ++j) dq_issue<D>(base, full, &tk, &tv, j, hk, bi);
  }
  __syncwarp();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int q_lo = q0 + wg * kM;  // this warpgroup's first row
  const int row = q_lo + warp * 16 + g;  // this thread's rows: row and row + 8
  const uint32_t q_slab = base + S::kQ + wg * kM * TB::kRowBytes;
  const uint32_t do_slab = base + S::kDo + wg * kM * TB::kRowBytes;
  const float2* st_g = stat + (static_cast<long long>(bi) * hq + h) * sq_pad;
  const float2 ld[2] = {st_g[row], st_g[row + 8]};  // rows < sq_pad: padded to kBlk
  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int j = 0; j < n; ++j) {
    const int st = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const int kv0 = j * kStream;
    const uint32_t k_tile = base + S::kK + st * TS::kBytes;
    const uint32_t v_tile = base + S::kV + st * TS::kBytes;
    mbar_wait(full + 8 * st, parity);
    // causal: every key of the tile follows every row of this warpgroup
    if (!(causal && kv0 > q_lo + kM - 1)) {
      float s[32], dp[32];
      wgmma_fence();
      wgmma_ss_tile<D>(s, q_slab, k_tile);  // S = Q K^T
      wgmma_ss_tile<D>(dp, do_slab, v_tile);  // dP = dO V^T
      wgmma_commit();
      wgmma_wait0();
      fence_regs<32>(s);
      fence_regs<32>(dp);
      // s[4j' + e]: row `row` + 8 (e >> 1), key kv0 + 8j' + 2t + (e & 1)
      const bool edge = kv0 + kStream > skv || (causal && kv0 + kStream - 1 > q_lo);
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int hh = (x / 2) % 2;
        float p = ex2(fmaf(s[x], scale_log2, -ld[hh].x));
        if (edge) {
          const int kp = kv0 + 8 * (x / 4) + 2 * t + (x % 2);
          if (kp >= skv || (causal && kp > row + 8 * hh)) p = 0.f;
        }
        dp[x] = p * (dp[x] - ld[hh].y);
      }
      uint32_t da[4][4];
      pack_frags(dp, da);
      wgmma_fence();
      wgmma_rs_tile<D>(dq_acc, da, k_tile);  // dQ += dS K
      wgmma_commit();
      wgmma_wait0();
      fence_regs<D / 2>(dq_acc);
      keep_regs(da);
    }
    mbar_arrive(empty + 8 * st);
    if (threadIdx.x == 0 && j + kStages < n) {
      mbar_wait(empty + 8 * st, parity);  // both warpgroups are done with the stage
      dq_issue<D>(base, full, &tk, &tv, j + kStages, hk, bi);
    }
    __syncwarp();
  }

  const long long stride = static_cast<long long>(hq) * D;
  store_rows<D>(dq + (static_cast<long long>(bi) * sq * hq + h) * D, dq_acc, row, sq, stride, t,
                scale);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* lse,
           const void* dout, void* stat, void* dq, void* dk, void* dv, const uint64_t* q_dims,
           const uint64_t* q_strides, const uint64_t* kv_dims, const uint64_t* kv_strides,
           const uint32_t* box, int b, int sq, int skv, int hq, int hkv, int sq_pad,
           int causal, float scale, cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return kNoEncoder;
  const CUtensorMapSwizzle swz =
      Tile<D, kBlk>::kWide ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap tq, tk, tv, tdo;
  int rc = encode(enc, &tq, q, q_dims, q_strides, box, swz);
  if (rc == 0) rc = encode(enc, &tdo, dout, q_dims, q_strides, box, swz);
  if (rc == 0) rc = encode(enc, &tk, k, kv_dims, kv_strides, box, swz);
  if (rc == 0) rc = encode(enc, &tv, v, kv_dims, kv_strides, box, swz);
  if (rc != 0) return rc;
  float2* st = static_cast<float2*>(stat);
  const long long rows = static_cast<long long>(b) * hq * sq_pad;
  bwd_stat_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), st, rows, sq, sq_pad, hq, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const float scale_log2 = scale * kLog2e;
  e = cudaFuncSetAttribute(bwd_dkdv_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           DkdvSmem<D>::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_dkdv_wgmma_kernel<D><<<dim3(b * hkv, (skv + kBlk - 1) / kBlk), kThreads,
                             DkdvSmem<D>::kBytes, stream>>>(
      tq, tk, tv, tdo, st, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      sq, skv, hq, hkv, sq_pad, causal, scale, scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(bwd_dq_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           DqSmem<D>::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_dq_wgmma_kernel<D><<<dim3(b * hq, (sq + kBlk - 1) / kBlk), kThreads, DqSmem<D>::kBytes,
                           stream>>>(tq, tk, tv, tdo, st, static_cast<__nv_bfloat16*>(dq), sq,
                                     skv, hq, hkv, sq_pad, causal, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgmma_route

// Dynamic shared memory of the wgmma route's kernel 1 (dK/dV) or 2 (dQ) at
// head_dim d (0 if the route does not take d).
extern "C" int flash_attention_bwd_wgmma_smem(int kernel, int d) {
  namespace w = wgmma_route;
  switch (d) {
    case 64: return kernel == 1 ? w::DkdvSmem<64>::kBytes : w::DqSmem<64>::kBytes;
    case 80: return kernel == 1 ? w::DkdvSmem<80>::kBytes : w::DqSmem<80>::kBytes;
    case 128: return kernel == 1 ? w::DkdvSmem<128>::kBytes : w::DqSmem<128>::kBytes;
    default: return 0;
  }
}

// The wgmma route: bf16 only, d = 64, 80 or 128, 16-byte aligned bases (the
// wrapper checks). The tensor-map arguments (dims d, h, s, b; byte strides
// of h, s, b; the box of 64 rows) come from flash_attention.py's
// bwd_tensor_map_args and are checked against the kernels' tiles here.
// stat: scratch of (b, hq, sq_pad) float2, sq_pad a multiple of 128 and at
// least sq. Launches (a), (b) and (c) in order on `stream`. Returns a
// cudaError_t, 9999 if libcuda has no cuTensorMapEncodeTiled, or 10000 + its
// CUresult if it refuses a map.
extern "C" int flash_attention_bwd_wgmma(const void* q, const void* k, const void* v,
                                         const void* o, const void* lse, const void* dout,
                                         void* stat, void* dq, void* dk, void* dv,
                                         const uint64_t* q_dims, const uint64_t* q_strides,
                                         const uint64_t* kv_dims, const uint64_t* kv_strides,
                                         const uint32_t* box, int b, int sq, int skv, int hq,
                                         int hkv, int d, int sq_pad, int causal, float scale,
                                         void* stream) {
  namespace w = wgmma_route;
  const int box_cols = d == 64 ? w::Tile<64, w::kBlk>::kBoxCols
                       : d == 80 ? w::Tile<80, w::kBlk>::kBoxCols
                       : d == 128 ? w::Tile<128, w::kBlk>::kBoxCols : 0;
  if (box_cols == 0 || hkv <= 0 || hq % hkv != 0 || b < 0 || sq < 0 || skv < 0 ||
      sq_pad < sq || sq_pad % w::kStatPad != 0 ||
      box[0] != static_cast<uint32_t>(box_cols) || box[1] != 1 || box[2] != w::kBoxRows ||
      box[3] != 1 || q_dims[0] != static_cast<uint64_t>(d) ||
      kv_dims[0] != static_cast<uint64_t>(d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b == 0 || (sq == 0 && skv == 0)) return 0;
  if (skv == 0) {
    return static_cast<int>(cudaMemsetAsync(dq, 0, static_cast<size_t>(b) * sq * hq * d * 2, s));
  }
  if (sq == 0) {  // no query rows: the gradients of K and V are zero
    const size_t bytes = static_cast<size_t>(b) * skv * hkv * d * 2;
    cudaError_t e = cudaMemsetAsync(dk, 0, bytes, s);
    if (e == cudaSuccess) e = cudaMemsetAsync(dv, 0, bytes, s);
    return static_cast<int>(e);
  }
  switch (d) {
    case 64:
      return w::launch<64>(q, k, v, o, lse, dout, stat, dq, dk, dv, q_dims, q_strides, kv_dims,
                           kv_strides, box, b, sq, skv, hq, hkv, sq_pad, causal, scale, s);
    case 80:
      return w::launch<80>(q, k, v, o, lse, dout, stat, dq, dk, dv, q_dims, q_strides, kv_dims,
                           kv_strides, box, b, sq, skv, hq, hkv, sq_pad, causal, scale, s);
    default:
      return w::launch<128>(q, k, v, o, lse, dout, stat, dq, dk, dv, q_dims, q_strides, kv_dims,
                            kv_strides, box, b, sq, skv, hq, hkv, sq_pad, causal, scale, s);
  }
}
