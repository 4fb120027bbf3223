// KV gather-write / scatter-read between per-layer caches and pool blocks,
// and the sparse gather of token rows.
//
// Replaces the Pallas TPU kernels repro/kernels/kv_transfer.py:
// kv_gather_write (pallas_call at :76), kv_scatter_read (:132) and
// sparse_kv_gather (:172; the sparse gather's notes are at its kernel below).
//
// Layouts (all contiguous):
//   caches  k, v : (L, n_slots * bt, hkv, hd)
//   blocks       : (n_blocks, 2L, bt, hkv, hd), fragments [k0, v0, k1, v1, ...]
// One (block, layer, k|v) fragment is a contiguous run of bt*hkv*hd elements
// on both sides: in the cache it is slot `slot_ids[b]` of layer l, i.e. run
// number (l * n_slots + slot) of frag elements.
//
// Bound on an H100: pure data movement, so bytes. Each fragment is read
// once and written once; the least time is (bytes read + bytes written) /
// 3.35 TB/s. The design: ONE launch for every fragment of every block (the
// paper's §6.1 fused copy, no per-fragment request list), one thread block
// per fragment, 16-byte vector loads and stores with neighbouring threads on
// neighbouring addresses. The copy is dtype-blind: the wrapper passes the
// fragment size in 16-byte units and checks that it divides evenly.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// dir == 0: gather (caches -> blocks); dir == 1: scatter (blocks -> caches)
template <int dir>
__global__ void kv_copy_kernel(uint4* __restrict__ k, uint4* __restrict__ v,
                               uint4* __restrict__ blocks,
                               const int32_t* __restrict__ slot_ids,
                               int n_frags, int two_l, int n_slots,
                               long long frag_vec) {
  for (int f = blockIdx.x; f < n_frags; f += gridDim.x) {
    const int b = f / two_l;
    const int r = f - b * two_l;
    const int layer = r >> 1;
    uint4* cache = (r & 1) ? v : k;
    uint4* c = cache + ((long long)layer * n_slots + slot_ids[b]) * frag_vec;
    uint4* p = blocks + (long long)f * frag_vec;
    for (long long i = threadIdx.x; i < frag_vec; i += kThreads) {
      if (dir == 0) {
        p[i] = c[i];
      } else {
        c[i] = p[i];
      }
    }
  }
}

int launch(int dir, void* k, void* v, void* blocks, const void* slot_ids,
           int n_blocks, int n_layers, int n_slots, long long frag_vec,
           void* stream) {
  const int n_frags = n_blocks * 2 * n_layers;
  if (n_frags == 0) return 0;
  const int grid = n_frags < 65535 * 8 ? n_frags : 65535 * 8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dir == 0) {
    kv_copy_kernel<0><<<grid, kThreads, 0, s>>>(
        static_cast<uint4*>(k), static_cast<uint4*>(v),
        static_cast<uint4*>(blocks), static_cast<const int32_t*>(slot_ids),
        n_frags, 2 * n_layers, n_slots, frag_vec);
  } else {
    kv_copy_kernel<1><<<grid, kThreads, 0, s>>>(
        static_cast<uint4*>(k), static_cast<uint4*>(v),
        static_cast<uint4*>(blocks), static_cast<const int32_t*>(slot_ids),
        n_frags, 2 * n_layers, n_slots, frag_vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// Sparse gather: out[i] = kv[ids[i]] for n_sel rows ("pieces") of w units
// of V (uint4 when a row is a multiple of 16 bytes and both bases are
// 16-byte aligned, else the element itself, 2 or 4 bytes). The contract is
// the JAX oracle's jnp.take, not the Pallas kernel's (which clamps): an id
// in [-N, 0) wraps to id + N; any other id out of [0, N) writes the dtype's
// quiet NaN, `nan` replicated over V. The ids are checked here, on the
// card, so the wrapper never syncs to look at them.
//
// Bound on an H100: bytes, n_sel rows read and written once; at exp10's
// shapes (8,192 pieces of 256 B, 16,384 of 160 B) that is 1.25-1.57 us,
// below a launch's own latency. What is left to a kernel is latency: the
// launch, then two dependent round trips (the id, then the piece) and the
// stores draining. On an H100 (sparse_probe) an empty kernel takes 1.8-1.9
// us on 132 CTAs and about 0.5 ns more per further CTA; the round trips
// and the stores take about 1.9 us of Llama's read in every design tried.
// So the design keeps one round trip of each for every piece, in ONE launch
// of at most one resident wave, with few CTAs, each with work for every
// lane:
//  - the grid gives every lane one unit, ceil(units / kSparseThreads)
//    CTAs, capped at the wave the card holds (the wrapper reads SMs x
//    resident CTAs once per device and width) and at one CTA a piece;
//    CTA c takes the contiguous pieces [c*q + min(c, r), +q + (c<r)) of
//    q, r = divmod(n_sel, grid), divided on the host, balanced to within
//    one piece. A grid of one full wave, most of its lanes idle, read
//    slower: its extra CTAs cost more launch than they save;
//  - neighbouring lanes copy neighbouring units of the CTA's contiguous
//    output; a lane loads its unit's id itself, one request per warp for
//    the two or three pieces its 32 units touch. Staging the ids once per
//    CTA in shared memory behind a barrier, or once per warp handed out by
//    shuffle, read slower (sparse_probe's `staged`, `warp_ids`);
//  - a lane with more than one unit (a read larger than a wave) issues up
//    to kSparseUnits loads (ld.global.nc, unrolled into registers) before
//    any store;
//  - offsets are 32-bit units (the wrapper refuses views past 2^31 units);
//    only the final address is 64-bit. The row width is a template case
//    (kW) for the widths the paths use, so the unit -> (piece, column)
//    split is a multiply, not a division: 0.10-0.13 us faster than the
//    generic case at each of phase 6's three reads on an H100
//    (sparse_probe's `generic_width`); kW == 0 takes any width.
// Nothing is allocated and the grid depends on shapes and the device only,
// so a call can be captured in a CUDA graph and replayed with new ids in
// place.
constexpr int kSparseThreads = 128;
constexpr int kSparseUnits = 2;  // units a lane holds in flight

template <typename V, int kW>
__global__ void __launch_bounds__(kSparseThreads)
    sparse_gather_kernel(const V* __restrict__ kv, V* __restrict__ out,
                         const int32_t* __restrict__ ids, int q, int r, int n_rows,
                         int row_units, V nan) {
  const unsigned w = kW > 0 ? kW : row_units;
  const int tid = threadIdx.x;
  const int c = blockIdx.x;
  const int first = c * q + min(c, r);
  const unsigned units = static_cast<unsigned>(q + (c < r ? 1 : 0)) * w;
  const int32_t* cids = ids + first;
  V* o = out + static_cast<size_t>(first) * w;
  for (unsigned u0 = 0; u0 < units; u0 += kSparseThreads * kSparseUnits) {
    V v[kSparseUnits];
#pragma unroll
    for (int k = 0; k < kSparseUnits; ++k) {
      const unsigned u = u0 + k * kSparseThreads + tid;
      v[k] = nan;
      if (u < units) {
        const unsigned p = u / w;
        int row = __ldg(cids + p);
        if (row < 0) row += n_rows;
        if (static_cast<unsigned>(row) < static_cast<unsigned>(n_rows))
          v[k] = __ldg(kv + (static_cast<unsigned>(row) * w + (u - p * w)));
      }
    }
#pragma unroll
    for (int k = 0; k < kSparseUnits; ++k) {
      const unsigned u = u0 + k * kSparseThreads + tid;
      if (u < units) o[u] = v[k];
    }
  }
}

// Calls f(kernel, nan) with the instantiation that takes (unit_bytes,
// row_units) and the dtype's NaN as its unit type V: the widths of the
// paths (Llama-3.1-8B's 256-B pieces, qwen3-32b's 160-B pieces and its
// (8, 80) bf16 top-k rows) have their own case, any other width kW == 0.
template <typename F>
int with_sparse_kernel(int unit_bytes, int row_units, unsigned int nan_bits, F f) {
  switch (unit_bytes) {
    case 16: {
      const uint4 nan = make_uint4(nan_bits, nan_bits, nan_bits, nan_bits);
      switch (row_units) {
        case 16:
          return f(sparse_gather_kernel<uint4, 16>, nan);
        case 10:
          return f(sparse_gather_kernel<uint4, 10>, nan);
        case 80:
          return f(sparse_gather_kernel<uint4, 80>, nan);
        default:
          return f(sparse_gather_kernel<uint4, 0>, nan);
      }
    }
    case 4:
      return f(sparse_gather_kernel<uint32_t, 0>, static_cast<uint32_t>(nan_bits));
    case 2:
      return f(sparse_gather_kernel<uint16_t, 0>, static_cast<uint16_t>(nan_bits));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// unit_bytes: 16 (row_units uint4 per row), 4 or 2 (row_units elements);
// nan_bits: the dtype's quiet NaN, replicated to fill a 4-byte word; grid:
// the wrapper's, at most SMs x sparse_kv_gather_ctas_per_sm and n_sel.
extern "C" int sparse_kv_gather(const void* kv, void* out, const void* ids,
                                int n_sel, int n_rows, int row_units,
                                int unit_bytes, unsigned int nan_bits, int grid,
                                void* stream) {
  if (n_sel <= 0) return 0;
  if (row_units <= 0 || grid <= 0 || grid > n_sel)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_sparse_kernel(unit_bytes, row_units, nan_bits, [&](auto kernel, auto nan) {
    using V = decltype(nan);
    kernel<<<grid, kSparseThreads, 0, s>>>(
        static_cast<const V*>(kv), static_cast<V*>(out), static_cast<const int32_t*>(ids),
        n_sel / grid, n_sel % grid, n_rows, row_units, nan);
    return static_cast<int>(cudaGetLastError());
  });
}

// Resident CTAs per SM of the instantiation that takes (unit_bytes,
// row_units), from cudaOccupancyMaxActiveBlocksPerMultiprocessor. Returns a
// cudaError_t.
extern "C" int sparse_kv_gather_ctas_per_sm(int unit_bytes, int row_units, int* out) {
  return with_sparse_kernel(unit_bytes, row_units, 0u, [&](auto kernel, auto) {
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, kSparseThreads, 0));
  });
}

extern "C" int kv_gather_write(const void* k, const void* v, void* blocks,
                               const void* slot_ids, int n_blocks, int n_layers,
                               int n_slots, long long frag_vec, void* stream) {
  return launch(0, const_cast<void*>(k), const_cast<void*>(v), blocks, slot_ids,
                n_blocks, n_layers, n_slots, frag_vec, stream);
}

extern "C" int kv_scatter_read(const void* blocks, void* k, void* v,
                               const void* slot_ids, int n_blocks, int n_layers,
                               int n_slots, long long frag_vec, void* stream) {
  return launch(1, k, v, const_cast<void*>(blocks), slot_ids, n_blocks,
                n_layers, n_slots, frag_vec, stream);
}
