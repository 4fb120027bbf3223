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

// Sparse gather: out[i] = kv[ids[i]] for n_sel rows of row_vec units of V
// (uint4 when a row is a multiple of 16 bytes and both bases are 16-byte
// aligned, else the element itself, 2 or 4 bytes). The contract is the JAX
// oracle's jnp.take, not the Pallas kernel's (which clamps): an id in
// [-N, 0) wraps to id + N; any other id out of [0, N) writes the dtype's
// quiet NaN, `nan` replicated over V. The ids are checked here, on the
// card, so the wrapper never syncs to look at them.
//
// Bound on an H100: bytes, n_sel rows read and written once; at exp10's
// shapes (8,192 pieces of 256 B, 16,384 of 160 B) that is 1.3-1.6 us, below
// a launch's own latency. The design: ONE launch for all n_sel rows, the
// paper's "thousands of tiny pieces, one kernel" (§6.1, Exp #10). Rows are
// far smaller than a thread block, so threads walk the flat (row, unit)
// space in a grid-stride loop: neighbouring threads copy neighbouring units
// of one row, and a warp spans two or more rows when they are short.
template <typename V>
__global__ void sparse_gather_kernel(const V* __restrict__ kv, V* __restrict__ out,
                                     const int32_t* __restrict__ ids,
                                     int n_rows, long long row_vec,
                                     long long total, V nan) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long i = t / row_vec;
    const long long j = t - i * row_vec;
    int id = __ldg(ids + i);
    if (id < -n_rows || id >= n_rows) {
      out[t] = nan;
    } else {
      if (id < 0) id += n_rows;
      out[t] = __ldg(kv + (long long)id * row_vec + j);
    }
  }
}

template <typename V>
int launch_sparse(const void* kv, void* out, const void* ids, int n_sel,
                  int n_rows, long long row_vec, V nan, void* stream) {
  const long long total = (long long)n_sel * row_vec;
  if (total == 0) return 0;
  long long grid = (total + kThreads - 1) / kThreads;
  if (grid > 132 * 32) grid = 132 * 32;
  sparse_gather_kernel<V><<<(int)grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(kv), static_cast<V*>(out),
      static_cast<const int32_t*>(ids), n_rows, row_vec, total, nan);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// unit_bytes: 16 (row_vec uint4 per row), 4 or 2 (row_vec elements);
// nan_bits: the dtype's quiet NaN, replicated to fill a 4-byte word.
extern "C" int sparse_kv_gather(const void* kv, void* out, const void* ids,
                                int n_sel, int n_rows, long long row_vec,
                                int unit_bytes, unsigned int nan_bits,
                                void* stream) {
  switch (unit_bytes) {
    case 16:
      return launch_sparse<uint4>(kv, out, ids, n_sel, n_rows, row_vec,
                                  make_uint4(nan_bits, nan_bits, nan_bits, nan_bits),
                                  stream);
    case 4:
      return launch_sparse<uint32_t>(kv, out, ids, n_sel, n_rows, row_vec,
                                     nan_bits, stream);
    case 2:
      return launch_sparse<uint16_t>(kv, out, ids, n_sel, n_rows, row_vec,
                                     static_cast<uint16_t>(nan_bits), stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
