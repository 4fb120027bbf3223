// KV gather-write / scatter-read between per-layer caches and pool blocks.
//
// Replaces the Pallas TPU kernels repro/kernels/kv_transfer.py:
// kv_gather_write (pallas_call at :76) and kv_scatter_read (:132).
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

}  // namespace

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
