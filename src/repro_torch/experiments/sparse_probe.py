"""Where ``sparse_kv_gather``'s time goes on the card.

At ``chip_smoke.py``'s three sparse reads: 8,192 pieces of 256 B from a
full-width Llama-3.1-8B pool of 512 blocks and 16,384 of 160 B from a
qwen3-32b pool of 512 blocks (16 tokens per (layer, kv head), each timed
over exp10's 32 reads cold in L2), and exp10's top-k read (4,096 rows of
(8, 80) bf16 from one full-width qwen3-32b layer's K and V, one id set,
its source in L2 as after the layer), times:

* the kernel, eager (CUDA events behind a spin on the card), and replayed
  from one captured CUDA graph of the 32 reads, divided by 32;
* ``empty``: a copy of ``csrc/kv_transfer.cu`` whose kernel returns at
  once, launched through the same C entry on the kernel's grid and block:
  the launch floor, which no design of the body removes from a call;
* copies with one part changed, on the kernel's grid: ``ids_from_blockidx``
  (each piece's row hashed from its index instead of loaded: no id round
  trip) and ``no_stores`` (every load, no store), whose outputs are wrong by
  design; ``old_kernel`` (the earlier one unit per thread grid-stride kernel,
  on its own grid), ``staged`` (the ids staged once per CTA in shared
  memory, then a barrier), ``warp_ids`` (one id load per piece a warp
  touches, handed out by shuffle) and ``generic_width`` (every row width
  through the kernel's generic case, which divides by the runtime width
  where the paths' 16-, 10- and 80-unit cases multiply), which are right;
* ``index_select`` on the same inputs, as a yardstick only;
* a ``%globaltimer`` timeline per CTA from a copy that stamps kernel
  entry, the first id in hand, the first unit in hand and the CTA's end,
  over one timed loop of 32 reads: the kernel's span, each phase, and the
  gap from one read's last CTA to the next read's first;
* a sweep of the id schemes (``lane_ids``, the kernel's own, ``staged``
  and ``warp_ids``) over threads per CTA, units a lane holds and the grid
  handed to the same C entry (SMs x CTAs per SM, or ``fit``: one unit a
  lane), beside the empty kernel on each grid.

    python -m repro_torch.experiments.sparse_probe

Rows are ``name,us,derived`` as in the other experiments. Runs on the card
only.
"""

from __future__ import annotations

import ctypes
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.pool import KVBlockLayout
from repro_torch.experiments import exp10_sparse as exp10
from repro_torch.experiments.common import (
    QUEUE_SPIN_CYCLES, byte_bound_us, cycled_ms, device_ms, device_name, emit, graph_ms,
)
from repro_torch.kernels import build
from repro_torch.kernels import kv_transfer as kvk

POOL_BLOCKS, BT = 512, 16
# each time is the median of REPEATS runs of ITERS calls; the runs of the
# copies compared in one row group take turns, so drift hits them alike, and
# each turn starts one copy later, so no copy always runs first
REPEATS, ITERS = 5, 2 * exp10.ID_SETS
# the sweep: threads per CTA x units a lane holds x the grid (SMs x CTAs per
# SM, or ``fit``: one unit a lane), for each id scheme
SWEEP_THREADS, SWEEP_UNITS, SWEEP_CTAS_PER_SM = (128, 256), (1, 2, 4), (1, 2, 4, 8, 16)
MAX_THREADS_PER_SM = 2048
_THREADS_LINE = "constexpr int kSparseThreads = 128;\n"
_UNITS_LINE = "constexpr int kSparseUnits = 2;"
_BODY = "                         int row_units, V nan) {\n"
_ID = "        int row = __ldg(cids + p);\n"
_STORE = "      if (u < units) o[u] = v[k];\n"
_LAUNCH = ("    kernel<<<grid, kSparseThreads, 0, s>>>(\n"
           "        static_cast<const V*>(kv), static_cast<V*>(out), static_cast<const int32_t*>(ids),\n"
           "        n_sel / grid, n_sel % grid, n_rows, row_units, nan);\n")
_DISPATCH = "// Calls f(kernel, nan) with the instantiation"
_OLD_KERNEL = """template <typename V>
__global__ void old_sparse_gather_kernel(const V* __restrict__ kv, V* __restrict__ out,
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

""" + _DISPATCH
_OLD_LAUNCH = """    const long long total = (long long)n_sel * row_units;
    long long old_grid = (total + 255) / 256;
    if (old_grid > 132 * 32) old_grid = 132 * 32;
    old_sparse_gather_kernel<V><<<(int)old_grid, 256, 0, s>>>(
        static_cast<const V*>(kv), static_cast<V*>(out),
        static_cast<const int32_t*>(ids), n_rows, (long long)row_units, total, nan);
"""
# the staged design: a CTA stages its pieces' ids once in shared memory
# (one lane an id, wrapped and marked there), then a barrier, then the copy
_STAGED_KERNEL = """constexpr int kSparseIds = kSparseThreads * kSparseUnits;  // ids staged at once

template <typename V, int kW>
__global__ void __launch_bounds__(kSparseThreads)
    staged_sparse_gather_kernel(const V* __restrict__ kv, V* __restrict__ out,
                                const int32_t* __restrict__ ids, int q, int r, int n_rows,
                                int row_units, V nan) {
  __shared__ int s_row[kSparseIds];
  const unsigned w = kW > 0 ? kW : row_units;
  const int tid = threadIdx.x;
  const int c = blockIdx.x;
  const int first = c * q + min(c, r);
  const int count = q + (c < r ? 1 : 0);
  const int batch = max(1, kSparseIds / static_cast<int>(w));
  for (int b0 = 0; b0 < count; b0 += batch) {
    if (b0 > 0) __syncthreads();  // the last batch is done with s_row
    const int nb = min(batch, count - b0);
    for (int i = tid; i < nb; i += kSparseThreads) {
      int id = __ldg(ids + first + b0 + i);
      if (id < 0) id += n_rows;
      s_row[i] = static_cast<unsigned>(id) < static_cast<unsigned>(n_rows) ? id : -1;
    }
    __syncthreads();
    const unsigned units = static_cast<unsigned>(nb) * w;
    V* o = out + static_cast<size_t>(first + b0) * w;
    for (unsigned u0 = 0; u0 < units; u0 += kSparseIds) {
      V v[kSparseUnits];
#pragma unroll
      for (int k = 0; k < kSparseUnits; ++k) {
        const unsigned u = u0 + k * kSparseThreads + tid;
        v[k] = nan;
        if (u < units) {
          const unsigned p = u / w;
          const int row = s_row[p];
          if (row >= 0) v[k] = __ldg(kv + (static_cast<unsigned>(row) * w + (u - p * w)));
        }
      }
#pragma unroll
      for (int k = 0; k < kSparseUnits; ++k) {
        const unsigned u = u0 + k * kSparseThreads + tid;
        if (u < units) o[u] = v[k];
      }
    }
  }
}

""" + _DISPATCH
_HELPERS = """template <typename V>
__device__ __forceinline__ unsigned word0(const V& v) {
  unsigned short w;
  memcpy(&w, &v, sizeof(w));
  return w;
}
__device__ unsigned long long* g_trace = nullptr;
__device__ unsigned int g_ctas_done = 0;
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
""" + _THREADS_LINE
# the id schemes: the shipped one (each lane loads its unit's id), the first
# design's staging, and lane j of a warp loading the id of the j-th piece the
# warp's 32 units touch (at most 32), handed to the lanes by shuffle
SCHEMES = {
    "lane_ids": [],
    "staged": [(_DISPATCH, _STAGED_KERNEL, 1),
               ("f(sparse_gather_kernel<", "f(staged_sparse_gather_kernel<", 6)],
    "warp_ids": [
        ("      v[k] = nan;\n      if (u < units) {\n        const unsigned p = u / w;\n" + _ID,
         "      const unsigned base = u0 + k * kSparseThreads + (tid & ~31);\n"
         "      const unsigned p0 = base / w;\n"
         "      int wrow = 0;\n"
         "      if (base < units && (p0 + (tid & 31)) * w < units)\n"
         "        wrow = __ldg(cids + p0 + (tid & 31));\n"
         "      const unsigned pw = u / w;\n"
         "      wrow = __shfl_sync(0xffffffffu, wrow, (pw - p0) & 31);\n"
         "      v[k] = nan;\n      if (u < units) {\n        const unsigned p = pw;\n"
         "        int row = wrow;\n", 1)],
}
# (old, new, count) edits of the source: each changes one part of the kernel
VARIANTS = {
    "empty": [(_BODY, _BODY + "  return;\n", 1)],
    "ids_from_blockidx": [
        (_ID, "        int row = static_cast<int>((static_cast<unsigned>(first) + p) * 2654435761u"
              " % static_cast<unsigned>(n_rows));\n", 1)],
    "no_stores": [(_THREADS_LINE, _HELPERS, 1),
                  (_STORE, "      if (u < units && word0(v[k]) == 0x7ff1u) o[u] = v[k];\n", 1)],
    "old_kernel": [(_DISPATCH, _OLD_KERNEL, 1), (_LAUNCH, _OLD_LAUNCH, 1)],
    # every 16-B width through the generic case (kW == 0): a division by the
    # runtime width in place of the paths' template cases
    "generic_width": [(f"sparse_gather_kernel<uint4, {w}>", "sparse_gather_kernel<uint4, 0>", 1)
                      for w in (16, 10, 80)],
    "staged": SCHEMES["staged"],
    "warp_ids": SCHEMES["warp_ids"],
}
STAMPS = 5  # per CTA of each read: entry, first id in hand, first data, end, SM id
TIMELINE = [
    (_THREADS_LINE, _HELPERS, 1),
    (_BODY, _BODY + "  __shared__ volatile unsigned s_sink;\n"
                    "  unsigned long long t_entry = gtime(), t_ids = 0, t_data = 0;\n", 1),
    (_ID, _ID + "        if (tid == 0 && u0 == 0 && k == 0) {\n"
                "          s_sink = row;  // waits for the id\n"
                "          t_ids = gtime();\n        }\n", 1),
    ("#pragma unroll\n    for (int k = 0; k < kSparseUnits; ++k) {\n"
     "      const unsigned u = u0 + k * kSparseThreads + tid;\n" + _STORE,
     "    if (tid == 0 && u0 == 0) {\n"
     "      s_sink = word0(v[0]);  // waits for the first unit\n"
     "      t_data = gtime();\n    }\n"
     "#pragma unroll\n    for (int k = 0; k < kSparseUnits; ++k) {\n"
     "      const unsigned u = u0 + k * kSparseThreads + tid;\n" + _STORE, 1),
    # CTAs of one launch all end before the next launch starts, so the
    # ticket's quotient by the grid is the launch
    (_STORE + "    }\n  }\n}\n",
     _STORE + "    }\n  }\n  __syncthreads();\n"
     "  if (tid == 0) {\n"
     "    const unsigned long long t_end = gtime();\n"
     f"    unsigned long long* tr = g_trace + atomicAdd(&g_ctas_done, 1u) * {STAMPS}ull;\n"
     "    unsigned sm;\n"
     "    asm volatile(\"mov.u32 %0, %smid;\" : \"=r\"(sm));\n"
     "    tr[0] = t_entry;\n    tr[1] = t_ids;\n    tr[2] = t_data;\n    tr[3] = t_end;\n"
     f"    tr[{STAMPS - 1}] = sm;\n"
     "  }\n}\n", 1),
    ('extern "C" int sparse_kv_gather_ctas_per_sm(',
     'extern "C" int sparse_probe_set_trace(void* p) {\n'
     "  const unsigned zero = 0;\n"
     "  cudaError_t err = cudaMemcpyToSymbol(g_trace, &p, sizeof(p));\n"
     "  if (err != cudaSuccess) return static_cast<int>(err);\n"
     "  return static_cast<int>(cudaMemcpyToSymbol(g_ctas_done, &zero, sizeof(zero)));\n"
     "}\n\n"
     'extern "C" int sparse_kv_gather_ctas_per_sm(', 1),
]
_TRACE_SIG = {"sparse_probe_set_trace": ([ctypes.c_void_p], ctypes.c_int)}


def pool_read(cfg, ctx_blocks: int, g: torch.Generator):
    """A seeded pool of ``cfg``'s layout, seen as (-1, 1, head_dim) pieces,
    and exp10's 32 reads of 16 tokens per (layer, kv head) from a context of
    ``ctx_blocks`` blocks in it -> (view, id sets)."""
    lay = KVBlockLayout.for_model(cfg, BT)
    pool = exp10.random_pool(lay, POOL_BLOCKS, g)[0]
    return pool.view(-1, 1, lay.head_dim), exp10.cold_id_sets(lay, POOL_BLOCKS, ctx_blocks, g)


def topk_read(cfg, g: torch.Generator):
    """exp10's top-k read at ``cfg``'s full width: one layer's K and V of
    exp10.SEQ tokens stacked as (2 * SEQ, hkv, hd) bf16, and the ids of the
    TOP sorted tokens of each query head in both -> (kv, ids). The tokens
    are drawn at random; the twin takes them from the layer's scores."""
    dev = g.device
    k, v = (torch.randn((exp10.SEQ, cfg.n_kv_heads, cfg.head_dim), generator=g, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    sel = torch.rand((cfg.n_heads, exp10.SEQ), generator=g, device=dev).argsort(-1)
    return exp10.topk_ids(k, v, sel[:, :exp10.TOP].sort(-1).values)


def reads(g: torch.Generator) -> dict:
    """name -> (view, id sets, cycled): the three reads. A cycled read is
    timed over its 32 id sets in turn (cold in L2); the top-k read repeats
    its one id set (its source stays in L2)."""
    llama, qwen = get_config("llama3.1-8b"), get_config("qwen3-32b")
    kv, ids = topk_read(qwen, g)
    return {
        "llama": (*pool_read(llama, 1024 // BT, g), True),
        "qwen3_32b": (*pool_read(qwen, POOL_BLOCKS, g), True),
        "topk": (kv, [ids], False),
    }


def call_out(view: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return torch.empty((ids.numel(), *view.shape[1:]), dtype=view.dtype, device=view.device)


def threads_edit(threads: int, units: int = 2) -> list:
    """Threads per CTA and units a lane holds in flight (kSparseUnits)."""
    return [(_THREADS_LINE, _THREADS_LINE.replace("128", str(threads)), 1),
            (_UNITS_LINE, _UNITS_LINE.replace("2", str(units)), 1)]


def caller(lib: ctypes.CDLL, view: torch.Tensor, grid: int | None = None):
    """ids -> one launch of ``lib``'s sparse_kv_gather on the real kernel's
    grid (``kv_transfer.sparse_args``), or on ``grid`` CTAs."""
    def call(ids):
        out = call_out(view, ids)
        args = kvk.sparse_args(view, ids, out)
        if grid is not None:
            args[-1] = min(grid, ids.numel())
        rc = lib.sparse_kv_gather(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"sparse_kv_gather launch failed: cudaError_t {rc}")
        return out
    return call


def time_read(fn, id_sets, cycled: bool) -> float:
    """ms of one read: over the id sets in turn, or of the one set repeated."""
    if cycled:
        return cycled_ms(fn, id_sets, ITERS)
    return device_ms(lambda: fn(id_sets[0]), ITERS)


def time_turns(fns: dict, id_sets, cycled: bool) -> dict:
    """name -> (median, min, max) us of ``time_read`` over REPEATS turns.
    Each turn starts one copy later, so no copy always runs first."""
    runs, names = {name: [] for name in fns}, list(fns)
    for turn in range(REPEATS):
        for name in names[turn % len(names):] + names[:turn % len(names)]:
            runs[name].append(time_read(fns[name], id_sets, cycled) * 1e3)
    return {name: (float(np.median(t)), min(t), max(t)) for name, t in runs.items()}


def _row(name: str, us: tuple, derived: str = "") -> tuple:
    return (name, f"{us[0]:.3f}", f"min={us[1]:.3f};max={us[2]:.3f}" + (";" + derived if derived
                                                                        else ""))


def floor_ms(view: torch.Tensor, id_sets) -> float:
    """The launch floor of a read: the ``empty`` copy on the kernel's grid,
    timed as chip_smoke times the kernel (``cycled_ms`` over the id sets)."""
    lib = build.load_variant("kv_transfer", "probe_empty", VARIANTS["empty"], kvk.SIGNATURES)
    return cycled_ms(caller(lib, view), id_sets)


def _timeline(lib: ctypes.CDLL, view, id_sets) -> list[tuple]:
    call = caller(lib, view)
    sets = id_sets * (32 // len(id_sets))
    grid = kvk.sparse_args(view, sets[0], call_out(view, sets[0]))[-1]
    stamps = torch.zeros((len(sets), grid, STAMPS), dtype=torch.int64, device=view.device)
    for timed in (False, True):  # three warm-up reads, then the timed loop
        torch.cuda.synchronize()
        stamps.zero_()
        if lib.sparse_probe_set_trace(ctypes.c_void_p(stamps.data_ptr())):
            raise RuntimeError("sparse_probe: setting the trace buffer failed")
        if timed:
            torch.cuda._sleep(QUEUE_SPIN_CYCLES)  # queue every read before the first runs
        for ids in sets if timed else sets[:3]:
            call(ids)
    torch.cuda.synchronize()
    t = stamps.cpu().numpy()
    start, end = t[:, :, 0].min(axis=1), t[:, :, 3].max(axis=1)
    us = (t[..., :4] - t[..., :1]) / 1e3  # per CTA, from its own entry
    return [
        ("timeline.kernel", f"{np.median(end - start) / 1e3:.3f}",
         f"reads={len(sets)};ctas={grid};sms={len(np.unique(t[..., STAMPS - 1]))};"
         f"period={(start[-1] - start[0]) / (len(sets) - 1) / 1e3:.3f}us"),
        ("timeline.entry_spread", f"{np.median(t[:, :, 0].max(axis=1) - start) / 1e3:.3f}",
         "first CTA's entry to the last CTA's entry of a read"),
        ("timeline.ids", f"{np.median(us[..., 1]):.3f}", "entry to the first id in hand"),
        ("timeline.first_data", f"{np.median(us[..., 2] - us[..., 1]):.3f}",
         "first id in hand to the first unit in hand"),
        ("timeline.stores", f"{np.median(us[..., 3] - us[..., 2]):.3f}",
         "first unit in hand to the CTA's end (its stores issued)"),
        ("timeline.gap", f"{np.median(start[1:] - end[:-1]) / 1e3:.3f}",
         "a read's last CTA's end to the next read's first CTA entry"),
    ]


def _libs() -> dict:
    """Every copy the probe times, built in parallel: name -> library."""
    sig = {**kvk.SIGNATURES, **_TRACE_SIG}
    todo = {name: edits for name, edits in VARIANTS.items()}
    todo["timeline"] = TIMELINE
    for t in SWEEP_THREADS:
        todo[f"t{t}_empty"] = threads_edit(t) + VARIANTS["empty"]
        for u in SWEEP_UNITS:
            for scheme, edits in SCHEMES.items():
                todo[f"t{t}_u{u}_{scheme}"] = threads_edit(t, u) + edits
    with ThreadPoolExecutor(max_workers=8) as pool:
        built = {name: pool.submit(build.load_variant, "kv_transfer", f"probe_{name}", edits,
                                   sig if name == "timeline" else kvk.SIGNATURES)
                 for name, edits in todo.items()}
        return {name: f.result() for name, f in built.items()}


def _sweep(read, libs, view, id_sets, cycled, n_sms) -> list[tuple]:
    """Each id scheme at each threads per CTA, units per lane and grid: SMs
    x CTAs per SM, or ``fit``, the CTAs that give every lane one unit."""
    rows = []
    n_sel, row_units = id_sets[0].numel(), view[0].numel() * view.element_size() // 16
    for t in SWEEP_THREADS:
        grids = {f"K{k}": n_sms * k for k in SWEEP_CTAS_PER_SM
                 if k * t <= MAX_THREADS_PER_SM}
        grids["fit"] = -(-n_sel * row_units // t)
        for gname, grid in grids.items():
            grid = min(grid, n_sel, n_sms * MAX_THREADS_PER_SM // t)
            fns = {"empty": caller(libs[f"t{t}_empty"], view, grid)}
            fns.update({f"U{u}.{scheme}": caller(libs[f"t{t}_u{u}_{scheme}"], view, grid)
                        for u in SWEEP_UNITS for scheme in SCHEMES})
            times = time_turns(fns, id_sets, cycled)
            floor = times["empty"][0]
            rows += [_row(f"sparse.{read}.sweep.T{t}.{gname}.{name}", us, f"grid={grid}" + (
                f";body={us[0] - floor:.3f}us" if name != "empty" else ""))
                     for name, us in times.items()]
    return rows


def run() -> list[tuple]:
    if not torch.cuda.is_available():
        raise SystemExit("sparse_probe runs on the card only")
    g = torch.Generator(device="cuda").manual_seed(1)
    card = device_name(torch.device("cuda"))
    libs = {"kernel": build.load("kv_transfer", kvk.SIGNATURES), **_libs()}
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for read, (view, id_sets, cycled) in reads(g).items():
        n_sel, row = id_sets[0].numel(), view[0].numel() * view.element_size()
        grid, unit, row_units = (kvk.sparse_args(view, id_sets[0], call_out(view, id_sets[0]))[i]
                                 for i in (8, 6, 5))
        per_sm = kvk.sparse_wave(view.device, unit, row_units) // n_sms
        plan = kvk.sparse_plan(n_sms, per_sm, n_sel, row_units)
        info = (f"pieces={n_sel}x{row}B;grid={grid};ctas_per_sm={per_sm};"
                f"units_per_lane={plan.units_per_lane};"
                + (f"bound={byte_bound_us(2 * n_sel * row):.3f}us;" if cycled
                   else "bound=none (source in L2);") + f"card={card}")
        fns = {name: caller(libs[name], view) for name in ("kernel", *VARIANTS)}
        fns["index_select"] = lambda ids: view.index_select(0, ids)
        times = time_turns(fns, id_sets, cycled)
        rows += [_row(f"sparse.{read}.{name}", us, info if name == "kernel" else "")
                 for name, us in times.items()]
        ms = graph_ms(caller(libs["kernel"], view), id_sets * (32 // len(id_sets)))
        rows.append((f"sparse.{read}.graph", f"{ms * 1e3:.3f}", "one CUDA graph of 32 reads"))
        rows += [(f"sparse.{read}.{n}", us, d) for n, us, d in _timeline(libs["timeline"], view,
                                                                         id_sets)]
        rows += _sweep(read, libs, view, id_sets, cycled, n_sms)
        del view, id_sets
    return rows


if __name__ == "__main__":
    emit(run())
