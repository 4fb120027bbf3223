"""Where ``paged_attention``'s time goes on the card.

At ``chip_smoke.py`` phase 2's shape (one Llama-3.1-8B decode token, q
``(1, 32, 128)`` bf16, over a layer's ``(1, 2048, 8, 128)`` dense cache as
128 blocks of 16, context 1040, cycling over 32 layers so each call finds its
K/V cold in the 50 MB L2), times:

* the kernel at the splits S its plan picks and at other S (the plan is
  patched, the kernel is the same);
* ablations: copies of ``csrc/paged_attention.cu`` with one phase cut out
  of the bf16 (tensor-core) kernel (``no_compute``: the tile's products and
  softmax; ``no_cluster_merge``: everything after each CTA's own merge),
  built beside the real library.
  Their outputs are wrong by design; only their times are read, and the
  difference to the full kernel is what the phase costs;
* ``scaled_dot_product_attention`` on the same inputs, as a yardstick only.

Then the decode shapes of every attention path, each against SDPA in turns
(``TURNS`` readings, the median kept), cycling over 32 caches: Llama's
group of 4, Arctic's group of 7 and Jamba's group of 8 at d 128, qwen3-32b's
group of 8 at d 80 (bf16: the tensor-core kernel, a whole group a CTA).
Each shape also gets a ``timeline``: a copy of the kernel that writes
``%globaltimer`` from thread 0 of every CTA at its start, once its first
copies are issued, when its first tile has landed, after its tile loop,
after its own merge, once its pushes to the cluster are issued, and at its
end; the row gives the median over CTAs of each point, in us from the
grid's first start.

    python -m repro_torch.experiments.paged_probe

Rows are ``name,us,derived`` as in the other experiments. Runs on the card
only.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.experiments.common import cycled_ms, device_name, emit
from repro_torch.kernels import build, ref
from repro_torch.kernels import paged_attention as pa

LAYERS, MAX_LEN, BT, CTX = 32, 2048, 16, 1040
HKV, HQ, HD = 8, 32, 128
SPLITS = (4, 8, 12, 16)
GROUP_SHAPES = {  # label -> (q heads, kv heads, head_dim, max_len, context)
    "llama": (32, 8, 128, 2048, 1040),
    "arctic": (56, 8, 128, 2048, 1040),
    "jamba": (64, 8, 128, 1024, 1016),
    "qwen3_32b": (64, 8, 80, 2048, 1040),
}
TURNS = 3
# (old, new, count) edits of the source: each cuts one phase out of the kernel
ABLATIONS = {
    "no_compute": [
        ("    if (n > 0) {\n", "    if (n > 0 && args.scale < 0.f) {\n", 1),
    ],
    "no_cluster_merge": [
        ("  cg::cluster_group cluster = cg::this_cluster();\n",
         "  return;\n  cg::cluster_group cluster = cg::this_cluster();\n", 1),
    ],
}


STAMPS = 8  # per CTA: the 7 points below and the CTA's tile count
TIMELINE = [  # on the bf16 (tensor-core) kernel, which every probed shape runs
    ("namespace {\n",
     "namespace {\n__device__ unsigned long long g_stamp[8192][8];\n"
     "#define STAMP(k, dep) if (threadIdx.x == 0) { unsigned long long t_; "
     "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_) : \"r\"(dep)); "
     "g_stamp[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x][k] = t_; }\n", 1),
    ("  const int split = blockIdx.x, hk = blockIdx.y, bi = blockIdx.z;\n",
     "  const int split = blockIdx.x, hk = blockIdx.y, bi = blockIdx.z;\n  STAMP(0, 0)\n", 1),
    ("  const int v_row = (lane & 7) + (lane >> 4) * 8, v_half = (lane >> 3) & 1;\n",
     "  const int v_row = (lane & 7) + (lane >> 4) * 8, v_half = (lane >> 3) & 1;\n"
     "  STAMP(1, n_tiles)\n  if (threadIdx.x == 0) g_stamp[(blockIdx.z * gridDim.y"
     " + blockIdx.y) * gridDim.x + blockIdx.x][7] = n_tiles;\n", 1),
    ("    if (n > 0) {\n", "    if (k == 0) STAMP(2, 0)\n    if (n > 0) {\n", 1),
    ("  cp_async_wait<0>();\n  __syncwarp();\n\n  // the warp's partial: O^T",
     "  cp_async_wait<0>();\n  __syncwarp();\n  STAMP(3, __float_as_int(l[0]))\n\n"
     "  // the warp's partial: O^T", 1),
    ("  if (s_act == 1) {\n",
     "  STAMP(4, __float_as_int(ca[0]))\n  if (s_act == 1) {\n", 1),
    ("  cluster.sync();  // the pushes are visible",
     "  STAMP(5, 0)\n  cluster.sync();  // the pushes are visible", 1),
    ("    if (kLse && idx % D == 0) lse[gi] = (mx + log2f(den)) * kLn2;\n  }\n}\n",
     "    if (kLse && idx % D == 0) lse[gi] = (mx + log2f(den)) * kLn2;\n  }\n"
     "  STAMP(6, 0)\n}\n", 1),
    ("extern \"C\" int paged_attention_fwd(",
     "extern \"C\" int paged_probe_stamps(void* dst, int bytes, int reset) {\n"
     "  if (reset) {\n"
     "    static unsigned long long zeros[8192][8];\n"
     "    return static_cast<int>(cudaMemcpyToSymbol(g_stamp, zeros, sizeof(zeros)));\n"
     "  }\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_stamp, bytes));\n}\n\n"
     "extern \"C\" int paged_attention_fwd(", 1),
]
POINTS = ("start", "ctx", "first_tile", "tiles", "cta_merge", "pushed", "end")


def _use(lib: ctypes.CDLL) -> None:
    build._LIBS["paged_attention"] = lib
    for cached in (pa.ctas_per_sm, pa.clusters_resident, pa.plan):
        cached.cache_clear()


def run() -> list[tuple]:
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    kc, vc, q = randn(LAYERS, 1, MAX_LEN, HKV, HD), randn(LAYERS, 1, MAX_LEN, HKV, HD), \
        randn(LAYERS, 1, HQ, HD)
    n_blk = MAX_LEN // BT
    table = pa.make_block_table([list(range(n_blk))], n_blk, dev)
    ctx = torch.tensor([CTX], dtype=torch.int32, device=dev)

    def kernel(i):
        return pa.paged_attention(q[i], pa.dense_blocks(kc[i], BT), pa.dense_blocks(vc[i], BT),
                                  table, ctx)

    want = torch.stack([ref.paged_attention_ref(q[i], pa.dense_blocks(kc[i], BT),
                                                pa.dense_blocks(vc[i], BT), table, ctx)
                        for i in range(LAYERS)]).float()
    card = device_name(dev)
    planned, per_sm = pa.plan(dev, torch.bfloat16, HD, HQ // HKV, 1, HKV, n_blk)
    rows = []
    real = build.load("paged_attention", pa.SIGNATURES)
    plan_splits = pa.plan_splits
    try:
        for splits in sorted({*SPLITS, planned}):
            pa.plan_splits = lambda *a, s=splits: s
            pa.plan.cache_clear()
            err = (torch.stack([kernel(i) for i in range(LAYERS)]).float() - want).abs().max()
            rows.append((f"paged_probe.S{splits}", cycled_ms(kernel, range(LAYERS)) * 1e3,
                         f"max_abs_err={err.item():.3g};planned={splits == planned};"
                         f"ctas_per_sm={per_sm};card={card}"))
        pa.plan_splits = plan_splits
        for name, edits in ABLATIONS.items():
            _use(build.load_variant("paged_attention", f"probe_{name}", edits, pa.SIGNATURES))
            rows.append((f"paged_probe.{name}.S{planned}", cycled_ms(kernel, range(LAYERS)) * 1e3,
                         f"output_wrong_by_design=True;card={card}"))
    finally:
        pa.plan_splits = plan_splits
        _use(real)
    qs = q.unsqueeze(3)
    ks, vs = kc[:, :, :CTX].transpose(2, 3), vc[:, :, :CTX].transpose(2, 3)
    rows.append(("paged_probe.sdpa", cycled_ms(lambda i: F.scaled_dot_product_attention(
        qs[i], ks[i], vs[i], enable_gqa=True), range(LAYERS)) * 1e3, f"card={card}"))
    del kc, vc, q, qs, ks, vs
    for label, shape in GROUP_SHAPES.items():
        rows += group_rows(label, *shape, randn, dev, card)
    return rows


def group_rows(label, hq, hkv, hd, max_len, ctx_len, randn, dev, card) -> list[tuple]:
    """The kernel and SDPA at one decode shape, in turns, medians kept."""
    import statistics

    n_blk = max_len // BT
    kc, vc = randn(LAYERS, 1, max_len, hkv, hd), randn(LAYERS, 1, max_len, hkv, hd)
    q = randn(LAYERS, 1, hq, hd)
    table = pa.make_block_table([list(range(n_blk))], n_blk, dev)
    ctx = torch.tensor([ctx_len], dtype=torch.int32, device=dev)

    def kernel(i):
        return pa.paged_attention(q[i], pa.dense_blocks(kc[i], BT), pa.dense_blocks(vc[i], BT),
                                  table, ctx)

    want = [ref.paged_attention_ref(q[i], pa.dense_blocks(kc[i], BT),
                                    pa.dense_blocks(vc[i], BT), table, ctx).float()
            for i in range(LAYERS)]
    err = max((kernel(i).float() - want[i]).abs().max().item() for i in range(LAYERS))
    qs = q.unsqueeze(3)
    ks, vs = kc[:, :, :ctx_len].transpose(2, 3), vc[:, :, :ctx_len].transpose(2, 3)
    sdpa = lambda i: F.scaled_dot_product_attention(  # noqa: E731
        qs[i], ks[i], vs[i], enable_gqa=True)
    runs = {"kernel": kernel, "sdpa": sdpa}
    times = {name: [] for name in runs}
    for _ in range(TURNS):
        for name, fn in runs.items():
            times[name].append(cycled_ms(fn, range(LAYERS)) * 1e3)
    splits, per_sm = pa.plan(dev, torch.bfloat16, hd, hq // hkv, 1, hkv, n_blk)
    med = {k: statistics.median(v) for k, v in times.items()}
    rows = [(f"paged_probe.{label}.{name}", f"{med[name]:.3f}",
             f"turns={'/'.join(f'{t:.3f}' for t in ts)};vs_sdpa={med[name] / med['sdpa']:.3f};"
             f"group={hq // hkv};d={hd};splits={splits};ctas_per_sm={per_sm};"
             + (f"max_abs_err={err:.3g};" if name == "kernel" else "") + f"card={card}")
            for name, ts in times.items()]
    rows.append(timeline(label, kernel, card))
    return rows


def timeline(label, kernel, card) -> tuple:
    """One call of the stamped copy on a cache cold in L2 (layer 0 after a
    pass over the others): the median over CTAs of each point."""
    import statistics

    real = build.load("paged_attention", pa.SIGNATURES)
    sigs = dict(pa.SIGNATURES, paged_probe_stamps=(
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int], ctypes.c_int))
    lib = build.load_variant("paged_attention", "probe_timeline", TIMELINE, sigs)
    try:
        _use(lib)
        for i in range(1, LAYERS):
            kernel(i)
        torch.cuda.synchronize()
        if lib.paged_probe_stamps(None, 0, 1):
            raise RuntimeError("paged_probe_stamps reset failed")
        kernel(0)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (8192 * STAMPS))()
        if lib.paged_probe_stamps(ctypes.addressof(buf), ctypes.sizeof(buf), 0):
            raise RuntimeError("paged_probe_stamps read failed")
    finally:
        _use(real)
    ctas = [list(buf[c * STAMPS:(c + 1) * STAMPS]) for c in range(8192)]
    ctas = [c for c in ctas if c[0]]
    t0 = min(c[0] for c in ctas)
    med = {p: statistics.median((c[k] - t0) / 1e3 for c in ctas if c[k])
           for k, p in enumerate(POINTS) if any(c[k] for c in ctas)}
    last = max((c[6] or c[4]) - t0 for c in ctas) / 1e3
    tiles = sorted({c[7] for c in ctas})
    return (f"paged_probe.{label}.timeline", f"{last:.3f}",
            ";".join(f"{p}_us={v:.3f}" for p, v in med.items())
            + f";ctas={len(ctas)};tiles_per_cta={tiles};card={card}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("paged_probe: runs on the card only")
    emit(run())


if __name__ == "__main__":
    main()
