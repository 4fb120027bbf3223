"""Where ``ssd_chunk``'s time goes on the card.

At ``chip_smoke.py`` phase 2's shapes (one mamba2-2.7b layer of a 1024- and
a 4096-token prefill: x ``(nb, 256, 80, 64)`` f32, one bf16 group of B and C
with d_state 128), times:

* the kernel, with bf16 B/C (the served model) and with the same values in
  float32 B/C (the float32 model's three-pass C.B^T, one CTA per SM);
* ablations: copies of ``csrc/ssd_chunk.cu`` with one part cut out
  (``px_one_pass``: only big.big of the split P.x; ``no_px``: no P.x at
  all; ``no_state``: no chunk-state products; ``no_restage``: x and B staged
  for the first two steps only, later steps reuse them), built beside the
  real library. Their outputs are wrong by design; only their times are
  read, and the difference to the full kernel is what the part costs;
* swaps, right but slower, that show what two choices of the design save:
  ``cvt_rna_split`` rounds the split with ``cvt.rna.tf32.f32`` instead of
  an integer add and mask, ``accurate_exp`` takes ``expf`` for ``__expf``;
* a timeline of the 1024-token call from a copy that stamps
  ``%globaltimer`` per CTA (start, each step, end of the step loop, end):
  CTA durations, the wait for the first step's tiles, each step, the
  cluster's state merge, and how many CTAs start together (the waves).

    python -m repro_torch.experiments.ssd_probe

Rows are ``name,us,derived`` as in the other experiments. Runs on the card
only.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.experiments.common import device_ms, device_name, emit
from repro_torch.kernels import build
from repro_torch.kernels import ssd_chunk as ssd

TOKENS = (1024, 4096)
_PX = "for (int u = 0; u < 8; ++u) mma_tf32(yacc[u], "
_X_STAGE = ("    stage_rows<float, true>(stage_x(s), kMaxHp, xsrc, x_stride, c0, lc, hp, kMaxHp,"
            " args.vec_x,\n                            tid);")
_B_STAGE = ("    stage_rows<T, false>(stage_b(s), kLd, bsrc, args.sb1, c0, lc, n, kMaxN,"
            " args.vec_bc, tid);")
# (old, new, count) edits of the source: each cuts one part out of the kernel
# or swaps one choice for its slower alternative
VARIANTS = {
    "px_one_pass": [(_PX + "ps,", "for (int u = 0; u < 0; ++u) mma_tf32(yacc[u], ps,", 1),
                    (_PX + "pb, xsm", "for (int u = 0; u < 0; ++u) mma_tf32(yacc[u], pb, xsm", 1)],
    "no_px": [(_PX, "for (int u = 0; u < 0; ++u) mma_tf32(yacc[u], ", 3)],
    "no_state": [("const int n_k8 = min(8, (lc - c * kT + 7) / 8);", "const int n_k8 = 0;", 1)],
    "no_restage": [(_X_STAGE, "    if (s < 2)\n" + _X_STAGE, 1),
                   (_B_STAGE, "    if (s < 2)\n" + _B_STAGE, 1)],
    # split lives in ssd_common.cuh: the copy calls a cvt.rna split of its own
    "cvt_rna_split": [
        ("using namespace ssd_common;\n",
         "using namespace ssd_common;\n"
         "__device__ __forceinline__ void split_rna(float v, uint32_t& big, uint32_t& small) {\n"
         "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(big) : \"f\"(v));\n"
         "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(small) : \"f\"(v - __uint_as_float(big)));\n"
         "}\n"
         "#define split split_rna\n", 1)],
    "accurate_exp": [("__expf(", "expf(", 3)],
}
STAMPS = 10  # per CTA: start, up to 5 step starts, loop end, end, (unused), SM id
TIMELINE = [
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n"
     "__device__ unsigned long long* g_trace = nullptr;\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n"
     "}\n", 1),
    ("  T* c_tiles = reinterpret_cast<T*>(smem);  // [2][kT][kLd]\n",
     "  T* c_tiles = reinterpret_cast<T*>(smem);  // [2][kT][kLd]\n"
     f"  unsigned long long* tr = g_trace + ((z * gridDim.y + h) * gridDim.x + rank) * {STAMPS};\n"
     "  if (tid == 0) {\n"
     "    unsigned sm;\n"
     "    asm volatile(\"mov.u32 %0, %smid;\" : \"=r\"(sm));\n"
     f"    tr[0] = gtime();\n    tr[{STAMPS - 1}] = sm;\n"
     "  }\n", 1),
    ("    cp_async_wait<1>();\n    __syncthreads();\n",
     "    cp_async_wait<1>();\n    __syncthreads();\n    if (tid == 0) tr[1 + s] = gtime();\n", 1),
    ("  // ---- the cluster's partial states",
     "  if (tid == 0) tr[6] = gtime();\n  // ---- the cluster's partial states", 1),
    ("\n}\n\ntemplate <typename T>\ncudaError_t prepare()",
     "\n  __syncthreads();\n  if (tid == 0) tr[7] = gtime();\n}\n\n"
     "template <typename T>\ncudaError_t prepare()", 1),
    ('extern "C" int ssd_chunk_info(',
     'extern "C" int ssd_probe_set_trace(void* p) {\n'
     "  return static_cast<int>(cudaMemcpyToSymbol(g_trace, &p, sizeof(p)));\n"
     "}\n\n"
     'extern "C" int ssd_chunk_info(', 1),
]


def _inputs(seq: int, g: torch.Generator):
    """One layer of a seq-token prefill, drawn as chip_smoke.ssd_inputs draws it."""
    cfg = get_config("mamba2-2.7b")
    ssm = cfg.ssm
    nh, hp, n, lc = ssm.n_heads(cfg.d_model), ssm.head_dim, ssm.d_state, ssm.chunk_size
    nb, dev = seq // lc, torch.device("cuda")
    x = torch.randn((nb, lc, nh, hp), generator=g, device=dev) * 0.05
    dt = torch.rand((nb, lc, nh), generator=g, device=dev) * 0.1 + 1e-3
    a = -dt * (torch.rand((nh,), generator=g, device=dev) * 15 + 1)
    bc = (torch.randn((nb, lc, 2 * n), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    return x, a, bc[..., :n].reshape(nb, lc, 1, n), bc[..., n:].reshape(nb, lc, 1, n)


def _caller(lib: ctypes.CDLL, x, a, b, c):
    """One launch of ``lib``'s kernel on these inputs, as the wrapper makes it."""
    nb, lc, nh, hp = x.shape
    n = b.shape[-1]
    y = torch.empty_like(x)
    st = torch.empty((nb, nh, n, hp), device=x.device)
    cum = torch.empty_like(a)
    dtype = 1 if b.dtype == torch.bfloat16 else 0

    def call():
        rc = lib.ssd_chunk_fwd(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                               y.data_ptr(), st.data_ptr(), cum.data_ptr(), dtype, nb, lc, nh,
                               hp, n, 1, *b.stride()[:3], torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"ssd_chunk launch failed: cudaError_t {rc}")
    return call


def _timeline(lib: ctypes.CDLL, x, a, b, c) -> list[tuple]:
    nb, lc, nh, _ = x.shape
    ranks = len(ssd.tile_schedule(lc))
    stamps = torch.zeros((nb * nh * ranks, STAMPS), dtype=torch.int64, device=x.device)
    if lib.ssd_probe_set_trace(ctypes.c_void_p(stamps.data_ptr())):
        raise RuntimeError("ssd_probe: setting the trace buffer failed")
    call = _caller(lib, x, a, b, c)
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    call()
    torch.cuda.synchronize()
    t = stamps.cpu().numpy()
    us = (t[:, :8] - t[:, 0].min()) / 1e3
    steps = len(ssd.tile_schedule(lc)[0])
    per_step = np.median(np.diff(us[:, 1:2 + steps], axis=1)[:, :steps], axis=0)
    starts = np.sort(us[:, 0])
    waves = 1 + int((np.diff(starts) > 0.5 * np.median(us[:, 7] - us[:, 0])).sum())
    return [
        ("ssd.timeline.kernel", f"{us[:, 7].max():.1f}", f"ctas={len(t)};waves={waves};"
         f"sms={len(np.unique(t[:, STAMPS - 1]))}"),
        ("ssd.timeline.cta", f"{np.median(us[:, 7] - us[:, 0]):.1f}",
         f"min={np.min(us[:, 7] - us[:, 0]):.1f};max={np.max(us[:, 7] - us[:, 0]):.1f}"),
        ("ssd.timeline.first_tiles", f"{np.median(us[:, 1] - us[:, 0]):.2f}",
         "start to the first step's tiles landed (and the prefix sums)"),
        ("ssd.timeline.steps", f"{per_step.sum():.2f}",
         "per_step=" + "/".join(f"{v:.2f}" for v in per_step)),
        ("ssd.timeline.merge", f"{np.median(us[:, 7] - us[:, 6]):.2f}",
         "end of the step loop to the end: cluster state merge and st"),
    ]


def run() -> list[tuple]:
    if not torch.cuda.is_available():
        raise SystemExit("ssd_probe runs on the card only")
    g = torch.Generator(device="cuda").manual_seed(1)
    card = device_name(torch.device("cuda"))
    libs = {"kernel": build.load("ssd_chunk", ssd.SIGNATURES)}
    libs.update({name: build.load_variant("ssd_chunk", f"probe_{name}", edits, ssd.SIGNATURES)
                 for name, edits in VARIANTS.items()})
    rows = []
    for seq in TOKENS:
        x, a, b, c = _inputs(seq, g)
        for name, lib in libs.items():
            ms = device_ms(_caller(lib, x, a, b, c))
            rows.append((f"ssd.{seq}.{name}", f"{ms * 1e3:.2f}", f"card={card}"))
        ms = device_ms(_caller(libs["kernel"], x, a, b.float(), c.float()))
        rows.append((f"ssd.{seq}.kernel_f32_bc", f"{ms * 1e3:.2f}", f"card={card}"))
        if seq == TOKENS[0]:
            timeline = build.load_variant("ssd_chunk", "probe_timeline", TIMELINE,
                                          ssd.SIGNATURES)
            rows += _timeline(timeline, x, a, b, c)
        del x, a, b, c
    return rows


if __name__ == "__main__":
    emit(run())
