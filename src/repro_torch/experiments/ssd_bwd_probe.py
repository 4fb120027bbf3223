"""Where ``ssd_chunk_bwd``'s time goes on the card.

At ``chip_smoke.py`` phase 2's two timed shapes (mamba2-2.7b's training
call: 32 chunk tiles of 256, 80 heads of 64, d_state 128, one bf16 group of
B and C, dcum given; Jamba's 256 heads over 4 tiles), drawn as
``chip_smoke.ssd_inputs`` draws them, times:

* each of a call's three launches (the main kernel, the sums of dB and dC,
  dcum and da), split by ``torch.profiler``;
* ablations: copies of ``csrc/ssd_chunk_bwd.cu`` with one part cut out,
  built beside the real library and timed in turns with it (three rounds,
  medians): ``no_state`` (the state's two products), ``no_pairs`` (dM^T and
  M^T.dy), ``no_end`` (dC's and dB's products), ``skeleton`` (all of
  those), ``no_loads`` (no tile staged: the products read stale shared
  memory), ``zero_fill`` (every copy issued, none reads a byte),
  ``no_wait`` (no wait for the copies) and ``no_exp`` (the decay without
  its exp). Their outputs are wrong by design; only their times are read,
  and the difference to the full kernel is what the part costs;
* a timeline of the training call from a copy that stamps ``%globaltimer``
  per CTA: G^T at the start, each head's state steps, pair steps and end,
  dC and dB at the end; medians over the CTAs, by column tile.

    python -m repro_torch.experiments.ssd_bwd_probe

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

SHAPES = {"train": ("mamba2-2.7b", 8192), "jamba": ("jamba-1.5-large-398b", 1024)}
ROUNDS = 3

_STATE = [
    ("#pragma unroll\n      for (int t = 0; t < 4; t += 2) {\n        uint32_t a2[2][4], as2[2][4];",
     "#pragma unroll\n      for (int t = 0; t < 0; t += 2) {\n        uint32_t a2[2][4], as2[2][4];", 1),
    ("for (int kp = 0; kp < 4; ++kp) {\n        const float4 xa = load_p4(xs, m0, kp, q), "
     "xb = load_p4(xs, m0 + 8, kp, q);\n        uint32_t ab[2][4], as[2][4];\n        split(w0",
     "for (int kp = 0; kp < 0; ++kp) {\n        const float4 xa = load_p4(xs, m0, kp, q), "
     "xb = load_p4(xs, m0 + 8, kp, q);\n        uint32_t ab[2][4], as[2][4];\n        split(w0", 1),
]
_PAIRS = [
    ("for (int kp = 0; kp < 4; ++kp) {\n        const float4 xa = load_p4(xs, m0, kp, q), "
     "xb = load_p4(xs, m0 + 8, kp, q);\n        uint32_t ab[2][4], as[2][4];\n        split(xa.x",
     "for (int kp = 0; kp < 0; ++kp) {\n        const float4 xa = load_p4(xs, m0, kp, q), "
     "xb = load_p4(xs, m0 + 8, kp, q);\n        uint32_t ab[2][4], as[2][4];\n        split(xa.x", 1),
    ("for (int t = 0; t < 4; ++t) {\n        uint32_t pb[4], ps[4];",
     "for (int t = 0; t < 0; ++t) {\n        uint32_t pb[4], ps[4];", 1),
]
_END = [
    ("for (int rr = 0; rr < nr; ++rr) {\n      const float* dg = dgs + rr * kTileF;\n"
     "      float acc[8][4] = {};",
     "for (int rr = 0; rr < 0; ++rr) {\n      const float* dg = dgs + rr * kTileF;\n"
     "      float acc[8][4] = {};", 1),
    ("#pragma unroll 2\n      for (int t = 0; t < 8; ++t) {\n        const float2 v0",
     "#pragma unroll 2\n      for (int t = 0; t < 0; ++t) {\n        const float2 v0", 1),
]
# (old, new, count) edits of the source: each cuts one part out of the kernel
VARIANTS = {
    "no_state": _STATE,
    "no_pairs": _PAIRS,
    "no_end": _END,
    "skeleton": _STATE + _PAIRS + _END,
    "no_loads": [("    if (j >= n_jobs) return;\n    unsigned char* st",
                  "    if (true) return;\n    unsigned char* st", 1)],
    "zero_fill": [("const int bytes = k < cols ? min(cols - k, kE) * (int)sizeof(E) : 0;",
                   "const int bytes = 0;", 1)],
    "no_wait": [("    cp_async_wait<0>();\n    __syncthreads();\n    issue(step + 1);",
                 "    __syncthreads();\n    issue(step + 1);", 1)],
    "no_exp": [("? __expf(cl - cm0) : 0.f", "? (cl - cm0) : 0.f", 1),
               ("? __expf(cl - cm1) : 0.f", "? (cl - cm1) : 0.f", 1)],
}
STAMPS = 64  # per CTA: start, G^T done, 3 per head (start, state done, pairs done), 50-52, SM id
TIMELINE = [
    ("namespace {\n\nusing namespace ssd_common;\n",
     "namespace {\n\nusing namespace ssd_common;\n"
     "__device__ unsigned long long* g_trace = nullptr;\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n"
     "}\n", 1),
    ("  const bool vec_f = args.vec_f, vec_bc = args.vec_bc;\n",
     "  const bool vec_f = args.vec_f, vec_bc = args.vec_bc;\n"
     f"  unsigned long long* tr = g_trace + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * {STAMPS};\n"
     "  if (tid == 0) {\n"
     "    unsigned sm;\n"
     "    asm volatile(\"mov.u32 %0, %smid;\" : \"=r\"(sm));\n"
     f"    tr[0] = gtime();\n    tr[{STAMPS - 1}] = sm;\n"
     "  }\n", 1),
    ("  // dB's state term over the block's heads, then dB itself",
     "  if (tid == 0) tr[1] = gtime();\n  // dB's state term over the block's heads, then dB itself",
     1),
    ("    float w0 = 0.f, w1 = 0.f;\n",
     "    float w0 = 0.f, w1 = 0.f;\n    if (tid == 0 && hi < 16) tr[2 + 3 * hi] = gtime();\n", 1),
    ("    // the state's dx times w_m; u_m = x_m . that",
     "    if (tid == 0 && hi < 16) tr[3 + 3 * hi] = gtime();\n"
     "    // the state's dx times w_m; u_m = x_m . that", 1),
    ("    // ---- the head's end:",
     "    if (tid == 0 && hi < 16) tr[4 + 3 * hi] = gtime();\n    // ---- the head's end:", 1),
    ("  // ---- dC's partial of each pair:",
     "  if (tid == 0) tr[50] = gtime();\n  // ---- dC's partial of each pair:", 1),
    ("  // ---- dB's partial over tile c:",
     "  if (tid == 0) tr[51] = gtime();\n  // ---- dB's partial over tile c:", 1),
    ("          make_float2(dbacc[hn][u][2], dbacc[hn][u][3]);\n    }\n  }\n}\n",
     "          make_float2(dbacc[hn][u][2], dbacc[hn][u][3]);\n    }\n  }\n"
     "  __syncthreads();\n  if (tid == 0) tr[52] = gtime();\n}\n", 1),
    ('extern "C" int ssd_chunk_bwd_info(',
     'extern "C" int ssd_bwd_probe_set_trace(void* p) {\n'
     "  return static_cast<int>(cudaMemcpyToSymbol(g_trace, &p, sizeof(p)));\n"
     "}\n\n"
     'extern "C" int ssd_chunk_bwd_info(', 1),
]


def _inputs(arch: str, seq: int, g: torch.Generator):
    """One layer's backward of a seq-token sequence: the forward's inputs as
    chip_smoke.ssd_inputs draws them, random cotangents dy, dst and dcum."""
    cfg = get_config(arch)
    ssm = cfg.ssm
    nh, hp, n, lc = ssm.n_heads(cfg.d_model), ssm.head_dim, ssm.d_state, ssm.chunk_size
    nb, dev = seq // lc, torch.device("cuda")
    x = torch.randn((nb, lc, nh, hp), generator=g, device=dev) * 0.05
    dt = torch.rand((nb, lc, nh), generator=g, device=dev) * 0.1 + 1e-3
    a = -dt * (torch.rand((nh,), generator=g, device=dev) * 15 + 1)
    bc = (torch.randn((nb, lc, 2 * n), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    b, c = bc[..., :n].reshape(nb, lc, 1, n), bc[..., n:].reshape(nb, lc, 1, n)
    dy = torch.randn((nb, lc, nh, hp), generator=g, device=dev)
    dst = torch.randn((nb, nh, n, hp), generator=g, device=dev)
    dcum = torch.randn((nb, lc, nh), generator=g, device=dev)
    return x, a, b, c, dy, dst, dcum


def _with(lib: ctypes.CDLL, fn):
    """fn() with ``ssd_chunk_bwd`` launching ``lib`` (a built variant)."""
    real = build._LIBS.get("ssd_chunk_bwd")
    build._LIBS["ssd_chunk_bwd"] = lib
    try:
        return fn()
    finally:
        build._LIBS["ssd_chunk_bwd"] = real


def _launches(args) -> list[tuple]:
    """Device time of each of one call's launches, by kernel, under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        ssd.ssd_chunk_bwd(*args)
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000)  # the window opens settled (chip_smoke.py's profiler note)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            ssd.ssd_chunk_bwd(*args)
        torch.cuda.synchronize()
    out = []
    for e in prof.key_averages():
        if "ssd_bwd_" in e.key:
            name = e.key.split("ssd_bwd_")[1].split("_kernel")[0]
            t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
            out.append((name, t / e.count))
    return out


def _timeline(lib: ctypes.CDLL, args) -> list[tuple]:
    x, a, b = args[:3]
    nb, lc, nh, _ = x.shape
    plan = ssd.bwd_plan(nb, lc, nh, b.shape[2])
    n_lt, hblk = plan["n_lt"], plan["head_block"]
    ctas = nb * plan["head_blocks"] * n_lt
    stamps = torch.zeros((ctas, STAMPS), dtype=torch.int64, device=x.device)
    if lib.ssd_bwd_probe_set_trace(ctypes.c_void_p(stamps.data_ptr())):
        raise RuntimeError("ssd_bwd_probe: setting the trace buffer failed")
    _with(lib, lambda: [ssd.ssd_chunk_bwd(*args) for _ in range(3)])
    torch.cuda.synchronize()
    _with(lib, lambda: ssd.ssd_chunk_bwd(*args))
    torch.cuda.synchronize()
    t = stamps.cpu().numpy().astype(np.float64)
    t0 = t[:, 0].min()
    us = (t[:, :STAMPS - 1] - t0) / 1e3
    col = np.arange(ctas) // (ctas // n_lt)  # blockIdx.y: the column tile
    heads = np.arange(hblk)
    state = us[:, 3 + 3 * heads] - us[:, 2 + 3 * heads]
    pairs = us[:, 4 + 3 * heads] - us[:, 3 + 3 * heads]
    ends = np.concatenate([us[:, 2 + 3 * heads[1:]], us[:, 50:51]], axis=1) - us[:, 4 + 3 * heads]
    rows = [
        ("ssd_bwd.timeline.kernel", f"{us[:, 52].max():.1f}",
         f"ctas={ctas};sms={len(np.unique(t[:, STAMPS - 1]))}"),
        ("ssd_bwd.timeline.cta", f"{np.median(us[:, 52] - us[:, 0]):.1f}",
         f"min={np.min(us[:, 52] - us[:, 0]):.1f};max={np.max(us[:, 52] - us[:, 0]):.1f}"),
    ]
    for c in range(n_lt):
        sel = col == c
        rows.append((f"ssd_bwd.timeline.col{c}", f"{np.median(us[sel, 52] - us[sel, 0]):.1f}",
                     f"pairs={n_lt - c};g={np.median(us[sel, 1] - us[sel, 0]):.2f};"
                     f"state={np.median(state[sel]):.2f};pairs_per_head="
                     f"{np.median(pairs[sel]):.2f};head_end={np.median(ends[sel]):.2f};"
                     f"dc={np.median(us[sel, 51] - us[sel, 50]):.2f};"
                     f"db={np.median(us[sel, 52] - us[sel, 51]):.2f}"))
    return rows


def run() -> list[tuple]:
    if not torch.cuda.is_available():
        raise SystemExit("ssd_bwd_probe runs on the card only")
    g = torch.Generator(device="cuda").manual_seed(2)
    card = device_name(torch.device("cuda"))
    libs = {"kernel": build.load("ssd_chunk_bwd", ssd.BWD_SIGNATURES)}
    libs.update({name: build.load_variant("ssd_chunk_bwd", f"probe_{name}", edits,
                                          ssd.BWD_SIGNATURES)
                 for name, edits in VARIANTS.items()})
    rows = []
    for label, (arch, seq) in SHAPES.items():
        args = _inputs(arch, seq, g)
        for name, us in _with(libs["kernel"], lambda: _launches(args)):
            rows.append((f"ssd_bwd.{label}.launch_{name}", f"{us:.2f}", f"card={card}"))
        times = {name: [] for name in libs}
        for rnd in range(ROUNDS):
            for name in (list(libs) if rnd % 2 == 0 else list(libs)[::-1]):
                times[name].append(_with(libs[name], lambda: device_ms(
                    lambda: ssd.ssd_chunk_bwd(*args), iters=10)))
        for name, ms in times.items():
            rows.append((f"ssd_bwd.{label}.{name}", f"{np.median(ms) * 1e3:.2f}",
                         f"card={card};rounds=" + "/".join(f"{v * 1e3:.2f}" for v in ms)))
        if label == "train":
            timeline = build.load_variant("ssd_chunk_bwd", "probe_timeline", TIMELINE,
                                          ssd.BWD_SIGNATURES)
            rows += _timeline(timeline, args)
        del args
    return rows


if __name__ == "__main__":
    emit(run())
