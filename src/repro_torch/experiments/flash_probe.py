"""Where ``flash_attention``'s wgmma route spends its time on the card.

At one causal prefill layer of each attention path that ``chip_smoke.py``
drives (bf16: Llama-3.1-8B q ``(1, 1024, 32, 128)``, Arctic-480B
``(1, 1024, 56, 128)``, Jamba-1.5-Large ``(1, 1000, 64, 128)``, qwen3-32b
``(1, 1024, 64, 80)``; 8 kv heads each), times, in turns within one process:

* ``kernel``: the route as shipped, a persistent grid of one CTA per SM;
* ``one_cta_per_item``: the same kernel given a grid of one CTA per work
  item (the wrapper's SM count patched to the item count), as the route's first
  design launched it: the difference is what the wave tail and each CTA's own
  set-up, Q load and pipeline fill cost;
* variants, copies of ``csrc/flash_attention.cu`` with one change each (same
  arithmetic, so their outputs are checked too): ``pingpong_qk``, the two
  consumer warpgroups taking turns (named barriers) to issue Q.K^T, so that
  one's softmax runs beside the other's product; ``pv_whole``,
  each tile's P.V issued at once after all its exps (the first design's order);
  ``exp2f``, the exps through exp2f (its range check around MUFU.EX2);
  and,
  at d 80 only (d 128 has no room), ``three_stages`` of K/V in flight;
* ``scaled_dot_product_attention`` on the same inputs, as a yardstick only.

    python -m repro_torch.experiments.flash_probe

Rows are ``name,us,derived`` as in the other experiments; each time is the
median of ``TURNS`` readings taken in turns. Runs on the card only.
"""

from __future__ import annotations

import statistics

import torch
import torch.nn.functional as F

from repro_torch.experiments.common import device_ms, device_name, emit
from repro_torch.kernels import build, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.mesh import PEAK_FLOPS_BF16

SHAPES = {  # label -> (sq, hq, hkv, d)
    "llama": (1024, 32, 8, 128),
    "arctic": (1024, 56, 8, 128),
    "jamba": (1000, 64, 8, 128),
    "qwen3_32b": (1024, 64, 8, 80),
}
TURNS = 3
BF16_FLOP_PER_S = PEAK_FLOPS_BF16
TURNS_HELPERS = (
    "__device__ __forceinline__ void turn_wait(int id) {\n"
    "  asm volatile(\"bar.sync %0, 256;\" ::\"r\"(id) : \"memory\");\n}\n"
    "__device__ __forceinline__ void turn_pass(int id) {\n"
    "  asm volatile(\"bar.arrive %0, 256;\" ::\"r\"(id) : \"memory\");\n}\n"
    "// S (64 x 128 f32) (+)= Q (64 x 16, smem)")
VARIANTS = {  # name -> (edits of the source, head_dims it runs at)
    "pingpong_qk": ([
        ("// S (64 x 128 f32) (+)= Q (64 x 16, smem)", TURNS_HELPERS, 1),
        ("    int it = 0;  // K/V tiles consumed so far",
         "    if (wg == 1) turn_pass(1);\n    int it = 0;  // K/V tiles consumed so far", 1),
        ("        float s[64];\n        wgmma_fence();\n",
         "        float s[64];\n        turn_wait(1 + wg);\n        wgmma_fence();\n", 1),
        ("        wgmma_commit();\n        wgmma_wait0();\n        fence_regs<64>(s);\n",
         "        wgmma_commit();\n        turn_pass(2 - wg);\n        wgmma_wait0();\n"
         "        fence_regs<64>(s);\n", 1),
    ], (64, 80, 128)),
    "pv_whole": ([
        ("constexpr int kPvParts = 2;", "constexpr int kPvParts = 1;", 1),
    ], (64, 80, 128)),
    "exp2f": ([
        ("  asm(\"ex2.approx.ftz.f32 %0, %1;\" : \"=f\"(y) : \"f\"(x));",
         "  y = exp2f(x);", 1),
    ], (64, 80, 128)),
    "three_stages": ([
        ("constexpr int kStages = 2;", "constexpr int kStages = 3;", 1),
    ], (64, 80)),
}


def _use(lib) -> None:
    build._LIBS["flash_attention"] = lib


def run() -> list[tuple]:
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(1)
    card = device_name(dev)
    real = build.load("flash_attention", fa.SIGNATURES)
    libs = {name: build.load_variant("flash_attention", f"probe_{name}", edits, fa.SIGNATURES)
            for name, (edits, _) in VARIANTS.items()}
    sms = build.sm_count(dev)
    rows = []
    try:
        for label, (sq, hq, hkv, d) in SHAPES.items():
            q = torch.randn((1, sq, hq, d), generator=g, device=dev).to(torch.bfloat16)
            k = torch.randn((1, sq, hkv, d), generator=g, device=dev).to(torch.bfloat16)
            v = torch.randn((1, sq, hkv, d), generator=g, device=dev).to(torch.bfloat16)
            want = ref.flash_attention_ref(q, k, v, causal=True).float()
            items = -(-sq // fa.BLOCK_Q) * hq
            flops = 4 * hq * d * (sq * (sq + 1) // 2)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

            def call(lib, ctas):
                _use(lib)
                fa.GRID_CTAS = ctas
                return fa.flash_attention(q, k, v, causal=True)

            variants = {
                "kernel": lambda: call(real, sms),
                "one_cta_per_item": lambda: call(real, items),
                **{name: (lambda lib=libs[name]: call(lib, sms))
                   for name, (_, dims) in VARIANTS.items() if d in dims},
                "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                               enable_gqa=True),
            }
            errs = {name: (fn().float() - want).abs().max().item()
                    for name, fn in variants.items() if name != "sdpa"}
            times = {name: [] for name in variants}
            for _ in range(TURNS):
                for name, fn in variants.items():
                    times[name].append(device_ms(fn) * 1e3)
            sdpa = statistics.median(times["sdpa"])
            for name, ts in times.items():
                us = statistics.median(ts)
                extra = f";max_abs_err={errs[name]:.3g}" if name in errs else ""
                rows.append((f"flash_probe.{label}.{name}", f"{us:.3f}",
                             f"turns={'/'.join(f'{t:.3f}' for t in ts)};"
                             f"tflops={flops / (us * 1e-6) / 1e12:.1f};vs_sdpa={us / sdpa:.3f};"
                             f"items={items};ctas={min(items, sms)}{extra};card={card}"))
            rows.append((f"flash_probe.{label}.bound", f"{flops / BF16_FLOP_PER_S * 1e6:.3f}",
                         f"by=operations;gflop={flops / 1e9:.2f}"))
            del q, k, v, want, qt, kt, vt
    finally:
        fa.GRID_CTAS = None
        _use(real)
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_probe: runs on the card only")
    emit(run())


if __name__ == "__main__":
    main()
