"""Where ``paged_attention``'s time goes on the card.

At ``chip_smoke.py`` phase 2's shape (one Llama-3.1-8B decode token, q
``(1, 32, 128)`` bf16, over a layer's ``(1, 2048, 8, 128)`` dense cache as
128 blocks of 16, context 1040, cycling over 32 layers so each call finds its
K/V cold in the 50 MB L2), times:

* the kernel at the splits S its plan picks and at other S (the plan is
  patched, the kernel is the same);
* ablations: copies of ``csrc/paged_attention.cu`` with one phase cut out
  (``no_compute``: the tile's scores, softmax and P.V; ``no_cluster_merge``:
  everything after each CTA's own merge), built beside the real library.
  Their outputs are wrong by design; only their times are read, and the
  difference to the full kernel is what the phase costs;
* ``scaled_dot_product_attention`` on the same inputs, as a yardstick only.

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
# (old, new, count) edits of the source: each cuts one phase out of the kernel
ABLATIONS = {
    "no_compute": [
        ("    // scores: kLpr lanes per row",
         "    if (args.scale < 0.f) {\n    // scores: kLpr lanes per row", 1),
        ("    __syncwarp();  // the stage and P are read",
         "    }\n    __syncwarp();  // the stage and P are read", 1),
    ],
    "no_cluster_merge": [
        ("  cg::cluster_group cluster = cg::this_cluster();\n",
         "  return;\n  cg::cluster_group cluster = cg::this_cluster();\n", 1),
    ],
}


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
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("paged_probe: runs on the card only")
    emit(run())


if __name__ == "__main__":
    main()
