"""Exp #9 (Fig. 14) on the port: dense KV block transfers per model layout.

Twin of ``benchmarks/exp09_dense_transfer.py``, with its row names. One KV
block of 16 tokens: Qwen3-32B = 128 fragments, Llama-3.1-8B = 64,
Qwen3-32B-FP8 = 128 half-size fragments. The write and read rows are the
reference's Beluga (fused kernel, direct) vs MoonCake RDMA (bounce buffer
and sglist splitting) latencies, MODELED by the port's copy of the paper's
fabric model (``core/transfer.py``). On the card the twin also times the
port's ``kv_gather_write`` and ``kv_scatter_read`` on one block of each
layout a call (bf16, and e4m3 for ``qwen3-32b-fp8``, cast as the fp8 KV
cache casts), cycling over 32 blocks so that each is cold in L2
(``.device`` rows), and checks that ``kv_gather_write`` packs
every fragment of a batch in one launch (``exp09.kernel_single_launch``).

    python -m repro_torch.experiments.exp09_dense_transfer [--device cpu] [--reduced]

Runs on the card unless ``--device cpu``; device times come only from the
card ("not measured" on the CPU).
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.core import transfer
from repro_torch.core.pool import KVBlockLayout
from repro_torch.experiments.common import (
    NOT_MEASURED, byte_bound_us, cycled_ms, device_name, emit,
)
from repro_torch.kernels import kv_transfer as kvk
from repro_torch.kernels import ops
from repro_torch.models.attention import to_e4m3

LAYOUTS = [("qwen3-32b", "qwen3-32b", 2), ("llama3.1-8b", "llama3.1-8b", 2),
           ("qwen3-32b-fp8", "qwen3-32b", 1)]  # (name, arch, dtype bytes)
BLOCK_TOKENS = 16
BLOCKS = 32  # timed calls cycle over 32 blocks: 67-84 MB, above the H100's 50 MB L2


def modeled_rows() -> list[tuple]:
    """The reference's write and read rows, one block per layout: MODELED.
    The reference prices a write and a read alike."""
    rows = []
    for name, arch, dtype_bytes in LAYOUTS:
        layout = KVBlockLayout.for_model(get_config(arch), BLOCK_TOKENS)
        res = {mode: transfer.block_transfer_cost(layout, 1, mode, dtype_bytes)[0] * 1e6
               for mode in ("beluga", "rdma")}
        cut = 1 - res["beluga"] / res["rdma"]
        rows.append(
            (f"exp09.{name}.write", f"{res['beluga']:.1f}",
             f"rdma={res['rdma']:.1f}us;cut={100*cut:.1f}%"
             f"(paper -36.2%);frags={transfer.n_fragments(layout)}")
        )
        rows.append(
            (f"exp09.{name}.read", f"{res['beluga']:.1f}",
             f"rdma={res['rdma']:.1f}us;cut={100*cut:.1f}%(paper -38.7%)")
        )
    return rows


def block_rows(arch: str, layout: KVBlockLayout, dev, gen, timed: bool,
               dtype_bytes: int = 2) -> list[tuple]:
    """BLOCKS blocks of ``layout`` written from bf16 caches of their tokens
    (e4m3 ones where ``dtype_bytes`` is 1) and read back by the port's
    kernels, checked bit for bit; then timed one block a call, cycling over
    the blocks so that each call finds its block cold in L2."""
    L, bt, hkv, hd = layout.n_layers_kv, layout.block_tokens, layout.n_kv_heads, layout.head_dim
    cast = to_e4m3 if dtype_bytes == 1 else (lambda t: t.to(torch.bfloat16))
    k = cast(torch.randn((L, BLOCKS * bt, hkv, hd), generator=gen, device=dev))
    v = cast(torch.randn((L, BLOCKS * bt, hkv, hd), generator=gen, device=dev))
    pool = ops.kv_gather_write(k, v, list(range(BLOCKS)), bt)
    kr, vr = ops.kv_scatter_read(pool, list(range(BLOCKS)), BLOCKS)
    exact = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8)) if dtype_bytes == 1
                else torch.equal(a, b) for a, b in ((kr, k), (vr, v)))
    calls = {
        "write": lambda i: ops.kv_gather_write(k, v, [i], bt),
        "read": lambda i: ops.kv_scatter_read(pool[i:i + 1], [0], 1),
    }
    block = pool[0].numel() * pool.element_size()
    rows = []
    for what, fn in calls.items():
        us = (f"{cycled_ms(fn, range(BLOCKS)) * 1e3:.2f}" if timed and dev.type == "cuda"
              else NOT_MEASURED)
        rows.append((f"exp09.{arch}.{what}.device", us,
                     f"frags={2 * L};bytes={block};bit_exact={exact};"
                     f"bound={byte_bound_us(2 * block):.3f}us;device={device_name(dev)}"))
    return rows


def run(device=None, *, reduced: bool = False, seed: int = 0, timed: bool = True) -> list[tuple]:
    """All of exp09's rows; the ``.device`` rows use the reduced configs'
    layouts with ``reduced``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = modeled_rows()
    for name, arch, dtype_bytes in LAYOUTS:
        cfg = reduced_config(arch) if reduced else get_config(arch)
        rows += block_rows(name, KVBlockLayout.for_model(cfg, BLOCK_TOKENS), dev, gen, timed,
                           dtype_bytes)
    # one launch packs every fragment of a batch (the reference's reduced
    # shapes; the plain version on the CPU, which launches nothing)
    L, n_slots, bt, hkv, hd = 4, 8, 16, 2, 32
    kz = torch.zeros((L, n_slots * bt, hkv, hd), dtype=torch.float32, device=dev)
    before = kvk.kv_gather_write.launches
    blocks = ops.kv_gather_write(kz, kz, list(range(4)), bt)
    launches = kvk.kv_gather_write.launches - before
    rows.append(
        ("exp09.kernel_single_launch", "1",
         f"kv_gather_write packs {2*L*4} fragments in {launches} kernel launch(es) "
         f"on {device_name(dev)}; out shape {tuple(blocks.shape)}")
    )
    return rows


def main(argv: list[str] | None = None) -> list[tuple]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--reduced", action="store_true", help="reduced layouts for .device rows")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    rows = run(args.device, reduced=args.reduced, seed=args.seed)
    print("# exp09.<layout>.write|read (no suffix): MODELED by the paper's CXL/RDMA fabric "
          "(repro_torch/core/fabric.py); every other row: this run")
    emit(rows)
    return rows


if __name__ == "__main__":
    main()
