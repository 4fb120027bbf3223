"""Serving launcher: real tokens through the KV block pool, on the card.

``python -m repro_torch.launch.serve --arch llama3.1-8b``

Twin of ``repro.launch.serve``: prompts that share their first half ->
prefix-index lookup -> pool fetch (kv_scatter_read) or prefill (flash
attention) + pool writeback (kv_gather_write) -> greedy decode. Two prompts
are repeated at the end. Any period-1 attention stack, MoE ones included
(``--arch arctic-480b``). Full width by default, with random weights from
seed 0; ``--reduced`` serves the small test config, and ``--device cpu``
runs the plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import argparse
import time


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.1-8b")
    ap.add_argument("--reduced", action="store_true", help="serve the reduced test config")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.serving.real_runner import BLOCK_TOKENS, RealEngine

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    # room for every prompt's blocks, in whole shards of 8
    blocks = args.requests * (args.prompt_len // BLOCK_TOKENS)
    eng = RealEngine.create(
        cfg,
        max_len=-(-(args.prompt_len + args.gen) // BLOCK_TOKENS) * BLOCK_TOKENS,
        pool_blocks=max(8, -(-blocks // 8) * 8),
        device=args.device,
    )
    rng = np.random.default_rng(0)
    n_shared = args.prompt_len // 2
    shared = rng.integers(0, cfg.vocab_size, size=n_shared).tolist()
    prompts = [
        shared + rng.integers(0, cfg.vocab_size, size=args.prompt_len - n_shared).tolist()
        for _ in range(args.requests)
    ]
    prompts += prompts[:2]  # repeats

    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        out, info = eng.generate(p, max_new=args.gen)
        print(
            f"req {i}: hit {info['hit_tokens']}/{len(p)} prompt tokens, "
            f"ttft {info['ttft_s'] * 1e3:.1f} ms, {len(out)} tokens -> {out[:8]}..."
        )
    print(f"total {time.perf_counter() - t0:.1f}s; index: {eng.index.stats()}")


if __name__ == "__main__":
    main()
