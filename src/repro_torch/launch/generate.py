"""Prefill then greedy decode through ``Model``, on the card.

``python -m repro_torch.launch.generate --arch mamba2-2.7b``

The port's twin of the prefill + decode half of ``examples/quickstart.py``,
for any stack ``Model`` runs: Mamba-2 (prefill through the ``ssd_chunk``
kernel, then the recurrent decode step), an attention stack with MLP or
MoE FFNs (flash attention, then paged decode attention), or Jamba's hybrid
period of both (``--arch jamba-1.5-large-398b``). Full width by default,
with random weights from seed 0; ``--reduced`` runs the small test config,
and ``--device cpu`` runs the plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import argparse
import time


def main(argv: list[str] | None = None) -> list[int]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-2.7b")
    ap.add_argument("--reduced", action="store_true", help="run the reduced test config")
    ap.add_argument("--prompt-len", type=int, default=1000)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import resolve_device
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.models.model import Model, init_params

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    dev = resolve_device(args.device)
    model = Model(cfg)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    gen = torch.Generator(device="cpu").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, args.prompt_len), generator=gen).to(dev)
    # an attention cache holds the prompt and the new tokens, in blocks of 16
    max_len = -(-(args.prompt_len + args.gen) // 16) * 16

    t0 = time.perf_counter()
    logits, cache = model.prefill_fn(params, tokens, max_len=max_len)
    out = [int(logits[0, 0].argmax())]
    ttft = time.perf_counter() - t0
    for i in range(args.gen - 1):
        pos = torch.tensor([args.prompt_len + i], device=dev)
        logits = model.decode_fn(params, cache, torch.tensor([out[-1]], device=dev), pos)
        out.append(int(logits[0].argmax()))
    total = time.perf_counter() - t0
    print(f"{cfg.name} on {dev}: prompt {args.prompt_len} tokens, ttft {ttft * 1e3:.1f} ms, "
          f"{len(out)} tokens in {total * 1e3:.1f} ms -> {out[:8]}...")
    return out


if __name__ == "__main__":
    main()
