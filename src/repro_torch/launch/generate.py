"""Prefill then greedy decode through ``Model``, on the card.

``python -m repro_torch.launch.generate --arch mamba2-2.7b``

The port's twin of the prefill + decode half of ``examples/quickstart.py``,
for any stack ``Model`` runs: Mamba-2 (prefill through the ``ssd_chunk``
kernel, then the recurrent decode step), an attention stack with MLP or
MoE FFNs (flash attention, then paged decode attention), Jamba's hybrid
period of both (``--arch jamba-1.5-large-398b``), and the stub frontends:
``--arch musicgen-large`` prefills ``--prompt-len`` audio frame
embeddings, ``--arch internvl2-26b`` the config's patch embeddings before
``--prompt-len`` text tokens, both drawn from a seed; decode then embeds
tokens. ``--fp8-kv`` keeps the attention caches in ``float8_e4m3fn``
(``RuntimeConfig.use_fp8_kv``). Full width by default, with random weights
from seed 0; ``--reduced`` runs the small test config, and ``--device
cpu`` runs the plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import argparse
import time


def main(argv: list[str] | None = None) -> list[int]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-2.7b")
    ap.add_argument("--reduced", action="store_true", help="run the reduced test config")
    ap.add_argument("--prompt-len", type=int, default=1000,
                    help="text tokens, or audio frames for musicgen-large")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--fp8-kv", action="store_true", help="attention caches in e4m3")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import resolve_device
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.models.model import Model, init_params, torch_dtype

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    dev = resolve_device(args.device)
    model = Model(cfg, runtime=RuntimeConfig(use_fp8_kv=args.fp8_kv))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    gen = torch.Generator(device="cpu").manual_seed(1)
    batch, seq = stub_batch(cfg, args.prompt_len, gen, torch_dtype(cfg.dtype))
    batch = {k: v.to(dev) for k, v in batch.items()}
    # an attention cache holds the prompt (patches included) and the new
    # tokens, in blocks of 16
    max_len = -(-(seq + args.gen) // 16) * 16

    t0 = time.perf_counter()
    logits, cache = model.prefill_fn(params, batch, max_len=max_len)
    out = [int(logits[0, 0].argmax())]
    ttft = time.perf_counter() - t0
    for i in range(args.gen - 1):
        pos = torch.tensor([seq + i], device=dev)
        logits = model.decode_fn(params, cache, torch.tensor([out[-1]], device=dev), pos)
        out.append(int(logits[0].argmax()))
    total = time.perf_counter() - t0
    print(f"{cfg.name} on {dev}: prompt {seq} positions, ttft {ttft * 1e3:.1f} ms, "
          f"{len(out)} tokens in {total * 1e3:.1f} ms -> {out[:8]}...")
    return out


def stub_batch(cfg, n: int, gen, dtype):
    """(batch, positions) of one prompt: ``n`` seeded audio frame embeddings
    (musicgen), the config's seeded patch embeddings then ``n`` text tokens
    (internvl2), or ``n`` tokens; embeddings N(0, 1) in the model dtype."""
    import torch

    def embeds(k):
        return torch.randn((1, k, cfg.d_model), generator=gen).to(dtype)

    if cfg.frontend == "audio_stub":
        return {"frame_embeds": embeds(n)}, n
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, n), generator=gen)}
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = embeds(cfg.n_frontend_tokens)
        return batch, cfg.n_frontend_tokens + n
    return batch, n


if __name__ == "__main__":
    main()
