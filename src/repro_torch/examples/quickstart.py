"""Quickstart: build an architecture, train one step, prefill and decode.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--arch olmo-1b] [--device cpu]

Twin of ``examples/quickstart.py`` on the reduced config (the full
architecture's topology at a CPU size): one AdamW step through
``make_train_step``, then a 48-token prefill and 8 greedy decode steps of
the updated model. On ``cuda`` by default.
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> list[int]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import resolve_device
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.models.model import Model, init_params, param_shapes
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state, tree_leaves
    from repro_torch.training.train_loop import make_train_step

    dev = resolve_device(args.device)
    cfg = reduced_config(args.arch)
    model = Model(cfg, runtime=RuntimeConfig(remat="none"))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n = sum(p.numel() for p in tree_leaves(params))
    full = sum(torch.Size(shape).numel()
               for shape, _, _ in _leaves(param_shapes(get_config(args.arch))))
    print(f"arch={cfg.name}: {n / 1e6:.2f}M params (full config: {full / 1e9:.1f}B)")

    # --- one training step ---
    gen = torch.Generator(device="cpu").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen).to(dev)
    opt_cfg = OptimizerConfig(warmup_steps=2, total_steps=100)
    step = make_train_step(model, opt_cfg)
    params, _, metrics = step(params, init_opt_state(opt_cfg, params),
                              {"tokens": tokens, "labels": tokens})
    print(f"train step: loss={float(metrics['loss']):.3f} "
          f"grad_norm={float(metrics['grad_norm']):.3f}")

    # --- prefill + decode ---
    prompt = tokens[:, :48]
    with torch.no_grad():
        logits, cache = model.prefill_fn(params, {"tokens": prompt}, max_len=96)
        out = [int(logits[0, 0].argmax())]
        pos = prompt.shape[1]
        for _ in range(8):
            logits = model.decode_fn(params, cache, torch.tensor([out[-1]] * 2, device=dev),
                                     torch.tensor([pos, pos], device=dev))
            out.append(int(logits[0].argmax()))
            pos += 1
    print(f"greedy decode: {out}")
    return out


def _leaves(tree: dict):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else [v]


if __name__ == "__main__":
    main()
