"""Training launcher: ``python -m repro_torch.launch.train --arch olmo-1b``.

Twin of ``repro/launch/train.py:1-124`` on one device, with its flags:
AdamW (``OptimizerConfig``, warmup 5, cosine to ``--steps``) over
``SyntheticLM`` batches of ``--batch`` x ``--seq-len`` tokens, the forward
recomputed per layer in the backward (``RuntimeConfig(remat="full")``),
one JSON line of metrics every 5 steps, and ``--heartbeat-file`` rewritten
with the time and step at each. ``--accum`` microbatches each step (JAX's
launcher parses the flag but leaves its loop at one). Random weights from
seed 0. On ``cuda`` by default: attention stacks through flash
attention's forward and backward kernels, SSM stacks (``--arch
mamba2-2.7b``) through ``ssd_chunk`` and its backward kernel
``ssd_chunk_bwd``; ``--device cpu`` runs the plain PyTorch versions,
``--smoke`` the reduced test config.

Not ported yet, and refused: ``--mesh`` other than 1x1 (sharding,
ROADMAP.md queue 1 item 5), ``--checkpoint-dir`` and ``--resume`` (the
checkpointer, ROADMAP.md queue 1 item 4).
"""

from __future__ import annotations

import argparse
import json
import time

MESH_TODO = "a mesh other than 1x1 needs sharding, not ported yet (ROADMAP.md queue 1 item 5)"
RESUME_TODO = ("--checkpoint-dir and --resume need the checkpointer, not ported yet "
               "(ROADMAP.md queue 1 item 4)")


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", default="1x1", help="DxM; only 1x1 is ported")
    ap.add_argument("--heartbeat-file", default=None)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    d, m = (int(x) for x in args.mesh.split("x"))
    if d * m != 1:
        raise SystemExit(MESH_TODO)
    if args.checkpoint_dir or args.resume:
        raise SystemExit(RESUME_TODO)

    import torch

    from repro_torch import resolve_device
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.data.pipeline import DataConfig, make_dataset
    from repro_torch.models.model import Model, init_params
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_loop import (TrainLoopConfig, make_train_step,
                                                 run_train_loop)

    cfg = reduced_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    model = Model(cfg, runtime=RuntimeConfig(remat="full", moe_dispatch="einsum"))
    opt_cfg = OptimizerConfig(peak_lr=args.lr, warmup_steps=5, total_steps=args.steps)
    data = make_dataset(DataConfig(seq_len=args.seq_len, global_batch=args.batch,
                                   vocab_size=cfg.vocab_size, dp_size=1))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)

    hb = args.heartbeat_file

    def on_metrics(step, metrics):
        print(json.dumps({"step": step, **metrics}), flush=True)
        if hb:
            with open(hb, "w") as f:
                f.write(f"{time.time()} {step}")

    _, _, history = run_train_loop(
        model, opt_cfg,
        TrainLoopConfig(steps=args.steps, log_every=5, checkpoint_every=args.checkpoint_every),
        iter(data), params=params, step_fn=make_train_step(model, opt_cfg, args.accum,
                                                           in_place=True),
        on_metrics=on_metrics,
    )
    return history


if __name__ == "__main__":
    main()
