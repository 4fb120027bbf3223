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

``--checkpoint-dir`` saves the weights, moments and data state every
``--checkpoint-every`` steps (``checkpoint/checkpointer.py``, JAX's
format, so either framework resumes the other's run); with ``--resume``
the latest committed step is restored into the tensors of freshly made
weights and moments (no second copy of the state is held), the data
iterator is put back, ``resumed from step N`` and the peak memory are
printed, and training goes on from step N; with no committed step, or no
``--checkpoint-dir``, it says so and starts at 0, as JAX's does.

Not ported yet, and refused: ``--mesh`` other than 1x1 (training under a
mesh, ROADMAP.md queue 1 item 5b; the model's forward under a mesh is
``launch/generate.py --mesh``).
"""

from __future__ import annotations

import argparse
import json
import resource
import time

MESH_TODO = ("a mesh other than 1x1 needs training under a mesh, not ported yet (ROADMAP.md "
             "queue 1 item 5b); the forward under a mesh is launch/generate.py --mesh")


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

    import torch

    from repro_torch import resolve_device
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.data.pipeline import DataConfig, make_dataset
    from repro_torch.models.model import Model, init_params
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.training.train_loop import (TrainLoopConfig, make_train_step,
                                                 run_train_loop)

    cfg = reduced_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    model = Model(cfg, runtime=RuntimeConfig(remat="full", moe_dispatch="einsum"))
    opt_cfg = OptimizerConfig(peak_lr=args.lr, warmup_steps=5, total_steps=args.steps)
    data = make_dataset(DataConfig(seq_len=args.seq_len, global_batch=args.batch,
                                   vocab_size=cfg.vocab_size, dp_size=1))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt_state = init_opt_state(opt_cfg, params)
    start_step = 0
    if args.resume:
        step = None
        if args.checkpoint_dir:
            ck = Checkpointer(args.checkpoint_dir)
            step = ck.latest_step()
        if step is None:
            print(f"nothing to resume in --checkpoint-dir {args.checkpoint_dir}: "
                  "starting at step 0")
        else:
            ck.restore(step, {"params": params, "opt_state": opt_state}, in_place=True)
            data.load_state_dict(ck.load_extra(step)["data_state"])
            start_step = step
            if dev.type == "cuda":
                peak = f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB on the device"
            else:  # ru_maxrss is in KiB on Linux
                peak = f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB max RSS"
            print(f"resumed from step {step} (peak memory {peak})")

    hb = args.heartbeat_file

    def on_metrics(step, metrics):
        print(json.dumps({"step": step, **metrics}), flush=True)
        if hb:
            with open(hb, "w") as f:
                f.write(f"{time.time()} {step}")

    _, _, history = run_train_loop(
        model, opt_cfg,
        TrainLoopConfig(steps=args.steps, log_every=5, checkpoint_every=args.checkpoint_every,
                        checkpoint_dir=args.checkpoint_dir),
        iter(data), params=params, opt_state=opt_state, start_step=start_step,
        step_fn=make_train_step(model, opt_cfg, args.accum, in_place=True),
        on_metrics=on_metrics,
    )
    return history


if __name__ == "__main__":
    main()
