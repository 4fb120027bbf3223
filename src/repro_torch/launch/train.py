"""Training launcher: ``python -m repro_torch.launch.train --arch olmo-1b``.

Twin of ``repro/launch/train.py:1-124``, with its flags:
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

``--mesh DxM`` trains under a (data D, model M) mesh: D x M ranks spawned
on this host (``distributed.world.run_world``: the ``spawn`` start method,
one gloo group, a ``file://`` rendezvous, a ``--timeout`` clock), each
holding its shards of the same seeded weights (``Model(rules=...)``,
``Model.init``) and moments, and stepping the same global batches
(``training.train_loop``: the gradient through the collectives' backwards,
each leaf summed over the axes it is replicated along). Every rank uses
the one card (``cuda:0``) unless ``--device cpu``; rank 0 prints the
metric lines and writes the heartbeat; a rank's exception fails the run.
Every flag keeps its meaning: ``--checkpoint-dir`` writes one
``proc_<rank>.npz`` of shards per rank, and ``--resume`` restores a
checkpoint written by any mesh or by one device into each rank's shards
(the tree's global shapes must match, as they do wherever the tp padding
of ``param_specs`` agrees). ``--mesh`` takes DxM of positive integers.

    python -m repro_torch.launch.train --mesh 2x2
    python -m repro_torch.launch.train --smoke --mesh 2x2 --device cpu --steps 4
"""

from __future__ import annotations

import argparse
import json
import re
import resource
import time


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
    ap.add_argument("--mesh", default="1x1", help="DxM: train as D x M ranks (data, model)")
    ap.add_argument("--heartbeat-file", default=None)
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--timeout", type=float, default=3600.0, help="seconds for a world")
    args = ap.parse_args(argv)

    shape = re.fullmatch(r"([1-9]\d*)x([1-9]\d*)", args.mesh)
    if shape is None:
        raise SystemExit(f"--mesh {args.mesh!r}: DxM of positive integers, e.g. 2x2")
    d, m = int(shape.group(1)), int(shape.group(2))
    if d * m > 1:
        from repro_torch.distributed.world import run_world

        return run_world(train_rank, d * m, (vars(args), (d, m)), timeout_s=args.timeout)
    return train_rank(0, 1, vars(args), None)


def train_rank(rank: int, n: int, args: dict, mesh_shape) -> list[dict]:
    """The training run of one rank of a ``mesh_shape`` (D, M) world, or of
    one device (``mesh_shape`` None); returns the metric history."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.data.pipeline import DataConfig, make_dataset
    from repro_torch.distributed.sharding import AxisRules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.training.train_loop import (TrainLoopConfig, make_train_step,
                                                 run_train_loop, state_specs)

    cfg = reduced_config(args["arch"]) if args["smoke"] else get_config(args["arch"])
    dev = resolve_device(args["device"])
    runtime = RuntimeConfig(remat="full", moe_dispatch="einsum")
    rules = None
    if mesh_shape is not None:
        rules = AxisRules.create(make_mesh(mesh_shape, ("data", "model"), device=dev,
                                           timeout_s=args["timeout"]))
    model = Model(cfg, runtime=runtime, rules=rules)
    opt_cfg = OptimizerConfig(peak_lr=args["lr"], warmup_steps=5, total_steps=args["steps"])
    data = make_dataset(DataConfig(seq_len=args["seq_len"], global_batch=args["batch"],
                                   vocab_size=cfg.vocab_size, dp_size=1))
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    opt_state = init_opt_state(opt_cfg, params)
    start_step = 0
    say = print if rank == 0 else (lambda *a, **k: None)
    if args["resume"]:
        step = None
        if args["checkpoint_dir"]:
            ck = Checkpointer(args["checkpoint_dir"], rules=rules)
            step = ck.latest_step()
        if step is None:
            say(f"nothing to resume in --checkpoint-dir {args['checkpoint_dir']}: "
                "starting at step 0")
        else:
            ck.restore(step, {"params": params, "opt_state": opt_state}, in_place=True,
                       specs=state_specs(model, opt_cfg))
            data.load_state_dict(ck.load_extra(step)["data_state"])
            start_step = step
            if dev.type == "cuda":
                peak = f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB on the device"
            else:  # ru_maxrss is in KiB on Linux
                peak = f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB max RSS"
            say(f"resumed from step {step} (peak memory {peak}{' on rank 0' if n > 1 else ''})")

    hb = args["heartbeat_file"] if rank == 0 else None

    def on_metrics(step, metrics):
        say(json.dumps({"step": step, **metrics}), flush=True)
        if hb:
            with open(hb, "w") as f:
                f.write(f"{time.time()} {step}")

    _, _, history = run_train_loop(
        model, opt_cfg,
        TrainLoopConfig(steps=args["steps"], log_every=5,
                        checkpoint_every=args["checkpoint_every"],
                        checkpoint_dir=args["checkpoint_dir"]),
        iter(data), params=params, opt_state=opt_state, start_step=start_step,
        step_fn=make_train_step(model, opt_cfg, args["accum"], in_place=True),
        on_metrics=on_metrics,
    )
    return history


if __name__ == "__main__":
    main()
