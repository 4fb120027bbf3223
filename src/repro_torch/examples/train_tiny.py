"""Train a reduced model with checkpoint/restart.

    PYTHONPATH=src python -m repro_torch.examples.train_tiny [--steps 300] [--kill-at 150] \
        [--device cpu]

Twin of ``examples/train_tiny.py``, with its flags and settings: the
reduced config of ``--arch``, AdamW (warmup 20, cosine to ``--steps``),
``SyntheticLM`` batches of 4 x 64 tokens, a checkpoint every 50 steps into
``--ckpt`` (emptied first). ``--kill-at`` simulates a crash mid-run: the
script stops there, restores the latest committed step (weights, moments,
the data iterator's state) into freshly made tensors and finishes the
run. Random weights from seed 0; on ``cuda`` by default.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile


def main(argv: list[str] | None = None) -> tuple[dict, dict, list[dict]]:
    """Returns the last run's (params, opt_state, history)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--kill-at", type=int, default=0)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_tiny_ckpt"))
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import resolve_device
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.configs.registry import reduced_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import Model, init_params
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.training.train_loop import TrainLoopConfig, run_train_loop

    if os.path.exists(args.ckpt):
        shutil.rmtree(args.ckpt)
    dev = resolve_device(args.device)
    cfg = reduced_config(args.arch)
    model = Model(cfg, runtime=RuntimeConfig(remat="none"))
    opt_cfg = OptimizerConfig(peak_lr=1e-3, warmup_steps=20, total_steps=args.steps)
    data_cfg = DataConfig(seq_len=64, global_batch=4, vocab_size=cfg.vocab_size)

    def fresh_params():
        return init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)

    def log(step, m):
        print(f"step {step:4d}  loss {m['loss']:.4f}  lr {m['lr']:.2e}")

    loop = TrainLoopConfig(steps=args.kill_at or args.steps, log_every=25,
                           checkpoint_every=50, checkpoint_dir=args.ckpt)
    out = run_train_loop(model, opt_cfg, loop, SyntheticLM(data_cfg), params=fresh_params(),
                         on_metrics=log)

    if args.kill_at:
        print(f"\n--- simulated crash at step {args.kill_at}; restarting ---")
        del out
        ck = Checkpointer(args.ckpt)
        step = ck.latest_step()
        if step is None:
            raise SystemExit(f"no committed checkpoint before step {args.kill_at} "
                             "(one is written every 50 steps)")
        print(f"latest committed checkpoint: step {step}")
        params = fresh_params()
        tree = ck.restore(step, {"params": params,
                                 "opt_state": init_opt_state(opt_cfg, params)})
        data2 = SyntheticLM(data_cfg)
        data2.load_state_dict(ck.load_extra(step)["data_state"])
        loop2 = TrainLoopConfig(steps=args.steps, log_every=25,
                                checkpoint_every=50, checkpoint_dir=args.ckpt)
        out = run_train_loop(model, opt_cfg, loop2, data2, params=tree["params"],
                             opt_state=tree["opt_state"], start_step=step, on_metrics=log)
    print("done")
    return out


if __name__ == "__main__":
    main()
