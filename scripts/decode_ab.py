"""Host-bound decode of two checkouts of the port, in turns on one card.

``python scripts/decode_ab.py --checkouts A B [--pairs 10]``

Each checkout is a tree of this repository (a ``git archive`` of a commit,
unpacked). For every model in ``RUNS`` one child process per checkout is
started with that checkout's ``src`` first on ``PYTHONPATH``, so it imports
that checkout's ``repro_torch`` (and builds its kernels under that
checkout's ``build/``). Each child makes the model once (random weights
from seed 0, full width, the depth ``RUNS`` gives), and on every request
prefills the same seeded ``PROMPT``-token prompt, then times ``STEPS``
greedy decode steps through ``Model.decode_fn`` on the host clock (a step
ends with the argmax read back, as ``launch/generate.py``'s loop does). The
parent asks the two children in turns, A B B A per pair of pairs, so that
drift of the machine falls on both sides alike.

Readings per run: decode tokens/s, the median host ms of a step; per child
once, after its timed runs: the aten ops one decode step dispatches
(counted under a ``TorchDispatchMode``, not timed). Per model: each side's
median, the ratio B / A of every pair, and the spread of each side. JSON
lines go to standard output and, with ``--out``, to a file. ``--cpu`` runs
the reduced configs on the CPU: a check of the plumbing that times nothing
of the card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

# arch -> layers (None: the published depth). internvl2-26b is cut to 24 of
# its 48 layers so that both sides' weights fit on the card at once
RUNS = {"qwen3-32b": 16, "internvl2-26b": 24}
PROMPT, STEPS, WARM_STEPS = 1024, 32, 4
TAG = "DECODE_AB "


def _child(arch: str, layers: int | None, device: str) -> None:
    """One side: the model made once, then a timed decode per request line.
    On the CPU the reduced config runs (a check of the plumbing)."""
    import dataclasses

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.models.model import Model, init_params, torch_dtype

    dev = torch.device(device)
    cfg = get_config(arch) if dev.type == "cuda" else reduced_config(arch)
    if layers and dev.type == "cuda":
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = Model(cfg)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    gen = torch.Generator().manual_seed(1)
    n_text = PROMPT - cfg.n_frontend_tokens if cfg.frontend == "vision_stub" else PROMPT
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, n_text), generator=gen).to(dev)}
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = torch.randn((1, cfg.n_frontend_tokens, cfg.d_model),
                                            generator=gen).to(torch_dtype(cfg.dtype)).to(dev)
    max_len = -(-(PROMPT + WARM_STEPS + STEPS + 1) // 16) * 16

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    def decode(count_ops: bool = False) -> dict:
        logits, cache = model.prefill_fn(params, batch, max_len=max_len)
        tok = int(logits[0, 0].argmax())
        for i in range(WARM_STEPS):
            pos = torch.tensor([PROMPT + i], device=dev)
            tok = int(model.decode_fn(params, cache, torch.tensor([tok], device=dev), pos)[0]
                      .argmax())
        steps = []
        for i in range(WARM_STEPS, WARM_STEPS + STEPS):
            t0 = time.perf_counter()
            pos = torch.tensor([PROMPT + i], device=dev)
            tok = int(model.decode_fn(params, cache, torch.tensor([tok], device=dev), pos)[0]
                      .argmax())
            steps.append(time.perf_counter() - t0)
        out = {"tokens_per_s": STEPS / sum(steps),
               "step_ms_median": statistics.median(steps) * 1e3}
        if count_ops:
            Count.n = 0
            pos = torch.tensor([PROMPT + WARM_STEPS + STEPS], device=dev)
            with Count():
                model.decode_fn(params, cache, torch.tensor([tok], device=dev), pos)
            out["aten_ops_per_step"] = Count.n
        del cache
        return out

    print(TAG + json.dumps({"ready": True, "layers": cfg.n_layers}), flush=True)
    for line in sys.stdin:
        cmd = line.strip()
        if cmd == "quit":
            break
        print(TAG + json.dumps(decode(count_ops=cmd == "count")), flush=True)


class Side:
    """A child process on one checkout, answering one request at a time."""

    def __init__(self, checkout: str, arch: str, layers: int | None, device: str):
        checkout = os.path.abspath(checkout)
        env = dict(os.environ, PYTHONPATH=os.path.join(checkout, "src"))
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", arch, str(layers or 0),
             device],
            cwd=checkout, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def read(self) -> dict:
        for line in self.proc.stdout:
            if line.startswith(TAG):
                return json.loads(line[len(TAG):])
        raise RuntimeError(f"a child exited with {self.proc.wait()}")

    def ask(self, cmd: str = "run") -> dict:
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.flush()
        return self.read()

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.stdin.write("quit\n")
            self.proc.stdin.flush()
            try:
                self.proc.wait(120)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def run(checkouts: list[str], pairs: int, out_path: str | None, device: str = "cuda") -> dict:
    import torch

    labels = [os.path.basename(os.path.normpath(c)) for c in checkouts]
    out = {"device": torch.cuda.get_device_name(0) if device == "cuda" else "cpu"}
    sink = open(out_path, "w") if out_path else None

    def emit(rec: dict) -> None:
        print(json.dumps(rec), flush=True)
        if sink:
            sink.write(json.dumps(rec) + "\n")
            sink.flush()

    try:
        for arch, layers in RUNS.items():
            t0 = time.perf_counter()
            sides = [Side(c, arch, layers, device) for c in checkouts]
            try:
                ready = [s.read() for s in sides]
                emit({"arch": arch, "layers": ready[0]["layers"], "ready_s":
                      time.perf_counter() - t0})
                runs = {lab: [] for lab in labels}
                for i in range(pairs):
                    order = (0, 1) if i % 2 == 0 else (1, 0)
                    for k in order:
                        r = sides[k].ask()
                        runs[labels[k]].append(r)
                        emit({"arch": arch, "pair": i, "side": labels[k], **r})
                counts = {lab: s.ask("count")["aten_ops_per_step"]
                          for lab, s in zip(labels, sides)}
            finally:
                for s in sides:
                    s.close()
            a, b = (runs[lab] for lab in labels)
            tps = {lab: [r["tokens_per_s"] for r in runs[lab]] for lab in labels}
            summary = {
                "arch": arch, "summary": True,
                "tokens_per_s_median": {lab: statistics.median(v) for lab, v in tps.items()},
                "tokens_per_s_range": {lab: [min(v), max(v)] for lab, v in tps.items()},
                "step_ms_median": {lab: statistics.median(r["step_ms_median"] for r in runs[lab])
                                   for lab in labels},
                "ratio_b_over_a": [y["tokens_per_s"] / x["tokens_per_s"] for x, y in zip(a, b)],
                "aten_ops_per_step": counts, "wall_s": time.perf_counter() - t0,
            }
            emit(summary | {"device": out["device"]})
            out[arch] = summary
    finally:
        if sink:
            sink.close()
    return out


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--child":
        _child(argv[1], int(argv[2]) or None, argv[3])
        return
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkouts", nargs=2, required=True)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true", help="reduced configs on the CPU (plumbing)")
    args = ap.parse_args(argv)
    run(args.checkouts, args.pairs, args.out, "cpu" if args.cpu else "cuda")


if __name__ == "__main__":
    main()
