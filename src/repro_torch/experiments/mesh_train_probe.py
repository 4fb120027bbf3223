"""Training under a device mesh on one card: each run against one device.

``python -m repro_torch.experiments.mesh_train_probe [seeds...]`` (default
seed 0; ``--cpu`` runs the reduced configs at short sequences on the CPU, a
check of the plumbing that times nothing)

Three runs at full width, as ``chip_smoke.py`` phase 16 drives them, on
phase 13's batches (``SyntheticLM``, 4 x 2048 tokens, from its batch 1 on)
with ``OptimizerConfig()`` (AdamW, bf16 gradient compression) and
``remat="full"``. Per seed, each run's one-device reference is computed
first on the tp-padded layout (the same weights ``Model.init`` draws on
every rank): ``run_train_loop`` in place, the loss, grad norm and lr of
every step, and the AdamW moments after the last step saved to a file the
ranks map; then ONE world of 4 ranks on ``cuda:0`` (gloo,
``distributed.world.run_world``) runs the three in turn:

  olmo_1x4    olmo-1b, all 16 layers, mesh 1x4 (4 heads a rank), 4 steps
  olmo_2x2    olmo-1b, 4 of 16 layers, mesh 2x2 (FSDP over data, 2 rows a
              rank), 4 steps; then the world saves a checkpoint. At 16
              layers this run alone took 107-126 s of gloo on one H100,
              so its depth is cut
  mamba2_1x4  mamba2-2.7b, 8 of 64 layers, mesh 1x4 (20 SSD heads a rank;
              vocab padded to 50304), 2 steps

Each rank first checks every collective of the path, forward and backward,
on CUDA tensors against the same on CPU tensors. Readings per run: each
step's loss and grad norm against the reference (relative), whether every
rank reports the same, the largest gap of the f32 moments m and v after
the last step, each rank's shards against its slices of the reference's,
relative to each leaf's largest entry (they carry every step's gradient at
full precision; the weights do not: at these steps' lrs of 3e-6 to 1.2e-5
four AdamW steps move a bf16 weight near 0.01 by less than one bf16 step,
so a weight gap is one rounding step whatever the gradient was), each
rank's kernel launches a step by route, peak memory, the steps' wall times
and the world's. The checkpoint: the save's wall time and bytes, each
rank's sha1 of every shard it holds; the parent restores the checkpoint on
one device (``checkpoint_check``) and hashes the same slices. Times of
collectives and of the checkpoint here are gloo and disk through host
memory of 4 processes on one card, not a multi-GPU number.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import os
import sys
import tempfile
import time

RUNS = {
    "olmo_1x4": dict(arch="olmo-1b", layers=None, mesh=(1, 4), steps=4),
    "olmo_2x2": dict(arch="olmo-1b", layers=4, mesh=(2, 2), steps=4, checkpoint=True),
    "mamba2_1x4": dict(arch="mamba2-2.7b", layers=8, mesh=(1, 4), steps=2),
}
BATCH, SEQ = 4, 2048  # phase 13's batches
FIRST_BATCH = 1  # phase 13 (ii) trains from batch 1 on ((i) takes batch 0)
WORLD_TIMEOUT_S = 900.0
MOMENTS = ("m", "v")  # AdamW's, held against the reference's


def small(run: dict) -> dict:
    """A run at the reduced config in float32 and short sequences (the CPU
    check: float32, so that only the summation orders part the two sides)."""
    return dict(run, reduced=True, seq=64, device="cpu", dtype="float32")


def config(run: dict):
    from repro_torch.configs.registry import get_config, reduced_config

    cfg = reduced_config(run["arch"]) if run.get("reduced") else get_config(run["arch"])
    if run["layers"] and not run.get("reduced"):
        cfg = dataclasses.replace(cfg, n_layers=run["layers"])
    return dataclasses.replace(cfg, dtype=run.get("dtype", cfg.dtype))


def get_layers(arch: str) -> int:
    """The published depth of ``arch``."""
    from repro_torch.configs.registry import get_config

    return get_config(arch).n_layers


def batches(run: dict, cfg):
    """Phase 13's batch iterator, at its batch ``FIRST_BATCH``."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    data = SyntheticLM(DataConfig(seq_len=run.get("seq", SEQ), global_batch=BATCH,
                                  vocab_size=cfg.vocab_size))
    data.load_state_dict({"step": FIRST_BATCH})
    return data


def _model(run: dict, rules=None):
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.models.model import Model

    return Model(config(run), runtime=RuntimeConfig(remat="full"), rules=rules,
                 tp=None if rules is not None else run["mesh"][1])


def reference(run: dict, seed: int, path: str) -> dict:
    """One device, the same weights and batches: each step's metrics; the
    moments after the last step saved to ``path`` (``torch.save``; keys
    ``m/<leaf>``, ``v/<leaf>`` and ``scale``, each leaf's largest |entry|),
    which the ranks map and slice. Everything returned lies on the host."""
    import torch

    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_loop import TrainLoopConfig, run_train_loop

    dev = torch.device(run.get("device", "cuda"))
    model = _model(run)
    params = model.init(torch.Generator(device=dev).manual_seed(seed), dev)
    t0 = time.perf_counter()
    params, state, history = run_train_loop(
        model, OptimizerConfig(), TrainLoopConfig(steps=run["steps"], log_every=1),
        batches(run, model.cfg), params=params)
    moments = {f"{name}/{k}": v.detach().cpu() for name in MOMENTS
               for k, v in _items(state[name])}
    moments["scale"] = {k: float(v.abs().max()) for k, v in moments.items()}
    torch.save(moments, path)
    del moments
    out = {"history": history, "wall_s": time.perf_counter() - t0}
    del params, state, model
    _free(dev)
    return out


def _items(tree: dict, prefix: str = ""):
    """(key, leaf) in ``tree_leaves`` order, keys as checkpoint paths."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _items(v, f"{prefix}/{k}" if prefix else k)
        else:
            yield f"{prefix}/{k}" if prefix else k, v


def _free(dev) -> None:
    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def check_collectives(mesh) -> list[str]:
    """Every collective of the path, forward and backward (its vector-
    Jacobian product with a fixed cotangent), on CUDA tensors against the
    same on CPU tensors, over each axis tuple: bit for bit, or the names
    that differ."""
    import torch

    from repro_torch.distributed import collectives as coll

    bad = []
    if mesh.device is None or mesh.device.type != "cuda":
        return bad
    g = torch.Generator().manual_seed(200 + mesh.rank)
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn(4, 6, 8, generator=g) * 8).to(dtype)
        for axes in ("model", "data", ("data", "model")):
            cases = {
                "all_reduce_sum": lambda t: coll.all_reduce(t, mesh, axes),
                "all_reduce_max": lambda t: coll.all_reduce(t, mesh, axes, op="max"),
                "all_gather_2": lambda t: coll.all_gather(t, 2, mesh, axes),
                "all_gather_flat": lambda t: torch.cat([p.reshape(-1) for p in (
                    coll.all_gather_flat([t, t[1:] * 2], [0, 1], mesh, axes))]),
                "all_to_all": lambda t: coll.all_to_all(t, mesh, axes),
            }
            for name, fn in cases.items():
                got = []
                for dev in ("cpu", mesh.device):
                    leaf = x.to(dev).requires_grad_(True)
                    with torch.enable_grad():
                        y = fn(leaf)
                        w = torch.linspace(-1, 1, y.numel(), device=y.device).reshape(
                            y.shape).to(y.dtype)
                        (grad,) = torch.autograd.grad(y, leaf, grad_outputs=w,
                                                      allow_unused=True, materialize_grads=True)
                    got.append((y.detach().cpu(), grad.cpu(), grad.device.type))
                (yc, gc_, _), (yg, gg, where) = got
                if where != "cuda" or not (torch.equal(yc, yg) and torch.equal(gc_, gg)):
                    bad.append(f"{name} {dtype} {axes}")
    return bad


def _sha1(t) -> str:
    """sha1 of a tensor's bytes."""
    import torch

    raw = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
    return hashlib.sha1(raw.numpy().tobytes()).hexdigest()


def _train_rank(run: dict, seed: int, ref_path: str, ckpt_dir: str | None) -> dict:
    """This rank's part of one run: its shards trained, the readings."""
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.distributed.sharding import AxisRules, local_slice, shard_box
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_loop import TrainLoopConfig, run_train_loop, state_specs

    dev = torch.device(run.get("device", "cuda"))
    cuda = dev.type == "cuda"
    rules = AxisRules.create(make_mesh(run["mesh"], ("data", "model"), device=dev,
                                       timeout_s=WORLD_TIMEOUT_S))
    mesh = rules.mesh
    model = _model(run, rules)
    opt = OptimizerConfig()
    params = model.init(torch.Generator(device=dev).manual_seed(seed), dev)
    stamps = []
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    stamps.append(time.perf_counter())

    def on_metrics(step, metrics):
        if cuda:
            torch.cuda.synchronize(dev)
        stamps.append(time.perf_counter())

    params, state, history = run_train_loop(
        model, opt, TrainLoopConfig(steps=run["steps"], log_every=1),
        batches(run, model.cfg), params=params, on_metrics=on_metrics)
    mine = {"rank": mesh.rank, "coords": mesh.coords, "history": history,
            "launches": ops.launch_counts(), "flash_routes": ops.flash_routes(),
            "bwd_routes": ops.bwd_routes(),
            "step_s": [b - a for a, b in zip(stamps, stamps[1:])],
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else 0.0}
    # the moments against this rank's slices of the reference's
    ref = torch.load(ref_path, mmap=True)
    mine["moment_gap"] = {}
    for name in MOMENTS:
        gap = 0.0
        for (key, t), (_, spec) in zip(_items(state[name]), _items(model.partition_specs())):
            want = local_slice(ref[f"{name}/{key}"], spec, mesh, key).to(dev)
            diff = float((t - want).abs().max())
            scale = ref["scale"][f"{name}/{key}"]
            gap = max(gap, diff / scale if scale > 0 else diff)
        mine["moment_gap"][name] = gap
    del ref
    if run.get("checkpoint") and ckpt_dir:
        tree = {"params": params, "opt_state": state}
        ck = Checkpointer(ckpt_dir, keep=1, rules=rules)
        if cuda:
            torch.cuda.synchronize(dev)
        dist.barrier()
        t0 = time.perf_counter()
        ck.save(run["steps"], tree, extra={"data_state": {"step": FIRST_BATCH + run["steps"]}},
                specs=state_specs(model, opt))
        mine["save_s"] = time.perf_counter() - t0
        mine["sha1"] = {key: _sha1(t) for key, t in _items(tree)}
        mine["index"] = {key: shard_box(spec.shape, rules.spec(spec.logical_axes), mesh, key)
                         for key, spec in _items(state_specs(model, opt))}
    del params, state
    _free(dev)
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    return {"ranks": ranks}


def rank_program(rank: int, n: int, runs: dict, seed: int, refs: dict,
                 ckpt_dir: str | None) -> dict:
    """This rank's part of every run in turn: the collectives first, then
    each run, its memory freed before the next."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    out = {}
    dev = torch.device(next(iter(runs.values())).get("device", "cuda"))
    for shape in ((1, 4), (2, 2)):
        bad = check_collectives(make_mesh(shape, ("data", "model"), device=dev))
        gathered = [None] * n
        dist.all_gather_object(gathered, bad)
        out[f"collectives_{shape[0]}x{shape[1]}"] = sorted({b for r in gathered for b in r})
    for name, run in runs.items():
        t0 = time.perf_counter()
        mine = _train_rank(run, seed, refs[name], ckpt_dir)
        dist.barrier()
        mine["wall_s"] = time.perf_counter() - t0
        out[name] = mine
    return out


def checkpoint_check(run: dict, ckpt_dir: str, ranks: list, device) -> dict:
    """The world's checkpoint restored on one device (the one-process
    reader) and each rank's shards hashed out of it: whether every shard
    equals, bit for bit, what that rank held; the restore's wall time and
    the bytes on disk."""
    import torch

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.training.optimizer import OptimizerConfig, tree_map
    from repro_torch.training.train_loop import state_specs

    specs = state_specs(_model(run), OptimizerConfig())
    tree = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device=device), specs)
    ck = Checkpointer(ckpt_dir)
    step = ck.latest_step()
    t0 = time.perf_counter()
    ck.restore(step, tree, in_place=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    restore_s = time.perf_counter() - t0
    differ = []
    for key, leaf in _items(tree):
        host = leaf.cpu()
        for r in ranks:
            if _sha1(host[r["index"][key]]) != r["sha1"][key]:
                differ.append((r["rank"], key))
    on_disk = sum(os.path.getsize(os.path.join(root, f))
                  for root, _, files in os.walk(ck.step_dir(step)) for f in files)
    with open(os.path.join(ck.step_dir(step), "manifest.json")) as f:
        nprocs = json.load(f)["nprocs"]
    del tree
    _free(device)
    return {"step": step, "shards_differ": differ, "restore_s": restore_s, "bytes": on_disk,
            "nprocs": nprocs}


def readings(name: str, ref: dict, got: dict) -> dict:
    """The gaps of one run against its reference."""
    ranks = got["ranks"]
    hist, want = ranks[0]["history"], ref["history"]
    r = {"wall_s": got["wall_s"],
         "peak_gib": [x["peak_gib"] for x in ranks],
         "launches": [x["launches"] for x in ranks],
         "flash_routes": [x["flash_routes"] for x in ranks],
         "bwd_routes": [x["bwd_routes"] for x in ranks],
         "step_s": ranks[0]["step_s"],
         "losses": [h["loss"] for h in hist], "ref_losses": [h["loss"] for h in want],
         "grad_norms": [h["grad_norm"] for h in hist],
         "ref_grad_norms": [h["grad_norm"] for h in want]}
    r["loss_rel"] = [abs(a / b - 1) for a, b in zip(r["losses"], r["ref_losses"])]
    r["grad_norm_rel"] = [abs(a / b - 1) for a, b in zip(r["grad_norms"], r["ref_grad_norms"])]
    r["ranks_agree"] = all(x["history"] == hist for x in ranks)
    r["moment_gap"] = {k: max(x["moment_gap"][k] for x in ranks) for k in MOMENTS}
    if "save_s" in ranks[0]:
        r["save_s"] = max(x["save_s"] for x in ranks)
    return r


def run(seeds=(0,), names=None, cpu: bool = False) -> dict:
    """Readings per seed: {seed: {"world_s", "collectives_<mesh>", name:
    readings, "checkpoint": checkpoint_check's}}."""
    import torch

    from repro_torch.distributed.world import run_world
    from repro_torch.kernels import build

    runs = {n: small(RUNS[n]) if cpu else RUNS[n] for n in (names or RUNS)}
    dev = torch.device("cpu" if cpu else "cuda")
    if not cpu:
        build.build_all()
    out = {}
    for seed in seeds:
        with tempfile.TemporaryDirectory(prefix="mesh_train_") as tmp:
            refs, paths = {}, {}
            for name, r in runs.items():
                paths[name] = os.path.join(tmp, f"ref_{name}.pt")
                refs[name] = reference(r, seed, paths[name])
            ckpt_dir = os.path.join(tmp, "ckpt")
            t0 = time.perf_counter()
            got = run_world(rank_program, 4, (runs, seed, paths, ckpt_dir),
                            timeout_s=WORLD_TIMEOUT_S, workdir=os.path.join(tmp, "world"))
            seed_out = {"world_s": time.perf_counter() - t0}
            for k in got:
                if k.startswith("collectives"):
                    seed_out[k] = got[k]
            for name, r in runs.items():
                seed_out[name] = readings(name, refs[name], got[name])
                if r.get("checkpoint"):
                    seed_out["checkpoint"] = checkpoint_check(r, ckpt_dir, got[name]["ranks"],
                                                              dev)
        out[seed] = seed_out
        print(json.dumps({"seed": seed, **seed_out}), flush=True)
    return out


if __name__ == "__main__":
    args = sys.argv[1:]
    run([int(s) for s in args if s != "--cpu"] or [0], cpu="--cpu" in args)
