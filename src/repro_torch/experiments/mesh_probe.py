"""The model under a device mesh on one card: each run against one device.

``python -m repro_torch.experiments.mesh_probe [seeds...]`` (default seed 0;
``--cpu`` runs the reduced configs at short prompts on the CPU, a check of
the plumbing that times nothing)

Four runs at full width, as ``chip_smoke.py`` phase 15 drives them; per
seed, each run's single-device reference is computed first (on the
tp-padded layout, the same weights ``Model.init`` draws on every rank),
kept on the host and freed, then ONE world of 4 ranks on ``cuda:0`` (gloo,
``distributed.world.run_world``) runs the four in turn:

  llama_1x4   Llama-3.1-8B, all 32 layers, mesh 1x4, pool-interleaved KV:
              a 1024-token prompt, then 16 greedy decode steps
  llama_2x2   Llama-3.1-8B, 4 of 32 layers, mesh 2x2 (FSDP gathers over
              data), 2 prompts of 1024 tokens, 4 steps
  arctic_1x4  arctic-480b, 1 of 35 layers, mesh 1x4, the a2a dispatch (32
              experts a rank), a 1024-token prefill at a capacity factor of
              8.0, which drops no pair, and at the published 1.25 (dropped
              pairs counted)
  mamba2_1x4  mamba2-2.7b, 8 of 64 layers, mesh 1x4 (20 SSD heads a rank;
              the vocab pads from 50280 to 50304), a 1000-token prompt, 16 steps

Each rank first checks every collective the path uses on CUDA tensors
against the same collective on CPU tensors. The ranks decode the
reference's greedy tokens (``mesh_generate``'s ``forced``), so every step
compares logits of one shared context. Readings per run: the largest
|logit| gap at each step against the reference; the steps where the
ranks' argmax differs from the reference's, each with the reference's
top-2 margin (with random weights over a vocabulary of 10^5 the top two
logits are often closer than bf16's noise through 32 layers, and a flip
is possible only where the margin is under twice the step's gap); the
arctic layer's outputs at the tokens routed alike (and the routing
flips); each rank's peak memory and kernel launches; the world's wall
time. Times of collectives here are gloo through host memory
on one card, not a multi-GPU number.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time

RUNS = {
    "llama_1x4": dict(arch="llama3.1-8b", layers=None, mesh=(1, 4), prompt=1024, gen=17,
                      batch=1, dispatch="einsum"),
    "llama_2x2": dict(arch="llama3.1-8b", layers=4, mesh=(2, 2), prompt=1024, gen=5,
                      batch=2, dispatch="einsum"),
    "arctic_1x4": dict(arch="arctic-480b", layers=1, mesh=(1, 4), prompt=1024, gen=1,
                       batch=1, dispatch="a2a", capacity=8.0),
    "mamba2_1x4": dict(arch="mamba2-2.7b", layers=8, mesh=(1, 4), prompt=1000, gen=17,
                       batch=1, dispatch="einsum"),
}
PUBLISHED_CAPACITY = 1.25
WORLD_TIMEOUT_S = 900.0


def get_layers(arch: str) -> int:
    """The published depth of ``arch``."""
    from repro_torch.configs.registry import get_config

    return get_config(arch).n_layers


def small(run: dict) -> dict:
    """A run at the reduced config and short prompts (the CPU check)."""
    return dict(run, reduced=True, prompt=40, gen=min(run["gen"], 5), device="cpu")


def config(run: dict):
    from repro_torch.configs.registry import get_config, reduced_config

    cfg = reduced_config(run["arch"]) if run.get("reduced") else get_config(run["arch"])
    if run["layers"] and not run.get("reduced"):
        cfg = dataclasses.replace(cfg, n_layers=run["layers"])
    if "capacity" in run:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=run["capacity"]))
    return cfg


def opts(run: dict, seed: int, forced=None) -> dict:
    return dict(cfg=config(run), mesh=run["mesh"], prompt_len=run["prompt"], gen=run["gen"],
                batch=run["batch"], decode_kv="pool_interleaved", moe_dispatch=run["dispatch"],
                fp8_kv=False, device=run.get("device", "cuda"), seed=seed, keep_logits=True,
                forced=forced)


def _routed(aux: list) -> "torch.Tensor":
    """Each token's chosen experts, sorted, over every MoE layer: (t, L*k)."""
    import torch

    return torch.cat([a["top_e"].sort(-1).values for a in aux], -1).cpu()


def reference(run: dict, seed: int) -> dict:
    """One device, the same weights and prompts: logits at every step and
    the greedy tokens; for arctic the layer's outputs per token and the
    routing. Everything returned lies on the host."""
    import torch

    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.launch.generate import stub_batch
    from repro_torch.models import transformer as stack_lib
    from repro_torch.models.model import Model, torch_dtype

    o = opts(run, seed)
    cfg, dev, tp = o["cfg"], torch.device(o["device"]), run["mesh"][1]
    model = Model(cfg, runtime=RuntimeConfig(moe_dispatch=run["dispatch"]), tp=tp)
    params = model.init(torch.Generator(device=dev).manual_seed(seed), dev)
    batch, seq = stub_batch(cfg, run["prompt"], torch.Generator().manual_seed(1),
                            torch_dtype(cfg.dtype), rows=run["batch"])
    batch = {k: v.to(dev) for k, v in batch.items()}
    block = 16 * tp
    max_len = -(-(seq + run["gen"]) // block) * block
    aux: list = []
    t0 = time.perf_counter()
    logits, cache = model.prefill_fn(params, batch, max_len=max_len, aux=aux)
    steps, toks = [logits[:, 0]], [logits[:, 0].argmax(-1)]
    for i in range(run["gen"] - 1):
        pos = torch.full((run["batch"],), seq + i, device=dev)
        steps.append(model.decode_fn(params, cache, toks[-1], pos))
        toks.append(steps[-1].argmax(-1))
    out = {"logits": torch.stack(steps).cpu(), "tokens": torch.stack(toks, 1).tolist(),
           "wall_s": time.perf_counter() - t0}
    if aux:
        x, positions = model.embed(params, batch)
        out["hidden"] = stack_lib.forward_full(params, x, positions, cfg, model.kernel_mode,
                                               None, model.moe_dispatch).float().cpu()
        out["routed"] = _routed(aux)
    del params, cache, model
    _free(dev)
    return out


def _free(dev) -> None:
    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def check_collectives(mesh) -> list[str]:
    """Every collective of the path on CUDA tensors against the same on CPU
    tensors, over each axis tuple: bit for bit, or the names that differ."""
    import torch

    from repro_torch.distributed import collectives as coll

    bad = []
    g = torch.Generator().manual_seed(100 + mesh.rank)
    dev = mesh.device if mesh.device.type == "cuda" else None
    if dev is None:
        return bad
    for dtype in (torch.float32, torch.bfloat16, torch.int64):
        x = (torch.randn(4, 6, 8, generator=g) * 8).to(dtype)
        for axes in ("model", "data", ("data", "model")):
            cases = {
                "all_reduce_sum": lambda t: coll.all_reduce(t, mesh, axes),
                "all_reduce_max": lambda t: coll.all_reduce(t, mesh, axes, op="max"),
                "all_gather_0": lambda t: coll.all_gather(t, 0, mesh, axes),
                "all_gather_2": lambda t: coll.all_gather(t, 2, mesh, axes),
                "all_to_all": lambda t: coll.all_to_all(t, mesh, axes),
            }
            for name, fn in cases.items():
                cpu, gpu = fn(x), fn(x.to(dev))
                if gpu.device.type != "cuda" or not torch.equal(gpu.cpu(), cpu):
                    bad.append(f"{name} {dtype} {axes}")
    return bad


def _arctic_rank(run: dict, seed: int, mesh_shape) -> dict:
    """arctic's a2a prefill on this rank at the run's capacity, then at the
    published one: logits, every token's layer output and routing, dropped
    pairs; rank 0's are returned."""
    import torch

    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.distributed.sharding import AxisRules
    from repro_torch.kernels import ops
    from repro_torch.launch.generate import stub_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as stack_lib
    from repro_torch.models.model import Model, torch_dtype

    dev = torch.device(run.get("device", "cuda"))
    cfg = config(run)
    rules = AxisRules.create(make_mesh(mesh_shape, ("data", "model"), device=dev))
    model = Model(cfg, runtime=RuntimeConfig(moe_dispatch="a2a"), rules=rules)
    params = model.init(torch.Generator(device=dev).manual_seed(seed), dev)
    batch, seq = stub_batch(cfg, run["prompt"], torch.Generator().manual_seed(1),
                            torch_dtype(cfg.dtype), rows=run["batch"])
    batch = {k: v.to(dev) for k, v in batch.items()}
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    aux: list = []
    logits, _ = model.prefill_fn(params, batch, max_len=-(-seq // 64) * 64, aux=aux)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    ctx = model.mesh_context(run["batch"])
    x, positions = model.embed(params, batch, ctx.batch_axes)
    hidden = stack_lib.forward_full(params, x, positions, cfg, model.kernel_mode, None,
                                    model.moe_dispatch, mesh_ctx=ctx)
    published = Model(dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=PUBLISHED_CAPACITY)), runtime=model.runtime, rules=rules)
    aux_pub: list = []
    published.prefill_fn(params, batch, max_len=-(-seq // 64) * 64, aux=aux_pub)
    out = {"logits": logits[:, 0][None].cpu(), "hidden": hidden.float().cpu(),
           "routed": _routed(aux), "dropped": [float(a["dropped"]) for a in aux],
           "dropped_published": [float(a["dropped"]) for a in aux_pub],
           "launches": launches, "prefill_s": wall,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0}
    del params, model, published
    return out


def rank_program(rank: int, n: int, runs: dict, seed: int, forced: dict) -> dict:
    """This rank's part of every run in turn: the collectives first, then
    each run (``launch.generate.mesh_generate``, or the arctic prefill),
    its memory freed before the next."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.generate import mesh_generate
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
        if name.startswith("arctic"):
            mine = _arctic_rank(run, seed, run["mesh"])
            stats = {"rank": rank, "peak_gib": mine.pop("peak_gib"),
                     "launches": mine.pop("launches"), "prefill_s": mine.pop("prefill_s")}
            ranks = [None] * n
            dist.all_gather_object(ranks, stats)
            mine["ranks"] = ranks
        else:
            mine = mesh_generate(rank, n, opts(run, seed, forced.get(name)))
        _free(dev)
        dist.barrier()
        mine["wall_s"] = time.perf_counter() - t0
        out[name] = mine
    return out


def readings(name: str, ref: dict, got: dict) -> dict:
    """The gaps of one run against its reference."""
    import torch

    r = {"wall_s": got["wall_s"],
         "peak_gib": [x["peak_gib"] for x in got["ranks"]],
         "launches": [x["launches"] for x in got["ranks"]],
         "paged_with_lse": [x.get("paged_with_lse", 0) for x in got["ranks"]]}
    a, b = got["logits"].float(), ref["logits"].float()
    r["max_dlogit_per_step"] = (a - b).abs().flatten(1).amax(1).tolist()
    r["logit_std"] = float(b.std())
    if "tokens" in got:
        top2 = b.topk(2, dim=-1).values  # (steps, b, 2)
        margin = (top2[..., 0] - top2[..., 1])
        mine = torch.tensor(got["tokens"]).T  # (steps, b)
        theirs = torch.tensor(ref["tokens"]).T
        flips = (mine != theirs).nonzero().tolist()
        r["token_flips"] = [(s_, i, float(margin[s_, i]), r["max_dlogit_per_step"][s_])
                            for s_, i in flips]
        r["tokens_equal"] = not flips
    if "hidden" in got:
        alike = (got["routed"] == ref["routed"]).all(-1)
        h, hr = got["hidden"].flatten(0, 1), ref["hidden"].flatten(0, 1)
        r["flips"] = int((~alike).sum())
        r["max_dhidden_alike"] = float((h[alike] - hr[alike]).abs().max())
        r["hidden_std"] = float(hr.std())
        r["dropped"] = got["dropped"]
        r["dropped_published"] = got["dropped_published"]
    return r


def run(seeds=(0,), names=None, cpu: bool = False) -> dict:
    """Readings per seed: {seed: {"world_s", "collectives_<mesh>", name: readings}}."""
    import torch

    from repro_torch.distributed.world import run_world
    from repro_torch.kernels import build

    runs = {n: small(RUNS[n]) if cpu else RUNS[n] for n in (names or RUNS)}
    if not cpu:
        build.build_all()
    out = {}
    for seed in seeds:
        refs = {name: reference(r, seed) for name, r in runs.items()}
        _free(torch.device("cpu" if cpu else "cuda"))
        t0 = time.perf_counter()
        forced = {name: ref["tokens"] for name, ref in refs.items() if "hidden" not in ref}
        got = run_world(rank_program, 4, (runs, seed, forced), timeout_s=WORLD_TIMEOUT_S)
        world_s = time.perf_counter() - t0
        seed_out = {"world_s": world_s}
        for k in got:
            if k.startswith("collectives"):
                seed_out[k] = got[k]
        for name in runs:
            seed_out[name] = readings(name, refs[name], got[name])
        out[seed] = seed_out
        print(json.dumps({"seed": seed, **seed_out}), flush=True)
    return out


if __name__ == "__main__":
    args = sys.argv[1:]
    run([int(s) for s in args if s != "--cpu"] or [0], cpu="--cpu" in args)
