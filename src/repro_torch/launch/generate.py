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

``--mesh DxM`` runs the model under a (data D, model M) mesh: D x M ranks
spawned on this host (``distributed.world.run_world``: the ``spawn`` start
method, one gloo group, a ``file://`` rendezvous), each holding its shards
and running prefill, then greedy decode with ``--decode-kv`` (the
pool-interleaved KV sequence merged by log-sum-exp, or replicated). Every
rank uses the one card (``cuda:0``) unless ``--device cpu``; rank 0 prints
the tokens, and a rank's exception fails the run. ``--batch`` prompts are
drawn (the batch is sharded over ``data`` where D divides it).

    python -m repro_torch.launch.generate --arch llama3.1-8b --mesh 1x4
    python -m repro_torch.launch.generate --reduced --arch command-r-35b \
        --mesh 2x2 --device cpu --prompt-len 40 --gen 6
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
    ap.add_argument("--mesh", default=None, help="DxM: run as D x M ranks (data, model)")
    ap.add_argument("--decode-kv", default="pool_interleaved",
                    choices=("pool_interleaved", "replicated"))
    ap.add_argument("--moe-dispatch", default="einsum", choices=("einsum", "ragged", "a2a"))
    ap.add_argument("--batch", type=int, default=1, help="prompts (under --mesh)")
    ap.add_argument("--timeout", type=float, default=1800.0, help="seconds for the world")
    args = ap.parse_args(argv)
    if args.mesh is not None:
        return _main_mesh(args)

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


def _main_mesh(args) -> list[int]:
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.distributed.world import run_world

    d, m = (int(x) for x in args.mesh.split("x"))
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    opts = dict(cfg=cfg, mesh=(d, m), prompt_len=args.prompt_len, gen=args.gen,
                batch=args.batch, decode_kv=args.decode_kv, moe_dispatch=args.moe_dispatch,
                fp8_kv=args.fp8_kv, device=args.device or "cuda")
    out = run_world(mesh_generate, d * m, (opts,), timeout_s=args.timeout)
    r0 = out["ranks"][0]
    print(f"{cfg.name} on mesh {d}x{m} ({opts['device']}, decode_kv {args.decode_kv}): prompt "
          f"{out['seq']} positions x {args.batch}, ttft {r0['prefill_s'] * 1e3:.1f} ms, "
          f"{args.gen} tokens in {(r0['prefill_s'] + r0['decode_s']) * 1e3:.1f} ms -> "
          f"{out['tokens'][0][:8]}...")
    for r in out["ranks"]:
        print(f"  rank {r['rank']} {r['coords']}: peak {r['peak_gib']:.2f} GiB, "
              f"launches {r['launches']}")
    return out["tokens"][0]


def mesh_generate(rank: int, n: int, opts: dict) -> dict:
    """One rank of ``--mesh``: its shards of the seeded weights
    (``Model.init``), prefill of the seeded prompts, then ``gen`` - 1
    greedy decode steps. Returns, on rank 0, {"tokens": (batch, gen)
    ints, "seq", "logits": the (batch, V) f32 logits of every step, with
    ``keep_logits``, "ranks": each rank's coordinates, peak memory,
    kernel launches and prefill / decode seconds}. ``opts``: cfg, mesh
    (D, M), prompt_len, gen, batch, decode_kv, moe_dispatch, fp8_kv,
    device, and optionally seed (weights; default 0), keep_logits, and
    forced: (batch, gen) tokens fed in place of the greedy ones, so that a
    check holds the logits of contexts both sides share (``tokens`` stays
    each step's own argmax)."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.distributed.sharding import AxisRules
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model, torch_dtype

    cfg = opts["cfg"]
    dev = torch.device(opts["device"])
    mesh = make_mesh(opts["mesh"], ("data", "model"), device=dev)
    model = Model(cfg, runtime=RuntimeConfig(decode_kv=opts["decode_kv"],
                                             moe_dispatch=opts["moe_dispatch"],
                                             use_fp8_kv=opts["fp8_kv"]),
                  rules=AxisRules.create(mesh))
    params = model.init(torch.Generator(device=dev).manual_seed(opts.get("seed", 0)), dev)
    batch, seq = stub_batch(cfg, opts["prompt_len"], torch.Generator().manual_seed(1),
                            torch_dtype(cfg.dtype), rows=opts["batch"])
    batch = {k: v.to(dev) for k, v in batch.items()}
    block = 16 * opts["mesh"][1]  # whole blocks of 16 on each sequence shard
    max_len = -(-(seq + opts["gen"]) // block) * block
    b = opts["batch"]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill_fn(params, batch, max_len=max_len)
    steps = [logits[:, 0]]
    toks = [logits[:, 0].argmax(-1)]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    forced = opts.get("forced")
    for i in range(opts["gen"] - 1):
        pos = torch.full((b,), seq + i, device=dev)
        fed = toks[-1] if forced is None else torch.tensor([f[i] for f in forced], device=dev)
        steps.append(model.decode_fn(params, cache, fed, pos))
        toks.append(steps[-1].argmax(-1))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    mine = {"rank": rank, "coords": mesh.coords, "launches": ops.launch_counts(),
            "paged_with_lse": pa.paged_attention.launches_with_lse,
            "prefill_s": t1 - t0, "decode_s": t2 - t1,
            "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                         if dev.type == "cuda" else 0.0)}
    ranks = [None] * n
    dist.all_gather_object(ranks, mine)
    out = {"tokens": torch.stack(toks, 1).tolist(), "seq": seq, "ranks": ranks,
           "max_len": max_len}
    if opts.get("keep_logits"):
        out["logits"] = torch.stack(steps).cpu()
    del params, cache
    return out


def stub_batch(cfg, n: int, gen, dtype, rows: int = 1):
    """(batch, positions) of ``rows`` prompts: ``n`` seeded audio frame
    embeddings (musicgen), the config's seeded patch embeddings then ``n``
    text tokens (internvl2), or ``n`` tokens; embeddings N(0, 1) in the
    model dtype."""
    import torch

    def embeds(k):
        return torch.randn((rows, k, cfg.d_model), generator=gen).to(dtype)

    if cfg.frontend == "audio_stub":
        return {"frame_embeds": embeds(n)}, n
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (rows, n), generator=gen)}
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = embeds(cfg.n_frontend_tokens)
        return batch, cfg.n_frontend_tokens + n
    return batch, n


if __name__ == "__main__":
    main()
