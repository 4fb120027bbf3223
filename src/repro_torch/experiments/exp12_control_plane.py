"""Exp #12 on the port: the control plane's micro-benchmarks.

Twin of ``benchmarks/exp12_control_plane.py``, at its sizes. It times the
four hot paths every request crosses against the frozen seed
(``core/seed_baseline.py``):

* ``bench_alloc_release``: 32 allocations of 16 blocks and their release
  on a 65,536-block pool of 32 shards, ``SeedAllocator`` against
  ``KVBlockPool`` on ``meta``;
* ``bench_match_prefix``: a published 15,000-token chain (4,096 with
  ``--fast``), the seed's str-hash chain with one lookup a key against
  ``PrefixIndex.match_prefix``;
* ``bench_scatter_read``: 64 blocks of the Qwen3-32B layout at head_dim
  128 (128 fragments, 4 MiB a block) read back, the seed's per-block loop
  against ``PoolTransfer.scatter_read``, fresh and into a persistent
  destination (``out=``), both pools' payloads on ``"cpu"``;
* ``bench_engine_loop``: the closed-loop cluster simulator
  (``cluster_common.run_populate_then_hit``, 16 engines, 131,072 pool
  blocks), its events (prefills and decode steps) per second of wall time.

Every time is host wall time (``time.perf_counter``, best of three); no
device is timed. Beside the timings ``run`` checks what is deterministic:
one cycle of the seed and the new allocator hands out the same ids, the
seed's chain matches none of the published keys and the port's matches
them all, the seed read, the fresh read and the read into the destination
give the same bytes (seeded payloads), and ``engine_loop``'s events equal
``PINNED_EVENTS`` (the JAX package's at the same size). No speedup is held
to a floor: they are printed.

The reference's ``exp12.exp05_wall`` row and the match row's
``pr1_us_reference`` / ``speedup_vs_pr1`` are not ported: they are
constants the reference measured on another machine, not numbers of this
run. The run writes no file unless asked (``--json PATH``).

    python -m repro_torch.experiments.exp12_control_plane [--fast] [--json PATH]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.core import seed_baseline as seed
from repro_torch.core.index import PrefixIndex
from repro_torch.core.pool import PAYLOAD_DTYPES, KVBlockLayout, KVBlockPool
from repro_torch.core.transfer import PoolTransfer
from repro_torch.experiments.cluster_common import qwen32b_layout, run_populate_then_hit
from repro_torch.experiments.common import emit
from repro_torch.serving.scheduler import ClusterConfig

HOST_NOTE = ("# exp12 rows: host wall time (time.perf_counter, best of 3); no device timed; "
             "engine_loop's events are the simulator's, its rate host wall")

# engine_loop's events (prefills + decode steps) as the JAX package's
# bench_engine_loop counts them: fast n=64, in_len=2048; full n=256, in_len=4096
PINNED_EVENTS = {"fast": 2144, "full": 2528}

SMALL_LAYOUT = KVBlockLayout(block_tokens=16, n_layers_kv=4, n_kv_heads=2, head_dim=8)


def _time(fn, iters: int) -> float:
    """us per call (best of 3 runs)."""
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, (time.perf_counter() - t0) / iters)
    return best * 1e6


# ---------------------------------------------------------------------------
def bench_alloc_release(n_blocks: int = 65536, n_shards: int = 32, group: int = 16) -> dict:
    lay = SMALL_LAYOUT

    def cycle(pool):
        def run():
            batches = [pool.allocate(group) for _ in range(32)]
            for b in batches:
                pool.release(b)
            return batches

        return run

    seed_pool = seed.SeedAllocator(lay, n_blocks, n_shards)
    new_pool = KVBlockPool(lay, n_blocks, "meta", n_shards)
    same_ids = cycle(seed_pool)() == cycle(new_pool)()
    # one op = one allocate(group) + one release(group)
    seed_us = _time(cycle(seed_pool), 2) / 32
    new_us = _time(cycle(new_pool), 8) / 32
    return {
        "pool_blocks": n_blocks,
        "n_shards": n_shards,
        "group": group,
        "seed_us_per_op": seed_us,
        "new_us_per_op": new_us,
        "speedup": seed_us / new_us,
        "same_ids": same_ids,
    }


# ---------------------------------------------------------------------------
def bench_match_prefix(n_tokens: int = 15000, bt: int = 16) -> dict:
    lay = KVBlockLayout(block_tokens=bt, n_layers_kv=4, n_kv_heads=2, head_dim=8)
    n_keys = n_tokens // bt
    pool = KVBlockPool(lay, 65536, "meta", 32)
    idx = PrefixIndex(pool)
    tokens = list(range(n_tokens))
    keys = idx.keys_for(tokens)
    blocks = pool.allocate(n_keys)
    epochs = pool.write_blocks(blocks)
    idx.publish_many(keys, blocks, epochs, bt)

    def run_seed():
        # the seed path: the chain re-derived with per-int str() hashing,
        # then one index lookup and one epoch check a key
        out = []
        for k in seed.seed_keys_for(tokens, bt):
            e = idx.lookup(k)
            if e is None or not pool.validate_epochs([e.block_id], [e.epoch])[0]:
                break
            out.append((k, e.block_id, e.epoch))
        return out

    def run_new():
        return idx.match_prefix(tokens)

    seed_matched, new_matched = len(run_seed()), len(run_new())
    seed_us = _time(run_seed, 4)
    new_us = _time(run_new, 16)
    return {
        "n_tokens": n_tokens,
        "n_keys": n_keys,
        "seed_us_per_match": seed_us,
        "new_us_per_match": new_us,
        "speedup": seed_us / new_us,
        "seed_matched": seed_matched,
        "new_matched": new_matched,
    }


# ---------------------------------------------------------------------------
def scatter_layout(full_layout: bool) -> KVBlockLayout:
    """Qwen3-32B at head_dim 128 (128 fragments, 4 MiB blocks), or a small
    layout for ``--fast``."""
    if full_layout:
        return KVBlockLayout(block_tokens=16, n_layers_kv=64, n_kv_heads=8, head_dim=128)
    return KVBlockLayout(block_tokens=16, n_layers_kv=8, n_kv_heads=2, head_dim=64)


def bench_scatter_read(n_read: int = 64, full_layout: bool = True, seed_val: int = 12) -> dict:
    lay = scatter_layout(full_layout)
    n_blocks = max(128, 2 * n_read)
    dtype = PAYLOAD_DTYPES[lay.dtype_bytes]
    payload = torch.empty((n_read, lay.block_bytes), dtype=torch.uint8)
    payload.random_(0, 256, generator=torch.Generator().manual_seed(seed_val))

    seed_pool = seed.SeedAllocator(lay, n_blocks, 32, device="cpu")
    new_pool = KVBlockPool(lay, n_blocks, "cpu", 32)
    xfer = PoolTransfer(new_pool)
    sblocks = seed_pool.allocate(n_read)
    seps = [seed_pool.write_block(b, payload[i]) for i, b in enumerate(sblocks)]
    nblocks = new_pool.allocate(n_read)
    neps = new_pool.write_blocks(nblocks, payload.view(dtype).view(n_read, *lay.block_shape))

    seed_us = _time(lambda: seed.seed_scatter_read(seed_pool, sblocks, seps), 3)
    new_alloc_us = _time(lambda: xfer.scatter_read(nblocks, neps), 3)
    # the serving pattern: read into the engine's persistent KV destination
    dst = torch.empty((n_read, *lay.block_shape), dtype=dtype)
    new_us = _time(lambda: xfer.scatter_read(nblocks, neps, out=dst), 3)

    want = payload.view(n_read, -1)
    got_seed = seed.seed_scatter_read(seed_pool, sblocks, seps)
    got_fresh = xfer.scatter_read(nblocks, neps)
    got_dst = xfer.scatter_read(nblocks, neps, out=dst)
    same_bytes = (got_dst is dst and all(
        torch.equal(t.view(torch.uint8).reshape(n_read, -1), want)
        for t in (got_seed, got_fresh, dst)))
    return {
        "n_blocks_read": n_read,
        "block_bytes": lay.block_bytes,
        "seed_us_per_read": seed_us,
        "new_alloc_us_per_read": new_alloc_us,
        "new_us_per_read": new_us,
        "speedup": seed_us / new_us,
        "same_bytes": same_bytes,
    }


# ---------------------------------------------------------------------------
def bench_engine_loop(n: int = 256, n_engines: int = 16, in_len: int = 4096) -> dict:
    cfg = ClusterConfig(n_engines=n_engines, transfer_mode="beluga", pool_blocks=131072)
    t0 = time.perf_counter()
    _s1, _s2, c = run_populate_then_hit(cfg, qwen32b_layout(), n=n, in_len=in_len)
    wall = time.perf_counter() - t0
    events = sum(e.stats.prefills + e.stats.decode_steps for e in c.engines)
    c.close()
    return {
        "n_clients": n,
        "n_engines": n_engines,
        "in_len": in_len,
        "events": events,
        "wall_s": wall,
        "events_per_s": events / wall,
    }


# ---------------------------------------------------------------------------
def check_failures(results: dict) -> list[str]:
    """The run's deterministic checks; returns those that fail."""
    bad = []
    if not results["alloc_release"]["same_ids"]:
        bad.append("alloc_release: the seed and the new allocator handed out other ids")
    mp = results["match_prefix"]
    if mp["seed_matched"] != 0 or mp["new_matched"] != mp["n_keys"]:
        bad.append(f"match_prefix: the seed chain matched {mp['seed_matched']} (want 0), the "
                   f"port's {mp['new_matched']} (want {mp['n_keys']})")
    if not results["scatter_read"]["same_bytes"]:
        bad.append("scatter_read: the seed read, the fresh read and the read into dst differ")
    want = PINNED_EVENTS["fast" if results["fast"] else "full"]
    if results["engine_loop"]["events"] != want:
        bad.append(f"engine_loop: {results['engine_loop']['events']} events, pinned {want}")
    return bad


def rows_of(results: dict) -> list[tuple]:
    rows = []
    for name in ("alloc_release", "match_prefix", "scatter_read"):
        r = results[name]
        us = next(v for k, v in r.items() if k.startswith("new_us"))
        seed_us = next(v for k, v in r.items() if k.startswith("seed_us"))
        rows.append((f"exp12.{name}", f"{us:.1f}",
                     f"seed_us={seed_us:.1f};speedup={r['speedup']:.1f}x"))
    el = results["engine_loop"]
    rows.append(("exp12.engine_loop", f"{1e6 / el['events_per_s']:.1f}",
                 f"events_per_s={el['events_per_s']:.0f};wall_s={el['wall_s']:.2f};"
                 f"clients={el['n_clients']}"))
    return rows


def run(fast: bool = False) -> tuple[list[tuple], dict]:
    """(rows, results) at the reference's sizes (``fast``: its CI sizes);
    raises if a deterministic check fails."""
    results: dict = {"fast": fast}
    results["alloc_release"] = bench_alloc_release()
    results["match_prefix"] = bench_match_prefix(n_tokens=4096 if fast else 15000)
    results["scatter_read"] = bench_scatter_read(full_layout=not fast)
    results["engine_loop"] = bench_engine_loop(n=64 if fast else 256,
                                               in_len=2048 if fast else 4096)
    results["failures"] = check_failures(results)
    if results["failures"]:
        raise AssertionError(f"exp12 checks failed: {results['failures']}")
    return rows_of(results), results


def main(argv: list[str] | None = None) -> list[tuple]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true", help="CI-sized inputs")
    ap.add_argument("--json", help="write the results here")
    args = ap.parse_args(argv)
    rows, results = run(fast=args.fast)
    print(HOST_NOTE)
    emit(rows)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    return rows


if __name__ == "__main__":
    main()
