"""Exp #14 on the port: the shared data plane across engine worker
processes.

Twin of ``benchmarks/exp14_procengine.py``, with the same workload, cells
and row names:

  1. parity: moving an engine into its own process must change no
     statistic. The whole ``Cluster.run`` dict (the summary, the index's
     counters, the pool's occupancy) is compared for equality across the
     private in-process run, the shared in-process run and one worker
     process, and the parity numbers against ``PINNED``, the JAX package's
     run at the same size;
  2. the sweep: N in {1, 2, 4} workers over one shared segment, the same
     workload; host wall time, and a worker's bytes moved over it. At N >= 2
     the hit tokens depend on which worker publishes first (JAX's own
     artifact shows 14288, 13984 and 13376 at N = 1, 2 and 4), and so do
     the bytes moved (``sweep``), so what is checked there is what the run
     conserves: every request done, every refcount accounted for
     (``refcounts_accounted``; with one engine, in the parity runs and at
     N = 1, no block is left overwritten), no block moved twice (bytes at
     most N = 1's), nothing left running or linked;
  3. chaos (``chaos_sweep``): the self-healing cluster with two workers; a
     SIGKILL of worker 0 between phases (reconciled, respawned, replayed),
     then the allocator moved to a fresh ring under the live workers.

Every time in the rows is host wall time of this machine's CPU, except the
parity row's ``avg_ttft_s`` and ``PINNED``'s, which are the simulator's
virtual time: MODELED. A full-size run holds 4096 pool blocks of 32 KiB
(a 128 MiB segment) and 160 requests of 4096 tokens.

    python -m repro_torch.experiments.exp14_procengine [--fast] [--json PATH]

The module's top level imports no torch: a worker or a shard service,
spawned, imports the main module again.
"""

from __future__ import annotations

import argparse
import json
import os
import time

HOST_NOTE = ("# exp14 rows: host wall time of this machine's CPU; the parity row's avg_ttft_s "
             "is the simulator's virtual time (MODELED)")
LAYOUT = dict(block_tokens=16, n_layers_kv=4, n_kv_heads=4, head_dim=32, dtype_bytes=2)
# the parity numbers of the JAX package's run on this tree
# (benchmarks.exp14_procengine.run, private in-process = shared = 1 worker)
PINNED = {
    "fast": {"n_done": 48, "avg_ttft_s": 11.910769282230506, "hit_tokens": 14288,
             "pool_free": 15},
    "full": {"n_done": 160, "avg_ttft_s": 94.15456607880965, "hit_tokens": 193344,
             "pool_free": 60},
}
PARITY_KEYS = ("n_done", "avg_ttft_s", "hit_tokens", "pool_free")
# a chaos shard's journal holds every publish and eviction of the full-size
# run (the reference's cell keeps the default 8192 and compacts), so that
# ``refcounts_accounted`` finds both publishes of every key published twice,
# in whichever order the journal holds them
CHAOS_JOURNAL = 1 << 16


def _layout():
    from repro_torch.core.pool import KVBlockLayout

    return KVBlockLayout(**LAYOUT)


def workload(fast: bool):
    from repro_torch.experiments.cluster_common import lveval_requests

    if fast:
        return lveval_requests(48, in_len=1024, out_len=16, rate=40.0)
    return lveval_requests(160, in_len=4096, out_len=32, rate=40.0)


def cluster_config(fast: bool, n_engines: int, **kw):
    from repro_torch.serving.scheduler import ClusterConfig

    return ClusterConfig(
        n_engines=n_engines, policy="round_robin", pool_blocks=1024 if fast else 4096,
        pool_shards=4, hbm_slots_per_engine=128 if fast else 512, block_tokens=16,
        index_rpc=True, index_transport="process", index_shards=2, **kw)


def run_once(fast: bool, n_engines: int, **kw) -> tuple[dict, float, list, dict]:
    """One cluster's life over the workload: (the run's stats, host wall
    seconds of ``run()``, each worker's stats, what the run conserves:
    ``refcounts_accounted``'s keys and ids, ``left`` (what ``close`` found
    running) and ``names`` / ``paths`` (its segments and FIFOs, for a check
    that they are gone))."""
    from repro_torch.serving.scheduler import Cluster

    c = Cluster(cluster_config(fast, n_engines, **kw), _layout(), device="cpu")
    try:
        for r in workload(fast):
            c.dispatch(r)
        t0 = time.perf_counter()
        stats = c.run()
        wall = time.perf_counter() - t0
        worker_stats = [w.stats_dict() for w in c.workers]
        refs = refcounts_accounted(c, diagnose=True)
        names, paths = c.shm_segment_names(), c.doorbell_paths()
    finally:
        left = c.close()
    return stats, wall, worker_stats, {**refs, "left": left, "names": names, "paths": paths}


def refcounts_accounted(c, diagnose: bool = False) -> dict:
    """With no request in flight, every pool block's refcount is accounted
    for: 1 for a block an entry of the index holds at its current epoch, 0
    for every other, except a block whose key another worker published
    again at the same time (the index keeps the block it applied last, as
    the reference's does, and the other keeps its allocation ref:
    committed, refcount 1, no entry). Returns ``settled`` (every block
    accounted for) and ``overwritten``, how many blocks are left so; one
    engine overwrites none. With ``diagnose`` it also returns the ids that
    broke a rule: ``unnamed``, the left blocks not explained, and
    ``miscounted``, the blocks whose refcount is neither the index's nor a
    left block's 1.

    The pool keeps no block's key. With journals (``selfheal``) each such
    block is named: the journals hold a publish of some key at the block's
    current epoch and a publish of the same key under another block, before
    or after it. The order does not count: a publish reaches the shard's
    ring and the journal in two calls, and two workers' calls to each
    serialise apart, so a journal may hold a key's two publishes in the
    other order from the index's. Without journals the blocks are counted:
    every block the engines wrote entered the index fresh or over a live
    entry, and an entry leaves only by an eviction, so they must number the
    blocks written less the entries and the evictions (a failed count names
    every left block). A ref leaked on a committed block that no entry
    holds breaks either rule. The index is read over the wire."""
    import numpy as np

    from repro_torch.core.shm import JOURNAL_PUBLISH

    pool, remote = c.pool, c.plane.remote
    want = np.zeros(pool.n_blocks, np.int32)
    _, ids, eps = remote.owners_of(list(range(pool.n_blocks)))
    if ids:
        ids = np.asarray(ids, np.intp)
        ok = pool.validate_epochs(ids, eps)
        want[ids[ok]] = 1
    every = np.arange(pool.n_blocks)
    rc, committed, epochs = pool.refcounts[every], pool.committed[every], pool.epochs[every]
    left = (want == 0) & (rc == 1) & committed
    left_ids = np.nonzero(left)[0].tolist()
    if c.cfg.selfheal:
        published: dict[bytes, set] = {}
        for s in c.plane.services:
            for op, key, b, e, _ in s.journal.records():
                if op == JOURNAL_PUBLISH:
                    published.setdefault(key, set()).add((b, e))
        named = set()
        for pubs in published.values():
            if len({b for b, _ in pubs}) > 1:  # the key went under two blocks
                named |= pubs
        unnamed = [b for b in left_ids if (b, int(epochs[b])) not in named]
        accounted = not unnamed
    else:
        if c.workers:
            ws = [w.stats_dict() for w in c.workers]
            written = sum(s["transfer"]["writes"] for s in ws)
            evicted = sum(s["manager"]["pool_evictions"] for s in ws)
        else:
            written = sum(e.manager.transfer.stats.writes for e in c.engines)
            evicted = sum(e.manager.stats.pool_evictions for e in c.engines)
        accounted = len(left_ids) == written - remote.stats()["entries"] - evicted
        unnamed = [] if accounted else left_ids
    miscounted = np.nonzero((rc != want) & ~left)[0].tolist()
    out = {"settled": not miscounted and accounted, "overwritten": len(left_ids)}
    if diagnose:
        out.update(unnamed=unnamed, miscounted=miscounted)
    return out


def chaos_sweep(fast: bool, n_workers: int = 2) -> dict:
    """Kill a worker, then restart the allocator, under the self-healing
    cluster; returns the ``chaos`` cell."""
    from repro_torch.distributed.fault_tolerance import FaultEvent, FaultInjector, FaultPlan
    from repro_torch.serving.scheduler import Cluster

    cfg = cluster_config(fast, n_workers, data_plane="shared", engine_processes=n_workers,
                         selfheal=True, supervisor_probe_interval=0.01,
                         journal_capacity=CHAOS_JOURNAL)
    work = workload(fast)
    third = max(1, len(work) // 3)
    out: dict = {"n_workers": n_workers}
    with Cluster(cfg, _layout(), device="cpu") as c:
        inj = FaultInjector(FaultPlan([FaultEvent(t=1.0, kind="kill_worker", shard=0),
                                       FaultEvent(t=2.0, kind="kill_allocator")]),
                            supervisors=(), worker_supervisors=c.workers,
                            allocator=c.restart_allocator).start()
        # steady: no fault yet
        for r in work[:third]:
            c.dispatch(r)
        t0 = time.perf_counter()
        c.run()
        out["steady_qps_wall"] = third / max(time.perf_counter() - t0, 1e-9)
        # outage: worker 0 killed; the first command that reaches it heals
        # it (reconcile its leases, respawn, replay)
        t_kill = time.perf_counter()
        inj.advance(now=1.0)
        recovery_s = None
        for r in work[third : 2 * third]:
            c.dispatch(r)
            if recovery_s is None and c.workers[0].restarts >= 1:
                recovery_s = time.perf_counter() - t_kill
        c.run()
        if recovery_s is None and c.workers[0].restarts >= 1:
            recovery_s = time.perf_counter() - t_kill  # the run's collect healed it
        out["outage_qps_wall"] = third / max(time.perf_counter() - t_kill, 1e-9)
        out["recovery_s"] = recovery_s
        # post: the allocator moved to a fresh ring, then the last phase
        inj.advance(now=2.0)
        for r in work[2 * third :]:
            c.dispatch(r)
        t2 = time.perf_counter()
        stats = c.run()
        out["post_qps_wall"] = (len(work) - 2 * third) / max(time.perf_counter() - t2, 1e-9)
        sh = stats["selfheal"]
        out["restarts"] = sh["worker_restarts"]
        out["allocator_restarts"] = sh["allocator_restarts"]
        out["leases_released"] = sh["leases_released"]
        # each respawn's start to CTRL_READY, forked from the forkserver
        out["worker_boot_s"] = [t for w in c.workers for t in w.boot_s]
        out["rpc_retries"] = sh["rpc_retries"]
        out["n_done"] = stats["n_done"]
        out["pool_free"] = stats["pool_free"]
        out.update(refcounts_accounted(c, diagnose=True))
    return out


def pinned_mismatches(fast: bool, parity: dict) -> list[str]:
    """The parity numbers against ``PINNED``: integers exactly, times within
    1e-12 relative."""
    from repro_torch.experiments.cluster_common import mismatches

    want = PINNED["fast" if fast else "full"]
    return mismatches({k: parity[k] for k in PARITY_KEYS}, want)


def parity(fast: bool) -> tuple[dict, tuple]:
    """Section 1: the private in-process, shared in-process and one-worker
    runs. Returns (the parity cell, with ``bit_identical``, the four numbers
    and their mismatches against ``PINNED``; the worker run's
    ``run_once`` tuple, which is the sweep's N = 1), and the other two
    runs' hygiene in ``hygiene``."""
    from repro_torch.serving.engineproc import worker_context

    worker_context()  # the workers' forkserver imports their stack meanwhile
    ref, _, _, h0 = run_once(fast, 1, data_plane="private")
    shared_inproc, _, _, h1 = run_once(fast, 1, data_plane="shared")
    worker1 = run_once(fast, 1, data_plane="shared", engine_processes=1)
    cell = {"bit_identical": ref == shared_inproc == worker1[0],
            **{k: ref[k] for k in PARITY_KEYS}, "hygiene": [h0, h1]}
    cell["pinned_mismatches"] = pinned_mismatches(fast, cell)
    return cell, worker1


def sweep(fast: bool, worker1: tuple) -> list[dict]:
    """Section 2: N = 1, 2, 4 workers over one segment (N = 1 is
    ``parity``'s run). A cell's ``bytes_moved_total`` is at most N = 1's,
    where every block of every request is read or written once: at N >= 2 a
    block another worker published between a request's match and its
    writeback is neither, and a writeback that finds the pool full of held
    blocks is skipped, both by the workers' timing (the reference's own runs
    vary there too)."""
    cells = []
    for n in (1, 2, 4):
        stats, wall, wstats, hyg = worker1 if n == 1 else run_once(
            fast, n, data_plane="shared", engine_processes=n)
        moved = [ws["transfer"]["bytes_written"] + ws["transfer"]["bytes_read"] for ws in wstats]
        cells.append({"n_workers": n, "wall_s": wall,
                      "qps_wall": stats["n_done"] / max(wall, 1e-9),
                      "per_engine_mb_s": (sum(moved) / max(1, len(moved))) / max(wall, 1e-9) / 1e6,
                      "bytes_moved_total": sum(moved), "n_done": stats["n_done"],
                      "hit_tokens": stats["hit_tokens"], "hygiene": hyg})
    return cells


def run(fast: bool = False) -> tuple[list[tuple], dict]:
    """(rows, results): the reference's three sections and rows."""
    cell, worker1 = parity(fast)
    results: dict = {"host_cores": os.cpu_count(), "parity": cell}
    rows = [("procengine.parity", 0.0,
             f"bit_identical={cell['bit_identical']};n_done={cell['n_done']}")]
    results["sweep"] = sweep(fast, worker1)
    for c in results["sweep"]:
        rows.append((f"procengine.N{c['n_workers']}", c["wall_s"] * 1e6 / max(1, c["n_done"]),
                     f"wall_s={c['wall_s']:.3f};per_engine_mb_s={c['per_engine_mb_s']:.1f};"
                     f"qps_wall={c['qps_wall']:.1f}"))
    ch = results["chaos"] = chaos_sweep(fast)
    rec = ch["recovery_s"]
    rows.append(("procengine.chaos", (rec or 0.0) * 1e6,
                 f"restarts={ch['restarts']};"
                 f"recovery_s={'none' if rec is None else f'{rec:.3f}'};"
                 f"alloc_restarts={ch['allocator_restarts']};"
                 f"boot_s={max(ch['worker_boot_s'], default=0.0):.3f};"
                 f"post_qps_wall={ch['post_qps_wall']:.1f}"))
    results["note"] = ("wall time on a host of few cores understates scaling at N >= 2 (the "
                       "parent, the allocator thread and the shard services share the cores); "
                       "the virtual-time stats do not depend on the load")
    if not cell["bit_identical"]:
        raise AssertionError("engine-worker parity broke: the shared or worker run's stats "
                             "differ from the private in-process run's")
    if not one_engine_settled(cell, results["sweep"]):
        raise AssertionError("a one-engine run left a pool refcount unaccounted for")
    return rows, results


def one_engine_settled(cell: dict, sweep_cells: list[dict]) -> bool:
    """The parity runs and the sweep's N = 1 run: every refcount accounted
    for, and none of a key published twice (one engine publishes a key
    once)."""
    hyg = cell["hygiene"] + [c["hygiene"] for c in sweep_cells if c["n_workers"] == 1]
    return all(h["settled"] and h["overwritten"] == 0 for h in hyg)


def main(argv: list[str] | None = None) -> list[tuple]:
    from repro_torch.experiments.common import emit

    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true", help="48 requests of 1024 tokens")
    ap.add_argument("--json", help="write the results here")
    args = ap.parse_args(argv)
    rows, results = run(fast=args.fast)
    print(HOST_NOTE)
    emit(rows)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2, default=str)
    return rows


if __name__ == "__main__":
    main()
