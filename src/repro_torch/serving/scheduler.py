"""Cluster scheduler: cache-oblivious (Beluga §6.3) vs cache-aware (MoonCake).

Twin of ``repro/serving/scheduler.py``'s in-process cluster simulator. The
paper's §6.3 claim: with a pool at near-local latency, the scheduler can
ignore KV locality and pure load balancing wins — no skewed KV
distribution, no rebalancing on elastic scale in/out. The cache-aware
baseline routes requests toward the instance whose HBM already holds the
prefix (locality first, load second), which is what RDMA-latency systems
are forced to do.

Every engine shares ONE pool and ONE in-process index; engines join and
leave (``add_engine`` / ``remove_engine``) with no KV migration. The pool
is payload-free (its payload lies on ``meta``): the allocator, epochs and
index run for real at the paper's size, and every time is MODELED. With
``tiering.enabled`` the pool is a ``tiering.TieredPool`` (``pool_blocks``
become its fast tier; the spill tier defaults to 4x it), its ghost list
hears the index's evictions, and one ``MigrationEngine`` shared by every
engine moves blocks along the chain, contending with the fetches in the
pool devices' queues (the reference's ``model_contention`` default).

``ClusterConfig`` holds the reference's fields that the in-process path
reads, with the same defaults, and the switches of the cross-process
planes (``index_rpc``, ``index_transport="process"``, a sharded index,
``data_plane="shared"``, ``engine_processes``, ``selfheal``), which the
port does not have yet: each raises a ``ValueError`` naming ``ROADMAP.md``
queue 1 item 7e, with tiering on or off. Their own knobs come with them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import fabric
from repro_torch.core.index import PrefixIndex
from repro_torch.core.pool import KVBlockLayout, KVBlockPool
from repro_torch.core.transfer import PoolTransfer
from repro_torch.kvcache.hbm_cache import HbmPagedCache
from repro_torch.kvcache.manager import FetchPlan, KVCacheManager
from repro_torch.serving.engine import EngineInstance, SimRunner, SimRunnerConfig
from repro_torch.serving.request import Request, summarize
from repro_torch.tiering import MigrationEngine, TieredPool, TieringConfig

ITEM_PLANES = "ROADMAP.md queue 1 item 7e (the cross-process planes)"

@dataclass
class ClusterConfig:
    n_engines: int = 16
    policy: str = "cache_oblivious"  # cache_oblivious | cache_aware | round_robin
    transfer_mode: str = "beluga"  # beluga | rdma | none (no offload)
    super_block_tokens: int = 0  # rdma batching granularity (LMCache: 256)
    pool_blocks: int = 65536
    pool_shards: int = 32
    # H20 (96 GB): 60 GB model -> ~28.3 GB usable KV (paper §7.1) at ~262
    # KB/token for Qwen3-32B = ~6750 16-token slots
    hbm_slots_per_engine: int = 6750
    block_tokens: int = 16
    straggler_cutover: float | None = None  # fetch-vs-recompute ratio
    runner: SimRunnerConfig = field(default_factory=SimRunnerConfig)
    # refused (item 7e): the metadata plane behind CXL-RPC rings, in
    # threads or processes, sharded, self-healing; the shared data plane;
    # engine worker processes. The defaults are the in-process path.
    index_rpc: bool = False
    index_transport: str = "thread"
    index_shards: int = 1
    data_plane: str = "private"
    engine_processes: int = 0
    selfheal: bool = False
    # the tiered pool (Exp #13): disabled, the flat pool's path unchanged
    tiering: TieringConfig = field(default_factory=TieringConfig)


def refuse_unported(cfg: ClusterConfig) -> None:
    """Raise for a setting whose piece the port does not have yet."""
    if cfg.index_transport not in ("thread", "process"):
        raise ValueError(
            f"index_transport must be 'thread' or 'process', got {cfg.index_transport!r}")
    if cfg.data_plane not in ("private", "shared"):
        raise ValueError(f"data_plane must be 'private' or 'shared', got {cfg.data_plane!r}")
    unported = [
        ("index_rpc", cfg.index_rpc, ITEM_PLANES),
        ("index_transport='process'", cfg.index_transport == "process", ITEM_PLANES),
        (f"index_shards={cfg.index_shards}", cfg.index_shards != 1, ITEM_PLANES),
        ("data_plane='shared'", cfg.data_plane == "shared", ITEM_PLANES),
        (f"engine_processes={cfg.engine_processes}", bool(cfg.engine_processes), ITEM_PLANES),
        ("selfheal", cfg.selfheal, ITEM_PLANES),
    ]
    for name, on, item in unported:
        if on:
            raise ValueError(f"ClusterConfig {name} is not ported yet: {item}")


class Cluster:
    def __init__(self, cfg: ClusterConfig, layout: KVBlockLayout):
        refuse_unported(cfg)
        self.cfg = cfg
        tcfg = cfg.tiering
        # payload-free: the reference's backing="meta"
        if tcfg.enabled:
            spill = tcfg.spill_blocks or 4 * cfg.pool_blocks
            spill = -(-spill // cfg.pool_shards) * cfg.pool_shards
            self.pool = TieredPool(layout, cfg.pool_blocks, spill, "meta", n_shards=cfg.pool_shards,
                                   cfg=tcfg)
            self.index = PrefixIndex(self.pool)
            # destroyed keys arm the ghost list's admission filter
            self.index.on_evict = self.pool.policy.ghost_add
            self.queues = fabric.PoolDeviceQueues()
            self.migrator = MigrationEngine(self.pool, self.index, tcfg, queues=self.queues)
        else:
            self.pool = KVBlockPool(layout, cfg.pool_blocks, "meta", n_shards=cfg.pool_shards)
            self.index = PrefixIndex(self.pool)
            self.queues = None
            self.migrator = None
        self.engines: list[EngineInstance] = [self._make_engine(i) for i in range(cfg.n_engines)]
        self.requests: list[Request] = []
        self._rr = 0

    def _make_engine(self, engine_id: int) -> EngineInstance:
        cfg = self.cfg
        transfer = PoolTransfer(
            self.pool,
            mode="beluga" if cfg.transfer_mode == "none" else cfg.transfer_mode,
            super_block_tokens=cfg.super_block_tokens,
        )
        hbm = HbmPagedCache(cfg.hbm_slots_per_engine, cfg.block_tokens)
        mgr = KVCacheManager(
            self.pool, self.index, hbm, transfer,
            recompute_cutover=cfg.straggler_cutover,
            prefill_tok_per_s=cfg.runner.prefill_tok_per_s,
            queues=self.queues,
        )
        if cfg.transfer_mode == "none":
            # no pool offload: disable prefix reuse entirely
            mgr.plan_fetch = _no_offload_plan(mgr)
            mgr.writeback = lambda *a, **k: 0
        return EngineInstance(engine_id, mgr, SimRunner(cfg.runner), migrator=self.migrator)

    # ------------------------------------------------------------------
    def _select_engine(self, req: Request) -> EngineInstance:
        """Routing policy only — no bookkeeping (shared by dispatch and the
        orphan re-dispatch path, which must not re-append)."""
        policy = self.cfg.policy
        if policy == "round_robin":
            eng = self.engines[self._rr % len(self.engines)]
            self._rr += 1
        elif policy == "cache_oblivious":
            eng = min(self.engines, key=lambda e: (e.load(), e.clock))
        elif policy == "cache_aware":
            local = [e for e in self.engines if e.has_prefix_locally(req)]
            eng = min(local or self.engines, key=lambda e: (e.load(), e.clock))
        else:
            raise ValueError(policy)
        return eng

    def dispatch(self, req: Request) -> EngineInstance:
        eng = self._select_engine(req)
        eng.submit(req)
        self.requests.append(req)
        return eng

    # ------------------------------------------------------------------
    def run(self, until: float | None = None) -> dict:
        if until is None:
            end = max(e.drain() for e in self.engines)
        else:
            for e in self.engines:
                e.advance(until)
            end = until
        start = min((r.arrival for r in self.requests), default=0.0)
        stats = summarize(self.requests, end - start)
        stats["index"] = self.index.stats()
        stats["pool_free"] = self.pool.free_blocks()
        stats["shard_occupancy_max"] = max(self.pool.shard_occupancy() or [0])
        if self.migrator is not None:
            stats["tiering"] = self.pool.stats_dict()
            stats["tiering"]["migrator_steps"] = self.migrator.steps
        return stats

    # ------------------------------------------------------------------
    # Elastic scaling (serving-side fault tolerance): engines join/leave
    # with NO KV rebalancing — the pool is shared (paper §6.3).
    # ------------------------------------------------------------------
    def remove_engine(self, engine_id: int) -> list[Request]:
        """Simulate an instance failure: requeue its in-flight requests,
        each routed and resubmitted once; ``requests`` keeps its order."""
        eng = self.engines[engine_id]
        orphans = list(eng.waiting) + list(eng.running)
        for r in orphans:
            r.state = "queued"
            r.t_admitted = r.t_first_token = None
            r.tokens_out = 0
        self.engines.pop(engine_id)
        for i, e in enumerate(self.engines):
            e.engine_id = i
        for r in orphans:
            self._select_engine(r).submit(r)
        return orphans

    def add_engine(self) -> EngineInstance:
        eng = self._make_engine(len(self.engines))
        eng.clock = max((e.clock for e in self.engines), default=0.0)
        self.engines.append(eng)
        return eng


def _no_offload_plan(mgr):
    def plan(tokens, now=0.0):
        return FetchPlan(0, len(tokens), [], 0.0, False)

    return plan


def refcounts_settled(pool, index: PrefixIndex) -> bool:
    """Once no request is in flight, every pool block's refcount is what
    the index owns: 1 for a block an entry holds at its current epoch, 0
    for every other. A flat pool or a tier chain."""
    ents = index.entries()
    want = np.zeros(pool.n_blocks, np.int32)
    if ents:
        ids = np.asarray([e.block_id for e in ents], np.intp)
        ok = pool.validate_epochs(ids, [e.epoch for e in ents])
        want[ids[ok]] = 1
    return bool((pool.refcounts[np.arange(pool.n_blocks)] == want).all())


def pending_live(pool) -> bool:
    """A tier chain's ``promote_pending`` names only live down-chain blocks
    that the index alone holds (committed, refcount 1)."""
    ids = np.fromiter(pool.promote_pending, np.intp, len(pool.promote_pending))
    return bool((ids >= pool.offset).all() and (pool.refcounts[ids] == 1).all()
                and pool.committed[ids].all())
