"""Cluster scheduler: cache-oblivious (Beluga §6.3) vs cache-aware (MoonCake).

Twin of ``repro/serving/scheduler.py``'s in-process cluster simulator. The
paper's §6.3 claim: with a pool at near-local latency, the scheduler can
ignore KV locality and pure load balancing wins — no skewed KV
distribution, no rebalancing on elastic scale in/out. The cache-aware
baseline routes requests toward the instance whose HBM already holds the
prefix (locality first, load second), which is what RDMA-latency systems
are forced to do.

Every engine shares ONE pool and ONE index; engines join and leave
(``add_engine`` / ``remove_engine``) with no KV migration. The pool
is payload-free (its payload lies on ``meta``): the allocator, epochs and
index run for real at the paper's size, and every time is MODELED. With
``tiering.enabled`` the pool is a ``tiering.TieredPool`` (``pool_blocks``
become its fast tier; the spill tier defaults to 4x it), its ghost list
hears the index's evictions, and one ``MigrationEngine`` shared by every
engine moves blocks along the chain, contending with the fetches in the
pool devices' queues (the reference's ``model_contention`` default).

The index is a ``PrefixIndex``, or with ``index_shards > 1`` a
``ShardedPrefixIndex``. With ``index_rpc`` the engines and the migrator
reach it over CXL-RPC rings instead, one ring of ``index_rpc_slots`` slots
of ``index_rpc_payload`` bytes per shard, and every engine and the migrator
share the plane's ``ShardedRemoteIndex``: the simulator runs in one thread,
which owns the ring clients.

  * ``index_transport="thread"``: each ring is served by a ``RingServer``
    thread of this process over the co-located index
    (``core/wire.ring_plane``); ``run()`` reads that index's stats, as the
    reference does.
  * ``index_transport="process"``: the pool's metadata moves into a named
    segment and each shard's index is built inside its own service process
    (``core/procserver.process_plane``); no index object stays here
    (``index`` is None), ``run()`` reads the stats over the wire, evictions'
    freed ids are released here (``on_freed``), and on a tiered pool the
    eviction replies' keys arm the ghost list. With ``selfheal`` each shard
    runs under a ``ShardWatchdog`` (its probe thread every
    ``supervisor_probe_interval`` s, a journal of ``journal_capacity``
    records, no periodic warm snapshot), the client journals, retries and
    degrades, and so do the managers (``degraded_ok``). ``selfheal``
    outside the process transport is ignored, as the reference ignores it.

``close()`` (or leaving a ``with`` block) stops every server thread or
service process, unlinks every segment and FIFO, and returns what is still
running; a construction that fails halfway leaves nothing behind.
``shm_segment_names()`` and ``doorbell_paths()`` name what the process
transport created.

``ClusterConfig`` holds the reference's fields that these paths read, with
the same defaults. The shared data plane and the engine workers
(``data_plane="shared"``, ``engine_processes``) are not ported yet and
raise a ``ValueError`` naming ``ROADMAP.md`` queue 1 item 7e-iii, with
tiering on or off.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import fabric
from repro_torch.core.index import PrefixIndex, ShardedPrefixIndex
from repro_torch.core.pool import KVBlockLayout, KVBlockPool
from repro_torch.core.procserver import ProcessPlane, process_plane
from repro_torch.core.rpc import RingClient
from repro_torch.core.transfer import PoolTransfer
from repro_torch.core.wire import RingPlane, ring_plane
from repro_torch.kvcache.hbm_cache import HbmPagedCache
from repro_torch.kvcache.manager import FetchPlan, KVCacheManager
from repro_torch.serving.engine import EngineInstance, SimRunner, SimRunnerConfig
from repro_torch.serving.request import Request, summarize
from repro_torch.tiering import MigrationEngine, TieredPool, TieringConfig

ITEM_SHARED = "ROADMAP.md queue 1 item 7e-iii (the shared data plane and the engine workers)"


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
    # the metadata plane behind CXL-RPC rings: one batched round trip per
    # metadata op; index_shards > 1 partitions the keys over S shards (S
    # rings with index_rpc), each served by a thread or a process of its own
    index_rpc: bool = False
    index_rpc_slots: int = 64
    index_rpc_payload: int = 1 << 16
    index_shards: int = 1
    index_transport: str = "thread"  # thread | process
    # the self-healing plane (process transport only): a watchdog a shard
    selfheal: bool = False
    journal_capacity: int = 8192  # records a shard's journal
    supervisor_probe_interval: float = 0.02  # s between probe steps
    # refused: the shared data plane and engine worker processes (item 7e-iii)
    data_plane: str = "private"
    engine_processes: int = 0
    # the tiered pool (Exp #13): disabled, the flat pool's path unchanged
    tiering: TieringConfig = field(default_factory=TieringConfig)


def refuse_unported(cfg: ClusterConfig) -> None:
    """Raise for a setting the reference refuses, or whose piece the port
    does not have yet (item 7e-iii)."""
    if cfg.index_transport not in ("thread", "process"):
        raise ValueError(
            f"index_transport must be 'thread' or 'process', got {cfg.index_transport!r}")
    if cfg.index_transport == "process" and not cfg.index_rpc:
        raise ValueError("index_transport='process' requires index_rpc=True")
    if cfg.data_plane not in ("private", "shared"):
        raise ValueError(f"data_plane must be 'private' or 'shared', got {cfg.data_plane!r}")
    for name, on in (("data_plane='shared'", cfg.data_plane == "shared"),
                     (f"engine_processes={cfg.engine_processes}", bool(cfg.engine_processes))):
        if on:
            raise ValueError(f"ClusterConfig {name} is not ported yet: {ITEM_SHARED}")


class Cluster:
    def __init__(self, cfg: ClusterConfig, layout: KVBlockLayout):
        refuse_unported(cfg)
        self.cfg = cfg
        self.plane: RingPlane | ProcessPlane | None = None
        self._closed = False
        try:
            self._build(cfg, layout)
        except BaseException:
            self.close()
            raise
        self.requests: list[Request] = []
        self._rr = 0

    def _build(self, cfg: ClusterConfig, layout: KVBlockLayout) -> None:
        tcfg = cfg.tiering
        # payload-free: the reference's backing="meta"
        if tcfg.enabled:
            spill = tcfg.spill_blocks or 4 * cfg.pool_blocks
            spill = -(-spill // cfg.pool_shards) * cfg.pool_shards
            self.pool = TieredPool(layout, cfg.pool_blocks, spill, "meta", n_shards=cfg.pool_shards,
                                   cfg=tcfg)
        else:
            self.pool = KVBlockPool(layout, cfg.pool_blocks, "meta", n_shards=cfg.pool_shards)
        shards = cfg.index_shards
        if cfg.index_rpc and cfg.index_transport == "process":
            # no index here: each shard's is built in its service process,
            # and an eviction reply's keys arm the ghost list
            self.index = None
            self.plane = process_plane(
                self.pool, shards, cfg.index_rpc_slots, cfg.index_rpc_payload,
                selfheal=cfg.selfheal, journal_capacity=cfg.journal_capacity,
                probe_interval=cfg.supervisor_probe_interval,
                on_evict=self.pool.policy.ghost_add if tcfg.enabled else None)
        else:
            self.index = (ShardedPrefixIndex(self.pool, shards) if shards > 1
                          else PrefixIndex(self.pool))
            if cfg.index_rpc:  # one ring and one server thread per shard
                self.plane = ring_plane(self.index, cfg.index_rpc_slots, cfg.index_rpc_payload)
            if tcfg.enabled:
                # destroyed keys arm the ghost list's admission filter; a
                # ring-served eviction runs on the shard, so its hook fires too
                self.index.on_evict = self.pool.policy.ghost_add
        if tcfg.enabled:
            self.queues = fabric.PoolDeviceQueues()
            # with index_rpc the migrator's owners_of / remap_many /
            # evict_blocks cross the rings; only its copies touch the pool
            self.migrator = MigrationEngine(self.pool, self._index_view(), tcfg,
                                            queues=self.queues)
        else:
            self.queues = None
            self.migrator = None
        self.engines: list[EngineInstance] = [self._make_engine(i) for i in range(cfg.n_engines)]

    def _index_view(self):
        """The index as an engine or the migrator reaches it: the object
        itself, or the client side of the rings."""
        return self.index if self.plane is None else self.plane.remote

    @property
    def ring_clients(self) -> list[RingClient]:
        """The ring clients (one per shard), whose ``stats`` count the round
        trips; empty without ``index_rpc``."""
        return [] if self.plane is None else list(self.plane.clients)

    def _owned_plane(self) -> ProcessPlane | None:
        plane = self.plane
        return plane if isinstance(plane, ProcessPlane) and not self._closed else None

    def shm_segment_names(self) -> list[str]:
        """The named segments the process transport holds (the pool's
        metadata, every ring of every generation, the journals); empty once
        closed."""
        plane = self._owned_plane()
        return [] if plane is None else plane.segment_names()

    def doorbell_paths(self) -> list[str]:
        """The FIFO paths the process transport holds; empty once closed."""
        plane = self._owned_plane()
        return [] if plane is None else plane.doorbell_paths()

    def close(self) -> list:
        """Stop every ring server thread or service process, unlink what
        they used (idempotent); returns the threads or services still
        running, which a caller must treat as a failure. The clients and
        their stats stay readable."""
        self._closed = True
        return [] if self.plane is None else self.plane.close()

    def __enter__(self) -> "Cluster":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _make_engine(self, engine_id: int) -> EngineInstance:
        cfg = self.cfg
        transfer = PoolTransfer(
            self.pool,
            mode="beluga" if cfg.transfer_mode == "none" else cfg.transfer_mode,
            super_block_tokens=cfg.super_block_tokens,
        )
        hbm = HbmPagedCache(cfg.hbm_slots_per_engine, cfg.block_tokens)
        mgr = KVCacheManager(
            self.pool, self._index_view(), hbm, transfer,
            recompute_cutover=cfg.straggler_cutover,
            prefill_tok_per_s=cfg.runner.prefill_tok_per_s,
            queues=self.queues,
            degraded_ok=cfg.selfheal and self.index is None,  # watched shards
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
        # the co-located index's counters, as the reference reads them; in
        # the process transport, over the wire
        stats["index"] = (self.index if self.index is not None else self.plane.remote).stats()
        stats["pool_free"] = self.pool.free_blocks()
        stats["shard_occupancy_max"] = max(self.pool.shard_occupancy() or [0])
        if isinstance(self.plane, ProcessPlane) and self.cfg.selfheal:
            stats["selfheal"] = {
                "restarts": self.plane.restarts(), "rpc_retries": self.plane.retries(),
                "rpc_degraded_ops": sum(c.stats.degraded_ops for c in self.plane.clients),
                "manager_degraded_ops": sum(e.manager.stats.degraded_ops for e in self.engines)}
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


def refcounts_settled(pool, index: PrefixIndex | ShardedPrefixIndex) -> bool:
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
