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

The pool's payload lies on ``device``: ``"meta"`` (payload-free, the
reference's ``backing="meta"``, the default) or ``"cpu"`` (real payload
rows, the twin of ``backing="numpy"``).

  * ``data_plane="shared"`` (``device="cpu"``) moves the payload into one
    named segment (``KVBlockPool.share_data``); engines in this process use
    the pool as before, over the shared rows.
  * ``engine_processes=N`` (with the shared data plane, the process
    transport, ``N == n_engines`` and ``policy="round_robin"``) runs each
    engine in a worker process of its own (``serving/engineproc.py``),
    which moves blocks on the shared segment, reaches the allocator over a
    ring served by a thread of this process (``core/wire.
    make_pool_handler``) and the index over the shard rings; the slots of
    every ring are partitioned between this process (part 0 of the index
    rings, the last slot of the allocator's) and the workers. ``run()``
    starts every worker's clock before it collects any, folds the workers'
    results into ``requests`` and then drives the migrator here, between
    rounds. With ``selfheal`` each worker runs under an
    ``EngineWorkerSupervisor``: a dead worker's leases are reconciled from
    the ``LeaseLedger`` the allocator's handler keeps, it is respawned and
    its requests not yet done are replayed; a shard respawned by its
    watchdog reaches the workers as a ``WCMD_ADOPT`` before the next
    command (``CutoverForwarder``); ``restart_allocator()`` moves the
    allocator to a fresh ring under the workers.

One thread owns the pool at a time: with workers, the allocator's server
thread, while any worker holds a command; the thread that drives the
cluster, between rounds (the migrator, stats). So a worker is restarted,
and its leases reconciled, only when no other worker holds a command: a
run that found its worker dead is run again (``rerun``) after every
worker's run was collected. The reconcile waits until the dead worker's
slots on the allocator ring hold no request; if the allocator's thread has
not served them by ``LEASE_DRAIN_S``, the allocator moves to a fresh ring
first, so that none of them is served later under the respawned worker,
which takes the same slots. The releases go over the ring, from the slot
no worker owns.

``close()`` (or leaving a ``with`` block) stops every worker, server thread
and service process, unlinks every segment and FIFO, and returns what is
still running; a construction that fails halfway leaves nothing behind.
``shm_segment_names()`` and ``doorbell_paths()`` name what the process
transport, the shared data plane and the workers created.

``ClusterConfig`` holds the reference's fields that these paths read, with
the same defaults; ``refuse`` raises the reference's refusals, in its order
and with its words (a payload off the CPU is its non-numpy backing).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import diag, fabric
from repro_torch.core.index import PrefixIndex, ShardedPrefixIndex
from repro_torch.core.pool import KVBlockLayout, KVBlockPool
from repro_torch.core.procserver import ProcessPlane, ShardWatchdog, process_plane
from repro_torch.core.rpc import REQ_READY, CTRL_STOP, RingClient, RingRetryPolicy, RingServer, SlotRing
from repro_torch.core.shm import FifoDoorbell
from repro_torch.core.shmpool import LeaseLedger
from repro_torch.core.transfer import PoolTransfer
from repro_torch.core.wire import RemotePool, RingPlane, make_pool_handler, ring_plane
from repro_torch.kvcache.hbm_cache import HbmPagedCache
from repro_torch.kvcache.manager import FetchPlan, KVCacheManager
from repro_torch.serving.engine import EngineInstance, SimRunner, SimRunnerConfig
from repro_torch.serving.engineproc import (
    PLANE_INDEX,
    PLANE_POOL,
    CutoverForwarder,
    EngineWorkerHost,
    EngineWorkerSupervisor,
    partition_slots,
    worker_context,
)
from repro_torch.serving.request import Request, summarize
from repro_torch.tiering import MigrationEngine, TieredPool, TieringConfig

LEASE_DRAIN_S = 5.0  # a dead worker's requests left on the allocator ring are served by then


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
    # the payload in one named segment ("shared", device="cpu"), and engines
    # in worker processes of their own over it (one a modeled GPU)
    data_plane: str = "private"
    engine_processes: int = 0
    # the tiered pool (Exp #13): disabled, the flat pool's path unchanged
    tiering: TieringConfig = field(default_factory=TieringConfig)


def refuse(cfg: ClusterConfig, device: str) -> None:
    """Raise the reference's refusals of a setting (its ``Cluster._build``),
    in its order and with its words; a payload on ``device`` other than
    ``"cpu"`` is its non-numpy backing."""
    if device not in ("meta", "cpu"):
        raise ValueError(device)
    if cfg.index_transport not in ("thread", "process"):
        raise ValueError(
            f"index_transport must be 'thread' or 'process', got {cfg.index_transport!r}")
    if cfg.index_transport == "process" and not cfg.index_rpc:
        raise ValueError("index_transport='process' requires index_rpc=True")
    if cfg.data_plane not in ("private", "shared"):
        raise ValueError(f"data_plane must be 'private' or 'shared', got {cfg.data_plane!r}")
    if cfg.data_plane == "shared" and device != "cpu":
        raise ValueError("data_plane='shared' requires backing='numpy' "
                         "(payload bytes must exist to be shared)")
    if cfg.engine_processes:
        if cfg.data_plane != "shared":
            raise ValueError("engine_processes requires data_plane='shared'")
        if not (cfg.index_rpc and cfg.index_transport == "process"):
            raise ValueError("engine_processes requires index_rpc=True and "
                             "index_transport='process'")
        if cfg.engine_processes != cfg.n_engines:
            raise ValueError("engine_processes must equal n_engines (one worker per modeled GPU)")
        if cfg.policy != "round_robin":
            raise NotImplementedError("engine workers support policy='round_robin' only "
                                      "(load/clock live inside the worker processes)")


class Cluster:
    def __init__(self, cfg: ClusterConfig, layout: KVBlockLayout, device: str = "meta"):
        refuse(cfg, device)
        self.cfg = cfg
        self.plane: RingPlane | ProcessPlane | None = None
        self.pool = None
        self.workers: list = []  # EngineWorkerHost / EngineWorkerSupervisor
        self._pool_server: RingServer | None = None  # the allocator's (workers)
        self._pool_ring: SlotRing | None = None
        self._pool_doorbell: FifoDoorbell | None = None
        self._pool_client: RemotePool | None = None  # the slot no worker owns
        self._pool_rings: list[tuple[str, str]] = []  # every allocator generation
        self._forwarders: list[CutoverForwarder] = []
        self._ledger: LeaseLedger | None = None
        self._data_spec: dict | None = None  # the shared data plane's attach spec
        self.allocator_restarts = 0
        self._closed = False
        self.requests: list[Request] = []
        self._rr = 0
        try:
            self._build(cfg, layout, device)
        except BaseException:
            self.close()
            raise

    def _build(self, cfg: ClusterConfig, layout: KVBlockLayout, device: str) -> None:
        tcfg = cfg.tiering
        if tcfg.enabled:
            spill = tcfg.spill_blocks or 4 * cfg.pool_blocks
            spill = -(-spill // cfg.pool_shards) * cfg.pool_shards
            self.pool = TieredPool(layout, cfg.pool_blocks, spill, device, n_shards=cfg.pool_shards,
                                   cfg=tcfg)
        else:
            self.pool = KVBlockPool(layout, cfg.pool_blocks, device, n_shards=cfg.pool_shards)
        shards = cfg.index_shards
        if cfg.engine_processes:
            worker_context()  # the workers' forkserver, before any thread that spawns
        if cfg.index_rpc and cfg.index_transport == "process":
            # no index here: each shard's is built in its service process,
            # and an eviction reply's keys arm the ghost list
            self.index = None
            self.plane = process_plane(
                self.pool, shards, cfg.index_rpc_slots, cfg.index_rpc_payload,
                selfheal=cfg.selfheal, journal_capacity=cfg.journal_capacity,
                probe_interval=cfg.supervisor_probe_interval,
                on_evict=self.pool.policy.ghost_add if tcfg.enabled else None,
                client_range=self._index_parts()[0] if cfg.engine_processes else None)
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
        if cfg.data_plane == "shared":
            self._data_spec = self.pool.share_data()
        if cfg.engine_processes:
            self._build_workers(cfg, self._data_spec)
            self.engines = self.workers
        else:
            self.engines: list[EngineInstance] = [self._make_engine(i)
                                                  for i in range(cfg.n_engines)]

    # ------------------------------------------------------------------
    # engine worker processes
    # ------------------------------------------------------------------
    def _index_parts(self) -> list[tuple[int, int]]:
        """An index ring's slots a client may use (a watched ring's last
        slot is its watchdog's), in N + 1 parts: this process's, then worker
        i's at i + 1."""
        cfg = self.cfg
        hi = cfg.index_rpc_slots - 1 if cfg.selfheal else cfg.index_rpc_slots
        return partition_slots(hi, cfg.engine_processes + 1)

    def _pool_parts(self) -> list[tuple[int, int]]:
        """The allocator ring's slots, worker i's at i; the last slot is
        this process's (the reconcile's releases)."""
        return partition_slots(self.cfg.index_rpc_slots - 1, self.cfg.engine_processes)

    def _slot_owner(self, slot: int) -> int | None:
        for w, (lo, hi) in enumerate(self._pool_parts()):
            if lo <= slot < hi:
                return w
        return None

    def _start_allocator(self) -> None:
        """The allocator's ring, its FIFO doorbell (which workers ring) and
        the thread that serves it, published together; this process's
        client takes the last slot."""
        cfg = self.cfg
        ring = SlotRing.create_shared(cfg.index_rpc_slots, cfg.index_rpc_payload)
        bell = FifoDoorbell.create()
        self._pool_rings.append((ring.shm_name, bell.path))
        bell.open_read()  # before the first park: a worker's ring finds a reader
        if cfg.selfheal:
            handler = make_pool_handler(
                self.pool, max_reply=cfg.index_rpc_payload, ledger=self._ledger,
                slot_owner=self._slot_owner, journals=[s.journal for s in self.plane.services])
        else:
            handler = make_pool_handler(self.pool, max_reply=cfg.index_rpc_payload)
        self._pool_server = RingServer(ring, handler, doorbell=bell).start()
        self._pool_ring, self._pool_doorbell = ring, bell
        n = cfg.index_rpc_slots
        rpc = RingClient(ring, slot_range=(n - 1, n), doorbell=FifoDoorbell.attach(bell.path))
        if self._pool_client is None:
            self._pool_client = RemotePool(rpc, self.pool.n_blocks)
        else:
            self._pool_client.rpc.close()
            self._pool_client.rpc = rpc

    def _worker_spec_kwargs(self, i: int, data_spec: dict) -> dict:
        """Worker ``i``'s spec from the current ring generations, at boot and
        at every respawn."""
        cfg = self.cfg
        services = [s.generation.service if isinstance(s, ShardWatchdog) else s
                    for s in self.plane.services]
        return dict(
            engine_id=i, pool_spec=data_spec,
            pool_ring_name=self._pool_ring.shm_name, pool_slots=cfg.index_rpc_slots,
            pool_payload=cfg.index_rpc_payload, pool_doorbell_name=self._pool_doorbell.path,
            pool_slot_range=self._pool_parts()[i],
            index_ring_names=tuple(s.spec.ring_name for s in services),
            index_slots=cfg.index_rpc_slots, index_payload=cfg.index_rpc_payload,
            index_doorbell_names=tuple(s.spec.doorbell_path for s in services),
            index_slot_range=self._index_parts()[i + 1],
            hbm_slots=cfg.hbm_slots_per_engine, transfer_mode=cfg.transfer_mode,
            super_block_tokens=cfg.super_block_tokens, straggler_cutover=cfg.straggler_cutover,
            runner=cfg.runner, selfheal=cfg.selfheal,
            retry=RingRetryPolicy() if cfg.selfheal else None)

    def _build_workers(self, cfg: ClusterConfig, data_spec: dict) -> None:
        """The allocator's service and one worker process a modeled GPU,
        booted at once; under selfheal, supervised workers and a cutover
        forwarder for each (shard, worker)."""
        if cfg.selfheal:
            self._ledger = LeaseLedger()
        self._start_allocator()
        for i in range(cfg.engine_processes):
            if cfg.selfheal:
                worker = EngineWorkerSupervisor(
                    lambda i=i: self._worker_spec_kwargs(i, data_spec),
                    on_worker_death=self._reconcile_worker_leases)
            else:
                worker = EngineWorkerHost(self._worker_spec_kwargs(i, data_spec))
            self.workers.append(worker)
            worker.start()
        for worker in self.workers:
            if not worker.wait_ready():
                raise RuntimeError(f"engine worker {worker.engine_id} failed to boot")
        if cfg.selfheal:
            self._forwarders = [CutoverForwarder(w, PLANE_INDEX, s, source=svc)
                                for s, svc in enumerate(self.plane.services)
                                for w in self.workers]

    def _forward_cutovers(self) -> None:
        """Carry every shard generation a watchdog published since the last
        command into the workers."""
        for f in self._forwarders:
            f.forward()

    def _reconcile_worker_leases(self, engine_id: int) -> dict:
        """A supervisor's ``on_worker_death``, when no other worker holds a
        command: once the dead worker's slots on the allocator ring hold no
        request (or, past ``LEASE_DRAIN_S``, the allocator moved to a fresh
        ring, which retires them), release its leases by the ledger's epoch
        rules, probing the index from here and releasing over the ring from
        the slot no worker owns."""
        lo, hi = self._pool_parts()[engine_id]
        deadline = time.monotonic() + LEASE_DRAIN_S
        while (self._pool_ring.status[lo:hi] == REQ_READY).any():
            if time.monotonic() > deadline:
                diag.note("scheduler.reconcile.drain_timeout")
                self._move_allocator(skip=engine_id)
                break
            time.sleep(1e-3)
        return self._ledger.reconcile(engine_id, self.pool,
                                      owners_of=self.plane.remote.owners_of,
                                      release=self._pool_client.release)

    def restart_allocator(self) -> None:
        """Move the allocator to a fresh ring under the workers (the
        allocator outage drill): the pool's state never leaves this process,
        only the transport moves. Between rounds, so that no worker posts
        meanwhile."""
        if self._pool_ring is None:
            raise RuntimeError("no allocator service to restart")
        self._move_allocator()
        self.allocator_restarts += 1

    def _move_allocator(self, skip: int | None = None) -> None:
        """Stop the old server (a request still on its ring is never
        served), start the new one, move every worker's client but
        ``skip``'s (``WCMD_ADOPT``; a respawn's spec names the new ring),
        then retire the old ring with its ``CTRL_STOP`` set."""
        old_server, old_ring, old_bell = self._pool_server, self._pool_ring, self._pool_doorbell
        if not old_server.stop():
            raise TimeoutError("the allocator's server thread did not stop")
        self._start_allocator()
        for worker in self.workers:
            if worker.engine_id != skip:
                CutoverForwarder(worker, PLANE_POOL).adopt_ring(
                    self._pool_ring, bell_path=self._pool_doorbell.path)
        old_ring.ctrl[CTRL_STOP] = 1  # a client that missed the cutover fails fast
        old_ring.close()
        old_bell.close()

    # ------------------------------------------------------------------
    def _index_view(self):
        """The index as an engine or the migrator reaches it: the object
        itself, or the client side of the rings."""
        return self.index if self.plane is None else self.plane.remote

    @property
    def ring_clients(self) -> list[RingClient]:
        """The ring clients (one per shard), whose ``stats`` count the round
        trips; empty without ``index_rpc``."""
        return [] if self.plane is None else list(self.plane.clients)

    def shm_segment_names(self) -> list[str]:
        """The named segments this cluster holds (the pool's metadata and
        payload, every ring of every generation, the journals, the
        workers' command rings); empty once closed."""
        if self._closed:
            return []
        names = self.plane.segment_names() if isinstance(self.plane, ProcessPlane) else []
        spec = self._data_spec
        if spec is not None:
            names.append(spec["data_shm_name"])
            if spec["meta"]["shm_name"] not in names:
                names.append(spec["meta"]["shm_name"])
        names += [name for name, _ in self._pool_rings]
        return names + [n for w in self.workers for n in w.segment_names()]

    def doorbell_paths(self) -> list[str]:
        """The FIFO paths this cluster holds; empty once closed."""
        if self._closed:
            return []
        paths = self.plane.doorbell_paths() if isinstance(self.plane, ProcessPlane) else []
        paths += [path for _, path in self._pool_rings]
        return paths + [p for w in self.workers for p in w.doorbell_paths()]

    def close(self) -> list:
        """Stop every worker, server thread and service process, unlink
        what they used (idempotent); returns what still runs, which a caller
        must treat as a failure. The ring clients and their stats stay
        readable."""
        if self._closed:
            return []
        self._closed = True
        # the workers first: they hold every other plane's segments
        for w in self.workers:
            w.close()
        left = [w for w in self.workers if w.running()]
        if self._pool_server is not None and not self._pool_server.stop():
            left.append(self._pool_server)
        if self._pool_client is not None:
            self._pool_client.rpc.close()
        if self._pool_ring is not None:
            self._pool_ring.close()
            self._pool_doorbell.close()
        if self.plane is not None:
            left += self.plane.close()
        if self.pool is not None:
            self.pool.unshare_data()
            self.pool.unshare_meta()
        return left

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
        if self.workers:
            # a worker echoes the parent's index back with the results
            self._forward_cutovers()
            eng.submit_indexed(req, len(self.requests))
        else:
            eng.submit(req)
        self.requests.append(req)
        return eng

    # ------------------------------------------------------------------
    def run(self, until: float | None = None) -> dict:
        if self.workers:
            # every worker's clock starts before any reply is collected: the
            # N drains run at once, against the one shared segment
            self._forward_cutovers()
            tokens = [w.post_run(until) for w in self.workers]
            clocks = [w.collect_run(t) for w, t in zip(self.workers, tokens)]
            # a supervised worker that died under its run restarts only now,
            # with every other worker idle: its restart reconciles its leases
            clocks = [w.rerun(t) if clock is None else clock
                      for w, t, clock in zip(self.workers, tokens, clocks)]
            end = until if until is not None else max(clocks, default=0.0)
            for w in self.workers:
                w.apply_results(self.requests)
            if self.migrator is not None:
                # the migrator stays with the pool; the workers only signal
                # demand over the ring. Driven here, between rounds
                self.migrator.run_until(end)
        elif until is None:
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
            if self.workers:  # the managers are in the workers: their counters come back
                mgr_degraded = sum(w.stats_dict()["manager"]["degraded_ops"]
                                   for w in self.workers)
            else:
                mgr_degraded = sum(e.manager.stats.degraded_ops for e in self.engines)
            stats["selfheal"] = {
                "restarts": self.plane.restarts(), "rpc_retries": self.plane.retries(),
                "rpc_degraded_ops": sum(c.stats.degraded_ops for c in self.plane.clients),
                "manager_degraded_ops": mgr_degraded}
            if self.workers:
                stats["selfheal"]["worker_restarts"] = sum(w.restarts for w in self.workers)
                stats["selfheal"]["allocator_restarts"] = self.allocator_restarts
                stats["selfheal"]["leases_released"] = sum(
                    r["released"] for w in self.workers for r in w.reconciled if r is not None)
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
        if self.workers:
            raise NotImplementedError("elastic scaling with engine worker processes (ROADMAP)")
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
        if self.workers:
            raise NotImplementedError("elastic scaling with engine worker processes (ROADMAP)")
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
