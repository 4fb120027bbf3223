"""The metadata plane in processes of its own (paper §6): shard services
over shared-memory rings, and the watchdog that keeps a shard alive.

Twin of ``repro/core/procserver.py``. The paper's metadata service owns its
cores and serves engines over load / store slots in the shared pool, not as
a thread inside the engine's interpreter. Here:

  * ``ShardProcess`` starts one OS process for one index shard behind one
    ring in a named segment (``core/rpc.SlotRing.create_shared``). The child
    gets a ``ShardSpec`` of names and numbers only, attaches the ring and
    the pool's shared metadata (``PoolMetaView``), builds its own
    ``PrefixIndex``, replays the shard's journal if it has one, sets
    ``CTRL_READY`` and serves until ``CTRL_STOP``. When the ring stays
    empty it parks on a ``core/shm.FifoDoorbell``, which a client's post
    rings. The child imports numpy and this package's torch-free modules
    only (``core/{shm,rpc,wire,index,fabric,diag}``, ``distributed/
    fault_tolerance``).
  * The service never writes the pool: ``PoolMetaView.release`` does
    nothing, the freed ids travel back in the eviction replies, and the
    pool-owning process releases them (``RemoteIndex(on_freed=...)``).
  * ``ShardWatchdog`` keeps one shard alive across crashes: it owns the
    shard's ``PublishJournal`` and a succession of ``ShardProcess``
    generations, and respawns a dead one on a fresh ring that replays the
    journal before it serves, then restores the last warm snapshot (LRU
    order and hit / miss counters).
  * ``process_plane`` puts S shards (plain or watched) over a pool and a
    ``ShardedRemoteIndex`` over their rings (``ProcessPlane``), the one
    place the process transport is put together (``serving/scheduler``,
    ``experiments/{exp11_rpc,ring_serve}``).

Differences from the reference, by design:

  * The start method is ``spawn``, always. The reference forks unless jax
    is loaded; the port's parent has torch loaded, its thread pools and, on
    the card, a live CUDA context, which a forked child must not inherit.
  * The watchdog takes no lock. Its probe thread (or, without one, the
    caller of ``check``) alone restarts a shard; a new generation is
    published as one immutable attribute (``generation``, a
    ``ShardGeneration``); each engine-side ``RingClient`` adopts it on its
    own thread when a call raises ``RingServiceDied`` (``RingClient.follow``).
    The warm snapshot and its restore go over the watchdog's own client,
    on a slot range the engine-side clients never use (the reference
    borrows a registered client, which would give it a second owner).
  * Liveness reads the child's sentinel and the ring's ``CTRL_STOP``, and
    reaps nothing, so any thread may ask. It is exact, so a probe step
    restarts a dead shard at once, with no heartbeat grace window.
  * There is no periodic warm snapshot (the reference's
    ``snapshot_interval``): the owner calls ``capture_snapshot``.
  * The reference's idle knobs (spin passes, backoff, park time) are
    constants here: no caller sets them to more than one value.
"""

from __future__ import annotations

import atexit
import multiprocessing
import os
import select
import signal
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import diag
from repro_torch.core.rpc import (
    CTRL_BUSY_NS,
    CTRL_DOORBELL,
    CTRL_READY,
    CTRL_SERVED,
    CTRL_STOP,
    RingClient,
    RingError,
    RingRetryPolicy,
    SlotRing,
    drain_ready,
)
from repro_torch.core.shm import (
    FifoDoorbell,
    PublishJournal,
    attach_segment,
    close_segment,
    live_entries,
)
from repro_torch.core.wire import ClientTotals, RemoteIndex, ShardedRemoteIndex

# a service's empty passes that only yield before it parks on its doorbell,
# and its longest park (the ceiling a wakeup lost to the arm / post race
# costs; a parked child holds no engine's interpreter lock)
SPIN_PASSES = 200
PARK_S = 0.05
READY_TIMEOUT_S = 30.0  # a spawned child's boot, under a loaded host


@dataclass(frozen=True)
class _MetaLayout:
    block_tokens: int


class PoolMetaView:
    """The attach side of a pool's ``share_meta`` segment, read-only: what a
    ``PrefixIndex`` needs of its pool (``n_blocks``, ``layout.block_tokens``,
    ``epochs``, ``refcounts``, ``committed``, ``validate_epochs``) over the
    memory the pool-owning process writes. ``release`` does nothing: the
    owner releases the ids the eviction replies carry."""

    def __init__(self, shm_name: str, n_blocks: int, block_tokens: int):
        self._segment = attach_segment(shm_name)
        self.n_blocks = n_blocks
        self.layout = _MetaLayout(block_tokens)
        buf = self._segment.buf
        self.epochs = np.frombuffer(buf, np.int64, n_blocks, 0)
        self.refcounts = np.frombuffer(buf, np.int32, n_blocks, 8 * n_blocks)
        self.committed = np.frombuffer(buf, np.bool_, n_blocks, 12 * n_blocks)

    def validate_epochs(self, block_ids, epochs) -> np.ndarray:
        ids = np.asarray(block_ids, np.intp)
        return self.committed[ids] & (self.epochs[ids] == np.asarray(epochs))

    def release(self, block_ids) -> None:
        """Deferred to the pool's owner (``RemoteIndex.on_freed``)."""

    def close(self) -> None:
        if self._segment is None:
            return
        self.epochs = self.refcounts = self.committed = None
        close_segment(self._segment, unlink=False)
        self._segment = None


@dataclass(frozen=True)
class ShardSpec:
    """What a service child needs to build its shard: names and numbers,
    nothing else crosses into the child."""

    ring_name: str
    n_slots: int
    payload_bytes: int
    pool_name: str
    n_blocks: int
    block_tokens: int
    doorbell_path: str
    journal_name: str | None = None
    journal_capacity: int = 0


def _service_main(spec: ShardSpec) -> None:
    """The child: attach, replay the journal, serve until ``CTRL_STOP``."""
    from repro_torch.core.index import PrefixIndex
    from repro_torch.core.wire import make_index_handler

    ring = SlotRing.attach(spec.ring_name, spec.n_slots, spec.payload_bytes)
    pool = PoolMetaView(spec.pool_name, spec.n_blocks, spec.block_tokens)
    bell = FifoDoorbell.attach(spec.doorbell_path)
    index = PrefixIndex(pool)
    if spec.journal_name is not None:
        # replayed before CTRL_READY: the first request a client lands on
        # this ring already sees every confirmed entry
        journal = PublishJournal.attach(spec.journal_name, spec.journal_capacity)
        try:
            index.rebuild_from_journal(journal.records())
        finally:
            journal.close()
    handler = make_index_handler(index, max_reply=spec.payload_bytes, ctrl=ring.ctrl)
    try:
        serve(ring, handler, bell)
    finally:
        handler = None  # drop the ctrl view before the ring's mapping goes
        bell.close()
        ring.close()
        pool.close()


def serve(ring: SlotRing, handler, bell: FifoDoorbell) -> None:
    """A service process's loop: set ``CTRL_READY``, then serve ``ring``
    until ``CTRL_STOP``; after ``SPIN_PASSES`` empty passes that only yield,
    arm ``CTRL_DOORBELL``, scan once more and park on ``bell`` for at most
    ``PARK_S``, so that a stop with no wakeup still ends the loop."""
    bell.open_read()  # a producer that sees the armed word finds a reader
    ring.ctrl[CTRL_READY] = 1
    idle = 0
    while not ring.ctrl[CTRL_STOP]:
        if drain_ready(ring, handler):
            idle = 0
            continue
        idle += 1
        if idle < SPIN_PASSES:
            time.sleep(0)
            continue
        ring.ctrl[CTRL_DOORBELL] = 1  # arm, scan once more, then park
        try:
            if drain_ready(ring, handler):
                idle = 0
                continue
            bell.wait(PARK_S)
        finally:
            ring.ctrl[CTRL_DOORBELL] = 0


def _exited(proc) -> bool:
    """The child has exited (reaped or not): its sentinel reads EOF."""
    return bool(select.select([proc.sentinel], [], [], 0)[0])


class ShardProcess:
    """One shard service process behind one ring in a named segment.

    ``start`` spawns the child; ``alive`` (the clients' liveness) is False
    once the child has exited or ``CTRL_STOP`` is set; ``kill`` crashes it
    (``kill -9``); ``stop`` sets ``CTRL_STOP``, wakes the child and reaps
    it; ``close`` also unlinks the ring and the doorbell. An ``atexit`` hook
    holds ``close`` from construction on, and a failure in construction
    leaves nothing behind."""

    def __init__(self, pool_spec: dict, n_slots: int = 64, payload_bytes: int = 1 << 16,
                 journal: PublishJournal | None = None):
        self.ring = self.doorbell = self._proc = None
        self._closed = False
        atexit.register(self.close)
        try:
            self.ring = SlotRing.create_shared(n_slots, payload_bytes)
            self.doorbell = FifoDoorbell.create()
        except BaseException:
            self.close()
            raise
        self.spec = ShardSpec(
            ring_name=self.ring.shm_name, n_slots=n_slots, payload_bytes=payload_bytes,
            pool_name=pool_spec["shm_name"], n_blocks=pool_spec["n_blocks"],
            block_tokens=pool_spec["block_tokens"], doorbell_path=self.doorbell.path,
            journal_name=None if journal is None else journal.name,
            journal_capacity=0 if journal is None else journal.capacity)
        self._proc = multiprocessing.get_context("spawn").Process(
            target=_service_main, args=(self.spec,), daemon=True, name="shard-service")

    def start(self) -> "ShardProcess":
        self._proc.start()
        return self

    # -- state --------------------------------------------------------------
    def _ctrl(self, word: int) -> int:
        ctrl = None if self.ring is None else self.ring.ctrl
        return 0 if ctrl is None else int(ctrl[word])

    @property
    def ready(self) -> bool:
        """The child has replayed its journal and serves."""
        return bool(self._ctrl(CTRL_READY))

    @property
    def served(self) -> int:
        """Requests served (the ring's ctrl word, kept in the child)."""
        return self._ctrl(CTRL_SERVED)

    @property
    def busy_ns(self) -> int:
        """Nanoseconds the child spent in its handler."""
        return self._ctrl(CTRL_BUSY_NS)

    def running(self) -> bool:
        """The child was started and has not exited."""
        p = self._proc
        return p is not None and p.pid is not None and not _exited(p)

    def alive(self) -> bool:
        """The liveness a client probes: the child runs and was not asked to
        stop. Any thread may call it."""
        return self.running() and not self._ctrl(CTRL_STOP)

    def wait_ready(self, timeout: float = READY_TIMEOUT_S) -> bool:
        """Wait for ``CTRL_READY``; False if the child died or the time ran
        out first."""
        deadline = time.monotonic() + timeout
        while not self.ready:
            if not self.running() or time.monotonic() > deadline:
                return False
            time.sleep(1e-3)
        return True

    # -- clients ------------------------------------------------------------
    def producer(self) -> FifoDoorbell:
        """A client's handle on the doorbell (its own descriptor)."""
        return FifoDoorbell.attach(self.spec.doorbell_path)

    def client(self, slot_range: tuple[int, int] | None = None) -> RingClient:
        return RingClient(self.ring, liveness=self.alive, slot_range=slot_range,
                          doorbell=self.producer())

    # -- ending -------------------------------------------------------------
    def kill(self) -> None:
        """Crash the child (SIGKILL) and wait until it has exited; nothing
        is reaped here."""
        p = self._proc
        if p is None or p.pid is None or _exited(p):
            return
        os.kill(p.pid, signal.SIGKILL)
        select.select([p.sentinel], [], [], 5.0)

    def stop(self, timeout: float = 5.0) -> None:
        """Set ``CTRL_STOP`` (also on a dead child's ring, so that its
        clients fail fast), wake the child, and reap it, escalating to
        SIGTERM and SIGKILL if it does not exit."""
        if self.ring is not None and self.ring.ctrl is not None:
            self.ring.ctrl[CTRL_STOP] = 1
            if self.doorbell is not None:
                self.doorbell.set()
        p = self._proc
        if p is None or p.pid is None:
            return
        p.join(timeout)
        if p.is_alive():
            p.terminate()
            p.join(1.0)
        if p.is_alive():
            p.kill()
            p.join(1.0)

    def close(self) -> None:
        """Stop the child, unlink the ring and the doorbell; safe to repeat."""
        if self._closed:
            return
        self._closed = True
        try:
            self.stop()
        finally:
            if self.ring is not None:
                self.ring.close()
            if self.doorbell is not None:
                self.doorbell.close()
            atexit.unregister(self.close)

    def segment_names(self) -> list[str]:
        return [self.spec.ring_name]

    def doorbell_paths(self) -> list[str]:
        return [self.spec.doorbell_path]


@dataclass(frozen=True)
class ShardGeneration:
    """One generation of a watched shard: its number (0 first) and its
    service. Published whole, never changed."""

    number: int
    service: ShardProcess


class ShardWatchdog:
    """Keeps one shard's service alive across crashes (twin of the
    reference's ``ShardSupervisor``, ``repro/core/procserver.py:343``).

    It owns the shard's ``PublishJournal`` and every ``ShardProcess``
    generation. A probe step that finds the current service dead (its
    child exited, which the sentinel tells exactly) restarts the shard:
    reap the old generation (its ring's ``CTRL_STOP`` set, so its clients
    fail fast), spawn a fresh service on a fresh ring that replays the
    journal before ``CTRL_READY``, restore the warm snapshot over the
    watchdog's own client, then publish the new ``generation``. At most
    ``max_restarts`` restarts; past them a dead shard stays down and its
    clients degrade.

    Single owner, no lock: the probe thread (``start(probe=True)``) alone
    takes probe steps, or, without one, the caller of ``check``. Engine-side
    clients (``client()``, over ``client_range``) adopt a new generation
    themselves (``RingClient.follow``). The watchdog's own client holds the
    last slot of every ring; the owner takes a warm snapshot with
    ``capture_snapshot``, and the restore goes over the same client. Rings
    of retired generations stay mapped until ``close``: a client may still
    read them."""

    def __init__(self, pool_spec: dict, *, n_slots: int = 64, payload_bytes: int = 1 << 16,
                 journal_capacity: int = 4096, probe_interval: float = 0.02,
                 max_restarts: int = 16):
        if n_slots < 2:
            raise ValueError("a watched ring needs a slot for its watchdog and one for clients")
        self._pool_spec = dict(pool_spec)
        self._geometry = (n_slots, payload_bytes)
        self.client_range = (0, n_slots - 1)
        self._own_range = (n_slots - 1, n_slots)
        self.probe_interval = probe_interval
        self.max_restarts = max_restarts
        self.restarts = 0
        self._snapshot: tuple[list, int, int] | None = None
        self._services: list[ShardProcess] = []
        self._stop = threading.Event()
        self._probe: threading.Thread | None = None
        self._own: RemoteIndex | None = None
        self.generation: ShardGeneration | None = None
        self.journal = None
        self._closed = False
        atexit.register(self.close)
        try:
            self.journal = PublishJournal.create(journal_capacity)
            self._services.append(self._new_service())
        except BaseException:
            self.close()
            raise
        self._journal_name = self.journal.name

    def _new_service(self) -> ShardProcess:
        return ShardProcess(self._pool_spec, *self._geometry, journal=self.journal)

    def _publish(self, srv: ShardProcess) -> None:
        """Point the watchdog's own client at ``srv``, then publish it."""
        if self._own is not None:
            self._own.rpc.close()
        self._own = RemoteIndex(srv.client(self._own_range), self._pool_spec["block_tokens"])
        self.generation = ShardGeneration(len(self._services) - 1, srv)

    def start(self, probe: bool = True) -> "ShardWatchdog":
        """Spawn generation 0; with ``probe``, start the probe thread."""
        srv = self._services[0].start()
        self._publish(srv)
        if probe:
            self._probe = threading.Thread(target=self._probe_loop, name="shard-watchdog",
                                           daemon=True)
            self._probe.start()
        return self

    def wait_ready(self, timeout: float = READY_TIMEOUT_S) -> bool:
        return self.generation.service.wait_ready(timeout)

    def alive(self) -> bool:
        return self.generation.service.alive()

    def running(self) -> bool:
        """Any generation's child has not exited."""
        return any(s.running() for s in list(self._services))

    def client(self, slot_range: tuple[int, int] | None = None) -> RingClient:
        """An engine-side client that follows this watchdog's generations,
        over ``slot_range`` (within ``client_range``, all of it by default)."""
        srv = self.generation.service
        return RingClient(srv.ring, liveness=srv.alive,
                          slot_range=self.client_range if slot_range is None else slot_range,
                          doorbell=srv.producer(), source=self)

    # -- totals over the generations ------------------------------------------
    @property
    def served(self) -> int:
        return sum(s.served for s in list(self._services))

    @property
    def busy_ns(self) -> int:
        return sum(s.busy_ns for s in list(self._services))

    def segment_names(self) -> list[str]:
        """The journal's and every generation's ring's segment names."""
        return [self._journal_name] + [s.spec.ring_name for s in list(self._services)]

    def doorbell_paths(self) -> list[str]:
        return [s.spec.doorbell_path for s in list(self._services)]

    # -- probing and restarting ---------------------------------------------
    def kill(self) -> None:
        """Crash the current generation (``kill -9``)."""
        self.generation.service.kill()

    def check(self) -> bool:
        """One probe step, for an owner that runs no probe thread; True when
        it restarted the shard."""
        if self._probe is not None:
            raise RuntimeError("check() is for a watchdog without a probe thread")
        return self._step()

    def _step(self) -> bool:
        if self._closed or self.generation.service.alive():
            return False
        return self._restart()

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_interval):
            self._step()

    def _restart(self) -> bool:
        if self.restarts >= self.max_restarts:
            return False  # a flapping shard stays down: its clients degrade
        self.generation.service.stop()  # reap; the ring stays mapped
        srv = self._new_service()
        self._services.append(srv)
        srv.start()
        if srv.wait_ready():
            self._publish_warm(srv)
        else:  # stillborn: published all the same, so the next step retries
            self._publish(srv)
        self.restarts += 1  # counted once the generation is published
        return True

    def _publish_warm(self, srv: ShardProcess) -> None:
        """Restore the last snapshot into ``srv`` over the own client, then
        publish it. The snapshot's entries go back in its LRU order (each
        restore is a publish, which refreshes) where the journal still holds
        them at the same block and epoch, so no entry retracted or remapped
        since comes back; OP_SEED_STATS restores the counters. A failure
        leaves the journal's rebuild, which is the contract."""
        self._publish(srv)
        snap = self._snapshot
        if snap is None:
            return
        entries, hits, misses = snap
        live = live_entries(self.journal.records())
        keep = [(k, b, e, t) for k, b, e, t in entries
                if (lv := live.get(k)) is not None and lv[0] == b and lv[1] == e]
        try:
            self._own.restore_entries([k for k, *_ in keep], [b for _, b, _, _ in keep],
                                      [e for _, _, e, _ in keep], [t for *_, t in keep])
            self._own.seed_stats(hits, misses)
        except (RingError, TimeoutError):
            diag.note("procserver.apply_snapshot.failed")

    def capture_snapshot(self) -> bool:
        """Page the live shard's entries (LRU order) and its hit / miss
        counters into the warm snapshot over the own client; False (the old
        snapshot kept) if the shard is down or the paging failed."""
        own = self._own
        if own is None or not self.generation.service.alive():
            return False
        try:
            entries = own.snapshot_all()
            st = own.stats()
        except (RingError, TimeoutError):
            diag.note("procserver.capture_snapshot.failed")
            return False
        self._snapshot = (entries, st["hits"], st["misses"])
        return True

    def close(self) -> None:
        """Stop the probe thread, then every generation and the journal;
        safe to repeat."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if self._probe is not None:
            self._probe.join(timeout=2 * READY_TIMEOUT_S)
            if self._probe.is_alive():
                diag.note("procserver.watchdog_close.probe_alive")
        for s in self._services:
            s.close()
        if self._own is not None:
            self._own.rpc.close()
        if self.journal is not None:
            self.journal.close()
        atexit.unregister(self.close)


@dataclass
class ProcessPlane(ClientTotals):
    """An index served by S shard services in processes of their own over a
    pool's shared metadata: ``services`` (``ShardProcess`` or
    ``ShardWatchdog``, shard s behind ring s), ``clients`` (one a ring,
    used from one thread) and ``remote``, the index's surface over them.
    ``close`` stops every service, unlinks every segment and FIFO, and
    returns the pool's metadata to private arrays."""

    pool: object
    meta_name: str
    services: list = field(default_factory=list)
    clients: list[RingClient] = field(default_factory=list)
    remote: ShardedRemoteIndex | None = None

    def restarts(self) -> int:
        return sum(getattr(s, "restarts", 0) for s in self.services)

    def segment_names(self) -> list[str]:
        return [self.meta_name] + [n for s in self.services for n in s.segment_names()]

    def doorbell_paths(self) -> list[str]:
        return [p for s in self.services for p in s.doorbell_paths()]

    def close(self) -> list:
        """Stop everything (idempotent); returns the services whose child
        still runs, which a caller must treat as a failure."""
        for c in self.clients:
            c.close()
        for s in self.services:
            s.close()
        self.pool.unshare_meta()
        return [s for s in self.services if s.running()]


def process_plane(pool, n_shards: int, n_slots: int, payload_bytes: int, *,
                  selfheal: bool = False, retry: RingRetryPolicy | None = None,
                  journal_capacity: int = 4096, probe_interval: float = 0.02,
                  probe: bool = True, on_evict=None,
                  client_range: tuple[int, int] | None = None) -> ProcessPlane:
    """Serve an index of ``pool`` (a ``KVBlockPool`` or ``TieredPool``,
    whose metadata this shares) from ``n_shards`` service processes, each
    behind a ring of ``n_slots`` slots of ``payload_bytes``, and put a
    ``ShardedRemoteIndex`` over them whose ``on_freed`` is the pool's
    release. With ``selfheal`` each shard runs under a ``ShardWatchdog``
    (its probe thread with ``probe``) and the client journals, retries
    (``retry``, a default ``RingRetryPolicy`` if None) and degrades. The
    plane's clients take ``client_range`` of each ring's slots (every slot a
    client may use by default), so that engine worker processes can hold the
    rest. Every service boots at once; nothing is left running if a step
    fails."""
    spec = pool.share_meta()
    plane = ProcessPlane(pool, spec["shm_name"])
    try:
        for _ in range(n_shards):
            if selfheal:
                svc = ShardWatchdog(spec, n_slots=n_slots, payload_bytes=payload_bytes,
                                    journal_capacity=journal_capacity,
                                    probe_interval=probe_interval)
                plane.services.append(svc)
                svc.start(probe=probe)
            else:
                plane.services.append(ShardProcess(spec, n_slots, payload_bytes).start())
        for svc in plane.services:
            if not svc.wait_ready():
                raise RuntimeError("a shard service never became ready")
        plane.clients = [svc.client(client_range) for svc in plane.services]
        if selfheal and retry is None:
            retry = RingRetryPolicy()
        plane.remote = ShardedRemoteIndex(
            plane.clients, spec["block_tokens"], retry=retry, on_evict=on_evict,
            on_freed=pool.release,
            journals=[s.journal for s in plane.services] if selfheal else None,
            degrade=selfheal)
    except BaseException:
        plane.close()
        raise
    return plane
