"""CXL-RPC: the lock-free shared-memory slot ring (paper §6.2, Exp #11).

Twin of ``repro/core/rpc.py``, with the same slot protocol and the same
byte layout, so the port and the JAX package can serve each other over one
named segment:

  * ``ctrl[5] int64 | status[n_slots] int64 | req | resp``; a slot is a
    ``u32`` length and the payload, padded to whole 64-byte cache lines;
  * the client writes a request, then flips its status word to REQ_READY;
    the server scans every status word in one vectorised pass
    (``drain_ready``), answers, and flips the word to RESP_READY, or to
    RESP_ERROR with the handler's exception text (cut on a UTF-8 character
    boundary) so a bad request never kills the service;
  * ``post`` / ``collect`` split a round trip, so a sharded client keeps
    requests to several rings outstanding at once (``call`` is both);
  * a client whose wait times out quarantines the slot: the server may
    still answer into it, so it returns to the free list only once the
    server has (seen at the next acquire), or once a ``liveness`` probe says
    no server is left to write there;
  * ``RingStats`` count failed round trips and fold their wait into
    ``total_wait`` before raising; ``RingRetryPolicy`` bounds a caller's
    backoff; ``adopt_ring`` cuts a client over to a fresh ring.

Single owner, no lock: the reference guards a client's free list with a
lock so that threads may share one client. Here a client belongs to one
thread; threads that share a ring each hold their own client over a
disjoint ``slot_range``, as the reference's engine worker processes do. The
server runs in a ``threading.Thread`` (``RingServer``, the thread
transport, its doorbell a ``threading.Event``) or in a process of its own
over a ring in a named segment (``core/procserver.ShardProcess``, the
process transport, its doorbell a ``core/shm.FifoDoorbell``); ``drain_ready``
serves both. A client that follows a ``core/procserver.ShardWatchdog``
(``source``) moves itself onto the watchdog's newest ring when a call
raises ``RingServiceDied`` (``follow``), on its own thread.

``RdmaRpcModel`` is the reference's ``ModeledRdmaRpc``: the same handler,
its round trip priced by the paper's RDMA constants (MODELED).
"""

from __future__ import annotations

import struct
import threading
import time
from dataclasses import dataclass

import numpy as np

from repro_torch.core import fabric
from repro_torch.core.shm import attach_segment, close_segment, create_segment

IDLE, REQ_READY, RESP_READY, RESP_ERROR = 0, 1, 2, 3
CACHE_LINE = 64
_LEN = struct.Struct("<I")

# control words at the head of every ring, as the reference's: STOP asks an
# out-of-process service to exit; SERVED and BUSY_NS are the service-side
# timer (requests served, ns inside handlers) kept by ``drain_ready``;
# READY is set once the service serves; DOORBELL is armed while a parked
# server waits for a post to wake it
CTRL_STOP, CTRL_SERVED, CTRL_READY, CTRL_BUSY_NS, CTRL_DOORBELL = 0, 1, 2, 3, 4
_N_CTRL = 5
# a parked server's longest sleep, the backstop for a lost wakeup (which the
# arm-then-scan order rules out in process): each timed-out wait takes the
# GIL from an engine in the same process, so it is rare (PERF.md §6)
DOORBELL_WAIT_S = 1.0
# collect's sleep(0) passes, then its naps: a client that only yields with
# sleep(0) takes the GIL straight back, and a server woken from its doorbell
# waits out the 5 ms switch interval before it can answer
CLIENT_SPINS, CLIENT_NAP_S = 32, 20e-6


class RingError(RuntimeError):
    """A handler failure, relayed in-band (a RESP_ERROR frame)."""


class RingServiceDied(RingError):
    """The service died, or the client's ring was swapped, while a call was
    outstanding: transient, so safe to retry for every op."""


@dataclass
class RingStats:
    requests: int = 0  # completed
    total_wait: float = 0.0  # errored and timed-out waits included
    timeouts: int = 0
    errors: int = 0  # RESP_ERROR frames and dead services
    retries: int = 0  # attempts retried under a RingRetryPolicy
    restarts: int = 0  # ring swaps seen (adopt_ring)
    degraded_ops: int = 0  # ops a degrading sharded client turned into holes

    @property
    def round_trips(self) -> int:
        """Every round trip that took ring time, failed or not."""
        return self.requests + self.errors + self.timeouts

    def avg_wait(self) -> float:
        return self.total_wait / max(1, self.round_trips)


@dataclass(frozen=True)
class RingRetryPolicy:
    """Bounded exponential backoff: ``backoff(attempt)`` is the sleep before
    retry ``attempt`` (1-based), base * 2^(attempt-1), capped; with the
    defaults the budget over ``max_retries`` is about 3.3 s."""

    max_retries: int = 8
    base_backoff: float = 0.02
    max_backoff: float = 1.0

    def backoff(self, attempt: int) -> float:
        return min(self.max_backoff, self.base_backoff * (2 ** (attempt - 1)))

    def budget(self) -> float:
        """Seconds of sleep before the last retry gives up."""
        return sum(self.backoff(a) for a in range(1, self.max_retries + 1))


def _truncate_utf8(raw: bytes, cap: int) -> bytes:
    """Cut ``raw`` to at most ``cap`` bytes without splitting a character."""
    if len(raw) <= cap:
        return raw
    cut = cap
    while cut > 0 and (raw[cut] & 0xC0) == 0x80:
        cut -= 1
    return raw[:cut]


def slot_bytes_of(payload_bytes: int) -> int:
    return -(-(4 + payload_bytes) // CACHE_LINE) * CACHE_LINE


class SlotRing:
    """``n_slots`` request / response slot pairs: private numpy arrays, or
    views over one named shared-memory segment (``create_shared`` /
    ``attach``) that another process, or the JAX package, maps by name."""

    def __init__(self, n_slots: int = 128, payload_bytes: int = 64, *,
                 _segment=None, _owner: bool = True):
        self.payload_bytes = payload_bytes
        self.slot_bytes = slot_bytes_of(payload_bytes)
        self.n_slots = n_slots
        self._segment = _segment
        self._owner = _owner
        self.shm_name = None if _segment is None else _segment.name
        if _segment is None:
            self.ctrl = np.zeros(_N_CTRL, np.int64)
            self.status = np.zeros(n_slots, np.int64)
            self.req = np.zeros((n_slots, self.slot_bytes), np.uint8)
            self.resp = np.zeros((n_slots, self.slot_bytes), np.uint8)
            return
        buf, off = _segment.buf, 0
        self.ctrl = np.frombuffer(buf, np.int64, _N_CTRL, off)
        off += 8 * _N_CTRL
        self.status = np.frombuffer(buf, np.int64, n_slots, off)
        off += 8 * n_slots
        nbytes = n_slots * self.slot_bytes
        self.req = np.frombuffer(buf, np.uint8, nbytes, off).reshape(n_slots, self.slot_bytes)
        off += nbytes
        self.resp = np.frombuffer(buf, np.uint8, nbytes, off).reshape(n_slots, self.slot_bytes)

    @staticmethod
    def shared_size(n_slots: int, payload_bytes: int) -> int:
        return 8 * _N_CTRL + 8 * n_slots + 2 * n_slots * slot_bytes_of(payload_bytes)

    @classmethod
    def create_shared(cls, n_slots: int = 128, payload_bytes: int = 64) -> "SlotRing":
        """A ring in a fresh named segment; the creator owns the unlink."""
        seg = create_segment(cls.shared_size(n_slots, payload_bytes))
        return cls(n_slots, payload_bytes, _segment=seg, _owner=True)

    @classmethod
    def attach(cls, name: str, n_slots: int, payload_bytes: int) -> "SlotRing":
        """Map an existing ring by segment name; the geometry travels out of
        band, the segment holds slot state only."""
        seg = attach_segment(name)
        return cls(n_slots, payload_bytes, _segment=seg, _owner=False)

    def close(self) -> None:
        """Drop this mapping (the creator also unlinks the name)."""
        if self._segment is None:
            return
        self.ctrl = self.status = self.req = self.resp = None
        close_segment(self._segment, unlink=self._owner)
        self._segment = None

    # -- framed slot I/O ------------------------------------------------
    def write_req(self, slot: int, payload: bytes) -> None:
        self._write(self.req, slot, payload)

    def write_resp(self, slot: int, payload: bytes) -> None:
        self._write(self.resp, slot, payload)

    def _write(self, buf: np.ndarray, slot: int, payload: bytes) -> None:
        n = len(payload)
        if n > self.payload_bytes:
            raise ValueError(f"payload {n} B exceeds slot capacity {self.payload_bytes} B")
        buf[slot, : 4 + n] = np.frombuffer(_LEN.pack(n) + payload, np.uint8)

    def read_req(self, slot: int) -> bytes:
        return self._read(self.req, slot)

    def read_resp(self, slot: int) -> bytes:
        return self._read(self.resp, slot)

    def _read(self, buf: np.ndarray, slot: int) -> bytes:
        (n,) = _LEN.unpack(buf[slot, :4].tobytes())
        return buf[slot, 4 : 4 + n].tobytes()


def drain_ready(ring: SlotRing, handler) -> int:
    """One vectorised pass over a ring: serve every REQ_READY slot; returns
    how many. A handler's exception goes back in-band as RESP_ERROR. A
    handler with a true ``wants_slot`` attribute also gets the slot: on a
    ring whose slots are partitioned between clients, it names the poster
    (``core/wire.make_pool_handler``'s lease ledger)."""
    status = ring.status
    ready = np.nonzero(status == REQ_READY)[0]
    if not len(ready):
        return 0
    wants_slot = getattr(handler, "wants_slot", False)
    t_ns = time.perf_counter_ns()
    for i in ready.tolist():
        payload = ring.read_req(i)
        try:
            ring.write_resp(i, handler(payload, i) if wants_slot else handler(payload))
            status[i] = RESP_READY
        except Exception as e:  # noqa: BLE001 - relayed to the caller in-band
            msg = _truncate_utf8(f"{type(e).__name__}: {e}".encode(), ring.payload_bytes)
            ring.write_resp(i, msg)
            status[i] = RESP_ERROR
    ring.ctrl[CTRL_SERVED] += len(ready)
    ring.ctrl[CTRL_BUSY_NS] += time.perf_counter_ns() - t_ns
    return len(ready)


class RingServer:
    """The metadata service as a poll thread: scans its ring and yields the
    GIL between empty passes, as the reference's thread transport does.

    With a ``doorbell`` (a ``threading.Event``, the in-process stand-in for
    the reference's FIFO ``Doorbell``), after an empty pass the thread arms
    ``CTRL_DOORBELL``, scans once more and blocks on the event, for at most
    ``DOORBELL_WAIT_S``; a client that posts while the word is armed sets
    the event (``RingClient``'s ``doorbell``). Arming before the last scan
    means no post is missed, and the bounded wait caps what a lost wakeup
    could cost. A parked thread holds no GIL, so it takes no interpreter
    time from an engine that shares the process. ``stop`` ends and joins
    the thread."""

    def __init__(self, ring: SlotRing, handler, doorbell=None):
        self.ring = ring
        self.handler = handler
        self.doorbell = doorbell
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll_loop, daemon=True,
                                        name="ring-server")

    @property
    def served(self) -> int:
        """Requests served (the ring's ctrl word, as ``drain_ready`` keeps it)."""
        return int(self.ring.ctrl[CTRL_SERVED])

    @property
    def busy_ns(self) -> int:
        """Nanoseconds spent inside the handler."""
        return int(self.ring.ctrl[CTRL_BUSY_NS])

    def alive(self) -> bool:
        return self._thread.is_alive()

    def start(self) -> "RingServer":
        self.ring.ctrl[CTRL_READY] = 1
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> bool:
        """Ask the thread to end and join it; True once it has ended (or
        never started), False if it is still alive after ``timeout``."""
        self._stop.set()
        if self.doorbell is not None:
            self.doorbell.set()  # wake a parked thread
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)
        return not self._thread.is_alive()

    def _poll_loop(self) -> None:
        ring, handler, stop, db = self.ring, self.handler, self._stop, self.doorbell
        while not stop.is_set():
            if drain_ready(ring, handler):
                continue
            if db is None:
                time.sleep(0)  # yield the GIL; the paper's service spins
                continue
            ring.ctrl[CTRL_DOORBELL] = 1  # arm, scan once more, then park
            try:
                if not drain_ready(ring, handler):
                    db.wait(DOORBELL_WAIT_S)
                    db.clear()
            finally:
                ring.ctrl[CTRL_DOORBELL] = 0


class RingClient:
    """The caller's side of one ring, owned by one thread.

    ``slot_range=(lo, hi)`` restricts the client to slots [lo, hi), so that
    several clients share a ring. ``liveness`` (a callable) turns a dead
    service into a fast ``RingServiceDied`` instead of a full timeout.
    ``source`` is an object whose ``generation`` attribute names the newest
    service (``number`` and ``service``, with ``ring``, ``alive`` and
    ``producer()``): ``follow`` adopts it, and the client starts on
    ``generation``."""

    def __init__(self, ring: SlotRing, liveness=None,
                 slot_range: tuple[int, int] | None = None, doorbell=None, source=None):
        self.ring = ring
        self.liveness = liveness
        # the server's wakeup: set on a post while armed (a threading.Event
        # or a FifoDoorbell producer)
        self.doorbell = doorbell
        self.source = source
        self._generation = None if source is None else source.generation.number
        self._slot_range = (0, ring.n_slots) if slot_range is None else tuple(slot_range)
        lo, hi = self._slot_range
        if not 0 <= lo < hi <= ring.n_slots:
            raise ValueError(f"slot_range {self._slot_range} outside ring of {ring.n_slots} slots")
        self.stats = RingStats()
        self._free = list(range(lo, hi))
        # slots whose caller timed out while the server still owed an answer
        self._quarantined: set[int] = set()
        # per-slot post time: a wait counts from the post
        self._t_posted = np.zeros(ring.n_slots, np.float64)

    @property
    def slot_range(self) -> tuple[int, int]:
        return self._slot_range

    def free_slots(self) -> int:
        return len(self._free)

    def adopt_ring(self, ring: SlotRing, liveness=None, doorbell=None) -> None:
        """Cut over to a fresh ring (a restarted service's, with its liveness
        probe and doorbell): the free list is full again, nothing stays
        quarantined, the slot range is kept. A FIFO doorbell left behind
        is closed."""
        old = self.doorbell
        if old is not None and old is not doorbell and hasattr(old, "close"):
            old.close()
        self.ring = ring
        self.liveness = liveness
        self.doorbell = doorbell
        lo, hi = self._slot_range
        self._free = list(range(lo, min(hi, ring.n_slots)))
        self._quarantined = set()
        self._t_posted = np.zeros(ring.n_slots, np.float64)
        self.stats.restarts += 1

    def follow(self) -> bool:
        """Adopt ``source``'s newest generation if this client is not on it
        yet; True when it moved. Called by the client's owner."""
        gen = None if self.source is None else self.source.generation
        if gen is None or gen.number == self._generation:
            return False
        srv = gen.service
        self.adopt_ring(srv.ring, liveness=srv.alive, doorbell=srv.producer())
        self._generation = gen.number
        return True

    def close(self) -> None:
        """Drop the client's FIFO doorbell handle, if it has one."""
        if hasattr(self.doorbell, "close"):
            self.doorbell.close()

    def _reclaim(self, slots) -> None:
        for s in slots:
            self.ring.status[s] = IDLE
            self._quarantined.discard(s)
            self._free.append(s)

    def _acquire_slot(self) -> int:
        if self._quarantined:
            status = self.ring.status
            self._reclaim([s for s in self._quarantined
                           if status[s] in (RESP_READY, RESP_ERROR)])
            # a dead service answers nothing more: its slots are safe again
            if self._quarantined and self.liveness is not None and not self.liveness():
                self._reclaim(list(self._quarantined))
        if not self._free:
            raise RuntimeError("no free RPC slots (QD exceeded)")
        return self._free.pop()

    def post(self, payload: bytes) -> int:
        """Write a request and flip its slot to REQ_READY; returns the slot
        for a later ``collect``."""
        slot = self._acquire_slot()
        try:
            self.ring.write_req(slot, payload)
        except BaseException:
            self._free.append(slot)  # nothing posted: plain recycle
            raise
        self._t_posted[slot] = time.perf_counter()
        self.ring.status[slot] = REQ_READY
        # the status word first, then the armed word: a server that armed
        # before the store sees the slot on its last scan or is woken here
        if self.doorbell is not None and self.ring.ctrl[CTRL_DOORBELL]:
            self.doorbell.set()
        return slot

    def collect(self, slot: int, timeout: float = 5.0) -> bytes:
        """Wait for the answer in ``slot``; recycle the slot, or quarantine
        it on a timeout. A failure is counted, with its wait, before it is
        raised: ``TimeoutError``, ``RingError`` for a handler's error,
        ``RingServiceDied`` for a dead service or a swapped ring."""
        ring, stats = self.ring, self.stats
        t0 = float(self._t_posted[slot])
        if t0 == 0.0:
            stats.errors += 1
            raise RingServiceDied("ring swapped mid-call (service restarted)")
        deadline = t0 + timeout
        completed = False
        spins = 0
        try:
            while (st := int(ring.status[slot])) not in (RESP_READY, RESP_ERROR):
                if time.perf_counter() > deadline:
                    stats.timeouts += 1
                    stats.total_wait += time.perf_counter() - t0
                    raise TimeoutError("RPC timeout")
                spins += 1
                if not spins & 0xFF:
                    if self.ring is not ring:
                        stats.errors += 1
                        stats.total_wait += time.perf_counter() - t0
                        raise RingServiceDied("ring swapped mid-call (service restarted)")
                    if (self.liveness is not None and not self.liveness()
                            and int(ring.status[slot]) not in (RESP_READY, RESP_ERROR)):
                        stats.errors += 1
                        stats.total_wait += time.perf_counter() - t0
                        raise RingServiceDied("metadata service died (ring abandoned)")
                # yield the GIL; past a few spins, for long enough that a
                # server thread woken from its doorbell can take it
                time.sleep(0 if spins < CLIENT_SPINS else CLIENT_NAP_S)
            out = ring.read_resp(slot)
            ring.status[slot] = IDLE
            completed = True
            stats.total_wait += time.perf_counter() - t0
            if st == RESP_ERROR:
                stats.errors += 1
                raise RingError(out.decode("utf-8", errors="replace"))
            stats.requests += 1
            return out
        finally:
            if self.ring is ring:  # a swapped ring's state was rebuilt
                if completed:
                    self._free.append(slot)
                else:
                    self._quarantined.add(slot)

    def call(self, payload: bytes, timeout: float = 5.0) -> bytes:
        return self.collect(self.post(payload), timeout)

    def modeled_rtt(self) -> float:
        """The paper's CXL-RPC round trip (Exp #11, MODELED)."""
        return fabric.CXL_RPC_RTT


class RdmaRpcModel:
    """RDMA RPC baseline: the same handler, in process, each call priced at
    the paper's RC or UD round trip (MODELED)."""

    def __init__(self, handler, transport: str = "rc"):
        self.handler = handler
        self.rtt = fabric.RDMA_RC_RPC_RTT if transport == "rc" else fabric.RDMA_UD_RPC_RTT
        self.stats = RingStats()

    def call(self, payload: bytes) -> bytes:
        out = self.handler(payload)
        self.stats.requests += 1
        self.stats.total_wait += self.rtt
        return out
