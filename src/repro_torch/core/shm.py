"""Named shared-memory segments: the stand-in for the paper's CXL pool
mappings, which every participant reads and writes by load / store.

Twin of the segment helpers of ``repro/core/shm.py``. A ring
(``core/rpc.SlotRing.create_shared``) lives in one such segment, so two
processes, or the JAX package and the port in one process, can map the
same slots by name. The rule is creator-unlinks: only the creator of a
segment removes its name; an attacher only drops its mapping.

  * ``create_segment`` makes a zero-filled segment (the caller owns the
    unlink);
  * ``attach_segment`` maps one by name without registering it with the
    ``resource_tracker``: on Python < 3.13 the tracker otherwise takes an
    attacher for an owner and unlinks the segment when the attacher exits;
  * ``close_segment`` drops the mapping (retrying through ``gc.collect()``
    when a numpy view still holds the export) and, for the creator,
    unlinks; it may run twice.

Beside the segments, the process transport's two named objects
(``core/procserver.py``):

  * ``FifoDoorbell``, the wakeup of a parked service process: a named FIFO,
    attached by path like a segment;
  * ``PublishJournal``, a shard's record of the index mutations its clients
    saw confirmed, which a respawned service replays (``live_entries``
    folds it). Its header and records are the reference's byte for byte,
    so each package reads the other's journal.
"""

from __future__ import annotations

import gc
import os
import secrets
import select
import struct
import tempfile
from multiprocessing import shared_memory

from repro_torch.core import diag


def create_segment(size: int) -> shared_memory.SharedMemory:
    """Create a zero-filled named segment (the caller owns the unlink)."""
    seg = shared_memory.SharedMemory(create=True, size=size)
    seg.buf[:] = bytes(len(seg.buf))
    return seg


def attach_segment(name: str) -> shared_memory.SharedMemory:
    """Map an existing segment without taking on its unlink."""
    try:
        from multiprocessing import resource_tracker
    except ImportError:  # no tracker on this platform: plain attach
        return shared_memory.SharedMemory(name=name)
    orig_register = resource_tracker.register
    resource_tracker.register = lambda *a, **k: None
    try:
        return shared_memory.SharedMemory(name=name)
    finally:
        resource_tracker.register = orig_register


def close_segment(seg: shared_memory.SharedMemory | None, *, unlink: bool) -> None:
    """Close (and, for the creator, unlink) a segment; safe to repeat."""
    if seg is None:
        return
    try:
        seg.close()
    except BufferError:
        gc.collect()  # a dropped numpy view still held the export
        try:
            seg.close()
        except BufferError:
            pass
    except Exception:  # noqa: BLE001
        diag.note("shm.close_segment.close_failed")
    if unlink:
        try:
            seg.unlink()
        except FileNotFoundError:
            pass
        except Exception:  # noqa: BLE001
            diag.note("shm.close_segment.unlink_failed")


class FifoDoorbell:
    """The wakeup of a ring's service process: a named FIFO (twin of the
    reference's ``Doorbell``, ``repro/core/shm.py:97``).

    The consumer (the service) arms the ring's ``CTRL_DOORBELL`` word, scans
    the ring once more, then ``wait``s a bounded time; a producer (a
    ``RingClient``) that posts while the word is armed writes one byte. The
    bound caps what a wakeup lost to the arm / post race costs; a spurious
    wakeup costs one more scan. A FIFO attaches by path, so the spec of a
    spawned service carries it as a string.

    The consumer opens the FIFO read-write, so that with no producer open it
    reads EAGAIN rather than an endless EOF. A producer opens the write end
    lazily and never raises: ``set`` (the name ``RingClient.post`` calls, as
    on a thread server's ``threading.Event``) returns False when no reader
    is there yet, True when a wakeup was written or is already pending.
    Only the creator unlinks the path; an attacher's ``close`` drops its
    descriptors."""

    def __init__(self, path: str, *, _owner: bool):
        self.path = path
        self._owner = _owner
        self._rfd: int | None = None
        self._wfd: int | None = None
        self._closed = False

    @classmethod
    def create(cls) -> "FifoDoorbell":
        """A new FIFO in the temporary directory; the caller owns its path."""
        path = os.path.join(tempfile.gettempdir(),
                            f"beluga-doorbell-{os.getpid()}-{secrets.token_hex(6)}")
        os.mkfifo(path)
        return cls(path, _owner=True)

    @classmethod
    def attach(cls, path: str) -> "FifoDoorbell":
        return cls(path, _owner=False)

    # -- consumer side ----------------------------------------------------
    def open_read(self) -> None:
        """Open the read end (before the first arm, so that a producer that
        sees the armed word always finds a reader)."""
        if self._rfd is None and not self._closed:
            self._rfd = os.open(self.path, os.O_RDWR | os.O_NONBLOCK)

    def wait(self, timeout: float) -> bool:
        """Block until a wakeup or ``timeout`` seconds; drain every pending
        byte. True when a wakeup came."""
        self.open_read()
        try:
            readable, _, _ = select.select([self._rfd], [], [], timeout)
        except OSError:
            return False
        while True:
            try:
                if not os.read(self._rfd, 4096):
                    break
            except OSError:  # EAGAIN: drained
                break
        return bool(readable)

    # -- producer side ----------------------------------------------------
    def set(self) -> bool:
        if self._closed:
            return False
        if self._wfd is None:
            try:
                self._wfd = os.open(self.path, os.O_WRONLY | os.O_NONBLOCK)
            except OSError:  # ENXIO: no reader yet, nothing to wake
                return False
        try:
            os.write(self._wfd, b"\x01")
            return True
        except BlockingIOError:
            return True  # the FIFO is full: a wakeup is pending
        except OSError:  # the reader went away: drop the stale descriptor
            os.close(self._wfd)
            self._wfd = None
            return False

    def clear(self) -> None:
        """Nothing to do: ``wait`` drained the wakeups. A ``core/rpc.
        RingServer`` thread parks on a FIFO, which a worker process can
        ring, as it does on a ``threading.Event``."""

    def close(self) -> None:
        """Drop the descriptors (the creator also unlinks the path); safe to
        repeat."""
        if self._closed:
            return
        self._closed = True
        for fd in (self._rfd, self._wfd):
            if fd is not None:
                os.close(fd)
        self._rfd = self._wfd = None
        if self._owner:
            try:
                os.unlink(self.path)
            except FileNotFoundError:
                pass


# ---------------------------------------------------------------------------
# a shard's publish journal (the self-healing plane, core/procserver.py)
# ---------------------------------------------------------------------------
JOURNAL_PUBLISH, JOURNAL_RETRACT, JOURNAL_REMAP = 1, 2, 3


def live_entries(records) -> dict[bytes, tuple[int, int, int]]:
    """Fold journal records into the entries that survive them, in the
    order a replay inserts them: ``key -> (block_id, epoch, n_tokens)``.

      * PUBLISH inserts the key, or moves it to the end with its new block;
      * RETRACT (an eviction's freed block) removes the key that last
        published that block, the entry the index dropped; an older key
        whose block was recycled under a new key survives, as it does in
        the index;
      * REMAP re-points a present key to its migrated block and epoch and
        keeps its n_tokens.
    """
    live: dict[bytes, list[int]] = {}
    block2key: dict[int, bytes] = {}
    for op, key, bid, epoch, ntk in records:
        if op == JOURNAL_PUBLISH:
            live.pop(key, None)
            live[key] = [bid, epoch, ntk]
            block2key[bid] = key
        elif op == JOURNAL_RETRACT:
            k = block2key.pop(bid, None)
            if k is not None and k in live and live[k][0] == bid:
                del live[k]
        elif op == JOURNAL_REMAP:
            ent = live.get(key)
            if ent is not None:
                if block2key.get(ent[0]) == key:
                    del block2key[ent[0]]
                ent[0], ent[1] = bid, epoch
                block2key[bid] = key
    return {k: (v[0], v[1], v[2]) for k, v in live.items()}


class PublishJournal:
    """A shard's append-only journal in a named segment (twin of the
    reference's ``ShardJournal``, ``repro/core/shm.py:275``).

    The pool-owning client appends a record for each index mutation whose
    reply confirmed it: publishes, evictions (a retract a freed block) and
    remaps. A respawned shard service replays it before it serves
    (``PrefixIndex.rebuild_from_journal``). A mutation whose reply the crash
    lost is not journalled: a publish is retried and lands again, and an
    eviction whose freed ids never came back leaves the block with the pool
    and the rebuilt index, so nothing is lost or freed twice.

    Layout: the header ``generation:u64 count:u64 capacity:u64``, then
    ``capacity`` records ``op:u8 key:16s block_id:i64 epoch:i64
    n_tokens:i32`` (37 B). When an append would overflow, the journal is
    compacted in place to ``live_entries`` as publishes and the generation
    bumped; the count is written last, so a reader never sees a half-written
    record as committed.

    One writer, no lock: only the client thread that owns the shard's ring
    client appends (the reference's journal takes a lock because its client
    is shared between threads; a port client has one owner). The reader is
    a booting service, whose ring is not yet served, so the journal is at
    rest while it reads."""

    _HDR = struct.Struct("<QQQ")  # generation, count, capacity
    _REC = struct.Struct("<B16sqqi")  # op, key, block_id, epoch, n_tokens

    def __init__(self, seg: shared_memory.SharedMemory, capacity: int, *, _owner: bool):
        self._seg = seg
        self._owner = _owner
        self.capacity = capacity
        self.name = seg.name

    @classmethod
    def segment_size(cls, capacity: int) -> int:
        return cls._HDR.size + capacity * cls._REC.size

    @classmethod
    def create(cls, capacity: int) -> "PublishJournal":
        seg = create_segment(cls.segment_size(capacity))
        cls._HDR.pack_into(seg.buf, 0, 0, 0, capacity)
        return cls(seg, capacity, _owner=True)

    @classmethod
    def attach(cls, name: str, capacity: int) -> "PublishJournal":
        seg = attach_segment(name)
        cap = cls._HDR.unpack_from(seg.buf, 0)[2]
        if cap != capacity:
            close_segment(seg, unlink=False)
            raise ValueError(f"journal {name}: capacity mismatch (segment {cap}, spec {capacity})")
        return cls(seg, capacity, _owner=False)

    @property
    def generation(self) -> int:
        return self._HDR.unpack_from(self._seg.buf, 0)[0]

    def __len__(self) -> int:
        return self._HDR.unpack_from(self._seg.buf, 0)[1]

    def _write_rec(self, i: int, rec) -> None:
        self._REC.pack_into(self._seg.buf, self._HDR.size + i * self._REC.size, *rec)

    def records(self) -> list[tuple[int, bytes, int, int, int]]:
        """Every committed record: (op, key, block_id, epoch, n_tokens)."""
        count = len(self)
        return [self._REC.unpack_from(self._seg.buf, self._HDR.size + i * self._REC.size)
                for i in range(count)]

    def _append(self, recs: list) -> None:
        gen, count, _ = self._HDR.unpack_from(self._seg.buf, 0)
        if count + len(recs) > self.capacity:
            live = live_entries(self.records())
            if len(live) + len(recs) > self.capacity:
                raise RuntimeError(f"journal {self.name} overflow: {len(live)} live + "
                                   f"{len(recs)} new > capacity {self.capacity}")
            for i, (k, (bid, epoch, ntk)) in enumerate(live.items()):
                self._write_rec(i, (JOURNAL_PUBLISH, k, bid, epoch, ntk))
            gen, count = gen + 1, len(live)
        for rec in recs:
            self._write_rec(count, rec)
            count += 1
        self._HDR.pack_into(self._seg.buf, 0, gen, count, self.capacity)

    def append_publish(self, keys, block_ids, epochs, n_tokens: int) -> None:
        self._append([(JOURNAL_PUBLISH, k, int(b), int(e), n_tokens)
                      for k, b, e in zip(keys, block_ids, epochs)])

    def append_retract(self, block_ids) -> None:
        self._append([(JOURNAL_RETRACT, bytes(16), int(b), 0, 0) for b in block_ids])

    def append_remap(self, keys, new_ids, new_epochs) -> None:
        self._append([(JOURNAL_REMAP, k, int(b), int(e), -1)
                      for k, b, e in zip(keys, new_ids, new_epochs)])

    def close(self) -> None:
        close_segment(self._seg, unlink=self._owner)
        self._seg = None
