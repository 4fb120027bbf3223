"""The metadata plane's binary wire protocol (paper §6, Exp #11): what
travels in a ring slot (``core/rpc.py``) between an engine and the prefix
index.

Twin of the index plane of ``repro/core/wire.py``: the same opcodes and
the same bytes, so a port client and a JAX server (or the reverse) speak to
each other over one named segment. Little-endian; keys are 16-byte blake2b
digests (``core/index.chain_keys``):

    request  := op:u8  body
    MATCH    := n:u32  keys[n*16]
    PUBLISH  := n:u32  n_tokens:i32  keys[n*16]  block_ids[n*i64]  epochs[n*i64]
    LOOKUP   := n:u32  keys[n*16]
    FILTER   := n:u32  keys[n*16]          (writeback: lookup + validate)
    EVICT    := n:u32                      (up to n LRU blocks)
    BATCH    := k:u32  k * (len:u32 request)
    OWNERS   := n:u32  block_ids[n*i64]    (the migrator's snapshot)
    REMAP    := n:u32  keys  old_ids  old_epochs  new_ids  new_epochs
    EVICT_BLOCKS := n:u32  block_ids[n*i64]
    STATS    := n:u32 (ignored)
    SNAPSHOT := max:u32  start:u32         (a page, LRU order)
    RESTORE  := n:u32  keys  block_ids  epochs  n_tokens[n*i32]
    SEED_STATS := 0:u32  hits:u64  misses:u64

    MATCH -> n_ok:u32 ids epochs; PUBLISH, RESTORE, SEED_STATS -> n:u32;
    LOOKUP -> n:u32 ids epochs n_tokens (id -1: missing); FILTER -> m:u32
    positions[u32]; EVICT, EVICT_BLOCKS -> m:u32 freed ids, k:u32 destroyed
    keys; BATCH -> k:u32 k * (len:u32 reply); OWNERS -> m:u32 keys ids
    epochs; REMAP -> n:u32 ok[u8]; STATS -> entries hits misses served
    busy_ns (u64 each); SNAPSHOT -> total:u32 m:u32 keys ids epochs n_tokens.

``reply_bound`` sizes a reply without running it and walks the whole frame;
``prevalidate`` checks every sub-op (duplicate MATCH keys, block ids out of
the pool) first, so a BATCH starts clean or not at all; ``handle_request``
dispatches; ``make_index_handler`` wraps the three for a ring server.

One difference by design: the decoder checks every unpack as
``reply_bound`` does, so a short SEED_STATS frame raises ``WireFormatError``
where the reference's ``handle_request`` unpacks it unchecked
(``repro/core/wire.py:624-625``) and raises ``struct.error``.

``RemoteIndex`` (the reference's ``RpcIndexClient``) is the prefix index's
surface over a ring: keys are hashed on the caller's side, each op is one
round trip, and a chain longer than a slot goes in chunks (a match's chunks
stay serial, so the service refreshes exactly the global prefix; pure reads
pipeline up to 8 chunks). ``ShardedRemoteIndex`` (``ShardedRpcIndexClient``)
fronts S rings, one ``PrefixIndex`` shard behind each, and posts to every
shard's ring before collecting any reply. A ``RingRetryPolicy`` retries a
dead or swapped ring for every op, a timeout only for ops that may repeat;
a client that follows a shard watchdog (``RingClient.source``) moves onto
the respawned service's ring before it retries. ``on_evict`` hears the keys
a ring-served eviction destroyed.

For a service in another process (``core/procserver.py``), which never
writes the pool: ``on_freed`` releases the ids an eviction reply carries,
in the pool-owning process; ``journal`` (``journals``, one a shard)
records each publish, eviction and remap once its reply confirmed it
(``core/shm.PublishJournal``), so a respawned service replays them; a
sharded client with ``degrade`` turns a shard that stays down through its
retries into holes in a match, which cuts the prefix there.

``ring_plane`` serves an index over S rings in threads of this process
(``RingPlane``), the one place the thread transport is put together
(``core/procserver.process_plane`` is the process transport's). The pool
and journal ops (13-19, 21, 22) belong to the shared data plane and the
engine workers (``ROADMAP.md`` queue 1 item 7e-iii).
"""

from __future__ import annotations

import struct
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import diag
from repro_torch.core.index import (
    ChainHasher,
    PrefixEntry,
    evict_blocks_sharded,
    evict_lru_pressure,
    merge_owners,
    merge_stats,
    partition_keys,
)
from repro_torch.core.rpc import (
    CTRL_BUSY_NS,
    CTRL_SERVED,
    RingClient,
    RingRetryPolicy,
    RingServer,
    RingServiceDied,
    SlotRing,
)

KEY_BYTES = 16

OP_MATCH = 1
OP_PUBLISH = 2
OP_LOOKUP = 3
OP_FILTER = 4
OP_EVICT = 5
OP_BATCH = 6
OP_OWNERS = 7
OP_REMAP = 8
OP_EVICT_BLOCKS = 9
OP_STATS = 10
OP_SNAPSHOT = 11
OP_RESTORE = 12
OP_SEED_STATS = 20

_HDR = struct.Struct("<BI")  # op, count
_U32 = struct.Struct("<I")
_PUB_HDR = struct.Struct("<BIi")  # op, count, n_tokens
_STATS = struct.Struct("<QQQQQ")  # entries, hits, misses, served, busy_ns
_SEED_STATS = struct.Struct("<QQ")
_MAX_BATCH_DEPTH = 4  # BATCH-in-BATCH nesting cap
_TRANSIENT = (RingServiceDied, TimeoutError)


class WireFormatError(ValueError):
    """A malformed frame: truncated, unknown op, bad ids or keys."""


# ---------------------------------------------------------------------------
# encode (client side)
# ---------------------------------------------------------------------------
def _join_keys(keys) -> bytes:
    blob = b"".join(keys)
    if len(blob) != KEY_BYTES * len(keys):
        raise WireFormatError("keys must be 16-byte digests")
    return blob


def _i64(xs) -> bytes:
    return np.asarray(xs, np.int64).tobytes()


def encode_match(keys) -> bytes:
    return _HDR.pack(OP_MATCH, len(keys)) + _join_keys(keys)


def encode_publish(keys, block_ids, epochs, n_tokens: int) -> bytes:
    n = len(keys)
    if not n == len(block_ids) == len(epochs):
        raise WireFormatError("publish arrays disagree on length")
    return _PUB_HDR.pack(OP_PUBLISH, n, n_tokens) + _join_keys(keys) + _i64(block_ids) + \
        _i64(epochs)


def encode_lookup(keys) -> bytes:
    return _HDR.pack(OP_LOOKUP, len(keys)) + _join_keys(keys)


def encode_filter(keys) -> bytes:
    return _HDR.pack(OP_FILTER, len(keys)) + _join_keys(keys)


def encode_evict(n: int) -> bytes:
    return _HDR.pack(OP_EVICT, n)


def encode_batch(requests: list[bytes]) -> bytes:
    return _HDR.pack(OP_BATCH, len(requests)) + b"".join(_U32.pack(len(r)) + r for r in requests)


def encode_owners(block_ids) -> bytes:
    return _HDR.pack(OP_OWNERS, len(block_ids)) + _i64(block_ids)


def encode_remap(keys, old_ids, old_epochs, new_ids, new_epochs) -> bytes:
    n = len(keys)
    if not n == len(old_ids) == len(old_epochs) == len(new_ids) == len(new_epochs):
        raise WireFormatError("remap arrays disagree on length")
    return _HDR.pack(OP_REMAP, n) + _join_keys(keys) + _i64(old_ids) + _i64(old_epochs) + \
        _i64(new_ids) + _i64(new_epochs)


def encode_evict_blocks(block_ids) -> bytes:
    return _HDR.pack(OP_EVICT_BLOCKS, len(block_ids)) + _i64(block_ids)


def encode_stats() -> bytes:
    return _HDR.pack(OP_STATS, 0)


def encode_snapshot(start: int, max_items: int) -> bytes:
    return _HDR.pack(OP_SNAPSHOT, max_items) + _U32.pack(start)


def encode_restore(keys, block_ids, epochs, n_tokens) -> bytes:
    n = len(keys)
    if not n == len(block_ids) == len(epochs) == len(n_tokens):
        raise WireFormatError("restore arrays disagree on length")
    return _HDR.pack(OP_RESTORE, n) + _join_keys(keys) + _i64(block_ids) + _i64(epochs) + \
        np.asarray(n_tokens, np.int32).tobytes()


def encode_seed_stats(hits: int, misses: int) -> bytes:
    return _HDR.pack(OP_SEED_STATS, 0) + _SEED_STATS.pack(hits, misses)


# ---------------------------------------------------------------------------
# decode helpers
# ---------------------------------------------------------------------------
def _need(buf: bytes, end: int) -> None:
    if len(buf) < end:
        raise WireFormatError(f"truncated message: need {end} B, have {len(buf)} B")


def _split_keys(buf: bytes, off: int, n: int) -> tuple[list[bytes], int]:
    end = off + n * KEY_BYTES
    _need(buf, end)
    return [buf[i : i + KEY_BYTES] for i in range(off, end, KEY_BYTES)], end


def _split(buf: bytes, off: int, n: int, dtype) -> tuple[np.ndarray, int]:
    end = off + np.dtype(dtype).itemsize * n
    _need(buf, end)
    return np.frombuffer(buf, dtype, n, off), end


def _count(buf: bytes, off: int = 0) -> int:
    _need(buf, off + 4)
    return _U32.unpack_from(buf, off)[0]


def decode_match_resp(buf: bytes) -> tuple[np.ndarray, np.ndarray]:
    n = _count(buf)
    ids, off = _split(buf, 4, n, np.int64)
    eps, _ = _split(buf, off, n, np.int64)
    return ids, eps


def decode_count_resp(buf: bytes) -> int:
    """PUBLISH / RESTORE / SEED_STATS: one u32."""
    return _count(buf)


def decode_lookup_resp(buf: bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    n = _count(buf)
    ids, off = _split(buf, 4, n, np.int64)
    eps, off = _split(buf, off, n, np.int64)
    ntk, _ = _split(buf, off, n, np.int32)
    return ids, eps, ntk


def decode_filter_resp(buf: bytes) -> list[int]:
    n = _count(buf)
    return _split(buf, 4, n, np.int32)[0].tolist()


def decode_evict_resp_keys(buf: bytes) -> tuple[list[int], list[bytes]]:
    """(freed block ids, the keys the eviction destroyed)."""
    n = _count(buf)
    ids, off = _split(buf, 4, n, np.int64)
    keys, _ = _split_keys(buf, off + 4, _count(buf, off))
    return ids.tolist(), keys


def decode_owners_resp(buf: bytes) -> tuple[list[bytes], list[int], list[int]]:
    m = _count(buf)
    keys, off = _split_keys(buf, 4, m)
    ids, off = _split(buf, off, m, np.int64)
    eps, _ = _split(buf, off, m, np.int64)
    return keys, ids.tolist(), eps.tolist()


def decode_remap_resp(buf: bytes) -> list[bool]:
    n = _count(buf)
    _need(buf, 4 + n)
    return [b != 0 for b in buf[4 : 4 + n]]


def decode_stats_resp(buf: bytes) -> tuple[int, int, int, int, int]:
    """(entries, hits, misses, ops served, busy ns)."""
    _need(buf, _STATS.size)
    return _STATS.unpack_from(buf)


def decode_snapshot_resp(buf: bytes) -> tuple[int, list[bytes], list[int], list[int], list[int]]:
    """(total entries, keys, block ids, epochs, n_tokens) of one page."""
    total, m = _count(buf), _count(buf, 4)
    keys, off = _split_keys(buf, 8, m)
    ids, off = _split(buf, off, m, np.int64)
    eps, off = _split(buf, off, m, np.int64)
    ntk, _ = _split(buf, off, m, np.int32)
    return total, keys, ids.tolist(), eps.tolist(), ntk.tolist()


def _split_frames(buf: bytes, off: int, k: int) -> list[bytes]:
    """k length-prefixed frames from ``off`` (a BATCH body)."""
    out = []
    for _ in range(k):
        ln = _count(buf, off)
        off += 4
        _need(buf, off + ln)
        out.append(buf[off : off + ln])
        off += ln
    return out


def decode_batch_resp(buf: bytes) -> list[bytes]:
    return _split_frames(buf, 4, _count(buf))


# ---------------------------------------------------------------------------
# server side
# ---------------------------------------------------------------------------
def _header(buf: bytes) -> tuple[int, int]:
    _need(buf, _HDR.size)
    return _HDR.unpack_from(buf)


def _nested(depth: int) -> None:
    if depth >= _MAX_BATCH_DEPTH:
        raise WireFormatError(f"BATCH nesting exceeds {_MAX_BATCH_DEPTH}")


def reply_bound(buf: bytes, _depth: int = 0) -> int:
    """Worst-case reply size, without running the request; walks and so
    checks the whole frame, each op's body included."""
    op, n = _header(buf)
    if op == OP_MATCH:
        _need(buf, _HDR.size + KEY_BYTES * n)
        return 4 + 16 * n
    if op == OP_PUBLISH:
        _need(buf, _PUB_HDR.size + (KEY_BYTES + 16) * n)
        return 4
    if op == OP_LOOKUP:
        _need(buf, _HDR.size + KEY_BYTES * n)
        return 4 + 20 * n
    if op == OP_FILTER:
        _need(buf, _HDR.size + KEY_BYTES * n)
        return 4 + 4 * n
    if op == OP_EVICT:
        return 8 + 24 * n  # ids (8 B) and destroyed keys (16 B), two counts
    if op == OP_OWNERS:
        _need(buf, _HDR.size + 8 * n)
        return 4 + 32 * n
    if op == OP_REMAP:
        _need(buf, _HDR.size + (KEY_BYTES + 32) * n)
        return 4 + n
    if op == OP_EVICT_BLOCKS:
        _need(buf, _HDR.size + 8 * n)
        return 8 + 24 * n
    if op == OP_STATS:
        return _STATS.size
    if op == OP_SNAPSHOT:
        _need(buf, _HDR.size + 4)
        return 8 + 36 * n
    if op == OP_RESTORE:
        _need(buf, _HDR.size + (KEY_BYTES + 20) * n)
        return 4
    if op == OP_SEED_STATS:
        _need(buf, _HDR.size + _SEED_STATS.size)
        return 4
    if op == OP_BATCH:
        _nested(_depth)
        return 4 + sum(4 + reply_bound(f, _depth + 1) for f in _split_frames(buf, _HDR.size, n))
    raise WireFormatError(f"unknown op {op}")


def _check_match_keys(keys: list[bytes]) -> None:
    if len(set(keys)) != len(keys):  # a chain never repeats a key
        raise WireFormatError("duplicate keys in MATCH chain")


def _check_block_ids(index, ids: np.ndarray, what: str) -> None:
    if len(ids) and (ids.min() < 0 or ids.max() >= index.pool.n_blocks):
        raise WireFormatError(f"{what} block id out of pool range")


def prevalidate(index, buf: bytes, _depth: int = 0) -> None:
    """The ops' own checks over every sub-op, before any runs."""
    op, n = _header(buf)
    if op == OP_MATCH:
        _check_match_keys(_split_keys(buf, _HDR.size, n)[0])
    elif op == OP_PUBLISH:
        _need(buf, _PUB_HDR.size)
        _, n, _ = _PUB_HDR.unpack_from(buf)
        _, off = _split_keys(buf, _PUB_HDR.size, n)
        _check_block_ids(index, _split(buf, off, n, np.int64)[0], "PUBLISH")
    elif op in (OP_OWNERS, OP_EVICT_BLOCKS):
        ids, _ = _split(buf, _HDR.size, n, np.int64)
        _check_block_ids(index, ids, "OWNERS" if op == OP_OWNERS else "EVICT_BLOCKS")
    elif op == OP_RESTORE:
        _, off = _split_keys(buf, _HDR.size, n)
        _check_block_ids(index, _split(buf, off, n, np.int64)[0], "RESTORE")
    elif op == OP_REMAP:
        _, off = _split_keys(buf, _HDR.size, n)
        old_ids, off = _split(buf, off, n, np.int64)
        _check_block_ids(index, old_ids, "REMAP old")
        _check_block_ids(index, _split(buf, off + 8 * n, n, np.int64)[0], "REMAP new")
    elif op == OP_BATCH:
        _nested(_depth)
        for f in _split_frames(buf, _HDR.size, n):
            prevalidate(index, f, _depth + 1)


def _evict_with_keys(index, fn) -> bytes:
    """Run one eviction with ``on_evict`` wrapped, so that the destroyed
    keys also travel back in the reply (ids, then keys)."""
    collected: list[bytes] = []
    prev = index.on_evict

    def hook(keys):
        collected.extend(keys)
        if prev is not None:
            prev(keys)

    index.on_evict = hook
    try:
        freed = fn()
    finally:
        index.on_evict = prev
    return _U32.pack(len(freed)) + _i64(freed) + _U32.pack(len(collected)) + b"".join(collected)


def handle_request(index, buf: bytes, _depth: int = 0, _validated: bool = False,
                   ctrl=None) -> bytes:
    """Decode one message, run it against ``index``, encode the reply.
    ``_validated`` skips the checks ``prevalidate`` made. STATS reports the
    service timer's two words from ``ctrl`` (the serving ring's control
    words, ``CTRL_SERVED`` and ``CTRL_BUSY_NS``), 0 without it."""
    op, n = _header(buf)
    if op == OP_MATCH:
        keys, _ = _split_keys(buf, _HDR.size, n)
        if not _validated:
            _check_match_keys(keys)
        hits = index.match_prefix_keys(keys)
        return _U32.pack(len(hits)) + _i64([b for _, b, _ in hits]) + \
            _i64([e for _, _, e in hits])
    if op == OP_PUBLISH:
        _need(buf, _PUB_HDR.size)
        _, n, n_tokens = _PUB_HDR.unpack_from(buf)
        keys, off = _split_keys(buf, _PUB_HDR.size, n)
        ids, off = _split(buf, off, n, np.int64)
        eps, _ = _split(buf, off, n, np.int64)
        if not _validated:
            _check_block_ids(index, ids, "PUBLISH")
        index.publish_many(keys, ids.tolist(), eps.tolist(), n_tokens)
        return _U32.pack(n)
    if op == OP_LOOKUP:
        keys, _ = _split_keys(buf, _HDR.size, n)
        ents = index.lookup_many(keys)
        return (_U32.pack(n)
                + _i64([-1 if e is None else e.block_id for e in ents])
                + _i64([0 if e is None else e.epoch for e in ents])
                + np.asarray([0 if e is None else e.n_tokens for e in ents], np.int32).tobytes())
    if op == OP_FILTER:
        keys, _ = _split_keys(buf, _HDR.size, n)
        missing = index.filter_unpublished(keys)
        return _U32.pack(len(missing)) + np.asarray(missing, np.int32).tobytes()
    if op == OP_EVICT:
        return _evict_with_keys(index, lambda: index.evict_lru(n))
    if op == OP_OWNERS:
        ids, _ = _split(buf, _HDR.size, n, np.int64)
        if not _validated:
            _check_block_ids(index, ids, "OWNERS")
        keys, bids, eps = index.owners_of(ids.tolist())
        return _U32.pack(len(keys)) + b"".join(keys) + _i64(bids) + _i64(eps)
    if op == OP_REMAP:
        keys, off = _split_keys(buf, _HDR.size, n)
        old_ids, off = _split(buf, off, n, np.int64)
        old_eps, off = _split(buf, off, n, np.int64)
        new_ids, off = _split(buf, off, n, np.int64)
        new_eps, _ = _split(buf, off, n, np.int64)
        if not _validated:
            _check_block_ids(index, old_ids, "REMAP old")
            _check_block_ids(index, new_ids, "REMAP new")
        ok = index.remap_many(keys, old_ids.tolist(), old_eps.tolist(), new_ids.tolist(),
                              new_eps.tolist())
        return _U32.pack(n) + bytes(bytearray(int(o) for o in ok))
    if op == OP_EVICT_BLOCKS:
        ids, _ = _split(buf, _HDR.size, n, np.int64)
        if not _validated:
            _check_block_ids(index, ids, "EVICT_BLOCKS")
        return _evict_with_keys(index, lambda: index.evict_blocks(ids.tolist()))
    if op == OP_STATS:
        s = index.stats()
        served = 0 if ctrl is None else int(ctrl[CTRL_SERVED])
        busy = 0 if ctrl is None else int(ctrl[CTRL_BUSY_NS])
        return _STATS.pack(s["entries"], s["hits"], s["misses"], served, busy)
    if op == OP_SNAPSHOT:
        _need(buf, _HDR.size + 4)
        (start,) = _U32.unpack_from(buf, _HDR.size)
        total, keys, ids, eps, ntk = index.snapshot_entries(start, n)
        return (_U32.pack(total) + _U32.pack(len(keys)) + b"".join(keys) + _i64(ids)
                + _i64(eps) + np.asarray(ntk, np.int32).tobytes())
    if op == OP_RESTORE:
        keys, off = _split_keys(buf, _HDR.size, n)
        ids, off = _split(buf, off, n, np.int64)
        eps, off = _split(buf, off, n, np.int64)
        ntk, _ = _split(buf, off, n, np.int32)
        if not _validated:
            _check_block_ids(index, ids, "RESTORE")
        index.restore_entries(keys, ids.tolist(), eps.tolist(), ntk.tolist())
        return _U32.pack(n)
    if op == OP_SEED_STATS:
        _need(buf, _HDR.size + _SEED_STATS.size)  # the reference unpacks unchecked
        index.seed_stats(*_SEED_STATS.unpack_from(buf, _HDR.size))
        return _U32.pack(0)
    if op == OP_BATCH:
        _nested(_depth)
        out = [handle_request(index, f, _depth + 1, _validated, ctrl)
               for f in _split_frames(buf, _HDR.size, n)]
        return _U32.pack(n) + b"".join(_U32.pack(len(r)) + r for r in out)
    raise WireFormatError(f"unknown op {op}")


def make_index_handler(index, max_reply: int | None = None, ctrl=None):
    """A ring server's handler over ``index``: the reply must fit
    ``max_reply`` (checked before anything runs), then ``prevalidate``,
    then the ops. ``ctrl`` (the serving ring's control words) feeds the
    service timer to STATS."""

    def handler(payload: bytes) -> bytes:
        if max_reply is not None and reply_bound(payload) > max_reply:
            raise WireFormatError(f"reply would exceed {max_reply} B slot")
        prevalidate(index, payload)
        return handle_request(index, payload, _validated=True, ctrl=ctrl)

    return handler


# ---------------------------------------------------------------------------
# client side
# ---------------------------------------------------------------------------
def _call_with_retry(rpc, payload: bytes, retry: RingRetryPolicy | None, idempotent: bool,
                     timeout: float | None = None) -> bytes:
    """One round trip under ``retry``: a dead or swapped ring is retried for
    every op (the journal makes a replayed mutation safe), a timeout only
    for an op that may run twice (a timed-out EVICT or REMAP may have
    applied). After a dead ring, a client that follows a watchdog moves
    onto its newest ring and re-posts at once."""
    attempt = 0
    while True:
        moved = False
        try:
            return rpc.call(payload) if timeout is None else rpc.call(payload, timeout)
        except RingServiceDied:
            if retry is None or attempt >= retry.max_retries:
                raise
            moved = rpc.follow()
        except TimeoutError:
            if retry is None or not idempotent or attempt >= retry.max_retries:
                raise
        attempt += 1
        rpc.stats.retries += 1
        if not moved:
            time.sleep(retry.backoff(attempt))


class RemoteIndex:
    """The prefix index's surface over one ring (``RpcIndexClient``'s twin):
    hashing runs here, and only keys cross the ring. ``on_freed`` releases
    an eviction's freed ids where the service cannot (another process);
    ``journal`` records each confirmed publish, eviction and remap."""

    def __init__(self, rpc, block_tokens: int, hasher: ChainHasher | None = None,
                 retry: RingRetryPolicy | None = None, on_evict=None, on_freed=None,
                 journal=None):
        self.rpc = rpc
        self.retry = retry
        self.on_evict = on_evict  # hears the keys a ring-served eviction destroyed
        self.on_freed = on_freed
        self.journal = journal
        self.hasher = hasher if hasher is not None else ChainHasher(block_tokens)
        self.block_tokens = block_tokens
        max_payload = rpc.ring.payload_bytes
        # chain capacity of one slot per op (headers <= 16 B), bounding both
        # the request and its reply
        self._max_match = max(1, (max_payload - 16) // KEY_BYTES)
        self._max_publish = max(1, (max_payload - 16) // (KEY_BYTES + 16))
        self._max_lookup = max(1, (max_payload - 16) // 20)
        self._max_evict = max(1, (max_payload - 24) // 24)
        self._max_owners = max(1, (max_payload - 16) // 32)
        self._max_remap = max(1, (max_payload - 16) // (KEY_BYTES + 32))
        self._max_snapshot = max(1, (max_payload - 24) // 36)

    def keys_for(self, tokens: list[int]) -> tuple[bytes, ...]:
        return self.hasher.keys_for(tokens)

    def _call(self, payload: bytes, idempotent: bool = True) -> bytes:
        return _call_with_retry(self.rpc, payload, self.retry, idempotent)

    def _pipelined_rounds(self, msgs: list[bytes]) -> list[bytes]:
        """Chunks of a pure read, up to 8 outstanding at once (the server
        drains by slot, not by post order, so only reads may pipeline). A
        transient failure drains what was posted and reruns every chunk
        serially under the retry policy."""
        rpc = self.rpc
        if len(msgs) <= 1:
            return [self._call(m) for m in msgs]
        out: list[bytes | None] = [None] * len(msgs)
        slots: list[tuple[int, int]] = []
        i = 0
        try:
            window = max(1, min(len(msgs), rpc.free_slots() - 1, 8))
            while i < len(msgs) or slots:
                while i < len(msgs) and len(slots) < window:
                    slots.append((i, rpc.post(msgs[i])))
                    i += 1
                j, slot = slots.pop(0)
                out[j] = rpc.collect(slot)
        except BaseException as e:
            for _, slot in slots:
                try:
                    rpc.collect(slot)
                except Exception:  # noqa: BLE001 - the slot stays quarantined
                    diag.note("wire.pipelined_drain.collect_failed")
            if self.retry is None or not isinstance(e, _TRANSIENT):
                raise
            return [self._call(m) for m in msgs]
        return out

    # -- chain ops -------------------------------------------------------
    def match_prefix(self, tokens: list[int]) -> list[tuple[bytes, int, int]]:
        return self.match_prefix_keys(self.keys_for(tokens))

    def match_prefix_keys(self, keys) -> list[tuple[bytes, int, int]]:
        out: list[tuple[bytes, int, int]] = []
        for off in range(0, len(keys), self._max_match):
            chunk = keys[off : off + self._max_match]
            ids, eps = decode_match_resp(self._call(encode_match(chunk)))
            out.extend(zip(chunk, ids.tolist(), eps.tolist()))
            if len(ids) < len(chunk):
                break  # the prefix ended inside this chunk
        return out

    def publish_many(self, keys, block_ids, epochs, n_tokens: int) -> None:
        # serial on purpose: pipelined chunks could land out of chain order
        for off in range(0, len(keys), self._max_publish):
            end = off + self._max_publish
            self._call(encode_publish(keys[off:end], block_ids[off:end], epochs[off:end],
                                      n_tokens))
            if self.journal is not None:
                self.journal.append_publish(keys[off:end], block_ids[off:end],
                                            epochs[off:end], n_tokens)

    def lookup_many(self, keys) -> list[PrefixEntry | None]:
        M = self._max_lookup
        out: list[PrefixEntry | None] = []
        for resp in self._pipelined_rounds(
                [encode_lookup(keys[off : off + M]) for off in range(0, len(keys), M)]):
            ids, eps, ntk = decode_lookup_resp(resp)
            out.extend(None if b < 0 else PrefixEntry(b, e, t)
                       for b, e, t in zip(ids.tolist(), eps.tolist(), ntk.tolist()))
        return out

    def filter_unpublished(self, keys) -> list[int]:
        M = self._max_lookup
        offs = list(range(0, len(keys), M))
        out: list[int] = []
        for off, resp in zip(offs, self._pipelined_rounds(
                [encode_filter(keys[off : off + M]) for off in offs])):
            out.extend(off + p for p in decode_filter_resp(resp))
        return out

    def _evicted(self, msg: bytes) -> list[int]:
        got, gone = decode_evict_resp_keys(self._call(msg, idempotent=False))
        if got:
            if self.journal is not None:
                self.journal.append_retract(got)
            if self.on_freed is not None:
                self.on_freed(got)
        if gone and self.on_evict is not None:
            self.on_evict(gone)
        return got

    def evict_lru(self, n: int) -> list[int]:
        """In chunks a reply can hold; a short chunk means no victims left."""
        freed: list[int] = []
        while n > 0:
            k = min(n, self._max_evict)
            got = self._evicted(encode_evict(k))
            freed.extend(got)
            if len(got) < k:
                break
            n -= k
        return freed

    # -- the migrator's ops ----------------------------------------------
    def owners_of(self, block_ids) -> tuple[list[bytes], list[int], list[int]]:
        M = self._max_owners
        keys: list[bytes] = []
        ids: list[int] = []
        eps: list[int] = []
        for resp in self._pipelined_rounds(
                [encode_owners(block_ids[off : off + M]) for off in range(0, len(block_ids), M)]):
            k, b, e = decode_owners_resp(resp)
            keys.extend(k)
            ids.extend(b)
            eps.extend(e)
        return keys, ids, eps

    def remap_many(self, keys, old_ids, old_epochs, new_ids, new_epochs) -> list[bool]:
        M = self._max_remap
        ok: list[bool] = []
        for off in range(0, len(keys), M):
            end = off + M
            sub = decode_remap_resp(self._call(
                encode_remap(keys[off:end], old_ids[off:end], old_epochs[off:end],
                             new_ids[off:end], new_epochs[off:end]),
                idempotent=False))
            if self.journal is not None and any(sub):
                done = [off + i for i, o in enumerate(sub) if o]
                self.journal.append_remap([keys[i] for i in done], [new_ids[i] for i in done],
                                          [new_epochs[i] for i in done])
            ok.extend(sub)
        return ok

    def evict_blocks(self, block_ids) -> list[int]:
        M = self._max_evict
        freed: list[int] = []
        for off in range(0, len(block_ids), M):
            freed.extend(self._evicted(encode_evict_blocks(block_ids[off : off + M])))
        return freed

    # -- counters, pages -------------------------------------------------
    def stats(self) -> dict:
        entries, hits, misses, _, _ = decode_stats_resp(self._call(encode_stats()))
        return {"entries": entries, "hits": hits, "misses": misses,
                "hit_rate": hits / max(1, hits + misses)}

    def n_entries(self) -> int:
        return self.stats()["entries"]

    def snapshot_entries(self, start: int = 0, max_items: int | None = None):
        return decode_snapshot_resp(self._call(
            encode_snapshot(start, self._max_snapshot if max_items is None else max_items)))

    def snapshot_all(self) -> list[tuple[bytes, int, int, int]]:
        """Every entry, least recently used first: (key, id, epoch, n_tokens)."""
        out: list[tuple[bytes, int, int, int]] = []
        while True:
            total, keys, ids, eps, ntk = self.snapshot_entries(len(out))
            out.extend(zip(keys, ids, eps, ntk))
            if len(out) >= total or not keys:
                return out

    def restore_entries(self, keys, block_ids, epochs, n_tokens) -> int:
        M = self._max_snapshot
        return sum(decode_count_resp(self._call(encode_restore(
            keys[off : off + M], block_ids[off : off + M], epochs[off : off + M],
            n_tokens[off : off + M]))) for off in range(0, len(keys), M))

    def seed_stats(self, hits: int, misses: int) -> None:
        self._call(encode_seed_stats(hits, misses))

    def call_batch(self, requests: list[bytes]) -> list[bytes]:
        """k encoded ops in one round trip."""
        return decode_batch_resp(self._call(encode_batch(requests)))


class ShardedRemoteIndex:
    """The prefix index's surface over S rings, one shard behind each (the
    reference's ``ShardedRpcIndexClient``): the same routing and merges as
    ``core/index.ShardedPrefixIndex``, and each fan-out posts to every
    shard's ring before it collects a reply. S=1 sends what one
    ``RemoteIndex`` sends. ``journals`` holds a shard's journal (or None)
    per ring; with ``degrade``, a match whose shard stays down through its
    retries (a dead or swapped ring, a timeout) takes that shard's positions
    as holes, counted in ``degraded_ops`` and the ring client's stats; any
    other failure still raises."""

    def __init__(self, rpcs, block_tokens: int, hasher: ChainHasher | None = None,
                 retry: RingRetryPolicy | None = None, on_evict=None, on_freed=None,
                 journals=None, degrade: bool = False):
        if not rpcs:
            raise ValueError("need at least one rpc transport")
        self.rpcs = list(rpcs)
        self.n_shards = len(self.rpcs)
        self.block_tokens = block_tokens
        self.hasher = hasher if hasher is not None else ChainHasher(block_tokens)
        self.retry = retry
        self.degrade = degrade
        self.degraded_ops = 0
        self.journals = [None] * self.n_shards if journals is None else list(journals)
        self.shards = [RemoteIndex(r, block_tokens, hasher=self.hasher, retry=retry,
                                   on_evict=on_evict, on_freed=on_freed, journal=j)
                       for r, j in zip(self.rpcs, self.journals)]
        # rings may differ in slot size: a fan-out takes the tightest
        for name in ("_max_match", "_max_publish", "_max_lookup", "_max_owners", "_max_remap"):
            setattr(self, name, min(getattr(s, name) for s in self.shards))

    def _fanout(self, msgs: dict[int, bytes], idempotent: bool = True,
                timeout: float = 5.0, failed: set[int] | None = None) -> dict[int, bytes]:
        """Post every shard's request, then collect every reply. A failed
        post stops posting; what was posted is still collected. A shard
        that failed transiently, or was never posted, gets its retries
        (``RingRetryPolicy``; one more attempt without one when ``failed``
        is given); then the first failure left is raised, unless ``failed``
        is given and every failure left is transient: those shards are
        added to it and left out of the answer."""
        slots: dict[int, int] = {}
        errs: dict[int, BaseException] = {}
        for s, m in msgs.items():
            try:
                slots[s] = self.rpcs[s].post(m)
            except BaseException as e:  # noqa: BLE001 - raised below unless retried
                errs[s] = e
                break
        out: dict[int, bytes] = {}
        for s, slot in slots.items():
            try:
                out[s] = self.rpcs[s].collect(slot, timeout)
            except BaseException as e:  # noqa: BLE001 - raised below unless retried
                errs[s] = e
        for s in msgs:
            e = errs.get(s)
            if s in out or (e is not None and not isinstance(e, _TRANSIENT)):
                continue
            if isinstance(e, TimeoutError) and not idempotent:
                continue  # it may have applied: surface it
            if self.retry is None and failed is None:
                continue
            try:
                out[s] = _call_with_retry(self.rpcs[s], msgs[s], self.retry, idempotent, timeout)
                errs.pop(s, None)
            except BaseException as e2:  # noqa: BLE001 - raised below
                errs[s] = e2
        missing = [s for s in msgs if s not in out]
        if missing and failed is not None and all(
                isinstance(errs[s], _TRANSIENT) for s in missing if s in errs):
            for s in missing:
                failed.add(s)
                self.rpcs[s].stats.degraded_ops += 1
            self.degraded_ops += len(missing)
        elif missing:
            for s in msgs:
                if s in errs:
                    raise errs[s]
            raise RuntimeError("fan-out incomplete without an error")
        return out

    def keys_for(self, tokens: list[int]) -> tuple[bytes, ...]:
        return self.hasher.keys_for(tokens)

    def _rounds(self, keys, M: int, encode, idempotent: bool = True,
                failed: set[int] | None = None):
        """Chunk rounds over the shards' sub-chains, each round one fan-out:
        yields (the shard, its keys, their positions in ``keys``, the
        chunk's offset, the reply); ``encode(keys, positions, lo, hi)``
        builds a shard's chunk. A shard leaves when its sub-chain is done,
        when the caller sends False for its reply (a match's short chunk),
        or when it lands in ``failed`` (``_fanout``)."""
        key_lists, pos_lists = partition_keys(keys, self.n_shards)
        offs = [0] * self.n_shards
        active = {s for s in range(self.n_shards) if key_lists[s]}
        while active:
            resp = self._fanout({s: encode(key_lists[s], pos_lists[s], offs[s], offs[s] + M)
                                 for s in sorted(active)}, idempotent, failed=failed)
            for s in sorted(active):
                if s not in resp:  # degraded: its positions stay holes
                    active.discard(s)
                    continue
                o = offs[s]
                more = yield s, key_lists[s], pos_lists[s], o, resp[s]
                offs[s] = o + min(M, len(key_lists[s]) - o)
                if more is False or offs[s] >= len(key_lists[s]):
                    active.discard(s)

    def match_prefix(self, tokens: list[int]) -> list[tuple[bytes, int, int]]:
        return self.match_prefix_keys(self.keys_for(tokens))

    def match_prefix_keys(self, keys) -> list[tuple[bytes, int, int]]:
        if self.n_shards == 1:
            if not self.degrade:
                return self.shards[0].match_prefix_keys(keys)
            try:
                return self.shards[0].match_prefix_keys(keys)
            except _TRANSIENT:  # the one shard is down: every position a hole
                self.degraded_ops += 1
                self.rpcs[0].stats.degraded_ops += 1
                return []
        found: list[tuple[int, int] | None] = [None] * len(keys)
        M = self._max_match
        rounds = self._rounds(keys, M, lambda kl, pl, lo, hi: encode_match(kl[lo:hi]),
                              failed=set() if self.degrade else None)
        step = next(rounds, None)
        while step is not None:
            _, kl, pl, o, resp = step
            ids, eps = decode_match_resp(resp)
            for j, (b, e) in enumerate(zip(ids.tolist(), eps.tolist())):
                found[pl[o + j]] = (b, e)
            # a short chunk ends this shard's prefix
            step = _send(rounds, len(ids) >= min(M, len(kl) - o))
        out: list[tuple[bytes, int, int]] = []
        for k, f in zip(keys, found):
            if f is None:
                break  # the first hole ends the global prefix
            out.append((k, f[0], f[1]))
        return out

    def publish_many(self, keys, block_ids, epochs, n_tokens: int) -> None:
        if self.n_shards == 1:
            return self.shards[0].publish_many(keys, block_ids, epochs, n_tokens)

        def encode(kl, pl, lo, hi):
            sel = pl[lo:hi]
            return encode_publish(kl[lo:hi], [block_ids[i] for i in sel],
                                  [epochs[i] for i in sel], n_tokens)

        M = self._max_publish
        for s, kl, pl, o, _ in self._rounds(keys, M, encode):
            if self.journals[s] is not None:
                sel = pl[o : o + M]
                self.journals[s].append_publish(kl[o : o + M], [block_ids[i] for i in sel],
                                                [epochs[i] for i in sel], n_tokens)

    def lookup_many(self, keys) -> list[PrefixEntry | None]:
        if self.n_shards == 1:
            return self.shards[0].lookup_many(keys)
        out: list[PrefixEntry | None] = [None] * len(keys)
        for _, _, pl, o, resp in self._rounds(
                keys, self._max_lookup, lambda kl, pl, lo, hi: encode_lookup(kl[lo:hi])):
            ids, eps, ntk = decode_lookup_resp(resp)
            for j, (b, e, t) in enumerate(zip(ids.tolist(), eps.tolist(), ntk.tolist())):
                if b >= 0:
                    out[pl[o + j]] = PrefixEntry(b, e, t)
        return out

    def filter_unpublished(self, keys) -> list[int]:
        if self.n_shards == 1:
            return self.shards[0].filter_unpublished(keys)
        out: list[int] = []
        for _, _, pl, o, resp in self._rounds(
                keys, self._max_lookup, lambda kl, pl, lo, hi: encode_filter(kl[lo:hi])):
            out.extend(pl[o + p] for p in decode_filter_resp(resp))
        return sorted(out)

    def evict_lru(self, n: int) -> list[int]:
        """The in-process plane's policy (``evict_lru_pressure``), each
        probe and eviction over its shard's ring."""
        if self.n_shards == 1:
            return self.shards[0].evict_lru(n)
        return evict_lru_pressure(self.shards, n)

    def owners_of(self, block_ids) -> tuple[list[bytes], list[int], list[int]]:
        if self.n_shards == 1:
            return self.shards[0].owners_of(block_ids)
        answers = []
        M = self._max_owners
        for off in range(0, len(block_ids), M):
            chunk = block_ids[off : off + M]
            resp = self._fanout({s: encode_owners(chunk) for s in range(self.n_shards)})
            answers.extend(decode_owners_resp(r) for r in resp.values())
        return merge_owners(block_ids, answers)

    def remap_many(self, keys, old_ids, old_epochs, new_ids, new_epochs) -> list[bool]:
        if self.n_shards == 1:
            return self.shards[0].remap_many(keys, old_ids, old_epochs, new_ids, new_epochs)

        def encode(kl, pl, lo, hi):
            sel = pl[lo:hi]
            return encode_remap(kl[lo:hi], [old_ids[i] for i in sel],
                                [old_epochs[i] for i in sel], [new_ids[i] for i in sel],
                                [new_epochs[i] for i in sel])

        ok = [False] * len(keys)
        M = self._max_remap
        for s, _, pl, o, resp in self._rounds(keys, M, encode, idempotent=False):
            sub = decode_remap_resp(resp)
            for v, i in zip(sub, pl[o : o + M]):
                ok[i] = v
            if self.journals[s] is not None and any(sub):
                done = [i for v, i in zip(sub, pl[o : o + M]) if v]
                self.journals[s].append_remap([keys[i] for i in done], [new_ids[i] for i in done],
                                              [new_epochs[i] for i in done])
        return ok

    def evict_blocks(self, block_ids) -> list[int]:
        if self.n_shards == 1:
            return self.shards[0].evict_blocks(block_ids)
        return evict_blocks_sharded(self.shards, block_ids)

    def stats(self) -> dict:
        if self.n_shards == 1:
            return self.shards[0].stats()
        return merge_stats([s.stats() for s in self.shards])


class ClientTotals:
    """A plane's round trips, ring wait and retries, summed over its
    ``clients`` (one ``RingClient`` a ring)."""

    def round_trips(self) -> int:
        return sum(c.stats.requests for c in self.clients)

    def total_wait(self) -> float:
        return sum(c.stats.total_wait for c in self.clients)

    def retries(self) -> int:
        return sum(c.stats.retries for c in self.clients)


@dataclass
class RingPlane(ClientTotals):
    """An index served over S rings by S ``RingServer`` threads: ``backing``
    is what they serve (shard s behind ring s), ``remote`` the index's
    surface over them, ``clients`` one ``RingClient`` a ring. The clients
    have one owner, so ``remote`` is used from one thread."""

    backing: object  # PrefixIndex | ShardedPrefixIndex
    remote: ShardedRemoteIndex
    clients: list[RingClient] = field(default_factory=list)
    servers: list[RingServer] = field(default_factory=list)

    def close(self, timeout: float = 5.0) -> list[RingServer]:
        """Stop and join every server thread (idempotent); returns those
        still alive after ``timeout`` each, which a caller must treat as a
        failure. ``servers`` and the clients' stats stay readable."""
        return [s for s in self.servers if not s.stop(timeout)]


def ring_plane(backing, n_slots: int, payload_bytes: int,
               retry: RingRetryPolicy | None = None) -> RingPlane:
    """Serve ``backing`` (a ``PrefixIndex``, or a ``ShardedPrefixIndex``
    with a ring a shard) over private rings of ``n_slots`` slots of
    ``payload_bytes``, each by a server thread that parks on its doorbell
    when idle, and put a ``ShardedRemoteIndex`` (under ``retry``) over the
    clients. Nothing is left running if a step fails."""
    shards = getattr(backing, "shards", None) or [backing]
    plane = RingPlane(backing, None)
    try:
        for shard in shards:
            ring = SlotRing(n_slots, payload_bytes)
            bell = threading.Event()
            plane.servers.append(RingServer(
                ring, make_index_handler(shard, max_reply=ring.payload_bytes),
                doorbell=bell).start())
            plane.clients.append(RingClient(ring, doorbell=bell))
        plane.remote = ShardedRemoteIndex(plane.clients, backing.block_tokens,
                                          hasher=backing.hasher, retry=retry)
    except BaseException:
        plane.close()
        raise
    return plane


def _send(gen, value):
    """``gen.send(value)``, None once the generator is done."""
    try:
        return gen.send(value)
    except StopIteration:
        return None
