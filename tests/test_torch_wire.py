"""The port's wire codec (``core/wire.py``) against the JAX package's:

* for every index-plane opcode (1-12, 20) the port's encoder gives JAX's
  bytes on seeded inputs, and each decoder reads JAX's replies alike;
* on seeded op streams (every op, BATCH frames, truncated and malformed
  frames among them) ``handle_request`` over a ``PrefixIndex`` gives replies
  byte-equal to JAX's over a ``GlobalIndex``, and so do ``reply_bound`` and
  ``prevalidate`` (the same frames refused);
* a Hypothesis fuzz: the port's handler raises nothing but
  ``WireFormatError`` on any frame. A short SEED_STATS frame is among the
  examples: JAX's ``handle_request`` unpacks it unchecked
  (``src/repro/core/wire.py:624-625``) and raises ``struct.error``, a
  difference by design that one test pins;
* ``RemoteIndex`` through slots small enough to chunk every op, against
  JAX's ``RpcIndexClient`` through slots of the same size on the same op
  stream, pipelined reads included.
"""

from __future__ import annotations

import struct

import numpy as np
import pytest
from hypothesis import example, given, settings
from hypothesis import strategies as st

from repro.core import wire as jwire
from repro.core.index import GlobalIndex
from repro.core.pool import BelugaPool, PoolLayout
from repro_torch.core import wire
from repro_torch.core.index import PrefixIndex, chain_keys
from repro_torch.core.pool import KVBlockLayout, KVBlockPool
from repro_torch.core.rpc import RingClient, RingServer, SlotRing
from test_torch_rpc import _drive

LAYOUT = KVBlockLayout(block_tokens=16, n_layers_kv=4, n_kv_heads=2, head_dim=8)
JLAYOUT = PoolLayout(block_tokens=16, n_layers_kv=4, n_kv_heads=2, head_dim=8)
OPS = {name: getattr(jwire, name) for name in dir(jwire) if name.startswith("OP_")}
INDEX_OPS = {n: v for n, v in OPS.items() if v <= 12 or v == 20}


def test_opcodes_are_the_reference_s():
    # the index plane's 13 ops and the pool and journal ops (13-19, 21, 22)
    mine = {n: getattr(wire, n) for n in dir(wire) if n.startswith("OP_")}
    assert mine == OPS and len(mine) == 22 and len(INDEX_OPS) == 13


def _keys(rng, n):
    return [rng.bytes(16) for _ in range(n)]


def _encodings(mod, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 9))
    ks = _keys(rng, n)
    ids = rng.integers(0, 1 << 40, size=n).tolist()
    eps = rng.integers(-5, 1 << 40, size=n).tolist()
    ntk = rng.integers(-(1 << 31), 1 << 31, size=n).tolist()
    return {
        "MATCH": mod.encode_match(ks),
        "PUBLISH": mod.encode_publish(ks, ids, eps, int(rng.integers(-(1 << 31), 1 << 31))),
        "LOOKUP": mod.encode_lookup(ks),
        "FILTER": mod.encode_filter(ks),
        "EVICT": mod.encode_evict(int(rng.integers(0, 1 << 32))),
        "BATCH": mod.encode_batch([mod.encode_match(ks), mod.encode_evict(3), mod.encode_stats()]),
        "OWNERS": mod.encode_owners(ids),
        "REMAP": mod.encode_remap(ks, ids, eps, ids[::-1], eps[::-1]),
        "EVICT_BLOCKS": mod.encode_evict_blocks(ids),
        "STATS": mod.encode_stats(),
        "SNAPSHOT": mod.encode_snapshot(int(rng.integers(0, 1 << 32)), int(rng.integers(0, 1 << 32))),
        "RESTORE": mod.encode_restore(ks, ids, eps, ntk),
        "SEED_STATS": mod.encode_seed_stats(int(rng.integers(0, 1 << 63)),
                                            int(rng.integers(0, 1 << 63))),
    }


@pytest.mark.parametrize("seed", range(6))
def test_every_encoder_gives_the_reference_s_bytes(seed):
    mine, ref = _encodings(wire, seed), _encodings(jwire, seed)
    assert set(mine) == {n[3:] for n in INDEX_OPS}
    assert mine == ref
    for name, frame in mine.items():
        assert frame[0] == INDEX_OPS["OP_" + name]
    for mod, err in ((wire, wire.WireFormatError), (jwire, jwire.WireError)):
        with pytest.raises(err):
            mod.encode_match([b"short"])
        with pytest.raises(err):
            mod.encode_publish([b"k" * 16], [1, 2], [1], 16)


def _pools():
    return (KVBlockPool(LAYOUT, 128, "meta", n_shards=8),
            BelugaPool(JLAYOUT, n_blocks=128, n_shards=8, backing="meta"))


def _frames(rng, pool, published):
    """One seeded frame: a valid op over the published chains, or a
    truncated, unknown or out-of-range one."""
    kind = int(rng.integers(0, 16))
    chain = published[int(rng.integers(len(published)))] if published else []
    keys = chain[: int(rng.integers(0, len(chain) + 1))] + _keys(rng, int(rng.integers(0, 3)))
    ids = rng.integers(0, pool.n_blocks, size=len(keys)).tolist()
    if kind == 0:
        return wire.encode_match(keys)
    if kind == 1:
        return wire.encode_lookup(keys)
    if kind == 2:
        return wire.encode_filter(keys)
    if kind == 3:
        return wire.encode_evict(int(rng.integers(0, 4)))
    if kind == 4:
        return wire.encode_owners(ids)
    if kind == 5:
        return wire.encode_remap(keys, ids, rng.integers(0, 3, size=len(keys)).tolist(),
                                 ids[::-1], rng.integers(0, 3, size=len(keys)).tolist())
    if kind == 6:
        return wire.encode_evict_blocks(ids)
    if kind == 7:
        return wire.encode_stats()
    if kind == 8:
        return wire.encode_snapshot(int(rng.integers(0, 8)), int(rng.integers(0, 6)))
    if kind == 9:
        return wire.encode_restore(keys, ids, rng.integers(0, 4, size=len(keys)).tolist(),
                                   rng.integers(0, 64, size=len(keys)).tolist())
    if kind == 10:
        return wire.encode_seed_stats(int(rng.integers(0, 100)), int(rng.integers(0, 100)))
    if kind == 11:  # a batch of valid sub-ops, maybe one bad one inside
        subs = [wire.encode_match(keys), wire.encode_stats(), wire.encode_evict(1)]
        if rng.random() < 0.3:
            subs.append(wire.encode_owners([pool.n_blocks + 3]))
        return wire.encode_batch(subs)
    if kind == 12:  # out of the pool's range
        return wire.encode_evict_blocks([pool.n_blocks + int(rng.integers(0, 9))])
    if kind == 13:  # a chain that repeats a key
        return wire.encode_match(keys + keys[:1]) if keys else wire.encode_match([b"d" * 16] * 2)
    if kind == 14:  # unknown op
        return bytes([int(rng.choice([0, 13, 19, 21, 99]))]) + bytes(8)
    full = wire.encode_restore(keys, ids, [1] * len(keys), [16] * len(keys))
    return full[: int(rng.integers(0, len(full) + 1))]  # truncated


def _answer(mod, index, frame, err):
    out = {}
    for name, fn in (("bound", lambda: mod.reply_bound(frame)),
                     ("pre", lambda: mod.prevalidate(index, frame)),
                     ("reply", lambda: mod.make_index_handler(index)(frame))):
        try:
            out[name] = fn()
        except err as e:
            out[name] = ("refused", str(e))
    return out


@pytest.mark.parametrize("seed", range(8))
def test_handler_replies_are_byte_equal_to_the_reference_s(seed):
    rng = np.random.default_rng(seed)
    pool, jpool = _pools()
    idx, jidx = PrefixIndex(pool), GlobalIndex(jpool)
    published = []
    for step in range(120):
        if step % 10 == 0 and pool.free_blocks() >= 6:  # publish a chain on both
            tokens = rng.integers(0, 1000, size=16 * int(rng.integers(1, 6))).tolist()
            keys = list(chain_keys(tokens, 16))
            blocks = pool.allocate(len(keys))
            assert jpool.allocate(len(keys)) == blocks
            frame = wire.encode_publish(keys, blocks, pool.write_blocks(blocks), 16)
            jpool.write_blocks(blocks)
            published.append(keys)
        elif step % 17 == 0:  # a reference dropped on both pools
            held = np.flatnonzero(pool.refcounts > 0)
            if len(held):
                b = int(rng.choice(held))
                pool.release([b])
                jpool.release([b])
            continue
        else:
            frame = _frames(rng, pool, published)
        got = _answer(wire, idx, frame, wire.WireFormatError)
        want = _answer(jwire, jidx, frame, jwire.WireError)
        assert got == want, (step, frame[:1])
    assert (pool.refcounts.tolist(), pool.epochs.tolist()) == \
        (jpool.refcounts.tolist(), jpool.epochs.tolist())
    assert idx.stats() == jidx.stats()


@pytest.mark.parametrize("seed", range(3))
def test_decoders_read_the_reference_s_replies(seed):
    rng = np.random.default_rng(seed)
    pool, jpool = _pools()
    jidx = GlobalIndex(jpool)
    tokens = rng.integers(0, 1000, size=64).tolist()
    keys = list(chain_keys(tokens, 16))
    blocks = jpool.allocate(4)
    jwire.handle_request(jidx, jwire.encode_publish(keys, blocks, jpool.write_blocks(blocks), 16))
    pairs = [
        ("decode_match_resp", jwire.encode_match(keys)),
        ("decode_lookup_resp", jwire.encode_lookup(keys + _keys(rng, 1))),
        ("decode_filter_resp", jwire.encode_filter(_keys(rng, 1) + keys)),
        ("decode_owners_resp", jwire.encode_owners(blocks)),
        ("decode_remap_resp", jwire.encode_remap(keys[:2], blocks[:2], [1, 0], blocks[2:],
                                                 [1, 1])),
        ("decode_stats_resp", jwire.encode_stats()),
        ("decode_snapshot_resp", jwire.encode_snapshot(1, 2)),
        ("decode_evict_resp_keys", jwire.encode_evict(2)),
        ("decode_batch_resp", jwire.encode_batch([jwire.encode_stats()] * 2)),
    ]
    for name, req in pairs:
        reply = jwire.handle_request(jidx, req)
        got, want = getattr(wire, name)(reply), getattr(jwire, name)(reply)
        norm = lambda x: [v.tolist() if isinstance(v, np.ndarray) else v  # noqa: E731
                          for v in x] if isinstance(x, tuple) else x
        assert norm(got) == norm(want), name
        with pytest.raises(wire.WireFormatError):
            getattr(wire, name)(reply[:-1] if len(reply) > 4 else reply[:2])


_SHORT_SEED_STATS = bytes([jwire.OP_SEED_STATS]) + struct.pack("<I", 0) + bytes(7)


def test_short_seed_stats_frame_is_a_wire_error_by_design():
    """The port checks the SEED_STATS body's length; JAX's handler unpacks
    it unchecked and raises ``struct.error`` (a defect of the reference)."""
    pool, jpool = _pools()
    with pytest.raises(wire.WireFormatError, match="truncated"):
        wire.handle_request(PrefixIndex(pool), _SHORT_SEED_STATS)
    with pytest.raises(struct.error):
        jwire.handle_request(GlobalIndex(jpool), _SHORT_SEED_STATS)
    # served with a reply bound (as a ring server serves it), JAX's
    # reply_bound refuses it first
    with pytest.raises(jwire.WireError):
        jwire.make_index_handler(GlobalIndex(jpool), max_reply=1024)(_SHORT_SEED_STATS)


@settings(max_examples=60, deadline=None, database=None)
@given(st.binary(min_size=0, max_size=200))
@example(_SHORT_SEED_STATS)
@example(bytes([jwire.OP_SEED_STATS, 0, 0, 0, 0]))
@example(bytes([jwire.OP_BATCH, 1, 0, 0, 0, 5, 0, 0, 0, jwire.OP_SEED_STATS, 0, 0, 0, 0]))
@example(bytes([jwire.OP_EVICT, 255, 255, 255, 255]))
@example(bytes([jwire.OP_SNAPSHOT, 255, 255, 255, 255, 0, 0, 0, 0]))
def test_fuzzed_frames_raise_nothing_but_wire_format_error(blob):
    pool = KVBlockPool(LAYOUT, 64, "meta", n_shards=8)
    idx = PrefixIndex(pool)
    for fn in (lambda: wire.handle_request(idx, blob), lambda: wire.make_index_handler(idx)(blob)):
        try:
            fn()
        except wire.WireFormatError:
            pass


@pytest.mark.parametrize("payload", [96, 128, 512])
@pytest.mark.parametrize("seed", [0, 3])
def test_remote_index_through_small_slots_equals_reference(payload, seed):
    """Every op chunked over slots of a few keys (pipelined reads among
    them): the same results, stats and pool as JAX's client and server over
    slots of the same size. (A chunked match that stops early leaves the
    chain's later chunks unsent, and so uncounted as misses, on both.)"""
    from repro.core.rpc import CxlRpcClient, CxlRpcServer, ShmRing

    pool = KVBlockPool(LAYOUT, 128, "meta", n_shards=8)
    ring = SlotRing(n_slots=6, payload_bytes=payload)
    server = RingServer(ring, wire.make_index_handler(PrefixIndex(pool),
                                                      max_reply=payload)).start()
    try:
        client = RingClient(ring)
        remote = wire.RemoteIndex(client, 16)
        assert remote._max_lookup <= 24 and remote._max_evict <= 20
        got = _drive(remote, pool, seed)
    finally:
        server.stop()
    jpool = BelugaPool(JLAYOUT, n_blocks=128, n_shards=8, backing="meta")
    jring = ShmRing(n_slots=6, payload_bytes=payload)
    jserver = CxlRpcServer(jring, jwire.make_index_handler(GlobalIndex(jpool),
                                                           max_reply=payload)).start()
    try:
        jclient = CxlRpcClient(jring)
        want = _drive(jwire.RpcIndexClient(jclient, 16), jpool, seed)
    finally:
        jserver.stop()
    assert got == want
    assert (client.stats.requests, client.stats.errors, client.stats.timeouts) == \
        (jclient.stats.requests, 0, 0)
    assert client.free_slots() == ring.n_slots


def test_remote_evictions_hand_the_destroyed_keys_to_on_evict():
    """A ring-served eviction's reply carries the keys it destroyed (ids,
    then keys), and ``on_evict`` hears them in the order the index dropped
    them, as the in-process index's own hook does."""
    pool = KVBlockPool(LAYOUT, 64, "meta", n_shards=8)
    idx = PrefixIndex(pool)
    local_heard, heard = [], []
    idx.on_evict = local_heard.extend
    keys = list(chain_keys(list(range(16 * 6)), 16))
    blocks = pool.allocate(len(keys))
    idx.publish_many(keys, blocks, pool.write_blocks(blocks), 16)
    ring = SlotRing(n_slots=4, payload_bytes=128)  # an eviction of 6 takes two chunks
    server = RingServer(ring, wire.make_index_handler(idx, max_reply=128)).start()
    try:
        remote = wire.RemoteIndex(RingClient(ring), 16, on_evict=heard.extend)
        assert remote._max_evict < 6
        assert remote.evict_blocks(blocks[4:]) == blocks[4:]
        assert remote.evict_lru(10) == blocks[:4]
    finally:
        server.stop()
    assert heard == local_heard == keys[4:] + keys[:4]
