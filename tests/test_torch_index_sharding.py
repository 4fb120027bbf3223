"""The port's index surface and sharded metadata plane against the JAX
package's, on seeded op streams:

* ``PrefixIndex``'s calls the wire serves (``publish``, ``lookup_many``,
  ``n_entries``, ``keys_of_blocks``, ``snapshot_entries``,
  ``restore_entries``, ``seed_stats``) against ``GlobalIndex``'s, LRU pages
  included;
* ``shard_of_key`` / ``partition_keys``, and ``ShardedPrefixIndex`` against
  ``ShardedIndex`` at 1-4 shards: every op's answer, the stats with their
  per-shard entries, the pool, each shard's LRU;
* ``ShardedRemoteIndex`` over S rings (one server thread a shard) against
  JAX's ``ShardedRpcIndexClient`` over S rings, and against the in-process
  ``ShardedPrefixIndex``; through small slots; its fan-out posts to every
  ring before it collects (a barrier across the shards' handlers), and a
  shard that fails leaves no slot behind;
* the occupancy-levelling eviction (``evict_lru_pressure``) freeing the
  same blocks in process and over the rings.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

from repro.core import wire as jwire
from repro.core.index import GlobalIndex, ShardedIndex
from repro.core.index import partition_keys as jpartition_keys
from repro.core.index import shard_of_key as jshard_of_key
from repro.core.pool import BelugaPool, PoolLayout
from repro.core.rpc import CxlRpcClient, CxlRpcServer, ShmRing
from repro_torch.core import wire
from repro_torch.core.index import (
    PrefixIndex,
    ShardedPrefixIndex,
    chain_keys,
    partition_keys,
    shard_of_key,
)
from repro_torch.core.pool import KVBlockLayout, KVBlockPool
from repro_torch.core.rpc import RingClient, RingServer, SlotRing
from test_torch_rpc import _drive, _norm

LAYOUT = KVBlockLayout(block_tokens=16, n_layers_kv=4, n_kv_heads=2, head_dim=8)
JLAYOUT = PoolLayout(block_tokens=16, n_layers_kv=4, n_kv_heads=2, head_dim=8)


def _pools(n=128):
    return (KVBlockPool(LAYOUT, n, "meta", n_shards=8),
            BelugaPool(JLAYOUT, n_blocks=n, n_shards=8, backing="meta"))


def _lru(idx):
    """Each shard's (key, block, epoch, n_tokens), least recently used first."""
    shards = idx.shards if hasattr(idx, "shards") else [idx]
    out = []
    for sh in shards:
        _, keys, ids, eps, ntk = sh.snapshot_entries(0, 1 << 30)
        out.append(list(zip(keys, ids, eps, ntk)))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_index_surface_equals_reference(seed):
    rng = np.random.default_rng(seed)
    pool, jpool = _pools()
    idx, jidx = PrefixIndex(pool), GlobalIndex(jpool)
    keys_seen = []
    for step in range(150):
        op = int(rng.integers(0, 9))
        if op <= 1 and pool.free_blocks() >= 4:
            keys = [rng.bytes(16) for _ in range(int(rng.integers(1, 4)))]
            if keys_seen and rng.random() < 0.4:
                keys[0] = keys_seen[int(rng.integers(len(keys_seen)))]  # a re-publish
            blocks = pool.allocate(len(keys))
            assert jpool.allocate(len(keys)) == blocks
            eps = pool.write_blocks(blocks)
            jpool.write_blocks(blocks)
            if op == 0:
                for k, b, e in zip(keys, blocks, eps):
                    idx.publish(k, b, e, 16)
                    jidx.publish(k, b, e, 16)
            else:
                idx.publish_many(keys, blocks, eps, 16)
                jidx.publish_many(keys, blocks, eps, 16)
            keys_seen += keys
        elif op == 2 and keys_seen:
            ks = [keys_seen[int(i)] for i in rng.integers(0, len(keys_seen), size=5)]
            assert _norm(idx.lookup_many(ks + [b"x" * 16])) == \
                _norm(jidx.lookup_many(ks + [b"x" * 16]))
        elif op == 3:
            ids = rng.integers(0, pool.n_blocks, size=6).tolist()
            assert idx.keys_of_blocks(ids) == jidx.keys_of_blocks(ids)
        elif op == 4:
            start, n = int(rng.integers(0, 10)), int(rng.integers(0, 8))
            assert idx.snapshot_entries(start, n) == jidx.snapshot_entries(start, n)
        elif op == 5 and keys_seen:
            ks = [keys_seen[int(i)] for i in rng.integers(0, len(keys_seen), size=3)]
            ids = rng.integers(0, pool.n_blocks, size=3).tolist()
            eps, ntk = rng.integers(0, 5, size=3).tolist(), rng.integers(1, 40, size=3).tolist()
            assert idx.restore_entries(ks, ids, eps, ntk) == \
                jidx.restore_entries(ks, ids, eps, ntk)
        elif op == 6:
            n = int(rng.integers(0, 3))
            assert idx.evict_lru(n) == jidx.evict_lru(n)
        elif op == 7:
            h, m = int(rng.integers(0, 50)), int(rng.integers(0, 50))
            idx.seed_stats(h, m)
            jidx.seed_stats(h, m)
        else:
            ks = keys_seen[-3:]
            assert idx.match_prefix_keys(ks) == jidx.match_prefix_keys(ks)
        assert idx.n_entries() == jidx.n_entries()
        assert idx.stats() == jidx.stats()
    assert _lru(idx) == _lru(jidx)
    assert (pool.refcounts.tolist(), pool.epochs.tolist()) == \
        (jpool.refcounts.tolist(), jpool.epochs.tolist())


def test_routing_equals_reference():
    rng = np.random.default_rng(0)
    keys = [rng.bytes(16) for _ in range(300)]
    for s in (1, 2, 3, 4, 7):
        assert [shard_of_key(k, s) for k in keys] == [jshard_of_key(k, s) for k in keys]
        assert partition_keys(keys, s) == jpartition_keys(keys, s)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_sharded_index_equals_reference(n_shards, seed):
    """The wire's op stream against ``ShardedPrefixIndex`` and
    ``ShardedIndex``; then a pool small enough that evictions drain the
    fullest shards first, on both."""
    for n_blocks in (128, 48):
        pool, jpool = _pools(n_blocks)
        got_idx, want_idx = ShardedPrefixIndex(pool, n_shards), ShardedIndex(jpool, n_shards)
        assert _drive(got_idx, pool, seed, paged=False) == \
            _drive(want_idx, jpool, seed, paged=False)
        assert _lru(got_idx) == _lru(want_idx)
        ids = list(range(n_blocks))
        assert got_idx.keys_of_blocks(ids) == want_idx.keys_of_blocks(ids)
        assert got_idx.n_entries() == want_idx.stats()["entries"]


def test_sharded_on_evict_hears_every_shard():
    pool, _ = _pools()
    sidx = ShardedPrefixIndex(pool, 3)
    heard = []
    sidx.on_evict = heard.extend
    assert all(sh.on_evict is not None for sh in sidx.shards)
    keys = list(chain_keys(list(range(16 * 12)), 16))
    blocks = pool.allocate(len(keys))
    sidx.publish_many(keys, blocks, pool.write_blocks(blocks), 16)
    freed = sidx.evict_lru(len(keys))
    assert sorted(freed) == sorted(blocks) and sorted(heard) == sorted(keys)
    assert {shard_of_key(k, 3) for k in heard} == {0, 1, 2}


class Rings:
    """S rings, each served by a thread over one shard (the port's or
    JAX's), stopped on exit."""

    def __init__(self, shards, port: bool, n_slots=8, payload=1 << 14, make=None):
        self.servers, self.clients = [], []
        for sh in shards:
            if port:
                ring = SlotRing(n_slots, payload)
                handler = (make or wire.make_index_handler)(sh, max_reply=payload)
                self.servers.append(RingServer(ring, handler))
                self.clients.append(RingClient(ring))
            else:
                ring = ShmRing(n_slots=n_slots, payload_bytes=payload)
                self.servers.append(CxlRpcServer(ring, jwire.make_index_handler(
                    sh, max_reply=payload)))
                self.clients.append(CxlRpcClient(ring))

    def __enter__(self):
        for s in self.servers:
            s.start()
        return self

    def __exit__(self, *exc):
        for s in self.servers:
            s.stop()


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("payload", [1 << 14, 160])
def test_sharded_remote_index_equals_reference(n_shards, payload):
    """The same op stream through ``ShardedRemoteIndex`` and JAX's
    ``ShardedRpcIndexClient``; at large slots also through the in-process
    ``ShardedPrefixIndex`` (small slots chunk a match, which leaves a
    chain's later chunks uncounted as misses)."""
    pool, jpool = _pools()
    sidx, jsidx = ShardedPrefixIndex(pool, n_shards), ShardedIndex(jpool, n_shards)
    with Rings(sidx.shards, True, payload=payload) as mine, \
            Rings(jsidx.shards, False, payload=payload) as ref:
        got = _drive(wire.ShardedRemoteIndex(mine.clients, 16, hasher=sidx.hasher), pool, 5,
                     paged=False)
        want = _drive(jwire.ShardedRpcIndexClient(ref.clients, 16, hasher=jsidx.hasher), jpool,
                      5, paged=False)
    assert got == want
    assert [c.stats.requests for c in mine.clients] == [c.stats.requests for c in ref.clients]
    assert all(c.free_slots() == 8 for c in mine.clients)
    assert _lru(sidx) == _lru(jsidx)
    if payload > 1024:
        inproc_pool, _ = _pools()
        assert got == _drive(ShardedPrefixIndex(inproc_pool, n_shards), inproc_pool, 5,
                             paged=False)


def test_fanout_posts_every_ring_before_collecting():
    """Each shard's handler waits until all S have their sub-request: a
    client that collected one ring before posting the next would hang."""
    S = 3
    pool, _ = _pools()
    sidx = ShardedPrefixIndex(pool, S)
    keys = list(chain_keys(list(range(16 * 24)), 16))
    blocks = pool.allocate(len(keys))
    sidx.publish_many(keys, blocks, pool.write_blocks(blocks), 16)
    barrier = threading.Barrier(S)

    def make(shard, max_reply):
        inner = wire.make_index_handler(shard, max_reply=max_reply)

        def handler(payload: bytes) -> bytes:
            barrier.wait(timeout=10)
            return inner(payload)

        return handler

    assert all(partition_keys(keys, S)[0])
    with Rings(sidx.shards, True, make=make) as r:
        proxy = wire.ShardedRemoteIndex(r.clients, 16, hasher=sidx.hasher)
        assert [b for _, b, _ in proxy.match_prefix_keys(keys)] == blocks


def test_fanout_collects_posted_slots_when_a_shard_fails():
    pool, _ = _pools()
    sidx = ShardedPrefixIndex(pool, 2)
    keys = list(chain_keys(list(range(64)), 16))
    blocks = pool.allocate(len(keys))
    sidx.publish_many(keys, blocks, pool.write_blocks(blocks), 16)
    with Rings(sidx.shards, True, n_slots=2) as r:
        proxy = wire.ShardedRemoteIndex(r.clients, 16, hasher=sidx.hasher)
        r.servers[1].stop()
        with pytest.raises(TimeoutError):
            proxy._fanout({0: wire.encode_match(keys[:1]), 1: wire.encode_match(keys[1:2])},
                          timeout=0.2)
        assert r.clients[0].stats.requests == 1 and r.clients[1].stats.timeouts == 1
        assert r.clients[0].free_slots() == 2
        first = partition_keys(keys, 2)[0][0][:1]
        assert proxy.shards[0].match_prefix_keys(first)
