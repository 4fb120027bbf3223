"""The self-healing plane's records against the JAX package's, in process:

* ``PublishJournal`` against ``ShardJournal`` on seeded op streams: the
  segment's bytes, ``records``, ``live_entries``, the compaction's
  generation, the overflow error; each package attaches and reads the
  other's journal, and an attach with the wrong capacity is refused;
* ``PrefixIndex.rebuild_from_journal`` against ``GlobalIndex``'s on the
  same records: the entries in the same LRU order, the same stats, and the
  same answers to a match;
* the pool's metadata segment (``share_meta``, flat and tiered) byte for
  byte JAX's after the same allocator stream, read through the other
  package's attach view (``SharedPoolMeta`` / ``PoolMetaView``) while the
  owner keeps writing; ``unshare_meta`` twice, values kept, name gone;
* ``FifoDoorbell``: a producer without a reader, a wakeup, the creator's
  unlink;
* the service chain imports without torch, in a fresh interpreter.

Every check is exact (bytes, ids, epochs, counters).
"""

from __future__ import annotations

import os
import subprocess
import sys
from multiprocessing import shared_memory
from pathlib import Path

import numpy as np
import pytest

from repro.core.index import GlobalIndex
from repro.core.pool import BelugaPool, PoolLayout
from repro.core.procserver import SharedPoolMeta
from repro.core.shm import ShardJournal
from repro.core.shm import live_entries as jlive_entries
from repro.tiering import TieredPool as JTieredPool
from repro.tiering import TieringConfig as JTieringConfig
from repro_torch.core.index import PrefixIndex
from repro_torch.core.pool import KVBlockLayout, KVBlockPool
from repro_torch.core.procserver import PoolMetaView
from repro_torch.core.shm import (
    JOURNAL_PUBLISH,
    JOURNAL_REMAP,
    JOURNAL_RETRACT,
    FifoDoorbell,
    PublishJournal,
    live_entries,
)
from repro_torch.tiering import TieredPool, TieringConfig

REPO = Path(__file__).resolve().parents[1]
LAYOUT = KVBlockLayout(block_tokens=16, n_layers_kv=4, n_kv_heads=2, head_dim=8)
JLAYOUT = PoolLayout(block_tokens=16, n_layers_kv=4, n_kv_heads=2, head_dim=8)


def _k(i: int) -> bytes:
    return i.to_bytes(4, "little") * 4


def _gone(name: str) -> bool:
    try:
        seg = shared_memory.SharedMemory(name=name)
    except FileNotFoundError:
        return True
    seg.close()
    return False


def _ops(seed: int, n: int = 60) -> list[tuple]:
    """A seeded stream of journal appends over 12 keys and 40 block ids."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        kind = int(rng.integers(0, 4))
        m = int(rng.integers(1, 4))
        keys = [_k(int(x)) for x in rng.integers(0, 12, m)]
        ids = rng.integers(0, 40, m).tolist()
        eps = rng.integers(0, 9, m).tolist()
        if kind <= 1:
            out.append(("append_publish", keys, ids, eps, int(rng.integers(1, 33))))
        elif kind == 2:
            out.append(("append_retract", ids))
        else:
            out.append(("append_remap", keys, ids, eps))
    return out


def _play(journal, ops) -> list:
    """Apply ``ops``; each result is the header after it, or the overflow's
    message."""
    seen = []
    for name, *args in ops:
        try:
            getattr(journal, name)(*args)
            seen.append((journal.generation, len(journal)))
        except RuntimeError as e:
            seen.append(str(e).replace(journal.name, "<name>"))
    return seen


@pytest.mark.parametrize("capacity", [64, 24, 9])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_journal_equals_reference_byte_for_byte(seed, capacity):
    """The same appends: the same headers after each (compactions included),
    the same overflow errors, the same segment bytes and records, the same
    fold; a small capacity compacts and overflows."""
    ops = _ops(seed)
    mine, theirs = PublishJournal.create(capacity), ShardJournal.create(capacity)
    try:
        assert _play(mine, ops) == _play(theirs, ops)
        size = PublishJournal.segment_size(capacity)
        assert size == ShardJournal.segment_size(capacity) == 24 + 37 * capacity
        assert bytes(mine._seg.buf[:size]) == bytes(theirs._seg.buf[:size])
        assert mine.records() == theirs.records()
        assert live_entries(mine.records()) == jlive_entries(theirs.records())
        assert list(live_entries(mine.records())) == list(jlive_entries(theirs.records()))
        if capacity == 9:
            assert mine.generation > 0
    finally:
        mine.close()
        theirs.close()
    assert _gone(mine.name) and _gone(theirs.name)


def test_each_package_reads_the_others_journal():
    ops = _ops(5, 20)
    mine, theirs = PublishJournal.create(128), ShardJournal.create(128)
    try:
        _play(mine, ops)
        _play(theirs, ops)
        j_on_mine = ShardJournal.attach(mine.name, 128)
        mine_on_j = PublishJournal.attach(theirs.name, 128)
        try:
            assert j_on_mine.records() == mine.records() == mine_on_j.records()
            # the attacher appends, the owner sees it
            mine_on_j.append_publish([_k(99)], [7], [3], 16)
            assert theirs.records()[-1] == (JOURNAL_PUBLISH, _k(99), 7, 3, 16)
            with pytest.raises(ValueError, match="capacity mismatch"):
                PublishJournal.attach(theirs.name, 64)
        finally:
            j_on_mine.close()
            mine_on_j.close()
        assert not _gone(mine.name)  # an attacher never unlinks
    finally:
        mine.close()
        theirs.close()


def test_live_entries_fold_as_reference():
    """A re-publish moves to the end, a retract removes only the last
    publisher of the block, a remap keeps n_tokens."""
    recs = [
        (JOURNAL_PUBLISH, _k(1), 10, 1, 16), (JOURNAL_PUBLISH, _k(2), 11, 1, 16),
        (JOURNAL_PUBLISH, _k(3), 12, 1, 16), (JOURNAL_RETRACT, bytes(16), 11, 0, 0),
        (JOURNAL_PUBLISH, _k(1), 13, 2, 16), (JOURNAL_REMAP, _k(3), 20, 5, -1),
        (JOURNAL_PUBLISH, _k(4), 20, 2, 8), (JOURNAL_RETRACT, bytes(16), 20, 0, 0),
    ]
    assert live_entries(recs) == jlive_entries(recs) == {_k(3): (20, 5, 16),
                                                        _k(1): (13, 2, 16)}
    assert list(live_entries(recs)) == list(jlive_entries(recs))


def _lru(idx) -> list:
    _, keys, ids, eps, ntk = idx.snapshot_entries(0, 1 << 20)
    return list(zip(keys, ids, eps, ntk))


@pytest.mark.parametrize("seed", [0, 3])
def test_rebuild_from_journal_equals_reference(seed):
    """Both indexes rebuilt from the same records over pools in the same
    state: the same entries in the same order, the same stats, the same
    matches (stale entries come back stale and are dropped alike)."""
    rng = np.random.default_rng(seed)
    pool = KVBlockPool(LAYOUT, 64, "meta", n_shards=8)
    jpool = BelugaPool(JLAYOUT, n_blocks=64, n_shards=8, backing="meta")
    journal = PublishJournal.create(256)
    try:
        docs = []
        for d in range(5):
            n = int(rng.integers(2, 7))
            keys = [_k(100 * d + i) for i in range(n)]
            for p in (pool, jpool):
                blocks = p.allocate(n)
                eps = p.write_blocks(blocks)
            journal.append_publish(keys, blocks, eps, 16)
            docs.append((keys, blocks))
        freed = docs[1][1][1:3]
        journal.append_retract(freed)
        for p in (pool, jpool):
            p.release(freed + [docs[2][1][0]])  # the last one goes stale
        journal.append_remap([docs[3][0][0]], [docs[4][1][0]], [9])
        recs = journal.records()
        mine, theirs = PrefixIndex(pool), GlobalIndex(jpool)
        assert mine.rebuild_from_journal(recs) == theirs.rebuild_from_journal(recs)
        assert _lru(mine) == _lru(theirs)
        assert mine.stats() == theirs.stats()
        for keys, _ in docs:
            assert mine.match_prefix_keys(keys) == theirs.match_prefix_keys(keys)
        assert _lru(mine) == _lru(theirs) and mine.stats() == theirs.stats()
    finally:
        journal.close()


def test_rebuild_keeps_the_journal_s_order_over_the_index_s_as_the_reference_does():
    """A client publishes to its shard's ring and appends to the journal in
    two calls, so two clients publishing one key at once may leave the
    journal holding the two publishes in the other order from the index's.
    A shard rebuilt from that journal then keeps the other block: the index
    applied ``b1`` then ``b2`` and held ``b2``, the journal says ``b2`` then
    ``b1``, and the rebuilt index holds ``b1``, in the port's
    ``PrefixIndex`` and the JAX package's ``GlobalIndex`` alike. The port
    follows the reference here on purpose (both packages share one
    journal's bytes)."""
    pool = KVBlockPool(LAYOUT, 16, "meta", n_shards=8)
    jpool = BelugaPool(JLAYOUT, n_blocks=16, n_shards=8, backing="meta")
    journal = PublishJournal.create(16)
    try:
        key = _k(7)
        blocks = [p.allocate(2) for p in (pool, jpool)]
        epochs = [p.write_blocks(b) for p, b in zip((pool, jpool), blocks)]
        assert blocks[0] == blocks[1] and epochs[0] == epochs[1]
        (b1, b2), (e1, e2) = blocks[0], epochs[0]
        live, jlive = PrefixIndex(pool), GlobalIndex(jpool)
        for idx in (live, jlive):
            idx.publish(key, b1, e1, 16)
            idx.publish(key, b2, e2, 16)
        assert _lru(live) == _lru(jlive) == [(key, b2, e2, 16)]
        journal.append_publish([key], [b2], [e2], 16)
        journal.append_publish([key], [b1], [e1], 16)
        recs = journal.records()
        mine, theirs = PrefixIndex(pool), GlobalIndex(jpool)
        assert mine.rebuild_from_journal(recs) == theirs.rebuild_from_journal(recs) == 1
        assert _lru(mine) == _lru(theirs) == [(key, b1, e1, 16)]
    finally:
        journal.close()


def _alloc_stream(pool, seed: int) -> None:
    rng = np.random.default_rng(seed)
    held: list[int] = []
    for _ in range(40):
        if held and rng.random() < 0.4:
            k = int(rng.integers(1, len(held) + 1))
            pool.release(held[:k])
            held = held[k:]
        elif pool.free_blocks() >= 4:
            got = pool.allocate(int(rng.integers(1, 5)))
            if rng.random() < 0.7:
                pool.write_blocks(got)
            held += got


def _segment_bytes(name: str, n: int) -> bytes:
    seg = shared_memory.SharedMemory(name=name)
    try:
        return bytes(seg.buf[: 13 * n])
    finally:
        seg.close()


@pytest.mark.parametrize("tiered", [False, True])
def test_shared_meta_segment_equals_reference(tiered):
    """The same allocator stream before and after ``share_meta``: the
    segments' 13n bytes are equal, each package's attach view reads the
    other's owner's later writes, and ``unshare_meta`` keeps the values."""
    if tiered:
        pool = TieredPool(LAYOUT, 64, 64, "meta", n_shards=8, cfg=TieringConfig(enabled=True))
        jpool = JTieredPool(JLAYOUT, 64, 64, n_shards=8, backing="meta",
                            cfg=JTieringConfig(enabled=True))
    else:
        pool = KVBlockPool(LAYOUT, 128, "meta", n_shards=8)
        jpool = BelugaPool(JLAYOUT, n_blocks=128, n_shards=8, backing="meta")
    n = pool.n_blocks
    _alloc_stream(pool, 0)
    _alloc_stream(jpool, 0)
    spec, jspec = pool.share_meta(), jpool.share_meta()
    assert pool.share_meta() is spec  # idempotent
    assert {k: v for k, v in spec.items() if k != "shm_name"} == \
        {k: v for k, v in jspec.items() if k != "shm_name"}
    try:
        _alloc_stream(pool, 1)
        _alloc_stream(jpool, 1)
        assert _segment_bytes(spec["shm_name"], n) == _segment_bytes(jspec["shm_name"], n)
        views = [SharedPoolMeta(spec["shm_name"], n, 16), PoolMetaView(jspec["shm_name"], n, 16)]
        try:
            for owner, view in ((pool, views[0]), (jpool, views[1])):
                got = owner.allocate(3)
                eps = owner.write_blocks(got)
                assert np.asarray(view.validate_epochs(got, eps)).all()
                assert view.refcounts[got].tolist() == [1, 1, 1]
                owner.release(got[:1])
                assert not np.asarray(view.validate_epochs(got[:1], eps[:1])).any()
                view.release(got)  # the owner releases, not the view
                assert owner.refcounts[got[1]] == 1
        finally:
            for v in views:
                v.close()
        every = np.arange(n)
        before = (pool.epochs[every].copy(), pool.refcounts[every].copy(),
                  pool.committed[every].copy())
    finally:
        pool.unshare_meta()
        jpool.unshare_meta()
    pool.unshare_meta()  # safe to repeat
    assert _gone(spec["shm_name"]) and _gone(jspec["shm_name"])
    for a, b in zip(before, (pool.epochs[every], pool.refcounts[every], pool.committed[every])):
        assert np.array_equal(a, b)
    _alloc_stream(pool, 2)  # private arrays again, still in use


def test_fifo_doorbell_wakes_and_unlinks():
    bell = FifoDoorbell.create()
    producer = FifoDoorbell.attach(bell.path)
    try:
        assert not producer.set()  # no reader yet: nothing to wake, no error
        bell.open_read()
        assert not bell.wait(0.0)
        assert producer.set() and producer.set()
        assert bell.wait(1.0)  # woken, every pending byte drained
        assert not bell.wait(0.0)
    finally:
        producer.close()
        bell.close()
        bell.close()
    assert not os.path.exists(bell.path)


def test_service_chain_imports_without_torch():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    code = "import repro_torch.core.procserver, sys; assert 'torch' not in sys.modules"
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
