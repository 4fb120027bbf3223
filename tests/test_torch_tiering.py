"""The port's tiered pool against the JAX package's, on the same inputs:

* ``core/fabric.py``: the spill media's prices and ``PoolDeviceQueues``
  against ``DeviceQueues`` on a seeded stream of submissions;
* ``core/pool.py``'s payload calls against ``BelugaPool(backing="numpy")``
  by bytes; ``core/index.py``'s eviction hook, ``evict_blocks``,
  ``owners_of`` and ``remap_many`` against ``GlobalIndex``, LRU order
  included;
* ``tiering/policy.py``: decay, ``coldest`` / ``hottest`` with ties, the
  ghost list's bound and one-shot admission;
* ``tiering/tiers.py``: the ids ``allocate`` gives under pressure, for
  ghost-hot keys and both overflow directions on chains of 2-4 tiers; the tier view against a concatenated array; a
  payload round trip across tiers against ``backing="numpy"``, by bytes;
* ``tiering/migrator.py``: the churn of ``tests/test_tiering.py:266-306``
  at seeds {0, 1, 2, 3, 17, 23}, with the same ``TierStats``, entries, LRU
  order and pending set after every operation; the manager's tiered fetch
  price behind the queues' backlog;
* ``Cluster`` with tiering for each transfer mode, with 8 shards, with
  ``remove_engine`` / ``add_engine`` mid-run, and the disabled
  config equal to the default: each request's timeline and ``run()``'s dict;
* the exp03 / exp04 / exp13 (``fast=True``) twins' rows string-equal to
  ``benchmarks/``'s, ``exp13_tiering.PINNED`` equal to the JAX run at full
  size, and ``tier_churn.PINS`` (``chip_smoke.py`` phase 19 (ii)) equal to
  the JAX package's payload-free churn.

Every number here is MODELED by the simulators; nothing runs on a device.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

import benchmarks.exp03_skew as jexp03
import benchmarks.exp04_background as jexp04
import benchmarks.exp13_tiering as jexp13
from repro.core import fabric as jfabric
from repro.core.index import _HEAD, _TAIL, GlobalIndex
from repro.core.pool import BelugaPool, OutOfPoolMemory, PoolLayout
from repro.core.transfer import TransferEngine
from repro.kvcache.hbm_cache import HbmPagedCache as JHbmPagedCache
from repro.kvcache.manager import KVCacheManager as JKVCacheManager
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import Cluster as JCluster
from repro.serving.scheduler import ClusterConfig as JClusterConfig
from repro.tiering import HotnessTracker as JHotnessTracker
from repro.tiering import MigrationEngine as JMigrationEngine
from repro.tiering import TieredPool as JTieredPool
from repro.tiering import TieringConfig as JTieringConfig
from repro_torch.core import fabric
from repro_torch.core.index import PrefixIndex
from repro_torch.core.pool import KVBlockLayout, KVBlockPool, PoolExhausted
from repro_torch.core.transfer import PoolTransfer
from repro_torch.experiments import exp03_skew, exp04_background, exp13_tiering
from repro_torch.experiments import tier_churn as tc
from repro_torch.experiments.cluster_common import qwen32b_layout
from repro_torch.kvcache.hbm_cache import HbmPagedCache
from repro_torch.kvcache.manager import KVCacheManager
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import Cluster, ClusterConfig, pending_live, refcounts_settled
from repro_torch.tiering import HotnessTracker, MigrationEngine, TieredPool, TieringConfig
from repro_torch.tiering.policy import GHOST_CAPACITY

torch.set_num_threads(1)

JLAYOUT = PoolLayout(block_tokens=16, n_layers_kv=4, n_kv_heads=2, head_dim=8)
LAYOUT = KVBlockLayout(block_tokens=16, n_layers_kv=4, n_kv_heads=2, head_dim=8)


def _chains(fast, spill, backing="meta", **kw):
    """The same chain on both sides: (JAX's, the port's)."""
    kw.setdefault("migrate_interval_s", 0.01)
    kw.setdefault("migrate_batch_blocks", 16)
    kw.setdefault("high_watermark", 0.9)
    kw.setdefault("demote_target", 0.5)
    jp = JTieredPool(JLAYOUT, fast, spill, n_shards=32, backing=backing,
                     cfg=JTieringConfig(enabled=True, **kw))
    device = "meta" if backing == "meta" else "cpu"
    pp = TieredPool(LAYOUT, fast, spill, device, n_shards=32, cfg=TieringConfig(enabled=True, **kw))
    return jp, pp


def _jax_lru(idx) -> list[bytes]:
    out, r = [], int(idx._lru_next[_HEAD])
    while r != _TAIL:
        out.append(idx._keys[r])
        r = int(idx._lru_next[r])
    return out


# ---------------------------------------------------------------------------
# fabric
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("media", ["rdma_dram", "ssd", "hdd"])
def test_spill_prices_equal_reference(media):
    for size in (0, 64, 16 * 1024, 2621440, 64 * 2621440):
        assert fabric.spill_transfer_latency(size, media) == \
            jfabric.spill_transfer_latency(size, media)
    assert list(fabric.SPILL_MEDIA) == list(jfabric.SPILL_MEDIA)


def test_unknown_medium_raises_as_reference():
    for fn in (fabric.spill_transfer_latency, jfabric.spill_transfer_latency):
        with pytest.raises(ValueError, match="tape"):
            fn(4096, "tape")


def test_fabric_constants_and_old_prices_unchanged():
    c = jfabric.DEFAULT
    assert (fabric.CXL_DEV_BW, fabric.CXL_ADAPTER_READ_BW, fabric.CXL_ADAPTER_WRITE_BW,
            fabric.N_DEVICES, fabric.INTERLEAVE_BYTES) == (
        c.cxl_dev_bw, c.cxl_adapter_read_bw, c.cxl_adapter_write_bw, c.n_devices,
        c.interleave_bytes)
    for size, nfrag in ((2621440, 128), (64 * 2621440, 64 * 128), (160, 1)):
        assert fabric.gpu_transfer_latency(size) == jfabric.gpu_transfer_latency(size, nfrag)
        assert fabric.rdma_transfer_latency(size, nfrag) == \
            jfabric.rdma_transfer_latency(size, nfrag)


@pytest.mark.parametrize("n_devices,total", [(32, 8 * 1024**4), (4, 64 * 2 * 1024**2), (1, 8 * 1024**4)])
def test_device_queues_equal_reference_on_a_seeded_stream(n_devices, total):
    rng = np.random.default_rng(n_devices)
    q = fabric.PoolDeviceQueues(n_devices=n_devices, total_bytes=total)
    jq = jfabric.DeviceQueues(n_devices=n_devices, total_bytes=total)
    now = 0.0
    for _ in range(500):
        now += float(rng.exponential(2e-6))
        addr = int(rng.integers(0, total))
        size = int(rng.choice([64, 16384, 2621440, 40 * 2621440]))
        il = bool(rng.integers(0, 2))
        assert q.submit(now, addr, size, il) == jq.submit(now, addr, size, il)
    assert q.busy_until == jq.busy_until


# ---------------------------------------------------------------------------
# pool (the payload calls) and index (the migrator's surface)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards,seed", [(32, 0), (8, 1), (4, 2)])
def test_pool_payload_calls_equal_numpy_backing(n_shards, seed):
    """Seeded allocate / write / read / release: ``write_blocks`` with and
    without payloads and ``read_blocks`` in a shuffled order give the
    reference's epochs and bytes."""
    rng = np.random.default_rng(seed)
    n_blocks = 8 * n_shards
    jp = BelugaPool(JLAYOUT, n_blocks, n_shards, backing="numpy")
    pp = KVBlockPool(LAYOUT, n_blocks, "cpu", n_shards=n_shards)
    held: list[int] = []
    for _ in range(30):
        if held and rng.random() < 0.4:
            k = int(rng.integers(1, len(held) + 1))
            rng.shuffle(held)
            jp.release(held[:k])
            pp.release(held[:k])
            del held[:k]
        n = int(rng.integers(1, 12))
        if n > jp.free_blocks():
            continue
        ids = jp.allocate(n)
        assert pp.allocate(n) == ids
        held += ids
        if rng.random() < 0.2:  # published in place, no payload
            assert pp.write_blocks(ids) == jp.write_blocks(ids)
            continue
        bits = rng.integers(-(2**15), 2**15, size=(n, *LAYOUT.block_shape), dtype=np.int16)
        assert pp.write_blocks(ids, torch.from_numpy(bits).view(torch.bfloat16)) == \
            jp.write_blocks(ids, bits)
        sel = rng.permutation(held).tolist()
        jraw, jeps = jp.read_blocks(sel)
        praw, peps = pp.read_blocks(sel)
        assert praw.shape == (len(sel), *LAYOUT.block_shape)
        assert praw.view(torch.uint8).flatten(1).numpy().tobytes() == jraw.tobytes()
        assert peps.tolist() == jeps.tolist()
    assert (pp.epochs == jp.epochs).all() and (pp.refcounts == jp.refcounts).all()


def test_index_eviction_hook_and_remaps_equal_reference():
    """A seeded stream of publishes, matches, LRU and targeted evictions,
    owner snapshots and remaps (some lost to a stale epoch or a vanished
    key): the same results, the same keys to ``on_evict`` in the same
    order, the same entries and LRU order after every step."""
    rng = np.random.default_rng(5)
    jp = BelugaPool(JLAYOUT, 128, 32, backing="meta")
    pp = KVBlockPool(LAYOUT, 128, "meta", n_shards=32)
    ji, pi = GlobalIndex(jp), PrefixIndex(pp)
    jev, pev = [], []
    ji.on_evict, pi.on_evict = jev.append, pev.append
    docs = [[d * 1000 + i for i in range(16 * 6)] for d in range(10)]
    for step in range(120):
        op = int(rng.integers(0, 7))
        d = docs[int(rng.integers(0, len(docs)))][: 16 * int(rng.integers(1, 7))]
        if op == 0:
            keys = ji.keys_for(d)
            miss = ji.filter_unpublished(keys)
            assert pi.filter_unpublished(pi.keys_for(d)) == miss
            if miss and len(miss) <= jp.free_blocks():
                ids = jp.allocate(len(miss))
                assert pp.allocate(len(miss)) == ids
                eps = jp.write_blocks(ids)
                assert pp.write_blocks(ids) == eps
                ji.publish_many([keys[i] for i in miss], ids, eps, 16)
                pi.publish_many([keys[i] for i in miss], ids, eps, 16)
        elif op == 1:
            assert pi.match_prefix(d) == ji.match_prefix(d)
        elif op == 2:
            n = int(rng.integers(1, 10))
            assert pi.evict_lru(n) == ji.evict_lru(n)
        elif op == 3:
            ids = rng.integers(0, 128, size=6).tolist()
            assert pi.evict_blocks(ids) == ji.evict_blocks(ids)
        elif op == 4:  # a stale entry: release a block under its entry
            live = np.flatnonzero(jp.refcounts == 1)
            if len(live):
                b = int(live[int(rng.integers(0, len(live)))])
                jp.release([b])
                pp.release([b])
        else:  # the migrator's snapshot, copy and remap (flat: new ids)
            ids = rng.integers(0, 128, size=5).tolist()
            assert pi.owners_of(ids) == ji.owners_of(ids)
            ids = [b for b in ids if jp.refcounts[b] == 1 and jp.committed[b]]
            jk, jids, jeps = ji.owners_of(ids)
            assert pi.owners_of(ids) == (jk, jids, jeps)
            if jk and len(jk) <= jp.free_blocks():
                if op == 6 and len(jeps) > 1:
                    jeps = [jeps[0] + 1] + jeps[1:]  # one lost remap
                new = jp.allocate(len(jk))
                assert pp.allocate(len(jk)) == new
                neps = jp.write_blocks(new)
                assert pp.write_blocks(new) == neps
                ok = ji.remap_many(jk, jids, jeps, new, neps)
                assert pi.remap_many(jk, jids, jeps, new, neps) == ok
                lost = [n for n, o in zip(new, ok) if not o]
                moved = [s for s, o in zip(jids, ok) if o]
                for p in (jp, pp):
                    p.release(lost)
                    p.release(moved)
        assert pev == jev, step
        assert [k for k, _ in pi.items()] == _jax_lru(ji), step
        ents = [(e.block_id, e.epoch) for _, e in pi.items()]
        assert ents == [(e.block_id, e.epoch) for e in ji.lookup_many(_jax_lru(ji))], step
        assert pi.stats() == ji.stats()
    assert jev, "the stream evicted nothing"


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------


def test_hotness_decay_and_ties_equal_reference():
    rng = np.random.default_rng(3)
    jt, pt = JHotnessTracker(64), HotnessTracker(64)
    now = 0.0
    for _ in range(200):
        now += float(rng.uniform(0.0, 8.0))  # a fair share of the 30 s half-life
        ids = rng.integers(0, 64, size=int(rng.integers(1, 8)))
        ids = np.unique(ids)
        jt.touch(ids, now)
        pt.touch(ids, now)
        if rng.random() < 0.2:
            src, dst = ids[:2], rng.integers(0, 64, size=min(2, len(ids)))
            jt.move(src, dst)
            pt.move(src, dst)
        if rng.random() < 0.1:
            jt.reset(ids)
            pt.reset(ids)
        cand = rng.permutation(64)[: int(rng.integers(1, 64))]
        k = int(rng.integers(1, 70))
        at = now + float(rng.uniform(0.0, 40.0))
        np.testing.assert_array_equal(pt.coldest(cand, k, at), jt.coldest(cand, k, at))
        np.testing.assert_array_equal(pt.hottest(cand, k, at), jt.hottest(cand, k, at))
        assert pt.heat_at(cand, at).tolist() == jt.heat_at(cand, at).tolist()
    assert pt.heat.tolist() == jt.heat.tolist()
    # ties: never-touched candidates all have heat 0
    cold = np.arange(40, 64)
    jt2, pt2 = JHotnessTracker(64), HotnessTracker(64)
    np.testing.assert_array_equal(pt2.coldest(cold[::-1], 5, 1.0), jt2.coldest(cold[::-1], 5, 1.0))
    np.testing.assert_array_equal(pt2.hottest(cold, 7, 1.0), jt2.hottest(cold, 7, 1.0))


def test_ghost_list_bound_and_one_shot_admission_equal_reference():
    jt, pt = JHotnessTracker(8), HotnessTracker(8)
    assert GHOST_CAPACITY == jt.ghost_capacity
    fill = [b"x%d" % i for i in range(GHOST_CAPACITY - 5)]
    script = [("add", [b"a", b"b", b"c"]), ("admit", b"b"), ("admit", b"b"),
              ("add", fill), ("add", [b"d", b"e", b"f", b"a"]), ("contains", b"c"),
              ("contains", b"a"), ("add", [b"g"]), ("contains", b"c"), ("admit", b"d"),
              ("admit", None), ("contains", None), ("admit", b"a"),
              ("add", [b"h", b"i", b"j", b"k", b"l", b"m"]), ("contains", b"x0"),
              ("contains", b"x5"), ("admit", b"h")]
    for op, arg in script:
        if op == "add":
            jt.ghost_add(arg)
            pt.ghost_add(arg)
        elif op == "admit":
            assert pt.admit_hot(arg) == jt.admit_hot(arg)
        else:
            assert pt.ghost_contains(arg) == jt.ghost_contains(arg)
        assert list(pt._ghost) == list(jt._ghost)
        assert (pt.ghost_len(), pt.ghost_hits) == (jt.ghost_len(), jt.ghost_hits)
    # full at the bound (its oldest keys gone), then h admitted out of it
    assert pt.ghost_len() == GHOST_CAPACITY - 1 and not pt.ghost_contains(b"x0")


# ---------------------------------------------------------------------------
# TieredPool
# ---------------------------------------------------------------------------

CHAINS = {
    "2 tiers": (32, 32, ()),
    "3 tiers": (32, 32, ((32, "ssd"),)),
    "4 tiers, deep sizes rounded": (32, 64, ((40, "ssd"), (20, "hdd"))),
}


@pytest.mark.parametrize("chain", list(CHAINS))
@pytest.mark.parametrize("watermark", [0.5, 0.8])
@pytest.mark.parametrize("seed", [0, 11])
def test_allocate_under_pressure_equals_reference(chain, watermark, seed):
    """Seeded allocate / release churn with keys and ghost-hot keys: the
    same ids or the same exhaustion, the same ``TierStats``, tier writes
    and ghost list after every call."""
    fast, spill, extra = CHAINS[chain]
    jp, pp = _chains(fast, spill, extra_tiers=extra, high_watermark=watermark)
    assert pp.n_blocks == jp.n_blocks and pp.tier_media == jp.tier_media
    rng = np.random.default_rng(seed)
    held: list[int] = []
    for step in range(80):
        if held and rng.random() < 0.35:
            k = int(rng.integers(1, len(held) + 1))
            rng.shuffle(held)
            jp.release(held[:k])
            pp.release(held[:k])
            del held[:k]
        n = int(rng.integers(1, 24))
        keys = None
        if rng.random() < 0.7:
            keys = [f"{seed}/{step}/{i}".encode() for i in range(n)]
            ghosted = [k for k in keys if rng.random() < 0.3]
            jp.policy.ghost_add(ghosted)
            pp.policy.ghost_add(ghosted)
        try:
            want = jp.allocate(n, keys=keys)
        except OutOfPoolMemory:
            with pytest.raises(PoolExhausted):
                pp.allocate(n, keys=keys)
            continue
        assert pp.allocate(n, keys=keys) == want, step
        held += want
        assert pp.tier_stats == dataclasses.replace(pp.tier_stats, **jp.tier_stats.as_dict())
        assert pp.tier_writes == jp.tier_writes
        assert list(pp.policy._ghost) == list(jp.policy._ghost)
        assert pp.shard_occupancy() == jp.shard_occupancy()
    assert pp.stats_dict() == jp.stats_dict()
    for p in (jp, pp):
        p.release(held)
    assert pp.free_blocks() == pp.n_blocks


def test_both_overflow_directions_equal_reference():
    """Pressured writes clamp down-chain (tail first, ghost-hot last), and
    overflow back into fast head first when down-chain is short."""
    for seq in ([20, 30, 10], [31, 2]):
        jp, pp = _chains(32, 32, high_watermark=0.5)
        for p in (jp, pp):
            p.policy.ghost_add([b"k1", b"k2"])
        for n in seq:
            keys = [b"k1", b"k2"] + [bytes([i]) for i in range(n - 2)] if n >= 2 else None
            assert pp.allocate(n, keys=keys) == jp.allocate(n, keys=keys)
        assert pp.stats_dict() == jp.stats_dict()


@pytest.mark.parametrize("seed", range(3))
def test_tier_view_equals_concatenated_array(seed):
    rng = np.random.default_rng(seed)
    jp, pp = _chains(32, 32, extra_tiers=((40, "ssd"),))
    for p in (jp, pp):
        held = p.allocate(80)
        p.retain(held[::3])
        p.write_blocks(held[::2])
    n = pp.n_blocks
    for name in ("refcounts", "epochs", "committed"):
        view = getattr(pp, name)
        ref = np.concatenate([np.asarray(getattr(t, name)) for t in jp.tiers])
        assert len(view) == n == len(ref)
        for i in (0, 31, 32, 63, 64, n - 1, int(rng.integers(0, n))):
            assert view[i] == ref[i] and view[np.intp(i)] == ref[i] and view[np.array(i)] == ref[i]
        for ids in (np.array([], np.intp), rng.integers(0, n, size=int(rng.integers(1, 3 * n))),
                    np.array([31, 32, 63, 64, 64, 31]), np.flip(rng.permutation(n))):
            np.testing.assert_array_equal(view[ids], ref[ids])
        mask = rng.random(n) < rng.random()
        np.testing.assert_array_equal(view[mask], ref[mask])


def test_payload_round_trip_across_tiers_equals_numpy_backing():
    """Writes through ``PoolTransfer`` / ``TransferEngine`` land on three
    tiers; reads in a mixed order give the reference's bytes."""
    jp, pp = _chains(32, 32, backing="numpy", extra_tiers=((32, "ssd"),), high_watermark=0.5)
    rng = np.random.default_rng(7)
    ids = jp.allocate(70)
    assert pp.allocate(70) == ids
    assert {jp.tier_of(b) for b in ids} == {0, 1, 2}
    bits = rng.integers(-(2**15), 2**15, size=(70, *LAYOUT.block_shape), dtype=np.int16)
    jeps = TransferEngine(jp).gather_write(ids, bits.view(np.float16))
    peps = PoolTransfer(pp).gather_write(ids, torch.from_numpy(bits).view(torch.bfloat16))
    assert peps == jeps
    order = rng.permutation(70)
    sel = [ids[i] for i in order]
    jout = TransferEngine(jp).scatter_read(sel, [jeps[i] for i in order])
    pout = PoolTransfer(pp).scatter_read(sel, [peps[i] for i in order])
    assert pout.view(torch.int16).numpy().tobytes() == jout.view(np.int16).tobytes()
    jraw, jeps2 = jp.read_blocks(sel[:5])
    praw, peps2 = pp.read_blocks(sel[:5])
    assert praw.view(torch.uint8).flatten(1).numpy().tobytes() == jraw.tobytes()
    assert peps2.tolist() == jeps2.tolist()


# ---------------------------------------------------------------------------
# the migrator
# ---------------------------------------------------------------------------


def _stack(side, pool):
    if side == "jax":
        idx = GlobalIndex(pool)
        idx.on_evict = pool.policy.ghost_add
        mgr = JKVCacheManager(pool, idx, JHbmPagedCache(512, 16), TransferEngine(pool))
        return mgr, idx, JMigrationEngine(pool, idx, pool.cfg)
    idx = PrefixIndex(pool)
    idx.on_evict = pool.policy.ghost_add
    mgr = KVCacheManager(pool, idx, HbmPagedCache(512, 16), PoolTransfer(pool))
    return mgr, idx, MigrationEngine(pool, idx, pool.cfg)


def _churn_states(side, pool, seed):
    mgr, idx, mig = _stack(side, pool)
    keys = tc.all_keys(idx, n_docs=8, max_chain=6)
    states = []

    def snap(step):
        lru = _jax_lru(idx) if side == "jax" else [k for k, _ in idx.items()]
        states.append((step, pool.tier_stats.as_dict(), tc.final_entries(idx, keys), lru,
                       sorted(pool.promote_pending), pool.free_blocks(), mig.steps))

    record = tc.churn(mgr, idx, mig, pool, seed=seed, n_ops=80, n_docs=8, max_chain=6,
                      evict_max=8, after_op=snap)
    return record, states, idx, mig


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 17, 23])
def test_migrator_churn_equals_reference(seed):
    """``tests/test_tiering.py``'s churn: demotions, promotions, bottom-tier
    evictions, LRU and targeted evictions, with the same stats, entries,
    LRU order and pending set after every operation, and the books
    balanced."""
    jp, pp = _chains(32, 64, migrate_batch_blocks=8, high_watermark=0.8, demote_target=0.5,
                     promote_min_heat=2.0)
    jrec, jstates, _, _ = _churn_states("jax", jp, seed)
    prec, pstates, pidx, pmig = _churn_states("port", pp, seed)
    assert prec == jrec
    for j, p in zip(jstates, pstates):
        assert p == j, j[0]
    assert tc.books_balance(pp, pidx) == []
    assert pending_live(pp) and refcounts_settled(pp, pidx) and pmig.steps > 0
    pidx.evict_lru(pp.n_blocks)
    assert pp.free_blocks() == pp.n_blocks and tc.books_balance(pp, pidx) == []


@pytest.mark.parametrize("mode,sbt", [("beluga", 0), ("rdma", 256)])
def test_tiered_fetch_price_behind_the_queue_backlog_equals_reference(mode, sbt):
    """Demote a document into spill and SSD, load the queues, then plan its
    fetch at several times: the same price per tier and backlog."""
    prices = {}
    for side in ("jax", "port"):
        jp, pp = _chains(32, 32, extra_tiers=((64, "ssd"),), high_watermark=0.5,
                         demote_target=0.25, migrate_batch_blocks=12)
        pool = jp if side == "jax" else pp
        queues = (jfabric.DeviceQueues(n_devices=32) if side == "jax"
                  else fabric.PoolDeviceQueues(n_devices=32))
        if side == "jax":
            idx = GlobalIndex(pool)
            mgr = JKVCacheManager(pool, idx, JHbmPagedCache(512, 16),
                                  TransferEngine(pool, mode=mode, super_block_tokens=sbt),
                                  queues=queues)
            mig = JMigrationEngine(pool, idx, pool.cfg, queues=queues)
        else:
            idx = PrefixIndex(pool)
            mgr = KVCacheManager(pool, idx, HbmPagedCache(512, 16),
                                 PoolTransfer(pool, mode=mode, super_block_tokens=sbt),
                                 queues=queues)
            mig = MigrationEngine(pool, idx, pool.cfg, queues=queues)
        got = []
        for d in range(6):
            mgr.writeback(f"w{d}", tc.doc_tokens(d, 9), now=0.01 * d)
            mig.run_until(0.01 * d)
        for t in (0.06, 0.0605, 0.2, 1.0):
            for d in (0, 3, 5):
                plan = mgr.plan_fetch(tc.doc_tokens(d, 9), now=t)
                got.append((plan.fetch_latency, len(plan.hit_blocks)))
            mig.run_until(t)
        prices[side] = (got, pool.tier_stats.as_dict(), queues.busy_until)
    assert prices["port"] == prices["jax"]
    assert {len(g) for g in prices["jax"][0]} and prices["jax"][1]["demotions"] > 0


# ---------------------------------------------------------------------------
# Cluster
# ---------------------------------------------------------------------------

TIMELINE = ("req_id", "engine_id", "t_admitted", "t_first_token", "t_done", "hit_tokens",
            "tokens_out", "state")


def _cluster_run(side, kw, tiering, n=48, n_docs=12, elastic=False):
    if side == "jax":
        C, CC, TC, R, lay = JCluster, JClusterConfig, JTieringConfig, JRequest, JLAYOUT
    else:
        C, CC, TC, R, lay = Cluster, ClusterConfig, TieringConfig, Request, LAYOUT
    cfg = CC(**{"n_engines": 2, "pool_blocks": 64, "pool_shards": 32,
                "hbm_slots_per_engine": 256, **kw}, tiering=TC(**tiering))
    c = C(cfg, lay)
    for i in range(n):
        c.dispatch(R(f"r{i}", tc.doc_tokens(i % n_docs, 16), 8, arrival=0.05 * i))
    orphans = []
    if elastic:
        for e in c.engines:
            e.advance(0.6)
        orphans = [r.req_id for r in c.remove_engine(0)]
        c.add_engine()
    stats = c.run()
    pool = c.pool
    return {
        "timeline": [tuple(getattr(r, f) for f in TIMELINE) for r in c.requests],
        "stats": stats, "orphans": orphans,
        "engines": [(e.engine_id, e.clock, dataclasses.asdict(e.stats),
                     {k: v for k, v in dataclasses.asdict(e.manager.stats).items()
                      if k != "degraded_ops"}) for e in c.engines],
        "pool": (pool.free_blocks(), pool.shard_occupancy(),
                 pool.refcounts[np.arange(pool.n_blocks)].tolist(),
                 pool.epochs[np.arange(pool.n_blocks)].tolist(),
                 sorted(getattr(pool, "promote_pending", ()))),
    }, c


TIERED = dict(enabled=True, spill_blocks=512, migrate_interval_s=0.01, migrate_batch_blocks=16)


@pytest.mark.parametrize("kw,tiering", [
    ({}, TIERED),
    ({"transfer_mode": "rdma", "super_block_tokens": 256}, TIERED),
    ({"transfer_mode": "none"}, TIERED),
    ({"pool_shards": 8}, TIERED),
    ({"policy": "cache_aware"}, dict(enabled=False)),
    ({"policy": "cache_aware"}, {**TIERED, "spill_blocks": 64}),  # bottom-tier evictions
    ({"straggler_cutover": 1.0}, {**TIERED, "spill_blocks": 64, "extra_tiers": ((128, "ssd"),)}),
    ({"policy": "round_robin"}, {**TIERED, "spill_media": "ssd"}),
])
def test_tiered_cluster_equals_reference(kw, tiering):
    want, _ = _cluster_run("jax", kw, tiering)
    got, c = _cluster_run("port", kw, tiering)
    for key in want:
        assert got[key] == want[key], key
    assert got["stats"]["n_done"] == 48
    assert refcounts_settled(c.pool, c.index)
    if tiering["enabled"]:
        t = got["stats"]["tiering"]
        assert t["migrator_steps"] > 0 and pending_live(c.pool)
        assert (t["demotions"] > 0) == (kw.get("transfer_mode") != "none")


@pytest.mark.parametrize("policy", ["cache_oblivious", "round_robin"])
def test_tiered_cluster_elastic_equals_reference(policy):
    want, _ = _cluster_run("jax", {"policy": policy}, TIERED, elastic=True)
    got, c = _cluster_run("port", {"policy": policy}, TIERED, elastic=True)
    assert got == want
    assert got["orphans"] and len(c.engines) == 2
    assert all(e.migrator is c.migrator for e in c.engines)


def test_disabled_tiering_equals_the_default_config():
    runs = [_cluster_run("port", {"pool_blocks": 256}, t, n=16)[0]
            for t in ({}, dict(enabled=False))]
    assert runs[0] == runs[1] and "tiering" not in runs[0]["stats"]
    assert runs[0] == _cluster_run("jax", {"pool_blocks": 256}, {}, n=16)[0]


# ---------------------------------------------------------------------------
# the experiment twins
# ---------------------------------------------------------------------------


def test_exp03_exp04_rows_equal_reference():
    assert exp03_skew.run() == jexp03.run()
    assert exp04_background.run() == jexp04.run()


def test_exp13_fast_rows_equal_reference_and_write_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rows = exp13_tiering.run(fast=True)
    assert os.listdir(tmp_path) == []  # the port's run writes no file unless asked
    assert rows == jexp13.run(fast=True)  # the reference writes its BENCH file here
    exp13_tiering.run(fast=True, out_path=str(tmp_path / "out.json"))
    assert (tmp_path / "out.json").exists()


def test_exp13_pinned_values_are_the_reference_run(tmp_path, monkeypatch):
    """``benchmarks/exp13_tiering.run()`` at full size (its results read from
    the file it writes in the working directory): equal to ``PINNED``, its
    rows equal to the rows the port makes from the pins, and the port's
    own run equal to them."""
    import json

    monkeypatch.chdir(tmp_path)
    rows = jexp13.run(fast=False)
    ref = json.loads((tmp_path / jexp13.OUT_PATH).read_text())
    assert exp13_tiering.pinned_mismatches(ref, rel=0.0) == []
    pin = exp13_tiering.PINNED
    assert exp13_tiering.rows_of({**pin, "zero_cost": {
        "identical": pin["zero_cost"] == exp13_tiering.REFERENCE_PR1}}) == rows
    assert exp13_tiering.REFERENCE_PR1 == jexp13.REFERENCE_PR1
    mine = exp13_tiering.results_of(False)
    assert exp13_tiering.pinned_mismatches(mine) == [] and exp13_tiering.chain_gate(mine) == []


def test_pinned_mismatches_report_each_number():
    pin = exp13_tiering.PINNED
    res = {"cells": [dict(c) for c in pin["cells"]], "tier_chain": pin["tier_chain"],
           "zero_cost": {"got": pin["zero_cost"]}}
    assert exp13_tiering.pinned_mismatches(res) == []
    res["cells"][1] = {**res["cells"][1], "ttft_ratio": res["cells"][1]["ttft_ratio"] * (1 + 1e-9),
                       "tiered": {**res["cells"][1]["tiered"], "hit_tokens": 1}}
    bad = exp13_tiering.pinned_mismatches(res)
    assert [b.split(":")[0] for b in bad] == ["cells[1].tiered.hit_tokens", "cells[1].ttft_ratio"]


# ---------------------------------------------------------------------------
# chip_smoke.py phase 19 (ii): the churn's pins
# ---------------------------------------------------------------------------


def _full_size_chain(side, device="meta", layout=None):
    if side == "jax":
        cfg = JTieringConfig(**tc.TIERING)
        from benchmarks.common import qwen32b_layout as jlayout

        pool = JTieredPool(jlayout(), tc.FAST_BLOCKS, tc.SPILL_BLOCKS, n_shards=tc.N_SHARDS,
                           backing="meta", cfg=cfg)
    else:
        pool = TieredPool(layout or qwen32b_layout(), tc.FAST_BLOCKS, tc.SPILL_BLOCKS, device,
                          n_shards=tc.N_SHARDS, cfg=TieringConfig(**tc.TIERING))
    return pool


def test_churn_pins_are_the_reference_run():
    pool = _full_size_chain("jax")
    mgr, idx, mig = _stack("jax", pool)
    assert tc.summary(tc.churn(mgr, idx, mig, pool), pool, mig, idx) == tc.PINS
    assert pool.tiers[2].n_blocks == 2048 and pool.n_blocks == 3072


def test_port_churn_equals_pins_with_books_balanced():
    pool = _full_size_chain("port")
    mgr, idx, mig = _stack("port", pool)
    unbalanced = []
    rec = tc.churn(mgr, idx, mig, pool,
                   after_op=lambda i: unbalanced.extend(tc.books_balance(pool, idx)))
    assert unbalanced == []
    assert tc.summary(rec, pool, mig, idx) == tc.PINS
    st = pool.tier_stats
    assert st.demotions > 0 and st.promotions > 0 and pool.tier_occupancy(2) > 0


def test_port_churn_with_payloads_reads_every_key_back():
    """The same churn on the CPU at a narrow layout, each key's block its
    own seeded bytes: the same placement, every indexed block read back
    through ``scatter_read`` equal to its key's bytes; a corrupted block
    is seen."""
    lay = KVBlockLayout(block_tokens=16, n_layers_kv=2, n_kv_heads=2, head_dim=8)
    pool = _full_size_chain("port", "cpu", lay)
    mgr, idx, mig = _stack("port", pool)
    rec = tc.churn(mgr, idx, mig, pool, payload=lambda keys: tc.key_payload(keys, lay, "cpu"))
    got = tc.summary(rec, pool, mig, idx)
    assert (got["digest"], got["tier_writes"], got["migrator_steps"]) == (
        tc.PINS["digest"], tc.PINS["tier_writes"], tc.PINS["migrator_steps"])
    transfer = PoolTransfer(pool)
    assert tc.verify_payloads(idx, transfer) == (tc.PINS["entries"], 0)
    _, e = idx.items()[5]
    t = int(pool._split_tiers([e.block_id])[1][0])
    pool.tiers[t].data[e.block_id - int(pool._starts[t]), 0, 0, 0, 0] += 1
    assert tc.verify_payloads(idx, transfer) == (tc.PINS["entries"], 1)
    idx.evict_lru(pool.n_blocks)
    assert pool.free_blocks() == pool.n_blocks
