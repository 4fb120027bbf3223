"""The port's control plane under the cluster simulator, against the JAX
package's, module by module on the same inputs:

* ``core/fabric.py``: the staging cost the manager adds, against
  ``FabricConstants`` (``tests/test_torch_experiments.py`` holds the rest);
* ``core/pool.py``: the layout's bytes for all 12 registry configs, and
  the allocation order of ``KVBlockPool`` against ``BelugaPool`` over
  seeded churns of allocations and releases, 8 and 32 shards (the
  degenerate sweep included), plus ``retain``;
* ``core/index.py``: stats, matches, writeback filtering and LRU eviction
  under pool pressure, with stale entries;
* ``core/transfer.py``: ``PoolTransfer``'s modeled seconds and requests for
  beluga, rdma and rdma with super-blocks, its fetch and write-back prices
  against the reference manager's and engine's, and the stale read refused
  where the reference raises its coherence error;
* ``kvcache/hbm_cache.py`` on a seeded op sequence: the same slots,
  refcounts and free order;
* ``kvcache/manager.py``: the counterparts of ``tests/test_capacity.py``'s
  pool-pressure and cutover cases and ``tests/test_serving.py``'s fetch
  failures, and one seeded stream of plans, fetches and writebacks against
  the reference's manager.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core import fabric as jfabric
from repro.core.coherence import CoherenceError
from repro.core.index import GlobalIndex
from repro.core.pool import BelugaPool, PoolLayout
from repro.core.transfer import TransferEngine
from repro.kvcache.hbm_cache import HbmPagedCache as JHbmPagedCache
from repro.kvcache.hbm_cache import OutOfHbmBlocks as JOutOfHbmBlocks
from repro.kvcache.manager import KVCacheManager as JKVCacheManager
from repro_torch.configs.registry import REGISTRY, get_config
from repro_torch.core import diag, fabric
from repro_torch.core.index import PrefixIndex
from repro_torch.core.pool import KVBlockLayout, KVBlockPool
from repro_torch.core.transfer import PoolTransfer, StaleBlockError
from repro_torch.kvcache.hbm_cache import HbmPagedCache, OutOfHbmBlocks
from repro_torch.kvcache.manager import KVCacheManager

torch.set_num_threads(1)

JLAYOUT = PoolLayout(block_tokens=16, n_layers_kv=4, n_kv_heads=2, head_dim=8)
LAYOUT = KVBlockLayout(block_tokens=16, n_layers_kv=4, n_kv_heads=2, head_dim=8)


# ---------------------------------------------------------------------------
# fabric
# ---------------------------------------------------------------------------


def test_superblock_staging_cost_is_the_reference_value():
    assert fabric.RDMA_SW_PER_SUPERBLOCK == jfabric.DEFAULT.rdma_sw_per_superblock


def test_diag_counts_tolerated_events():
    diag.reset()
    diag.note("x")
    diag.note("x")
    assert diag.count("x") == 2 and diag.counters() == {"x": 2} and diag.count("y") == 0
    diag.reset()
    assert diag.counters() == {}


# ---------------------------------------------------------------------------
# pool
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_layout_bytes_equal_reference_for_every_config(arch):
    for dtype_bytes in (1, 2):
        lay = dataclasses.replace(KVBlockLayout.for_model(get_config(arch)),
                                  dtype_bytes=dtype_bytes)
        jlay = dataclasses.replace(PoolLayout.for_model(jax_get_config(arch)),
                                   dtype_bytes=dtype_bytes)
        for f in ("block_tokens", "n_layers_kv", "n_kv_heads", "head_dim", "fragment_bytes",
                  "n_fragments", "block_bytes", "token_bytes"):
            assert getattr(lay, f) == getattr(jlay, f), (arch, f)


@pytest.mark.parametrize("n_shards", [8, 32])
@pytest.mark.parametrize("seed", [0, 1])
def test_pool_allocation_order_equals_reference(n_shards, seed):
    n_blocks = 8 * n_shards
    jpool = BelugaPool(JLAYOUT, n_blocks, n_shards, backing="meta")
    pool = KVBlockPool(LAYOUT, n_blocks, "meta", n_shards=n_shards)
    rng = np.random.default_rng(n_shards + 100 * seed)
    for step in range(400):
        op = rng.choice(["alloc", "alloc", "release", "retain", "all"])
        if op in ("alloc", "all"):
            n = jpool.free_blocks() if op == "all" else int(rng.integers(1, 3 * n_shards))
            if n > jpool.free_blocks():
                with pytest.raises(RuntimeError):
                    pool.allocate(n)
                continue
            assert pool.allocate(n) == jpool.allocate(n), step
        else:
            live = np.flatnonzero(jpool.refcounts > 0)
            if not len(live):
                continue
            pick = rng.choice(live, size=int(rng.integers(1, len(live) + 1)),
                              replace=False).tolist()
            if op == "retain":
                jpool.retain(pick)
                pool.retain(pick)
            else:  # uneven releases leave the shards unbalanced
                jpool.release(pick)
                pool.release(pick)
        assert pool.free_blocks() == jpool.free_blocks()
        assert pool.shard_occupancy() == jpool.shard_occupancy()
        assert np.array_equal(pool.refcounts, jpool.refcounts)
        assert np.array_equal(pool.epochs, jpool.epochs)
    with pytest.raises(ValueError, match="retain of a free block"):
        KVBlockPool(LAYOUT, 8, "meta").retain([3])


def test_meta_pool_holds_no_bytes_at_paper_size():
    lay = KVBlockLayout.for_model(get_config("qwen3-32b"))
    pool = KVBlockPool(lay, 262144, "meta", n_shards=32)
    assert pool.payload_free and pool.data.device.type == "meta"
    assert lay.block_bytes == 128 * 20 * 1024 == PoolLayout.for_model(
        jax_get_config("qwen3-32b")).block_bytes
    assert pool.n_blocks * lay.block_bytes == 640 * 2**30
    assert not KVBlockPool(LAYOUT, 8, "cpu").payload_free


# ---------------------------------------------------------------------------
# index
# ---------------------------------------------------------------------------


def test_index_stats_and_lru_eviction_under_pool_pressure():
    bt, n_blocks = 4, 48
    jlay, lay = PoolLayout(bt, 1, 1, 8), KVBlockLayout(bt, 1, 1, 8)
    jpool = BelugaPool(jlay, n_blocks, 8, backing="meta")
    pool = KVBlockPool(lay, n_blocks, "meta")
    jidx, idx = GlobalIndex(jpool), PrefixIndex(pool)
    rng = np.random.default_rng(11)
    stems = [rng.integers(0, 40, size=12).tolist() for _ in range(4)]
    prompts = [stems[i % 4] + rng.integers(0, 40, size=int(rng.integers(0, 25))).tolist()
               for i in range(16)]
    evicted = 0
    for step in range(500):
        p = prompts[int(rng.integers(len(prompts)))]
        keys = jidx.keys_for(p)
        assert idx.keys_for(p) == keys
        op = rng.choice(["write", "write", "match", "release"])
        if op == "write":  # the manager's writeback: filter, allocate or evict, publish
            missing = jidx.filter_unpublished(keys)
            assert idx.filter_unpublished(keys) == missing
            if not missing:
                continue
            if jpool.free_blocks() < len(missing):
                freed = jidx.evict_lru(2 * len(missing))
                assert idx.evict_lru(2 * len(missing)) == freed, step
                evicted += len(freed)
                if jpool.free_blocks() < len(missing):
                    continue
            ids = jpool.allocate(len(missing))
            assert pool.allocate(len(missing)) == ids
            eps = jpool.write_blocks(ids)
            assert pool.write_blocks(ids) == eps
            new = [keys[i] for i in missing]
            jidx.publish_many(new, ids, eps, bt)
            idx.publish_many(new, ids, eps, bt)
        elif op == "match":
            assert idx.match_prefix_keys(keys) == jidx.match_prefix_keys(keys)
        else:  # a block released behind the index's back: its entry goes stale
            live = np.flatnonzero(jpool.refcounts > 0)
            if len(live):
                b = [int(live[rng.integers(len(live))])]
                jpool.release(b)
                pool.release(b)
        assert idx.stats() == jidx.stats(), step
        assert np.array_equal(pool.refcounts, jpool.refcounts)
    assert evicted > 50 and idx.stats()["hits"] > 0  # the pressure was real


# ---------------------------------------------------------------------------
# transfer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,sbt", [("beluga", 0), ("rdma", 0), ("rdma", 64), ("rdma", 256)])
def test_pool_transfer_prices_as_transfer_engine(mode, sbt):
    jeng = TransferEngine(BelugaPool(JLAYOUT, 64, 8, backing="meta"), mode=mode,
                          super_block_tokens=sbt)
    eng = PoolTransfer(KVBlockPool(LAYOUT, 64, "meta"), mode=mode, super_block_tokens=sbt)
    for n in (1, 3, 17, 40):
        ids = jeng.pool.allocate(n)
        assert eng.pool.allocate(n) == ids
        assert eng.gather_write(ids, None) == jeng.gather_write(ids, None)
        eng.scatter_read(ids, eng.pool.epochs[ids].tolist())
        jeng.scatter_read(ids, jeng.pool.epochs[ids].tolist())
        assert dataclasses.asdict(eng.stats) == dataclasses.asdict(jeng.stats)
        jeng.pool.release(ids)
        eng.pool.release(ids)


@pytest.mark.parametrize("mode,sbt", [("beluga", 0), ("rdma", 0), ("rdma", 16), ("rdma", 256)])
def test_fetch_and_writeback_prices_equal_manager_and_engine(mode, sbt):
    """The reference prices these in ``KVCacheManager._fetch_latency`` and
    ``EngineInstance._writeback_latency``; the port in ``PoolTransfer``."""
    from repro.serving.engine import EngineInstance as JEngineInstance
    from repro.serving.engine import SimRunner as JSimRunner
    from repro.serving.engine import SimRunnerConfig as JSimRunnerConfig

    jpool = BelugaPool(JLAYOUT, 64, 8, backing="meta")
    jm = JKVCacheManager(jpool, GlobalIndex(jpool), JHbmPagedCache(64, 16),
                         TransferEngine(jpool, mode=mode, super_block_tokens=sbt))
    jeng = JEngineInstance(0, jm, JSimRunner(JSimRunnerConfig()))
    eng = PoolTransfer(KVBlockPool(LAYOUT, 64, "meta"), mode=mode, super_block_tokens=sbt)
    for n in (1, 3, 16, 17, 40, 937):
        assert eng.fetch_latency(n) == jm._fetch_latency(n), n
        assert eng.writeback_latency(n) == jeng._writeback_latency(n), n
    assert dataclasses.asdict(eng.stats) == dataclasses.asdict(PoolTransfer(eng.pool).stats)


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_stale_read_is_refused_where_the_reference_raises(device):
    backing = "meta" if device == "meta" else "numpy"
    jpool = BelugaPool(JLAYOUT, 16, 8, backing=backing)
    pool = KVBlockPool(LAYOUT, 16, device)
    jeng, eng = TransferEngine(jpool), PoolTransfer(pool)
    ids = jpool.allocate(3)
    assert pool.allocate(3) == ids
    kv = torch.randn((3, *LAYOUT.block_shape)).to(torch.bfloat16)
    eps = eng.gather_write(ids, None if device == "meta" else kv)
    assert jeng.gather_write(ids, None if device == "meta" else kv.float().numpy().astype(
        np.float16)) == eps
    out = eng.scatter_read(ids, eps)
    jeng.scatter_read(ids, eps)
    assert out.shape == (3, *LAYOUT.block_shape)
    if device == "cpu":
        assert torch.equal(out, kv)
    jpool.write_blocks([ids[1]])  # a rewrite moves block 1's epoch on
    pool.write_blocks([ids[1]])
    with pytest.raises(CoherenceError, match=f"block {ids[1]} "):
        jeng.scatter_read(ids, eps)
    with pytest.raises(StaleBlockError, match=f"block {ids[1]} "):
        eng.scatter_read(ids, eps)
    assert dataclasses.asdict(eng.stats) == dataclasses.asdict(jeng.stats)


# ---------------------------------------------------------------------------
# hbm cache
# ---------------------------------------------------------------------------


def test_hbm_cache_equals_reference_on_a_seeded_op_sequence():
    j, h = JHbmPagedCache(64, 16), HbmPagedCache(64, 16)
    rng = np.random.default_rng(5)
    keys = [bytes([i]) * 4 for i in range(24)]
    held: list[int] = []
    seqs = 0
    for step in range(600):
        op = rng.choice(["alloc", "alloc", "shared", "release", "seq", "extend", "finish"])
        if op == "alloc":
            n = int(rng.integers(1, 9))
            ks = ([keys[int(k)] if rng.random() < 0.7 else None
                   for k in rng.integers(0, len(keys), size=n)] if rng.random() < 0.6 else None)
            if n > j.free_slots():
                with pytest.raises(OutOfHbmBlocks):
                    h.allocate(n, keys=ks)
                continue
            got = h.allocate(n, keys=ks)
            assert got == j.allocate(n, keys=ks)
            held += got
        elif op == "shared":
            k = keys[int(rng.integers(len(keys)))]
            assert h.has_key(k) == j.has_key(k)
            s = h.lookup_shared(k)
            assert s == j.lookup_shared(k)
            if s is not None:
                held.append(s)
        elif op == "release" and held:
            pick = [held.pop(int(rng.integers(len(held)))) for _ in range(
                int(rng.integers(1, min(6, len(held)) + 1)))]
            h.release(pick)
            j.release(pick)
        elif op == "seq" and j.free_slots() >= 2:
            sid = f"s{seqs}"
            seqs += 1
            slots = j.allocate(2)
            assert h.allocate(2) == slots
            j.register_sequence(sid, slots)
            h.register_sequence(sid, slots)
        elif op in ("extend", "finish") and j.seq_tables:
            sid = sorted(j.seq_tables)[int(rng.integers(len(j.seq_tables)))]
            if op == "finish":
                j.finish_sequence(sid)
                h.finish_sequence(sid)
            else:
                n_new, seq_len = int(rng.integers(1, 40)), len(j.table(sid)) * 16
                try:
                    want = j.extend_sequence(sid, n_new, seq_len)
                except JOutOfHbmBlocks:
                    with pytest.raises(OutOfHbmBlocks):
                        h.extend_sequence(sid, n_new, seq_len)
                    continue
                assert h.extend_sequence(sid, n_new, seq_len) == want
        assert np.array_equal(h.refcounts, j.refcounts), step
        assert h._free == j._free and h._by_key == j._by_key and h._slot_key == j._slot_key
        assert h.seq_tables == j.seq_tables
    with pytest.raises(ValueError, match="double free"):
        h.release([int(np.flatnonzero(h.refcounts == 0)[0])])


# ---------------------------------------------------------------------------
# manager
# ---------------------------------------------------------------------------


def _manager(pool_blocks=32, mode="beluga", **kw):
    pool = KVBlockPool(LAYOUT, pool_blocks, "meta", n_shards=4)
    idx = PrefixIndex(pool)
    hbm = HbmPagedCache(256, 16)
    return KVCacheManager(pool, idx, hbm, PoolTransfer(pool, mode=mode), **kw), pool, idx


def _manager_stats(jstats) -> dict:
    """The reference's manager stats, ``degraded_ops`` included (0 in
    process: the degraded mode is off)."""
    return dataclasses.asdict(jstats)


def _tokens(doc, n_blocks):
    return [doc * 100000 + i for i in range(n_blocks * 16)]


def test_writeback_pool_oom_evicts_lru_and_retries():
    mgr, pool, idx = _manager(pool_blocks=32)
    assert mgr.writeback("a", _tokens(1, 32)) == 32  # pool now full
    assert mgr.writeback("b", _tokens(2, 16)) == 16  # OOM -> evict -> retry
    assert mgr.stats.pool_evictions > 0
    assert mgr.plan_fetch(_tokens(2, 16)).n_hit_tokens == 16 * 16
    assert mgr.plan_fetch(_tokens(1, 32)).n_hit_tokens < 32 * 16


def test_writeback_skips_offload_when_pool_is_pinned():
    mgr, pool, idx = _manager(pool_blocks=32)
    mgr.writeback("a", _tokens(1, 32))
    pool.retain(list(range(32)))  # everything referenced: eviction refuses
    assert mgr.writeback("b", _tokens(2, 16)) == 0
    pool.release(list(range(32)))


def test_recompute_cutover_triggers_on_slow_fetch():
    mgr, pool, idx = _manager(mode="rdma", recompute_cutover=1.0)
    mgr.transfer.super_block_tokens = 16
    mgr.writeback("a", _tokens(1, 16))
    plan = mgr.plan_fetch(_tokens(1, 16))
    assert plan.recompute
    assert plan.hit_blocks == [] and plan.n_hit_tokens == 0
    assert plan.n_miss_tokens == 16 * 16
    assert mgr.stats.recompute_cutovers == 1


def test_no_cutover_when_disabled_or_fast():
    mgr, pool, idx = _manager(mode="beluga", recompute_cutover=1000.0)
    mgr.writeback("a", _tokens(1, 16))
    plan = mgr.plan_fetch(_tokens(1, 16))
    assert not plan.recompute and plan.n_hit_tokens == 16 * 16
    mgr2, *_ = _manager(mode="rdma", recompute_cutover=None)
    mgr2.transfer.super_block_tokens = 16
    mgr2.writeback("a", _tokens(1, 16))
    assert not mgr2.plan_fetch(_tokens(1, 16)).recompute


def test_fetch_failure_rolls_back_slots_and_registers_empty_seq():
    """An epoch race inside scatter_read leaks neither pool refs nor HBM
    slots, and the sequence table exists."""
    mgr, pool, idx = _manager(pool_blocks=64)
    mgr.writeback("a", _tokens(1, 8))
    plan = mgr.plan_fetch(_tokens(1, 8))
    assert plan.hit_blocks
    pool.write_blocks([b for _, b, _ in plan.hit_blocks])  # epochs move on
    free_before = mgr.hbm.free_slots()
    with pytest.raises(StaleBlockError):
        mgr.fetch_into_hbm("victim", plan)
    assert mgr.hbm.seq_tables["victim"] == []
    assert mgr.hbm.free_slots() == free_before
    assert (pool.refcounts >= 0).all() and pool.refcounts.max() == 1
    assert mgr.stats.prefix_hits_tokens == 0 and mgr.stats.prefix_miss_tokens == 8 * 16


def test_fetch_into_full_hbm_rolls_back_pool_refs():
    mgr, pool, idx = _manager(pool_blocks=64)
    mgr.writeback("a", _tokens(1, 8))
    mgr.hbm.allocate(250)
    plan = mgr.plan_fetch(_tokens(1, 8))
    with pytest.raises(OutOfHbmBlocks):
        mgr.fetch_into_hbm("victim", plan)
    assert mgr.hbm.seq_tables["victim"] == [] and pool.refcounts.max() == 1


@pytest.mark.parametrize("mode,sbt,cutover", [("beluga", 0, None), ("rdma", 256, None),
                                              ("rdma", 16, 1.0)])
def test_manager_equals_reference_on_a_seeded_stream(mode, sbt, cutover):
    """Plans, fetches, writebacks and finishes under pool pressure: the same
    plans, slots, stats, pool and index state as the reference's manager."""
    jpool = BelugaPool(JLAYOUT, 96, 8, backing="meta")
    pool = KVBlockPool(LAYOUT, 96, "meta")
    jm = JKVCacheManager(jpool, GlobalIndex(jpool), JHbmPagedCache(128, 16),
                         TransferEngine(jpool, mode=mode, super_block_tokens=sbt),
                         recompute_cutover=cutover, prefill_tok_per_s=12800.0)
    m = KVCacheManager(pool, PrefixIndex(pool), HbmPagedCache(128, 16),
                       PoolTransfer(pool, mode=mode, super_block_tokens=sbt),
                       recompute_cutover=cutover, prefill_tok_per_s=12800.0)
    rng = np.random.default_rng(21)
    base = rng.integers(0, 500, size=400).tolist()
    docs = [base[: int(rng.integers(0, 300))] + rng.integers(0, 500, size=int(
        rng.integers(16, 400))).tolist() for _ in range(12)]
    for i in range(60):
        toks = docs[int(rng.integers(len(docs)))]
        sid = f"q{i}"
        jp, p = jm.plan_fetch(toks), m.plan_fetch(toks)
        assert dataclasses.asdict(p) == dataclasses.asdict(jp), i
        try:
            want = jm.fetch_into_hbm(sid, jp)
        except JOutOfHbmBlocks:
            with pytest.raises(OutOfHbmBlocks):
                m.fetch_into_hbm(sid, p)
        else:
            assert m.fetch_into_hbm(sid, p) == want
        assert m.writeback(sid, toks, keys=p.keys) == jm.writeback(sid, toks, keys=jp.keys)
        if rng.random() < 0.7:
            jm.finish(sid)
            m.finish(sid)
        assert dataclasses.asdict(m.stats) == _manager_stats(jm.stats)
        assert dataclasses.asdict(m.transfer.stats) == dataclasses.asdict(jm.transfer.stats)
        assert m.index.stats() == jm.index.stats()
        assert np.array_equal(pool.refcounts, jpool.refcounts)
        assert m.hbm._free == jm.hbm._free
    assert m.stats.pool_evictions > 0
    assert (m.stats.recompute_cutovers > 0) if cutover else (m.stats.prefix_hits_tokens > 0)
