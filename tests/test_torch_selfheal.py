"""Self-healing against the JAX package's, driven step by step on the CPU.

No test here waits on a probe thread's schedule: restarts are driven with
``ShardWatchdog.check()`` (and the reference's ``ShardSupervisor.check()``,
its probe thread idle), except the cluster's own probe thread, whose
restart is polled for up to a deadline.

* a kill, one ``check``, the journal's replay: ``match_prefix`` and
  ``lookup`` answer as the reference's supervisor does after the same
  sequence, confirmed remaps included, every segment of every generation
  unlinked at ``close``;
* the warm snapshot (``capture_snapshot`` called directly) restores the LRU
  order and the hit / miss counters as the reference's does;
* ``max_restarts`` holds; an injector's ``kill`` reaches a watchdog;
* the sharded client's ``degrade`` turns a dead shard into the same holes
  as the reference's, and a handler's in-band error still raises;
* the manager's degraded mode (all-miss, the rolled-back writeback,
  ``degraded_ops``) equals the reference's under the same injected
  ``RingServiceDied`` / ``ServiceDiedError``;
* seeded op streams (``tests/test_metadata_equivalence.py``) with a kill in
  the middle: a stale-free stream equals the reference's no-fault run
  observation for observation; the full stream completes; in both every
  block's refcount is the no-fault run's;
* a self-healing ``Cluster`` respawns a killed shard under its probe
  thread and serves the tail's hits.
"""

from __future__ import annotations

import os
import random
import time
from multiprocessing import shared_memory

import numpy as np
import pytest
import torch

from repro.core import wire as jwire
from repro.core.index import GlobalIndex
from repro.core.index import shard_of_key as jshard_of_key
from repro.core.pool import BelugaPool, PoolLayout
from repro.core.procserver import ProcessRpcServer, ShardSupervisor
from repro.core.rpc import CxlRpcClient, RetryPolicy, ServiceDiedError
from repro.core.transfer import TransferEngine
from repro.kvcache.hbm_cache import HbmPagedCache as JHbmPagedCache
from repro.kvcache.manager import KVCacheManager as JKVCacheManager
from repro_torch.core import wire
from repro_torch.core.index import PrefixIndex, ShardedPrefixIndex, shard_of_key
from repro_torch.core.pool import KVBlockLayout, KVBlockPool
from repro_torch.core.procserver import ShardWatchdog, process_plane
from repro_torch.core.rpc import RingError, RingRetryPolicy, RingServiceDied
from repro_torch.core.transfer import PoolTransfer
from repro_torch.distributed.fault_tolerance import FaultEvent, FaultInjector, FaultPlan
from repro_torch.kvcache.hbm_cache import HbmPagedCache
from repro_torch.kvcache.manager import KVCacheManager
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import Cluster, ClusterConfig
from tests.test_metadata_equivalence import Backend, _key, make_ops, replay

torch.set_num_threads(1)

LAYOUT = KVBlockLayout(block_tokens=16, n_layers_kv=4, n_kv_heads=2, head_dim=8)
JLAYOUT = PoolLayout(block_tokens=16, n_layers_kv=4, n_kv_heads=2, head_dim=8)
FAST = dict(max_retries=10, base_backoff=0.005, max_backoff=0.1)
IDLE_PROBE = 3600.0  # the reference's probe thread never steps within a test


def _gone(name: str) -> bool:
    try:
        seg = shared_memory.SharedMemory(name=name)
    except FileNotFoundError:
        return True
    seg.close()
    return False


class Side:
    """One package's watched shard over its own pool, driven by ``check``."""

    def __init__(self, port: bool, n_blocks: int = 256, **kw):
        self.port = port
        if port:
            self.pool = KVBlockPool(LAYOUT, n_blocks, "meta", n_shards=4)
            self.wd = ShardWatchdog(self.pool.share_meta(), n_slots=8, payload_bytes=1 << 14,
                                    journal_capacity=256, **kw).start(probe=False)
            self.client = self.wd.client()
            retry = RingRetryPolicy(**FAST)
            self.proxy = wire.RemoteIndex(self.client, 16, journal=self.wd.journal,
                                          retry=retry, on_freed=self.pool.release)
        else:
            self.pool = BelugaPool(JLAYOUT, n_blocks=n_blocks, n_shards=4, backing="meta")
            self.wd = ShardSupervisor(self.pool.share_meta(), journal_capacity=256,
                                      probe_interval=IDLE_PROBE, grace=0.0, n_slots=8,
                                      payload_bytes=1 << 14, **kw).start()
            self.client = CxlRpcClient(self.wd.ring, liveness=self.wd.server.alive)
            self.wd.register_client(self.client)
            self.proxy = jwire.RpcIndexClient(self.client, 16, journal=self.wd.journal,
                                              retry=RetryPolicy(**FAST),
                                              on_freed=self.pool.release)
        assert self.wd.wait_ready(60)

    def respawn(self) -> None:
        self.wd.kill()
        self.wd.check()

    def close(self) -> list[str]:
        names = self.wd.segment_names()
        if self.port:
            self.client.close()
        self.wd.close()
        self.pool.unshare_meta()
        return names


def _entries(proxy, keys):
    return [None if e is None else (e.block_id, e.epoch, e.n_tokens)
            for e in proxy.lookup_many(keys)]


def _restart_sequence(side: Side) -> dict:
    pool, proxy = side.pool, side.proxy
    keys = [_key(3, i) for i in range(8)]
    blocks = pool.allocate(8)
    proxy.publish_many(keys, blocks, pool.write_blocks(blocks), 16)
    freed = proxy.evict_blocks([blocks[5]])
    before = _entries(proxy, keys)
    served = side.wd.served
    side.respawn()
    out = {"freed": freed, "before": before, "after": _entries(proxy, keys),
           "match": [(b, e) for _, b, e in proxy.match_prefix_keys(keys)],
           "match_tail": [(b, e) for _, b, e in proxy.match_prefix_keys(keys[6:])],
           "stats": proxy.stats(), "free": pool.free_blocks(), "restarts": side.wd.restarts,
           "client_restarts": side.client.stats.restarts,
           "served_grew": side.wd.served > served, "journal": len(side.wd.journal)}
    out["names"] = side.close()
    return out


def test_restart_replays_the_journal_as_reference():
    got = _restart_sequence(Side(True))
    want = _restart_sequence(Side(False))
    for key in ("freed", "before", "after", "match", "match_tail", "stats", "free",
                "restarts", "client_restarts", "served_grew", "journal"):
        assert got[key] == want[key], key
    assert got["after"] == got["before"] and got["restarts"] == 1 and got["free"] == 256 - 7
    assert len(got["names"]) == 3  # the journal, the live ring, the retired ring
    assert all(_gone(n) for n in got["names"])


def _remap_sequence(side: Side) -> dict:
    """Publish eight blocks, move five to fresh blocks (the fifth with a
    stale epoch, refused and not journalled), then kill and respawn."""
    pool, proxy = side.pool, side.proxy
    keys = [_key(6, i) for i in range(8)]
    blocks = pool.allocate(8)
    epochs = pool.write_blocks(blocks)
    proxy.publish_many(keys, blocks, epochs, 16)
    new = pool.allocate(5)
    new_epochs = pool.write_blocks(new)
    old_epochs = [int(e) for e in epochs[:5]]
    old_epochs[4] += 1
    ok = proxy.remap_many(keys[:5], blocks[:5], old_epochs, new, new_epochs)
    before = _entries(proxy, keys)
    side.respawn()
    out = {"ok": ok, "blocks": blocks, "new": new, "before": before,
           "after": _entries(proxy, keys), "journal": len(side.wd.journal),
           "restarts": side.wd.restarts}
    side.close()
    return out


def test_restart_replays_confirmed_remaps_as_reference():
    """``RemoteIndex.remap_many`` journals the remaps the reply confirmed,
    so the rebuilt shard holds the moved blocks, as the reference's."""
    got, want = _remap_sequence(Side(True)), _remap_sequence(Side(False))
    assert got == want
    assert got["ok"] == [True] * 4 + [False] and got["restarts"] == 1
    assert got["after"] == got["before"]
    assert [e[0] for e in got["after"]] == got["new"][:4] + got["blocks"][4:]


def _warm_sequence(side: Side) -> dict:
    pool, proxy = side.pool, side.proxy
    keys = [_key(9, i) for i in range(6)]
    blocks = pool.allocate(6)
    proxy.publish_many(keys, blocks, pool.write_blocks(blocks), 16)
    assert len(proxy.match_prefix_keys(keys[:3])) == 3  # 0-2 now most recent
    hits = proxy.stats()["hits"]
    assert side.wd.capture_snapshot()
    side.respawn()
    snap = proxy.snapshot_all()
    out = {"order": [k for k, *_ in snap], "hits": proxy.stats()["hits"], "hits_before": hits,
           "evicted": proxy.evict_lru(1), "blocks": blocks, "free": pool.free_blocks()}
    side.close()
    return out


def test_warm_snapshot_restores_lru_order_and_counters_as_reference():
    got, want = _warm_sequence(Side(True)), _warm_sequence(Side(False))
    keys = [_key(9, i) for i in range(6)]
    assert got["order"] == want["order"] == keys[3:] + keys[:3]
    assert got["hits"] == got["hits_before"] == want["hits"] == want["hits_before"] >= 3
    assert got["evicted"] == [got["blocks"][3]] and want["evicted"] == [want["blocks"][3]]
    assert got["free"] == want["free"] == 256 - 5


def test_max_restarts_holds():
    side = Side(True, n_blocks=64, max_restarts=2)
    try:
        for _ in range(4):
            side.wd.kill()
            side.wd.check()
        assert side.wd.restarts == 2 and not side.wd.alive()
        assert not side.wd.check()  # a flapping shard stays down
        with pytest.raises(RuntimeError, match="without a probe thread"):
            ShardWatchdog.check(type("Probing", (), {"_probe": object()})())
    finally:
        names = side.close()
    assert len(names) == 4 and all(_gone(n) for n in names)
    assert not side.wd.running()


def test_injector_kill_reaches_a_watchdog():
    side = Side(True)
    try:
        keys = [_key(5, i) for i in range(4)]
        blocks = side.pool.allocate(4)
        side.proxy.publish_many(keys, blocks, side.pool.write_blocks(blocks), 16)
        clock = {"t": 0.0}
        inj = FaultInjector(FaultPlan([FaultEvent(t=0.0, kind="kill", shard=0)]),
                            supervisors=[side.wd], clock=lambda: clock["t"]).start()
        assert [e.kind for e in inj.advance()] == ["kill"]
        assert not side.wd.alive()
        assert side.wd.check() and side.wd.restarts == 1
        assert [b for _, b, _ in side.proxy.match_prefix_keys(keys)] == blocks
        assert side.client.stats.restarts == 1 and side.client.stats.retries == 1
    finally:
        side.close()


# ---------------------------------------------------------------------------
# degraded mode
# ---------------------------------------------------------------------------


def _degrade_run(port: bool, n_shards: int) -> dict:
    keys = [_key(4, i) for i in range(12)]
    if port:
        pool = KVBlockPool(LAYOUT, 256, "meta", n_shards=4)
        plane = process_plane(pool, n_shards, 8, 1 << 14)
        services, clients = plane.services, plane.clients
        proxy = wire.ShardedRemoteIndex(
            clients, 16, on_freed=pool.release, degrade=True,
            retry=RingRetryPolicy(max_retries=2, base_backoff=0.002))
        dead = shard_of_key(keys[0], n_shards)
    else:
        pool = BelugaPool(JLAYOUT, n_blocks=256, n_shards=4, backing="meta")
        spec = pool.share_meta()
        services = [ProcessRpcServer(spec, n_slots=8, payload_bytes=1 << 14).start()
                    for _ in range(n_shards)]
        assert all(s.wait_ready(60) for s in services)
        clients = [CxlRpcClient(s.ring, liveness=s.alive) for s in services]
        proxy = jwire.ShardedRpcIndexClient(
            clients, 16, on_freed=pool.release, degrade=True,
            retry=RetryPolicy(max_retries=2, base_backoff=0.002))
        dead = jshard_of_key(keys[0], n_shards)
    try:
        blocks = pool.allocate(12)
        proxy.publish_many(keys, blocks, pool.write_blocks(blocks), 16)
        full = proxy.match_prefix_keys(keys)
        services[dead].kill()  # no watchdog: the shard stays down
        holes = proxy.match_prefix_keys(keys)
        return {"full": [(b, e) for _, b, e in full], "holes": [(b, e) for _, b, e in holes],
                "degraded": proxy.degraded_ops,
                "client_degraded": [c.stats.degraded_ops for c in clients],
                "lookup_raises": _raises(lambda: proxy.lookup_many(keys))}
    finally:
        if port:
            plane.close()
        else:
            for s in services:
                s.close()
            pool.unshare_meta()


def _raises(fn) -> str | None:
    try:
        fn()
    except (RingServiceDied, ServiceDiedError, TimeoutError) as e:
        return "transient: " + type(e).__name__.replace("RingServiceDied", "ServiceDiedError")
    return None


@pytest.mark.parametrize("n_shards", [1, 2])
def test_sharded_degrade_turns_a_dead_shard_into_holes_as_reference(n_shards):
    got, want = _degrade_run(True, n_shards), _degrade_run(False, n_shards)
    assert got == want
    assert len(got["full"]) == 12 and got["degraded"] >= 1 and sum(got["client_degraded"]) >= 1
    keys = [_key(4, i) for i in range(12)]
    first_dead = min(i for i, k in enumerate(keys)
                     if shard_of_key(k, n_shards) == shard_of_key(keys[0], n_shards))
    assert len(got["holes"]) <= first_dead
    assert got["lookup_raises"]  # only a match degrades


def test_degrade_still_raises_a_handler_error():
    pool = KVBlockPool(LAYOUT, 64, "meta", n_shards=4)
    plane = process_plane(pool, 2, 8, 1 << 14)
    try:
        proxy = wire.ShardedRemoteIndex(plane.clients, 16, degrade=True)
        k = [_key(1, 0)] * 4  # a chain never repeats a key: refused in-band
        with pytest.raises(RingError, match="duplicate keys"):
            proxy.match_prefix_keys(k)
        assert proxy.degraded_ops == 0
    finally:
        assert not plane.close()


def _flaky(base, fault):
    """``base`` (an index class) whose remote ops named in ``down`` raise
    ``fault``, as a dead transport would."""

    class Flaky(base):
        down = {"match", "filter", "publish"}

        def _die(self, op):
            if op in self.down:
                raise fault("injected outage")

        def match_prefix_keys(self, keys):
            self._die("match")
            return super().match_prefix_keys(keys)

        def filter_unpublished(self, keys):
            self._die("filter")
            return super().filter_unpublished(keys)

        def publish_many(self, *a, **k):
            self._die("publish")
            return super().publish_many(*a, **k)

    return Flaky


def _manager_run(port: bool) -> list:
    if port:
        pool = KVBlockPool(LAYOUT, 128, "meta", n_shards=4)
        idx = _flaky(PrefixIndex, RingServiceDied)(pool)

        def mk(ok):
            return KVCacheManager(pool, idx, HbmPagedCache(64, 16), PoolTransfer(pool),
                                  degraded_ok=ok)
    else:
        pool = BelugaPool(JLAYOUT, n_blocks=128, n_shards=4, backing="meta")
        idx = _flaky(GlobalIndex, ServiceDiedError)(pool)

        def mk(ok):
            return JKVCacheManager(pool, idx, JHbmPagedCache(64, 16), TransferEngine(pool),
                                   degraded_ok=ok)
    mgr = mk(True)
    tokens = list(range(64))
    plan = mgr.plan_fetch(tokens)  # all-miss
    out = [("plan", plan.n_hit_tokens, plan.n_miss_tokens, plan.hit_blocks),
           ("writeback", mgr.writeback("s0", tokens), pool.free_blocks())]
    idx.down = set()
    out.append(("healed", mgr.writeback("s0", tokens), mgr.plan_fetch(tokens).n_hit_tokens))
    idx.down = {"publish"}  # dies after its blocks were allocated: handed back
    out.append(("rollback", mgr.writeback("s1", list(range(1000, 1064))), pool.free_blocks()))
    out.append(("stats", dict(vars(mgr.stats))))
    idx.down = {"match"}
    out.append(("strict", _raises(lambda: mk(False).plan_fetch(tokens))))
    return out


def test_manager_degraded_mode_equals_reference():
    got, want = _manager_run(True), _manager_run(False)
    assert got == want
    assert got[1] == ("writeback", 0, 128) and got[2] == ("healed", 4, 64)
    assert got[3] == ("rollback", 0, 124) and got[4][1]["degraded_ops"] == 3
    assert got[5] == ("strict", "transient: ServiceDiedError")


# ---------------------------------------------------------------------------
# chaos: a kill in the middle of a seeded stream
# ---------------------------------------------------------------------------


class WatchedBackend:
    """``replay``'s backend: three watched process shards over a port pool,
    driven by ``check``."""

    def __init__(self, n_shards: int = 3):
        self.pool = KVBlockPool(LAYOUT, 4096, "meta", n_shards=8)
        self.plane = process_plane(self.pool, n_shards, 8, 1 << 14, selfheal=True, probe=False,
                                   retry=RingRetryPolicy(max_retries=12, base_backoff=0.01,
                                                         max_backoff=0.2))
        self.view = self.plane.remote

    def kill(self, shard: int = 0) -> None:
        wd = self.plane.services[shard]
        wd.kill()
        assert wd.check()

    def close(self) -> None:
        assert not self.plane.close()


def test_chaos_stale_free_stream_equals_the_no_fault_reference():
    ops = make_ops(random.Random(17), 24, staleness=False)
    half = len(ops) // 2
    with Backend("inproc", 3) as ref:
        want = replay(ref, ops[:half]) + replay(ref, ops[half:])
    b = WatchedBackend()
    try:
        got = replay(b, ops[:half])
        b.kill(0)
        got += replay(b, ops[half:])
        assert b.plane.services[0].restarts == 1 and b.plane.clients[0].stats.restarts == 1
        # every block's refcount is the no-fault run's: nothing lost or freed twice
        assert np.array_equal(b.pool.refcounts, ref.pool.refcounts)
    finally:
        b.close()
    assert got == want


def test_chaos_full_stream_completes_with_settled_refcounts():
    ops = make_ops(random.Random(23), 30)
    half = len(ops) // 2
    nofault = type("InProc", (), {})()
    nofault.pool = KVBlockPool(LAYOUT, 4096, "meta", n_shards=8)
    nofault.view = ShardedPrefixIndex(nofault.pool, 3)
    want = replay(nofault, ops[:half]) + replay(nofault, ops[half:])
    b = WatchedBackend()
    try:
        got = replay(b, ops[:half])
        b.kill(0)
        got += replay(b, ops[half:])
        assert b.plane.services[0].restarts == 1 and len(got) == len(want)
        # the stream completed, and every block's refcount (so the free
        # count) is the no-fault run's, though the rebuilt LRU may pick other
        # victims
        assert np.array_equal(b.pool.refcounts, nofault.pool.refcounts)
        assert got[-1] == want[-1]
        for doc in range(4):
            keys = [_key(doc, i) for i in range(8)]
            hits = b.view.match_prefix_keys(keys)
            assert [(e.block_id, e.epoch) for e in b.view.lookup_many([k for k, _, _ in hits])] \
                == [(bid, ep) for _, bid, ep in hits]
    finally:
        b.close()


def test_cluster_selfheal_respawns_under_its_probe_thread():
    cfg = ClusterConfig(n_engines=2, pool_blocks=2048, hbm_slots_per_engine=256,
                        index_rpc=True, index_shards=2, index_rpc_slots=8,
                        index_transport="process", selfheal=True)
    c = Cluster(cfg, LAYOUT)
    try:
        base = list(range(512))
        for i in range(8):
            c.dispatch(Request(f"r{i}", base, 8, 0.0))
        c.run()
        wd = c.plane.services[shard_of_key(c.plane.remote.keys_for(base)[0], 2)]
        wd.kill()
        deadline = time.monotonic() + 60.0
        while not (wd.restarts and wd.alive()) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert wd.restarts == 1 and wd.alive()
        t0 = max(e.clock for e in c.engines)
        tail = [Request(f"h{i}", base, 8, t0) for i in range(4)]
        for r in tail:
            c.dispatch(r)
        s2 = c.run()
        assert all(r.hit_tokens == 512 for r in tail)
        assert sum(e.manager.stats.degraded_ops for e in c.engines) == 0
        assert s2["index"]["entries"] == 32
        names, paths = c.shm_segment_names(), c.doorbell_paths()
        assert len(names) == 1 + 2 + 3 and len(paths) == 3
    finally:
        assert not c.close()
    assert all(_gone(n) for n in names) and not any(os.path.exists(p) for p in paths)
