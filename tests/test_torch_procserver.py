"""The process transport against the JAX package's, on the CPU:

* a ``ShardProcess`` (a spawned service over a port pool's shared
  metadata) answers a seeded stream of every wire op exactly as a
  ``RingServer`` thread over an in-process ``PrefixIndex`` does, the pool
  released by the eviction replies' ``on_freed``;
* interop, one test each way: JAX's ``ProcessRpcServer`` serves the port's
  ``RemoteIndex`` over a port pool's metadata, and a port ``ShardProcess``
  serves JAX's ``RpcIndexClient`` over a JAX pool's;
* a killed service fails a call fast (``RingServiceDied``), well inside
  the call's timeout, and a posted slot likewise;
* ``Cluster(index_rpc=True, index_transport="process")`` at 1 and 4 shards
  in the reference's small-cluster shape (``tests/test_procserver.py``):
  ``run()``'s dicts equal the port's thread transport and JAX's process
  transport, with and without ``selfheal``; a tiered cluster over processes
  (migrator and ghost list over the rings) likewise, and with ``selfheal``
  a shard killed after the migrations and rebuilt from its journal answers
  as before and as the reference's supervisor; ``close()`` and a
  construction failing halfway leave no segment, FIFO or child;
* (exp11's process rows and chaos sweep run in ``test_torch_rpc.py``.)
"""

from __future__ import annotations

import os
import time
from multiprocessing import shared_memory

import numpy as np
import pytest
import torch

from repro.core import wire as jwire
from repro.core.index import GlobalIndex
from repro.core.pool import BelugaPool, PoolLayout
from repro.core.procserver import ProcessRpcServer
from repro.core.rpc import CxlRpcClient, ShmRing
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import Cluster as JCluster
from repro.serving.scheduler import ClusterConfig as JClusterConfig
from repro_torch.core import procserver, wire
from repro_torch.core.index import PrefixIndex
from repro_torch.core.pool import KVBlockLayout, KVBlockPool
from repro_torch.core.procserver import ShardProcess
from repro_torch.core.rpc import RingClient, RingServer, RingServiceDied, SlotRing
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import Cluster, ClusterConfig, TieringConfig
from tests.test_torch_rpc import _drive

torch.set_num_threads(1)

LAYOUT = KVBlockLayout(block_tokens=16, n_layers_kv=4, n_kv_heads=2, head_dim=8)
JLAYOUT = PoolLayout(block_tokens=16, n_layers_kv=4, n_kv_heads=2, head_dim=8)


def _gone(name: str) -> bool:
    try:
        seg = shared_memory.SharedMemory(name=name)
    except FileNotFoundError:
        return True
    seg.close()
    return False


@pytest.mark.parametrize("seed", [0, 1])
def test_process_shard_answers_as_a_thread_server(seed):
    pool = KVBlockPool(LAYOUT, 128, "meta", n_shards=8)
    srv = ShardProcess(pool.share_meta(), n_slots=8, payload_bytes=1024).start()
    try:
        assert srv.wait_ready()
        client = srv.client()
        got = _drive(wire.RemoteIndex(client, 16, on_freed=pool.release), pool, seed)
        assert client.stats.requests > 60 and client.stats.errors == 0
        assert srv.served == client.stats.requests
        client.close()
    finally:
        srv.close()
        pool.unshare_meta()
    ref_pool = KVBlockPool(LAYOUT, 128, "meta", n_shards=8)
    ring = SlotRing(8, 1024)
    thread = RingServer(ring, wire.make_index_handler(PrefixIndex(ref_pool), 1024)).start()
    try:
        want = _drive(wire.RemoteIndex(RingClient(ring), 16), ref_pool, seed)
    finally:
        assert thread.stop()
    assert got == want
    assert _gone(srv.spec.ring_name) and not os.path.exists(srv.spec.doorbell_path)
    assert not srv.running()


def test_jax_service_process_serves_the_port_client():
    pool = KVBlockPool(LAYOUT, 128, "meta", n_shards=8)
    jsrv = ProcessRpcServer(pool.share_meta(), n_slots=8, payload_bytes=1024).start()
    ring = None
    try:
        assert jsrv.wait_ready(60)
        ring = SlotRing.attach(jsrv.ring.shm_name, 8, 1024)
        client = RingClient(ring, liveness=jsrv.alive)
        got = _drive(wire.RemoteIndex(client, 16, on_freed=pool.release), pool, 4)
    finally:
        if ring is not None:
            ring.close()
        jsrv.close()
        pool.unshare_meta()
    ref_pool = KVBlockPool(LAYOUT, 128, "meta", n_shards=8)
    assert got == _drive(PrefixIndex(ref_pool), ref_pool, 4)


def test_port_service_process_serves_the_jax_client():
    jpool = BelugaPool(JLAYOUT, n_blocks=128, n_shards=8, backing="meta")
    srv = ShardProcess(jpool.share_meta(), n_slots=8, payload_bytes=1024).start()
    jring = None
    try:
        assert srv.wait_ready()
        jring = ShmRing.attach(srv.ring.shm_name, 8, 1024)
        jclient = CxlRpcClient(jring, liveness=srv.alive)
        got = _drive(jwire.RpcIndexClient(jclient, 16, on_freed=jpool.release), jpool, 5)
        assert jclient.stats.errors == 0
    finally:
        if jring is not None:
            jring.close()
        srv.close()
        jpool.unshare_meta()
    ref_pool = BelugaPool(JLAYOUT, n_blocks=128, n_shards=8, backing="meta")
    assert got == _drive(GlobalIndex(ref_pool), ref_pool, 5)


def test_killed_service_fails_fast():
    pool = KVBlockPool(LAYOUT, 256, "meta", n_shards=8)
    srv = ShardProcess(pool.share_meta(), n_slots=4, payload_bytes=4096).start()
    try:
        assert srv.wait_ready()
        client = srv.client()
        proxy = wire.RemoteIndex(client, 16, on_freed=pool.release)
        keys = list(proxy.keys_for(list(range(64))))
        blocks = pool.allocate(len(keys))
        proxy.publish_many(keys, blocks, pool.write_blocks(blocks), 16)
        assert len(proxy.match_prefix_keys(keys)) == 4
        srv.kill()
        assert not srv.alive() and not srv.running()
        t0 = time.perf_counter()
        with pytest.raises(RingServiceDied, match="died"):
            client.call(wire.encode_match(keys), timeout=30)
        slot = client.post(wire.encode_match(keys))
        with pytest.raises(RingServiceDied, match="died"):
            client.collect(slot, timeout=30)
        assert time.perf_counter() - t0 < 5.0
        assert client.stats.errors == 2
        client.close()
    finally:
        srv.close()
        pool.unshare_meta()


# ---------------------------------------------------------------------------
# the cluster over service processes
# ---------------------------------------------------------------------------


def _run_small_cluster(port: bool, **kw):
    """The reference's small cluster (``tests/test_procserver.py:258``):
    eight requests on one 512-token prompt, then four hits; returns
    ``run()``'s two dicts and the requests served a shard."""
    C, Cfg, Req, lay = ((Cluster, ClusterConfig, Request, LAYOUT) if port
                        else (JCluster, JClusterConfig, JRequest, JLAYOUT))
    c = C(Cfg(n_engines=2, pool_blocks=2048, hbm_slots_per_engine=256, index_rpc_slots=8, **kw),
          lay)
    try:
        base = list(range(512))
        for i in range(8):
            c.dispatch(Req(f"r{i}", base, 8, 0.0))
        s1 = c.run()
        t0 = max(e.clock for e in c.engines)
        tail = [Req(f"h{i}", base, 8, t0) for i in range(4)]
        for r in tail:
            c.dispatch(r)
        s2 = c.run()
        assert all(r.hit_tokens > 0 for r in tail)
        if port:
            served = [s.served for s in c.plane.services] if kw.get("index_transport") else []
            names, paths = c.shm_segment_names(), c.doorbell_paths()
        else:
            served, names, paths = [srv.served for srv in c._rpc_servers], [], []
    finally:
        alive = c.close()
    if port:
        assert not alive
        assert all(_gone(n) for n in names) and not any(os.path.exists(p) for p in paths)
        assert c.shm_segment_names() == [] and c.doorbell_paths() == []
    return s1, s2, served, names


@pytest.mark.parametrize("shards", [1, 4])
def test_cluster_process_transport_equals_thread_and_reference(shards):
    thread = _run_small_cluster(True, index_rpc=True, index_shards=shards)
    process = _run_small_cluster(True, index_rpc=True, index_shards=shards,
                                 index_transport="process")
    healed = _run_small_cluster(True, index_rpc=True, index_shards=shards,
                                index_transport="process", selfheal=True)
    ref = _run_small_cluster(False, index_rpc=True, index_shards=shards,
                             index_transport="process")
    ref_healed = _run_small_cluster(False, index_rpc=True, index_shards=shards,
                                    index_transport="process", selfheal=True)
    assert process[:2] == thread[:2] == ref[:2]
    # with selfheal, run() adds the reference's "selfheal" section, and
    # nothing else changes
    assert healed[:2] == ref_healed[:2]
    for s in healed[:2]:
        assert s.pop("selfheal") == {"restarts": 0, "rpc_retries": 0, "rpc_degraded_ops": 0,
                                     "manager_degraded_ops": 0}
    assert healed[:2] == process[:2]
    assert len(process[2]) == shards and all(process[2]) and process[2] == ref[2]
    assert len(process[3]) == 1 + shards  # the pool's metadata, a ring a shard
    assert len(healed[3]) == 1 + 2 * shards  # and a journal a shard


def _tiered_run(port: bool, **kw):
    """A tiered cluster whose migrator and ghost list work over the index's
    rings (``test_torch_cluster.py``'s tiered scenario): the timeline, the
    stats, and every block's refcount and epoch."""
    from repro.tiering import TieringConfig as JTieringConfig

    C, Cfg, Req, lay, T = ((Cluster, ClusterConfig, Request, LAYOUT, TieringConfig) if port
                           else (JCluster, JClusterConfig, JRequest, JLAYOUT, JTieringConfig))
    tcfg = T(enabled=True, spill_blocks=64, migrate_interval_s=0.01, migrate_batch_blocks=16)
    c = C(Cfg(n_engines=2, pool_blocks=64, pool_shards=32, hbm_slots_per_engine=256,
              index_rpc=True, index_shards=2, index_rpc_slots=8, tiering=tcfg,
              policy="cache_aware", **kw), lay)
    names = c.shm_segment_names() if port else []
    paths = c.doorbell_paths() if port else []
    try:
        prompts = [np.random.default_rng(i).integers(0, 1000, size=256).tolist()
                   for i in range(12)]
        for i in range(48):
            c.dispatch(Req(f"r{i}", prompts[i % 12], 8, 0.05 * i))
        stats = c.run()
        every = np.arange(c.pool.n_blocks)
        out = {"timeline": [(r.req_id, r.engine_id, r.t_first_token, r.t_done, r.hit_tokens)
                            for r in c.requests],
               "stats": stats, "refcounts": c.pool.refcounts[every].tolist(),
               "epochs": c.pool.epochs[every].tolist()}
        if kw.get("selfheal"):
            out["respawn"] = _respawn_shard0(c, port, prompts)
        if port:
            names, paths = c.shm_segment_names(), c.doorbell_paths()
    finally:
        alive = c.close()
    if port:
        assert not alive and all(_gone(n) for n in names)
        assert not any(os.path.exists(p) for p in paths)
    return out, names


def _respawn_shard0(c, port: bool, prompts) -> dict:
    """Kill shard 0's service after the run and wait (up to a deadline) for
    its watchdog's probe thread to respawn it from the journal; every
    prompt's chain looked up over the plane before and after."""
    if port:
        view, wd = c.plane.remote, c.plane.services[0]
    else:
        view, wd = c._index_view(), c._supervisors[0]
    keys = [k for p in prompts for k in view.keys_for(p)]

    def entries():
        return [None if e is None else (e.block_id, e.epoch, e.n_tokens)
                for e in view.lookup_many(keys)]

    before = entries()
    wd.kill()
    deadline = time.monotonic() + 30.0
    while not (wd.restarts and wd.alive()) and time.monotonic() < deadline:
        time.sleep(0.01)
    return {"restarts": wd.restarts, "before": before, "after": entries(),
            "journal": len(wd.journal)}


def test_cluster_tiering_over_processes_equals_thread_and_reference():
    """The migrator's owners_of / remap_many / evict_blocks and the ghost
    list's keys (from the eviction replies) over service processes: the run
    equals the thread transport's and the reference's over its processes,
    and the processes' segments (the tiered pool's one metadata segment, a
    ring a shard) are unlinked at close."""
    (got, names), (thread, _) = (_tiered_run(True, index_transport="process"),
                                 _tiered_run(True))
    want, _ = _tiered_run(False, index_transport="process")
    assert got == thread == want
    t = got["stats"]["tiering"]
    assert t["demotions"] > 0 and t["spill_evictions"] > 0 and len(names) == 3


def test_cluster_tiering_selfheal_rebuilds_remapped_entries_as_reference():
    """Self-healing shards under a tiered cluster: the migrator's confirmed
    remaps (demotions) and the evictions' retracts go into the journals, so
    a shard killed after the run and rebuilt from its journal answers every
    chain's lookup with the post-migration blocks, as before the kill and
    as the reference's supervisor after the same sequence."""
    (got, names), (want, _) = (_tiered_run(True, index_transport="process", selfheal=True),
                               _tiered_run(False, index_transport="process", selfheal=True))
    plain, _ = _tiered_run(True, index_transport="process")
    assert got == want
    assert got["stats"].pop("selfheal")["restarts"] == 0  # read before the kill
    assert {k: got[k] for k in plain} == plain
    r = got["respawn"]
    assert r["restarts"] == 1 and r["after"] == r["before"]
    live = [e for e in r["after"] if e is not None]
    tiers = got["stats"]["tiering"]
    assert live and tiers["demotions"] > 0 and tiers["spill_evictions"] > 0
    # some live entries sit on demoted blocks (the spill tier's ids)
    assert any(b >= 64 for b, _, _ in live)
    # the metadata, a journal and a ring a shard, and shard 0's retired ring
    assert len(names) == 1 + 2 * 2 + 1


@pytest.mark.parametrize("selfheal", [False, True])
def test_cluster_failing_halfway_leaks_nothing(monkeypatch, selfheal):
    made: list = []
    real_init = ShardProcess.__init__

    def recording(self, *a, **k):
        real_init(self, *a, **k)
        made.append(self)

    def boom(self, engine_id):
        raise RuntimeError("engine construction failed")

    monkeypatch.setattr(ShardProcess, "__init__", recording)
    monkeypatch.setattr(Cluster, "_make_engine", boom)
    with pytest.raises(RuntimeError, match="engine construction"):
        Cluster(ClusterConfig(n_engines=2, pool_blocks=1024, hbm_slots_per_engine=64,
                              index_rpc=True, index_shards=2, index_rpc_slots=8,
                              index_transport="process", selfheal=selfheal), LAYOUT)
    assert len(made) == 2
    for srv in made:
        assert _gone(srv.spec.ring_name) and _gone(srv.spec.pool_name)
        assert not os.path.exists(srv.spec.doorbell_path) and not srv.running()
        assert srv.spec.journal_name is None or _gone(srv.spec.journal_name)


def test_a_service_that_never_boots_leaks_nothing(monkeypatch):
    """A service that is not ready in time: the plane raises, stops every
    child and unlinks everything."""
    pool = KVBlockPool(LAYOUT, 64, "meta", n_shards=8)
    made: list = []
    real_init = ShardProcess.__init__

    def recording(self, *a, **k):
        real_init(self, *a, **k)
        made.append(self)

    monkeypatch.setattr(ShardProcess, "__init__", recording)
    monkeypatch.setattr(ShardProcess, "wait_ready", lambda self, timeout=0.0: False)
    with pytest.raises(RuntimeError, match="never became ready"):
        procserver.process_plane(pool, 2, 8, 1024)
    assert pool._meta_spec is None and len(made) == 2
    for srv in made:
        assert _gone(srv.spec.ring_name) and not srv.running()
