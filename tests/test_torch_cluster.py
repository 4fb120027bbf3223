"""The port's cluster simulator against the JAX package's, on the same
requests:

* ``Cluster`` for each policy x transfer mode, and with the straggler
  cutover, pool pressure, an 8-shard pool, HBM pressure, a run cut
  at a horizon, and ``remove_engine`` / ``add_engine`` mid-run: each
  request's ``engine_id``, ``t_admitted``, ``t_first_token``, ``t_done``,
  ``hit_tokens`` and ``tokens_out`` equal, and so are ``run()``'s dicts,
  ``pool_free``, the shard occupancy, the pool's refcounts and epochs, and
  each engine's stats;
* exp08's prefill/decode disaggregation (two clusters sharing one pool and
  index) at a small size;
* the exp05 twin's rows string-equal to ``benchmarks/exp05_e2e.run(n=64)``;
  ``exp05_e2e.PINNED`` equal to the JAX run at the paper's 256 clients, and
  the port's own run at 256 equal to them, with every pool refcount back to
  what the index owns;
* the metadata plane behind CXL-RPC rings served by threads
  (``index_rpc``, at 1 and 4 shards, chunked through small slots, under
  pool pressure) and sharded in process (``index_shards``): each equal to
  JAX's and to the in-process path; a tiered cluster whose migrator
  crosses the rings equal to JAX's and to the co-located migrator; exp05's
  beluga mode at 256 clients over 1 and 4 rings equal to ``PINNED``;
* each ``ValueError`` refusal, with the message JAX's ``Cluster`` gives for
  the same settings (a payload-free pool shared, workers without the shared
  data plane, the process transport without ``index_rpc``, unknown
  transports and data planes).

Every number here is MODELED by the simulators; nothing runs on a device.
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import benchmarks.exp05_e2e as jexp05
from repro.core.pool import PoolLayout
from repro.serving.request import Request as JRequest
from repro.serving.request import summarize as jsummarize
from repro.serving.scheduler import Cluster as JCluster
from repro.serving.scheduler import ClusterConfig as JClusterConfig
from repro_torch.core.pool import KVBlockLayout
from repro_torch.experiments import exp05_e2e
from repro_torch.serving.request import Request, summarize
from repro_torch.serving.scheduler import (
    Cluster, ClusterConfig, TieringConfig, refcounts_settled)

torch.set_num_threads(1)

SIDES = {
    "jax": SimpleNamespace(Cluster=JCluster, ClusterConfig=JClusterConfig, Request=JRequest,
                           summarize=jsummarize,
                           layout=PoolLayout(block_tokens=16, n_layers_kv=4, n_kv_heads=2,
                                             head_dim=8)),
    "port": SimpleNamespace(Cluster=Cluster, ClusterConfig=ClusterConfig, Request=Request,
                            summarize=summarize,
                            layout=KVBlockLayout(block_tokens=16, n_layers_kv=4, n_kv_heads=2,
                                                 head_dim=8)),
}
TIMELINE = ("req_id", "engine_id", "t_admitted", "t_first_token", "t_done", "hit_tokens",
            "tokens_out", "state")


def _requests(side, n, in_len=512, out_len=8, tag="r", arrival=0.0, rate=None, seed=0):
    """n requests sharing 40 % of a seeded base prompt; Poisson arrivals at
    ``rate`` (all at ``arrival`` without one)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 1000, size=in_len).tolist()
    cut = int(in_len * 0.4)
    out, t = [], arrival
    for i in range(n):
        suffix = np.random.default_rng(seed * 1000 + i).integers(0, 1000, in_len - cut).tolist()
        out.append(side.Request(f"{tag}{i}", base[:cut] + suffix, out_len, t))
        if rate:
            t += float(rng.exponential(1.0 / rate))
    return out


def _scenario(side, kw: dict, elastic: bool = False, until: float | None = None,
              n: int = 24, in_len: int = 512, out_len: int = 8):
    """A populating closed-loop phase, then the same prompts again as an
    open-loop stream. ``elastic`` fails engine 1 after 0.3 s and adds two;
    ``until`` cuts the second run at a horizon."""
    kw = {"n_engines": 4, "pool_blocks": 8192, "hbm_slots_per_engine": 512, **kw}
    c = side.Cluster(side.ClusterConfig(**kw), side.layout)
    for r in _requests(side, n, in_len, out_len):
        c.dispatch(r)
    orphans = []
    if elastic:
        for e in c.engines:
            e.advance(0.3)
        orphans = [r.req_id for r in c.remove_engine(1)]
        c.add_engine()
        c.add_engine()
    s1 = c.run()
    t0 = max(e.clock for e in c.engines)
    for r in _requests(side, n, in_len, 2 * out_len, tag="h", arrival=t0, rate=20.0):
        c.dispatch(r)
    s2 = c.run(until=None if until is None else t0 + until)
    return c, s1, s2, orphans


def _observed(c, s1, s2, orphans):
    return {
        "timeline": [tuple(getattr(r, f) for f in TIMELINE) for r in c.requests],
        "s1": s1, "s2": s2, "orphans": orphans,
        "engines": [(e.engine_id, e.clock, dataclasses.asdict(e.stats), len(e.waiting),
                     len(e.running), e.manager.hbm.free_slots(),
                     _manager_stats(e.manager.stats)) for e in c.engines],
        "pool": (c.pool.free_blocks(), c.pool.shard_occupancy(), c.pool.refcounts.tolist(),
                 c.pool.epochs.tolist()),
    }


def _manager_stats(stats) -> dict:
    """Without the reference's degraded-mode count (item 7e), which stays 0
    in process."""
    out = dataclasses.asdict(stats)
    assert out.pop("degraded_ops", 0) == 0
    return out


def _assert_same(kw: dict, **opts):
    want = _observed(*_scenario(SIDES["jax"], kw, **opts))
    got = _observed(*_scenario(SIDES["port"], kw, **opts))
    for key in want:
        assert got[key] == want[key], key
    return got


POLICIES = ["cache_oblivious", "cache_aware", "round_robin"]
MODES = [("beluga", 0), ("rdma", 256), ("none", 0)]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mode,sbt", MODES)
def test_cluster_equals_reference(policy, mode, sbt):
    got = _assert_same({"policy": policy, "transfer_mode": mode, "super_block_tokens": sbt})
    assert got["s1"]["n_done"] == 24 and got["s2"]["n_done"] == 48
    assert (got["s2"]["hit_tokens"] > 0) == (mode != "none")


@pytest.mark.parametrize("policy", POLICIES)
def test_cluster_elastic_remove_and_add_equals_reference(policy):
    got = _assert_same({"policy": policy, "transfer_mode": "beluga"}, elastic=True)
    assert got["orphans"] and len(got["engines"]) == 5 and got["s2"]["n_done"] == 48


@pytest.mark.parametrize("kw,opts", [
    # the straggler cutover: RDMA at native 16 recomputes instead of fetching
    ({"transfer_mode": "rdma", "super_block_tokens": 16, "straggler_cutover": 1.0}, {}),
    # pool pressure: LRU eviction, then skipped offloads
    ({"pool_blocks": 256, "policy": "cache_aware"}, {}),
    ({"pool_blocks": 64, "transfer_mode": "rdma", "super_block_tokens": 256}, {}),
    # fewer, fuller shards
    ({"pool_shards": 8}, {}),
    # HBM pressure: the capacity gate holds admissions back
    ({"hbm_slots_per_engine": 80, "n_engines": 2}, {}),
    # a run cut at a horizon leaves work queued
    ({"policy": "round_robin"}, {"until": 0.4}),
])
def test_cluster_variants_equal_reference(kw, opts):
    got = _assert_same(kw, **opts)
    if "straggler_cutover" in kw:
        assert sum(e[6]["recompute_cutovers"] for e in got["engines"]) > 0
    if kw.get("pool_blocks", 8192) <= 256:
        assert sum(e[6]["pool_evictions"] for e in got["engines"]) > 0
    if "until" in opts:
        assert got["s2"]["n_done"] < 48


def _pd_disagg(side, mode, sbt):
    """exp08 (a) at a small size: a decode cluster served from the prefill
    cluster's pool and index."""
    cfg = side.ClusterConfig(n_engines=3, transfer_mode=mode, pool_blocks=4096,
                             super_block_tokens=sbt, hbm_slots_per_engine=512)
    pre = side.Cluster(cfg, side.layout)
    for r in _requests(side, 12, 384, 1):
        pre.dispatch(r)
    pre.run()
    t0 = max(e.clock for e in pre.engines)
    dec = side.Cluster(cfg, side.layout)
    dec.pool, dec.index = pre.pool, pre.index
    for e in dec.engines:
        e.manager.pool = e.manager.transfer.pool = pre.pool
        e.manager.index = pre.index
    for r in _requests(side, 12, 384, 16, tag="d", arrival=t0):
        dec.dispatch(r)
    dec.run()
    ds = [r for r in dec.requests if r.req_id.startswith("d")]
    return [tuple(getattr(r, f) for f in TIMELINE) for r in ds], side.summarize(
        ds, max(x.t_done for x in ds) - t0), pre.index.stats()


@pytest.mark.parametrize("mode,sbt", [("rdma", 256), ("beluga", 0)])
def test_pd_disaggregation_equals_reference(mode, sbt):
    got = _pd_disagg(SIDES["port"], mode, sbt)
    assert got == _pd_disagg(SIDES["jax"], mode, sbt)
    assert got[1]["hit_tokens"] > 0


# ---------------------------------------------------------------------------
# exp05 (Table 5)
# ---------------------------------------------------------------------------


def test_exp05_rows_equal_reference_at_64_clients():
    assert exp05_e2e.run(n=64) == jexp05.run(n=64)


def test_pinned_values_are_the_reference_run_at_256(monkeypatch):
    """``benchmarks/exp05_e2e.run()`` at the paper's size, its summaries
    recorded as it computes them: equal to ``PINNED`` (integers exactly,
    times within 1e-12 relative), and its rows equal to the rows the port
    makes from the pins."""
    seen = []
    real = jexp05.run_populate_then_hit

    def record(*a, **k):
        s1, s2, c = real(*a, **k)
        seen.append((s1, s2))
        return s1, s2, c

    monkeypatch.setattr(jexp05, "run_populate_then_hit", record)
    rows = jexp05.run()
    assert [name for name, _, _ in exp05_e2e.MODES] == ["vllm", "rdma", "beluga"]
    res = {}
    for (name, _, _), (s1, s2) in zip(exp05_e2e.MODES, seen):
        assert exp05_e2e.pinned_mismatches(name, s1, s2) == [], name
        res[name] = (exp05_e2e.PINNED[name]["populate"], exp05_e2e.PINNED[name]["cache_hit"])
    assert exp05_e2e.rows_of(res) == rows


@pytest.mark.parametrize("name", ["vllm", "rdma", "beluga"])
def test_port_at_256_equals_pins_and_settles(name):
    s1, s2, c = exp05_e2e.run_mode(name)
    assert exp05_e2e.pinned_mismatches(name, s1, s2) == []
    assert all(r.state == "done" for r in c.requests) and len(c.requests) == 512
    assert refcounts_settled(c.pool, c.index)
    assert all(e.manager.hbm.free_slots() == e.manager.hbm.n_slots for e in c.engines)


def test_pinned_mismatches_reports_each_number():
    pin = exp05_e2e.PINNED["beluga"]
    s1, s2 = dict(pin["populate"]), dict(pin["cache_hit"])
    assert exp05_e2e.pinned_mismatches("beluga", s1, s2) == []
    s2["avg_ttft_s"] = math.nextafter(s2["avg_ttft_s"], 10.0)  # inside 1e-12
    assert exp05_e2e.pinned_mismatches("beluga", s1, s2) == []
    s2["avg_ttft_s"] *= 1 + 1e-9
    s1["pool_free"] += 1
    s1["index"] = {**s1["index"], "hits": s1["index"]["hits"] - 1}
    bad = exp05_e2e.pinned_mismatches("beluga", s1, s2)
    assert [b.split(":")[0] for b in bad] == [
        "beluga.populate.index.hits", "beluga.populate.pool_free", "beluga.cache_hit.avg_ttft_s"]


def test_settled_check_sees_a_leaked_reference():
    c, *_ = _scenario(SIDES["port"], {})
    assert refcounts_settled(c.pool, c.index)
    live = int(np.flatnonzero(c.pool.refcounts == 1)[0])
    c.pool.retain([live])
    assert not refcounts_settled(c.pool, c.index)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


# every setting here is one the reference refuses, and each case holds the
# port's message against the one JAX's Cluster gives for it. The ids are the
# cases' first ones (a test whose check changes keeps its name): kw1 and kw5
# once named item 7e-ii, whose process transport the reference refuses
# without index_rpc; kw0, kw2, kw3 and kw4 named item 7e-iii until the shared
# data plane and the engine workers were ported, and now check the
# reference's own refusal of their settings: a payload-free pool
# (backing="meta", the port's device="meta") cannot be shared, and workers
# need the shared data plane
@pytest.mark.parametrize("kw,item", [
    pytest.param({"index_rpc": True, "index_transport": "process", "data_plane": "shared"},
                 "requires backing='numpy'", id="kw0-item 7e-ii"),
    pytest.param({"index_transport": "process"}, "requires index_rpc=True",
                 id="kw1-item 7e-ii"),
    pytest.param({"tiering": TieringConfig(enabled=True), "index_rpc": True,
                  "index_transport": "process", "selfheal": True, "engine_processes": 4},
                 "requires data_plane='shared'", id="kw2-item 7e-ii"),
    pytest.param({"data_plane": "shared"}, "requires backing='numpy'", id="kw3-item 7e-iii"),
    pytest.param({"engine_processes": 4}, "requires data_plane='shared'", id="kw4-item 7e-iii"),
    pytest.param({"selfheal": True, "index_transport": "process"},
                 "requires index_rpc=True", id="kw5-item 7e-ii"),
    ({"index_transport": "carrier-pigeon"}, "must be 'thread' or 'process'"),
    ({"data_plane": "public"}, "must be 'private' or 'shared'"),
])
def test_unported_settings_are_refused(kw, item):
    from repro.tiering import TieringConfig as JTieringConfig

    with pytest.raises(ValueError, match=item) as got:
        Cluster(ClusterConfig(n_engines=1, pool_blocks=64, **kw), SIDES["port"].layout)
    jkw = {k: JTieringConfig(**dataclasses.asdict(v)) if k == "tiering" else v
           for k, v in kw.items()}
    with pytest.raises(ValueError) as ref:
        JCluster(JClusterConfig(n_engines=1, pool_blocks=64, **jkw), SIDES["jax"].layout)
    assert str(got.value) == str(ref.value)


# ---------------------------------------------------------------------------
# the metadata plane behind rings (threads) and sharded
# ---------------------------------------------------------------------------


def _observed_closed(side, kw: dict):
    c, s1, s2, orphans = _scenario(side, kw)
    try:
        return _observed(c, s1, s2, orphans), c
    finally:
        assert not c.close()  # no server thread outlived its stop


@pytest.mark.parametrize("kw", [
    # the settings the port refused before it had the plane
    {"index_rpc": True},
    {"index_rpc": True, "index_shards": 4},
    {"index_shards": 4},
    # under pool pressure (evictions cross the rings), slots so small that
    # every chain goes in chunks, and shards that outnumber the pool's
    {"index_rpc": True, "index_shards": 4, "pool_blocks": 256, "policy": "cache_aware"},
    {"index_rpc": True, "index_rpc_slots": 4, "index_rpc_payload": 256, "index_shards": 2},
    {"index_shards": 3, "pool_blocks": 256, "transfer_mode": "rdma",
     "super_block_tokens": 256},
])
def test_metadata_plane_settings_equal_reference(kw):
    want, _ = _observed_closed(SIDES["jax"], kw)
    got, c = _observed_closed(SIDES["port"], kw)
    for key in want:
        assert got[key] == want[key], key
    n_rings = kw.get("index_shards", 1) if kw.get("index_rpc") else 0
    assert (c.plane is None) == (n_rings == 0)
    assert c.plane is None or (len(c.plane.servers) == n_rings
                               and not any(s.alive() for s in c.plane.servers))
    assert len(c.ring_clients) == n_rings
    assert all(cl.stats.requests > 0 and cl.stats.errors == 0 for cl in c.ring_clients)
    if kw.get("index_rpc"):  # behind the ring, the in-process path's answers
        plain = {k: v for k, v in kw.items() if k not in ("index_rpc", "index_rpc_slots",
                                                         "index_rpc_payload")}
        local, _ = _observed_closed(SIDES["port"], plain)
        if "index_rpc_payload" in kw:  # a chunked match leaves later chunks uncounted
            for d in (got, local):
                for s in ("s1", "s2"):
                    d[s]["index"] = {k: v for k, v in d[s]["index"].items() if k != "misses"
                                     and k != "hit_rate"}
        assert got == local


@pytest.mark.parametrize("shards", [1, 2])
def test_tiered_cluster_over_the_ring_equals_reference_and_colocated(shards):
    """The migrator's owners_of / remap_many / evict_blocks over the rings:
    the whole run equals JAX's over its rings and the co-located migrator's
    (``tests/test_tiering.py:531-570`` holds JAX to the same)."""
    from repro.tiering import TieringConfig as JTieringConfig

    def run(side, **kw):
        tcfg = (JTieringConfig if side is SIDES["jax"] else TieringConfig)(
            enabled=True, spill_blocks=64, migrate_interval_s=0.01, migrate_batch_blocks=16)
        cfg = side.ClusterConfig(n_engines=2, pool_blocks=64, pool_shards=32,
                                 hbm_slots_per_engine=256, index_shards=shards, tiering=tcfg,
                                 policy="cache_aware", **kw)
        c = side.Cluster(cfg, side.layout)
        try:
            for i in range(48):
                base = np.random.default_rng(i % 12).integers(0, 1000, size=256).tolist()
                c.dispatch(side.Request(f"r{i}", base, 8, 0.05 * i))
            stats = c.run()
        finally:
            alive = c.close()
        assert not alive
        every = np.arange(c.pool.n_blocks)
        return {"timeline": [tuple(getattr(r, f) for f in TIMELINE) for r in c.requests],
                "stats": stats, "refcounts": c.pool.refcounts[every].tolist(),
                "epochs": c.pool.epochs[every].tolist()}, c

    want, _ = run(SIDES["jax"], index_rpc=True, index_rpc_slots=8)
    got, c = run(SIDES["port"], index_rpc=True, index_rpc_slots=8)
    colocated, c0 = run(SIDES["port"])
    assert got == want == colocated
    t = got["stats"]["tiering"]
    assert t["demotions"] > 0 and t["spill_evictions"] > 0
    assert all(cl.stats.requests > 0 for cl in c.ring_clients)
    assert c.migrator.index is not c.index and c0.migrator.index is c0.index
    assert refcounts_settled(c.pool, c.index)


@pytest.mark.parametrize("shards", [1, 4])
def test_exp05_over_the_ring_at_256_equals_pins(shards):
    """Table 5's beluga mode at the paper's 256 clients with the index
    behind rings (phase 20 (i) of ``chip_smoke.py``): every summary number
    equals ``PINNED`` (the in-process reference run), the per-shard entries
    summing to the total, and every refcount back to what the index owns."""
    s1, s2, c = exp05_e2e.run_mode("beluga", index_rpc=True, index_shards=shards)
    assert not c.close()
    per_shard = s1["index"].pop("shards", None)
    assert exp05_e2e.pinned_mismatches("beluga", s1, s2) == []
    assert (per_shard is None) == (shards == 1)
    assert per_shard is None or sum(per_shard) == s1["index"]["entries"]
    assert refcounts_settled(c.pool, c.index)
    assert len(c.ring_clients) == shards and all(cl.stats.requests for cl in c.ring_clients)


def test_cluster_config_fields_and_defaults_are_the_reference_s():
    """Each field the port has is the reference's, with its default, so a
    config written for the port is valid for JAX, ``TieringConfig``'s too;
    what the port leaves out fails loudly as an unknown keyword."""
    def fields(cls):
        return {f.name: (f.default if f.default is not dataclasses.MISSING
                         else dataclasses.asdict(f.default_factory()))
                for f in dataclasses.fields(cls)}

    from repro.tiering import TieringConfig as JTieringConfig

    for port, ref in ((ClusterConfig, JClusterConfig), (TieringConfig, JTieringConfig)):
        mine, theirs = fields(port), fields(ref)
        assert {k: theirs.get(k) for k in mine if k != "tiering"} == \
            {k: v for k, v in mine.items() if k != "tiering"}
    assert fields(ClusterConfig)["tiering"] == {k: v for k, v in fields(JClusterConfig)[
        "tiering"].items() if k in fields(TieringConfig)}
    with pytest.raises(TypeError):
        ClusterConfig(snapshot_interval=0.5)
    with pytest.raises(TypeError):
        TieringConfig(prefix_admit_blocks=3)
