"""The port's fault-tolerance policies against the JAX package's, on the
same clocks and inputs drawn with numpy from a seed:

* ``HeartbeatMonitor.dead_hosts``; ``plan_elastic_remesh`` over the shapes
  and failed hosts of JAX's tests and seeded others (each plan, or each
  error, equal); ``StragglerPolicy``'s flagged hosts and histories;
* ``FaultPlan``'s ``due`` / ``pending`` / ``active`` on seeded schedules;
  ``FaultInjector``'s kills on stub supervisors, and its delay and drop
  windows on a port ring: a drop raises until the window closes, and the
  index client's own retry outlives it;
* ``RealEngine`` (reduced llama3.1-8b, CPU) with its index behind a ring
  (``experiments/ring_serve.py``, ``chip_smoke.py`` phase 20 (iii)): under
  a 1 ms delay window the tokens are unchanged and each request's index
  calls spend its posts x 1 ms more outside their round trips; under a drop
  window shorter than the
  retry budget the match retries and the tokens are unchanged.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from repro.distributed import fault_tolerance as jft
from repro_torch.core import wire
from repro_torch.core.index import PrefixIndex
from repro_torch.core.pool import KVBlockLayout, KVBlockPool
from repro_torch.core.rpc import RingClient, RingRetryPolicy, RingServer, SlotRing
from repro_torch.distributed import fault_tolerance as ft

torch.set_num_threads(1)

SEEDS = [0, 1, 2, 3, 17]


def _outcome(fn, *args):
    """A call's result, or its exception's type and text."""
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 - compared across the two sides
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("seed", SEEDS)
def test_dead_hosts_equal_reference(seed):
    rng = np.random.default_rng(seed)
    n, timeout = int(rng.integers(1, 12)), float(rng.uniform(1, 30))
    sides = [jft.HeartbeatMonitor(n, timeout), ft.HeartbeatMonitor(n, timeout)]
    for _ in range(40):
        h, now = int(rng.integers(0, n + 2)), float(rng.uniform(0, 100))
        if rng.random() < 0.6:
            for s in sides:
                s.beat(h, now=now)
        got = [s.dead_hosts(now=now) for s in sides]
        assert got[0] == got[1]
    assert sides[0].last_beat == sides[1].last_beat


def _remesh_cases():
    cases = [  # JAX's own tests' cases first
        ((2, 16, 16), ("pod", "data", "model"), 4, [3], 1200),
        ((4, 2, 8), ("data", "fsdp", "model"), 1, [0], 100),
        ((4, 2, 8), ("data", "fsdp", "model"), 1, [], 100),
        ((1, 4), ("data", "model"), 1, [0], 0),
        ((2, 2), ("model", "data"), 1, [1], 0),  # no data-parallel axis first
    ]
    rng = np.random.default_rng(7)
    for _ in range(60):
        nd = int(rng.integers(1, 4))
        shape = tuple(int(x) for x in rng.choice([1, 2, 4, 8, 16], size=nd + 1))
        axes = (("pod", "data", "model", "x")[: nd + 1] if rng.random() < 0.5
                else ("data", "fsdp", "model", "x")[: nd + 1])
        hosts = int(rng.choice([1, 2, 4, 8, 64]))
        n_hosts = max(1, int(np.prod(shape)) // hosts)
        failed = sorted(set(rng.integers(0, n_hosts + 4, size=int(rng.integers(0, 5))).tolist()))
        cases.append((shape, axes, hosts, failed, int(rng.integers(0, 5000))))
    return cases


@pytest.mark.parametrize("case", _remesh_cases())
def test_elastic_remesh_equals_reference(case):
    got = _outcome(ft.plan_elastic_remesh, *case)
    want = _outcome(jft.plan_elastic_remesh, *case)
    if isinstance(want, tuple):
        assert got == want
    else:
        assert (got.old_shape, got.new_shape, got.axes, got.restart_step, got.note,
                got.degraded) == (want.old_shape, want.new_shape, want.axes, want.restart_step,
                                  want.note, want.degraded)


@pytest.mark.parametrize("seed", SEEDS)
def test_stragglers_equal_reference(seed):
    rng = np.random.default_rng(seed)
    window, factor = int(rng.integers(1, 8)), float(rng.uniform(1.1, 2.5))
    sides = [jft.StragglerPolicy(window, factor), ft.StragglerPolicy(window, factor)]
    for _ in range(60):
        h = int(rng.integers(0, 6))
        t = float(rng.lognormal(0.0, 0.4)) * (3.0 if h == 2 else 1.0)
        for s in sides:
            s.record(h, t)
        assert sides[0].stragglers() == sides[1].stragglers()
    assert sides[0].history == sides[1].history


def _events(rng, mod):
    kinds = ("kill", "delay", "drop", "kill_worker", "kill_allocator")
    return [mod.FaultEvent(t=float(rng.uniform(0, 2)), kind=str(rng.choice(kinds)),
                           shard=int(rng.integers(0, 3)), duration=float(rng.uniform(0, 0.8)),
                           delay_s=float(rng.uniform(0, 0.01))) for _ in range(12)]


@pytest.mark.parametrize("seed", SEEDS)
def test_fault_plan_equals_reference(seed):
    plans = [jft.FaultPlan(_events(np.random.default_rng(seed), m)) for m in (jft, ft)]
    as_tuple = lambda evs: [(e.t, e.kind, e.shard, e.duration, e.delay_s) for e in evs]  # noqa: E731
    assert as_tuple(plans[0].events) == as_tuple(plans[1].events)
    rng = np.random.default_rng(seed + 100)
    for now in np.sort(rng.uniform(0, 2.5, size=25)).tolist():
        shard = int(rng.integers(0, 3))
        assert as_tuple(plans[0].active(shard, now)) == as_tuple(plans[1].active(shard, now))
        assert as_tuple(plans[0].due(now)) == as_tuple(plans[1].due(now))
        assert plans[0].pending() == plans[1].pending()
    for mod in (jft, ft):
        with pytest.raises(ValueError, match="unknown fault kind"):
            mod.FaultEvent(t=0.0, kind="explode")


def test_injector_kills_reach_stub_supervisors_as_reference():
    """Kills go to the shard's supervisor, workers and the allocator hook,
    once each, in the plan's order, on both sides."""
    logs = []
    for mod in (jft, ft):
        log = []

        class Stub:
            def __init__(self, name):
                self.name = name

            def kill(self, log=log):
                log.append(self.name)

        clock = {"t": 0.0}
        plan = mod.FaultPlan([
            mod.FaultEvent(0.3, "kill", shard=1), mod.FaultEvent(0.1, "kill", shard=0),
            mod.FaultEvent(0.2, "kill_worker", shard=0), mod.FaultEvent(0.4, "kill", shard=5),
            mod.FaultEvent(0.5, "kill_allocator"), mod.FaultEvent(0.25, "delay", duration=1.0),
        ])
        inj = mod.FaultInjector(plan, [Stub("s0"), Stub("s1")], clock=lambda c=clock: c["t"],
                                worker_supervisors=[Stub("w0")],
                                allocator=lambda log=log: log.append("alloc")).start()
        fired = []
        for t in (0.0, 0.15, 0.35, 1.0):
            clock["t"] = t
            fired.append([(e.t, e.kind, e.shard) for e in inj.advance()])
        logs.append((log, fired, [(e.t, e.kind) for e in inj.applied], inj.now()))
    assert logs[0] == logs[1]
    assert logs[1][0] == ["s0", "w0", "s1", "alloc"]  # shard 5 has no supervisor


@pytest.fixture
def served_ring():
    layout = KVBlockLayout(block_tokens=16, n_layers_kv=4, n_kv_heads=2, head_dim=8)
    pool = KVBlockPool(layout, 64, "meta", n_shards=4)
    idx = PrefixIndex(pool)
    ring = SlotRing(n_slots=4, payload_bytes=1 << 14)
    server = RingServer(ring, wire.make_index_handler(idx, max_reply=ring.payload_bytes)).start()
    yield pool, idx, ring
    server.stop()


def test_injector_windows_on_a_port_ring(served_ring):
    """Outside a window a post goes through; a delay window sleeps before
    each post; a drop window raises ``TimeoutError`` (counted by nobody:
    nothing was posted); the index client's retry outlives a drop window
    that closes, as JAX's test drives it on a virtual clock."""
    pool, idx, ring = served_ring
    client = RingClient(ring)
    clock = {"t": 0.0}
    inj = ft.FaultInjector(ft.FaultPlan([
        ft.FaultEvent(t=1.0, kind="drop", shard=0, duration=1.0),
        ft.FaultEvent(t=3.0, kind="delay", shard=0, duration=1.0, delay_s=0.02),
        ft.FaultEvent(t=0.0, kind="drop", shard=1, duration=9.0),  # another shard's
    ]), supervisors=[], clock=lambda: clock["t"]).start()
    inj.attach_client(0, client)
    keys = [bytes([7]) * 16, bytes([8]) * 16]
    proxy = wire.RemoteIndex(client, block_tokens=16)
    assert proxy.lookup_many(keys) == [None, None]
    clock["t"] = 1.5
    with pytest.raises(TimeoutError, match="fault-injected"):
        proxy.lookup_many(keys)
    assert client.stats.round_trips == 1 and client.free_slots() == ring.n_slots
    clock["t"] = 3.5
    t0 = time.perf_counter()
    assert proxy.lookup_many(keys) == [None, None]
    assert time.perf_counter() - t0 >= 0.02
    clock["t"] = 1.5
    retried = wire.RemoteIndex(client, block_tokens=16,
                               retry=RingRetryPolicy(max_retries=8, base_backoff=0.01))
    timer = threading.Timer(0.03, lambda: clock.update(t=2.5))
    timer.start()
    try:
        assert retried.lookup_many(keys) == [None, None]
    finally:
        timer.cancel()
    assert client.stats.retries >= 1 and client.stats.timeouts == 0


# ---------------------------------------------------------------------------
# RealEngine with its index behind a ring, under the injector's windows
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engine_prompts():
    from repro_torch.configs.registry import reduced_config
    from repro_torch.serving.real_runner import RealEngine

    cfg = reduced_config("llama3.1-8b")
    eng = RealEngine.create(cfg, max_len=96, pool_blocks=64, device="cpu", seed=0)
    rng = np.random.default_rng(0)
    fresh = lambda n: rng.integers(0, cfg.vocab_size, size=n).tolist()  # noqa: E731
    shared = fresh(32)
    p0, p1 = shared + fresh(32), fresh(64)
    p2, p3 = shared + fresh(32), shared + fresh(32)
    return eng, [p0, p1, p2, p3, p0, p1], [0, 0, 32, 32, 64, 64]


def test_engine_over_a_ring_under_delay_and_drop_windows(engine_prompts):
    from repro_torch.experiments import ring_serve as rs

    eng, prompts, want_hits = engine_prompts
    clean, plane = rs.serve(eng, prompts, 6, n_shards=1)
    try:
        hits = prompts[4:]
        base = rs.faulted(eng, plane, hits * 3, 6, ft.FaultPlan([]))
        delay = 0.001
        slow = rs.faulted(eng, plane, hits, 6, ft.FaultPlan(
            [ft.FaultEvent(0.0, "delay", 0, duration=60.0, delay_s=delay)]))
        budget = RingRetryPolicy().budget()
        window = 0.05
        assert window < budget
        dropped = rs.faulted(eng, plane, hits, 6, ft.FaultPlan(
            [ft.FaultEvent(0.0, "drop", 0, duration=window)]))
    finally:
        plane.close()
    assert [r["hit_tokens"] for r in clean] == want_hits
    for i, (s, d) in enumerate(zip(slow, dropped)):
        want = clean[4 + i]
        assert s["tokens"] == d["tokens"] == want["tokens"]
        assert torch.equal(s["logits"], want["logits"]) and torch.equal(d["logits"], want["logits"])
        assert s["hit_tokens"] == d["hit_tokens"] == 64
        assert s["round_trips"] == 1 and s["retries"] == 0
        floor = min(b["index_s"] - b["wait_s"] for b in base[i::2])
        assert s["index_s"] - s["wait_s"] - floor >= s["round_trips"] * delay
        assert d["retries"] >= 1 and d["ttft_s"] >= window


@pytest.mark.parametrize("n_shards", [1, 4])
def test_engine_over_rings_equals_in_process_index(engine_prompts, n_shards):
    """The same tokens, logits (bit for bit), hits and pool block ids with the
    in-process ``PrefixIndex`` and with a ``RemoteIndex`` over one ring or a
    ``ShardedRemoteIndex`` over 4, each on a fresh pool; a request costs
    one round trip a ring for a match and one for a publish."""
    from repro_torch.experiments import ring_serve as rs

    eng, prompts, want_hits = engine_prompts
    local, _ = rs.serve(eng, prompts, 6)
    remote, plane = rs.serve(eng, prompts, 6, n_shards=n_shards)
    assert plane.close() == []
    assert len(plane.servers) == n_shards and not any(s.alive() for s in plane.servers)
    for a, b in zip(local, remote):
        assert (a["tokens"], a["hit_tokens"], a["block_ids"], a["epochs"]) == \
            (b["tokens"], b["hit_tokens"], b["block_ids"], b["epochs"])
        assert torch.equal(a["logits"], b["logits"])
        assert a["round_trips"] == 0
    assert [r["hit_tokens"] for r in remote] == want_hits
    # a full hit matches once on each ring that holds a key of its chain;
    # a cold request also publishes there
    from repro_torch.core.index import chain_keys, shard_of_key

    rings = [len({shard_of_key(k, n_shards) for k in chain_keys(p, 16)}) for p in prompts]
    assert [r["round_trips"] for r in remote][4:] == rings[4:]
    assert all(r["round_trips"] <= 2 * n for r, n in zip(remote, rings))
    assert all(r["mean_wait_s"] > 0 for r in remote)
