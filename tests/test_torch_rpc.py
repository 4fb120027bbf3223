"""The port's CXL-RPC ring against the JAX package's:

* the ring's own rules, as ``tests/test_wire.py:434-620`` pins them for
  JAX: a handler's failure comes back in-band and the server thread lives
  on; ``RingStats`` count errors and timeouts with their waits; an error
  frame is cut on a UTF-8 character boundary; ``post`` / ``collect`` keep
  several requests outstanding; a timed-out slot stays quarantined until
  the server answers it; a dead service or a swapped ring fails fast;
* several threads, each with its own client over a disjoint
  ``slot_range`` of one ring (the port's clients have one owner);
* interop over one named segment, both ways: the port's ``RemoteIndex``
  against JAX's ``CxlRpcServer`` serving a ``GlobalIndex``, and JAX's
  ``RpcIndexClient`` against the port's ``RingServer`` serving a
  ``PrefixIndex``, each on a seeded op stream whose results and stats equal
  the same stream run in process;
* the coherent writer and reader against JAX's over payload pools, by
  bytes, modeled costs, stale epochs and retries;
* the exp01 / exp02 twins' rows string-equal to ``benchmarks/``'s; exp11's
  rows (reduced), its MODELED constants, an unknown transport and a chaos
  sweep without a shard refused; ``examples/pool_demo.py``'s twin on the
  CPU.
"""

from __future__ import annotations

import sys
import threading
import time

import numpy as np
import pytest
import torch

import benchmarks.exp01_coherence as jexp01
import benchmarks.exp02_latency as jexp02
from repro.core import coherence as jcoh
from repro.core import fabric as jfabric
from repro.core import wire as jwire
from repro.core.index import GlobalIndex
from repro.core.pool import BelugaPool, PoolLayout
from repro.core.rpc import CxlRpcClient, CxlRpcServer, ModeledRdmaRpc, ShmRing
from repro_torch.core import coherence, fabric, wire
from repro_torch.core.index import PrefixIndex, chain_keys
from repro_torch.core.pool import KVBlockLayout, KVBlockPool
from repro_torch.core.rpc import (
    RESP_READY,
    RdmaRpcModel,
    RingClient,
    RingError,
    RingServer,
    RingServiceDied,
    SlotRing,
)
from repro_torch.experiments import exp01_coherence, exp02_latency, exp11_rpc

torch.set_num_threads(1)

LAYOUT = KVBlockLayout(block_tokens=16, n_layers_kv=4, n_kv_heads=2, head_dim=8)
JLAYOUT = PoolLayout(block_tokens=16, n_layers_kv=4, n_kv_heads=2, head_dim=8)


class Served:
    """A port ring served by a thread, stopped on exit."""

    def __init__(self, handler, n_slots=4, payload_bytes=64, **kw):
        self.ring = SlotRing(n_slots, payload_bytes)
        self.server = RingServer(self.ring, handler, **kw)

    def __enter__(self):
        self.server.start()
        return self

    def __exit__(self, *exc):
        self.server.stop()


def _wait_for(cond, timeout=5.0):
    deadline = time.perf_counter() + timeout
    while not cond():
        assert time.perf_counter() < deadline, "timed out waiting"
        time.sleep(0.001)


# ---------------------------------------------------------------------------
# the ring's rules
# ---------------------------------------------------------------------------


def test_server_survives_handler_failure():
    pool = KVBlockPool(LAYOUT, 64, "meta", n_shards=4)
    idx = PrefixIndex(pool)
    keys = list(chain_keys(list(range(64)), 16))
    blocks = pool.allocate(4)
    idx.publish_many(keys, blocks, pool.write_blocks(blocks), 16)
    with Served(wire.make_index_handler(idx), payload_bytes=1024) as s:
        client = RingClient(s.ring)
        with pytest.raises(RingError, match="WireFormatError"):
            client.call(wire.encode_match(keys)[:10])
        assert s.server.alive()
        assert len(wire.RemoteIndex(client, 16).match_prefix(list(range(64)))) == 4
        assert client.free_slots() == s.ring.n_slots
    assert not s.server.alive()


def test_stats_account_failed_round_trips():
    gate = threading.Event()

    def handler(payload: bytes) -> bytes:
        if payload == b"hang":
            gate.wait(5)
            return b"late"
        if payload == b"boom":
            raise ValueError("no")
        return payload

    with Served(handler, n_slots=2) as s:
        try:
            client = RingClient(s.ring)
            client.call(b"fine")
            with pytest.raises(RingError, match="ValueError: no"):
                client.call(b"boom")
            wait_after_error = client.stats.total_wait
            with pytest.raises(TimeoutError):
                client.call(b"hang", timeout=0.05)
            st = client.stats
            assert (st.requests, st.errors, st.timeouts, st.round_trips) == (1, 1, 1, 3)
            assert st.total_wait >= wait_after_error + 0.05
            assert st.avg_wait() == st.total_wait / 3
        finally:
            gate.set()


def test_error_frame_is_cut_on_a_character_boundary():
    boom = "кэш-блок недействителен: " + "デ" * 40

    def handler(payload: bytes) -> bytes:
        raise RuntimeError(boom)

    with Served(handler, n_slots=1) as s:
        with pytest.raises(RingError) as ei:
            RingClient(s.ring).call(b"x")
    msg = str(ei.value)
    assert "�" not in msg and msg.startswith("RuntimeError: кэш-блок")
    assert len(msg.encode()) <= s.ring.payload_bytes
    assert f"RuntimeError: {boom}".startswith(msg)


def test_post_collect_keeps_requests_outstanding():
    with Served(lambda p: b"ok:" + p) as s:
        client = RingClient(s.ring)
        slots = [client.post(bytes([65 + i]) * 4) for i in range(3)]
        outs = [client.collect(sl) for sl in reversed(slots)]
    assert outs == [b"ok:CCCC", b"ok:BBBB", b"ok:AAAA"]
    assert client.free_slots() == 4 and client.stats.requests == 3


def test_timeout_quarantines_the_slot_until_the_server_answers():
    release = threading.Event()

    def slow(payload: bytes) -> bytes:
        release.wait(5)
        return b"LATE:" + payload

    with Served(slow, n_slots=1) as s:
        try:
            client = RingClient(s.ring)
            with pytest.raises(TimeoutError):
                client.call(b"victim", timeout=0.05)
            assert client.stats.timeouts == 1 and client.free_slots() == 0
            with pytest.raises(RuntimeError, match="QD exceeded"):
                client.call(b"second")
            release.set()
            _wait_for(lambda: s.ring.status[0] == RESP_READY)
            # the next acquire reclaims the slot; the late answer is dropped
            assert client.call(b"fresh", timeout=5) == b"LATE:fresh"
            assert client.free_slots() == 1
        finally:
            release.set()


def test_a_dead_service_fails_fast_and_frees_quarantined_slots():
    ring = SlotRing(2, 64)  # no server: nothing will ever answer
    alive = {"up": True}
    client = RingClient(ring, liveness=lambda: alive["up"])
    with pytest.raises(TimeoutError):
        client.call(b"a", timeout=0.02)
    assert client.free_slots() == 1
    alive["up"] = False
    t0 = time.perf_counter()
    with pytest.raises(RingServiceDied, match="died"):
        client.call(b"b", timeout=30.0)
    assert time.perf_counter() - t0 < 5.0 and client.stats.errors == 1
    # with the service gone, its quarantined slots are safe to reuse
    slot = client.post(b"c")
    assert client.free_slots() == 1 and slot in (0, 1)


def test_adopt_ring_fails_an_outstanding_call_and_keeps_the_range():
    old = SlotRing(8, 64)
    client = RingClient(old, slot_range=(2, 6))
    slot = client.post(b"x")
    assert 2 <= slot < 6 and client.slot_range == (2, 6)
    with Served(lambda p: p[::-1], n_slots=8) as s:
        client.adopt_ring(s.ring)
        with pytest.raises(RingServiceDied, match="swapped"):
            client.collect(slot)
        assert client.stats.restarts == 1 and client.free_slots() == 4
        assert client.call(b"abc") == b"cba"
    with pytest.raises(ValueError, match="slot_range"):
        RingClient(old, slot_range=(6, 9))


def test_threads_with_their_own_clients_share_one_ring():
    """Twelve threads (more than the cores of an 8-core host), each owning a
    client over 4 of the 48 slots and trading the GIL every 10 us, keep their
    share outstanding; every answer reaches its own caller. A client out of
    slots is refused while the others go on."""
    gate = threading.Event()

    def handler(payload: bytes) -> bytes:
        if payload == b"block":
            gate.wait(5)
        return bytes((x + 1) % 256 for x in payload)

    n_threads, per = 12, 40
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # threads trade the GIL often: a lost slot would show
    with Served(handler, n_slots=48) as s:
        try:
            ranges = exp11_rpc.slot_ranges(48, n_threads)
            blocker = RingClient(s.ring, slot_range=ranges[0])
            held = [blocker.post(b"block") for _ in range(4)]
            with pytest.raises(RuntimeError, match="QD exceeded"):
                blocker.post(b"extra")
            gate.set()
            assert [blocker.collect(h) for h in held] == [b"cmpdl"] * 4
            errors, outs = [], [[] for _ in range(n_threads)]

            def worker(i):
                try:
                    c = RingClient(s.ring, slot_range=ranges[i])
                    for j in range(per):
                        sl = [c.post(bytes([i, j, k])) for k in range(3)]
                        outs[i].append([c.collect(x) for x in sl])
                    assert c.free_slots() == ranges[i][1] - ranges[i][0]
                except BaseException as e:  # noqa: BLE001 - reported below
                    errors.append(e)

            ts = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
        finally:
            gate.set()
            sys.setswitchinterval(switch)
    assert not errors and not any(t.is_alive() for t in ts)
    for i in range(n_threads):
        assert outs[i] == [[bytes([i + 1, j + 1, k + 1]) for k in range(3)] for j in range(per)]


def test_modeled_rdma_rpc_equals_reference():
    for transport in ("rc", "ud"):
        mine, ref = RdmaRpcModel(lambda p: p * 2, transport), ModeledRdmaRpc(lambda p: p * 2,
                                                                             transport)
        for p in (b"a", b"bc"):
            assert mine.call(p) == ref.call(p)
        assert (mine.rtt, mine.stats.requests, mine.stats.total_wait) == \
            (ref.rtt, ref.stats.requests, ref.stats.total_wait)
    assert RingClient(SlotRing(1, 64)).modeled_rtt() == jfabric.DEFAULT.cxl_rpc_rtt


def test_shared_layout_equals_reference():
    for n, p in ((1, 64), (64, 1 << 16), (7, 100)):
        assert SlotRing.shared_size(n, p) == ShmRing.shared_size(n, p)
        assert SlotRing(n, p).slot_bytes == ShmRing(n, p).slot_bytes


# ---------------------------------------------------------------------------
# interop over one named segment
# ---------------------------------------------------------------------------


def _norm(x):
    """Results of either package's index calls in one comparable form."""
    if isinstance(x, np.ndarray):
        return x.tolist()
    if hasattr(x, "block_id"):
        return (int(x.block_id), int(x.epoch), int(x.n_tokens))
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


def _snapshot(idx):
    if hasattr(idx, "snapshot_all"):
        return [list(e) for e in idx.snapshot_all()]
    _, keys, ids, eps, ntk = idx.snapshot_entries(0, 1 << 30)
    return [list(e) for e in zip(keys, ids, eps, ntk)]


def _drive(idx, pool, seed: int, paged: bool = True) -> list:
    """A seeded stream of every op the wire carries, against one index
    (without ``paged``, none of the snapshot / restore / seed-stats ops,
    which a sharded front lacks, as JAX's does)."""
    rng = np.random.default_rng(seed)
    out = []
    chains = []
    for step in range(60):
        op = int(rng.integers(0, 10)) if chains else 0
        if op in (0, 1):  # publish a chain, some of it over an older one
            base = chains[int(rng.integers(len(chains)))][: int(rng.integers(0, 3)) * 16] \
                if chains and rng.random() < 0.5 else []
            tokens = base + rng.integers(0, 1000, size=16 * int(rng.integers(1, 6))).tolist()
            keys = list(chain_keys(tokens, 16))
            if pool.free_blocks() < len(keys):
                out.append(("evict", _norm(idx.evict_lru(len(keys)))))
                continue
            blocks = pool.allocate(len(keys))
            idx.publish_many(keys, blocks, pool.write_blocks(blocks), 16)  # the index's now
            chains.append(tokens)
            out.append(("publish", blocks))
        elif op == 2:
            keys = list(chain_keys(chains[int(rng.integers(len(chains)))], 16))
            out.append(("match", _norm(idx.match_prefix_keys(keys))))
        elif op == 3:
            keys = list(chain_keys(chains[int(rng.integers(len(chains)))], 16)) + [b"z" * 16]
            out.append(("lookup", _norm(idx.lookup_many(keys))))
            out.append(("filter", idx.filter_unpublished(keys)))
        elif op == 4:
            out.append(("evict", _norm(idx.evict_lru(int(rng.integers(0, 4))))))
        elif op == 5:
            ids = rng.integers(0, pool.n_blocks, size=6).tolist()
            out.append(("owners", _norm(idx.owners_of(ids))))
        elif op == 6:
            ids = rng.integers(0, pool.n_blocks, size=4).tolist()
            owned = [(k, b, e) for k, b, e in zip(*idx.owners_of(ids))
                     if pool.validate_epochs([b], [e])[0] and pool.refcounts[b] == 1]
            keys, bids, eps = (list(x) for x in zip(*owned)) if owned else ([], [], [])
            if keys and pool.free_blocks() >= len(keys):
                new = pool.allocate(len(keys))
                new_eps = pool.write_blocks(new)
                stale = [e + (i % 2) for i, e in enumerate(eps)]  # every other one loses
                ok = idx.remap_many(keys, bids, stale, new, new_eps)
                pool.release([b for b, o in zip(bids, ok) if o] + [n for n, o in zip(new, ok)
                                                                   if not o])
                out.append(("remap", _norm(ok)))
        elif op == 7:
            ids = rng.integers(0, pool.n_blocks, size=5).tolist()
            out.append(("evict_blocks", _norm(idx.evict_blocks(ids))))
        elif op == 8 or not paged:
            out.append(("stats", _norm(idx.stats())))
        else:
            out.append(("snapshot", _norm(_snapshot(idx))))
    if not paged:
        return out + [("pool", pool.refcounts.tolist(), pool.epochs.tolist(), pool.free_blocks())]
    snap = _snapshot(idx)
    keys = [e[0] for e in snap[:5]]
    idx.restore_entries(keys, [e[1] for e in snap[:5]], [e[2] for e in snap[:5]],
                        [e[3] + 1 for e in snap[:5]])
    idx.seed_stats(7, 11)
    out.append(("restored", _norm(_snapshot(idx)), _norm(idx.stats())))
    out.append(("pool", pool.refcounts.tolist(), pool.epochs.tolist(), pool.free_blocks()))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_client_against_jax_server_over_one_segment(seed):
    jring = ShmRing.create_shared(n_slots=8, payload_bytes=1024)
    try:
        jpool = BelugaPool(JLAYOUT, n_blocks=128, n_shards=8, backing="meta")
        server = CxlRpcServer(jring, jwire.make_index_handler(
            GlobalIndex(jpool), max_reply=jring.payload_bytes)).start()
        ring = SlotRing.attach(jring.shm_name, 8, 1024)
        try:
            client = RingClient(ring)
            got = _drive(wire.RemoteIndex(client, 16), jpool, seed)
        finally:
            server.stop()
            ring.close()
        ref_pool = BelugaPool(JLAYOUT, n_blocks=128, n_shards=8, backing="meta")
        assert got == _drive(GlobalIndex(ref_pool), ref_pool, seed)
        assert client.stats.requests > 60 and client.stats.errors == 0
    finally:
        jring.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_jax_client_against_port_server_over_one_segment(seed):
    ring = SlotRing.create_shared(n_slots=8, payload_bytes=1024)
    try:
        pool = KVBlockPool(LAYOUT, 128, "meta", n_shards=8)
        server = RingServer(ring, wire.make_index_handler(
            PrefixIndex(pool), max_reply=ring.payload_bytes)).start()
        jring = ShmRing.attach(ring.shm_name, 8, 1024)
        try:
            jclient = CxlRpcClient(jring)
            got = _drive(jwire.RpcIndexClient(jclient, 16), pool, seed)
        finally:
            server.stop()
            jring.close()
        ref_pool = KVBlockPool(LAYOUT, 128, "meta", n_shards=8)
        want = _drive(PrefixIndex(ref_pool), ref_pool, seed)
        assert got == want
        jpool = BelugaPool(JLAYOUT, n_blocks=128, n_shards=8, backing="meta")
        assert want == _drive(GlobalIndex(jpool), jpool, seed)
        assert jclient.stats.requests > 60 and jclient.stats.errors == 0
    finally:
        ring.close()


# ---------------------------------------------------------------------------
# coherence
# ---------------------------------------------------------------------------


def _payload_pools(seed):
    jpool = BelugaPool(JLAYOUT, n_blocks=32, n_shards=8, backing="numpy")
    pool = KVBlockPool(LAYOUT, 32, "cpu", n_shards=8)
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((4, *LAYOUT.block_shape)).astype(np.float32)
    bf = torch.from_numpy(rows).to(torch.bfloat16)
    raw = bf.view(torch.int16).numpy().view(np.uint8).reshape(4, -1)
    return jpool, pool, bf, raw


@pytest.mark.parametrize("wmethod,rmethod", [("ntstore", "clflush"), ("clflush", "uncacheable"),
                                             ("uncacheable", "dsa"), ("dsa", "clflush")])
def test_coherent_writer_and_reader_equal_reference(wmethod, rmethod):
    jpool, pool, bf, raw = _payload_pools(0)
    jw, jr = jcoh.CoherentWriter(jpool, wmethod), jcoh.CoherentReader(jpool, rmethod)
    w, r = coherence.CoherentBlockWriter(pool, wmethod), coherence.CoherentBlockReader(pool, rmethod)
    jids, ids = jpool.allocate(4), pool.allocate(4)
    assert jids == ids
    jeps = [jw.write_block(b, raw[i]) for i, b in enumerate(jids)]
    eps = [w.write_block(b, bf[i]) for i, b in enumerate(ids)]
    assert jeps == eps
    for i, (b, e) in enumerate(zip(ids, eps)):
        got = r.read_block(b, e)
        assert torch.equal(got, bf[i])
        assert np.array_equal(got.view(torch.int16).numpy().view(np.uint8).reshape(-1),
                              jr.read_block(b, e))
    # a recycled block: both readers refuse the stale epoch
    for p in (jpool, pool):
        p.release([ids[0]])
    with pytest.raises(jcoh.CoherenceError, match="no longer valid"):
        jr.read_block(ids[0], eps[0])
    with pytest.raises(coherence.StaleEpochError, match="no longer valid"):
        r.read_block(ids[0], eps[0])
    assert vars(w.stats) == vars(jw.stats) and vars(r.stats) == vars(jr.stats)


def test_coherent_reader_retries_a_moving_epoch_as_reference():
    jpool, pool, bf, raw = _payload_pools(1)
    [jb], [b] = jpool.allocate(1), pool.allocate(1)
    je = jcoh.CoherentWriter(jpool).write_block(jb, raw[0])
    e = coherence.CoherentBlockWriter(pool).write_block(b, bf[0])
    jread, read = jpool.read_block, pool.read_blocks
    jpool.read_block = lambda bid: (jread(bid)[0], jread(bid)[1] + 1)  # recycled meanwhile
    pool.read_blocks = lambda ids: (read(ids)[0], read(ids)[1] + 1)
    jr, r = jcoh.CoherentReader(jpool), coherence.CoherentBlockReader(pool)
    with pytest.raises(jcoh.CoherenceError, match="unstable epoch"):
        jr.read_block(jb, je)
    with pytest.raises(coherence.StaleEpochError, match="unstable epoch"):
        r.read_block(b, e)
    assert vars(r.stats) == vars(jr.stats) and r.stats.retries == 3


# ---------------------------------------------------------------------------
# the experiment twins and the example
# ---------------------------------------------------------------------------


def test_exp01_exp02_rows_equal_reference():
    assert exp01_coherence.run() == jexp01.run()
    assert exp02_latency.run() == jexp02.run()


def test_fabric_prices_equal_reference():
    sizes = [64, 1000, 16384, 24 * 1024, 1 << 20]
    for s in sizes:
        for m in ("ntstore", "clflush", "uncacheable", "dsa"):
            assert fabric.cpu_write_latency(s, m) == jfabric.cpu_write_latency(s, m)
        for m in ("clflush", "uncacheable", "dsa"):
            assert fabric.cpu_read_latency(s, m) == jfabric.cpu_read_latency(s, m)
        for n in (1, 3, 64):
            for m in ("fused_kernel", "cudamemcpy"):
                for d in ("read", "write"):
                    assert fabric.gpu_transfer_latency(s, n, m, d) == \
                        jfabric.gpu_transfer_latency(s, n, m, d)
        assert fabric.local_dram_latency(s) == jfabric.local_dram_latency(s)
    for bad in (lambda: fabric.cpu_write_latency(1, "x"), lambda: fabric.cpu_read_latency(1, "x"),
                lambda: fabric.gpu_transfer_latency(1, 1, "x")):
        with pytest.raises(ValueError):
            bad()
    c = jfabric.DEFAULT
    assert (fabric.CXL_RPC_RTT, fabric.RDMA_RC_RPC_RTT, fabric.RDMA_UD_RPC_RTT) == \
        (c.cxl_rpc_rtt, c.rdma_rc_rpc_rtt, c.rdma_ud_rpc_rtt)


def test_exp11_thread_rows_and_refusals():
    rows, res = exp11_rpc.run(fast=True)
    names = [r[0] for r in rows]
    # the process rows and the chaos sweep are ported: the reference's whole
    # list (test_torch_procserver.py checks those sections' results)
    assert names == ["exp11.match_prefix_rtt_qd1", "exp11.match_prefix_chain",
                     "exp11.publish_many_chain", "exp11.threaded_match",
                     "exp11.modeled_rtt_comparison", "exp11.client_accounting",
                     "exp11.shard_sweep.s1", "exp11.shard_sweep.s2", "exp11.shard_sweep.s4",
                     "exp11.shard_sweep_process.s1", "exp11.shard_sweep_process.s2",
                     "exp11.shard_sweep_process.s4", "exp11.shard_scaling",
                     "exp11.chaos_recovery"]
    c = jfabric.DEFAULT
    assert rows[4] == ("exp11.modeled_rtt_comparison", f"{c.cxl_rpc_rtt*1e6:.2f}",
                       f"cxl=2.11us vs rdma_rc={c.rdma_rc_rpc_rtt*1e6:.2f}us "
                       f"vs rdma_ud={c.rdma_ud_rpc_rtt*1e6:.2f}us (4.0x, Fig. 15)")
    assert res["n_keys"] == 128 and res["match"]["speedup"] > 1.0
    assert res["client_stats"]["errors"] == res["client_stats"]["timeouts"] == 0
    for cell in res["shard_sweep"] + res["shard_sweep_process"]:
        assert cell["errors"] == cell["timeouts"] == 0 and all(cell["served_per_shard"])
        assert cell["capacity_keys_per_s"] > 0
    ch = res["chaos"]  # a watched shard killed under load recovers
    assert ch["restarts"] == 1 and ch["recovery_s"] is not None and ch["n_keys"] == 937
    # both transports are ported (test_torch_procserver.py runs the process
    # rows and the chaos sweep): an unknown transport, and a chaos sweep
    # without a shard, are refused
    with pytest.raises(ValueError, match="unknown transport"):
        exp11_rpc.shard_sweep(256, True, transport="carrier-pigeon")
    with pytest.raises(ValueError, match="at least one"):
        exp11_rpc.chaos_sweep(256, True, n_shards=0)


def test_pool_demo_runs_on_the_cpu(capsys):
    from repro_torch.examples import pool_demo

    pool_demo.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "payload bit-exact" in out and "in 1 round trip" in out
    assert "stale read rejected" in out and "ERROR" not in out
