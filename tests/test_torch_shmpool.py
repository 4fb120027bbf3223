"""The shared data plane's pieces against the JAX package's, in one process.

Twins of the unit tests of ``tests/test_engineproc.py`` and
``tests/test_workerheal.py`` (their cluster tests are in
``tests/test_torch_engineproc.py``), each with the same scenario:

* the FIFO doorbell: a parked waiter wakes well inside its ceiling, by the
  port's producer and by the reference's; a producer with no reader is
  safe; only the creator unlinks;
* ``share_data``: stores on either side of a mapping are the same bytes,
  and JAX's ``SharedPoolData`` reads the port's segment (and the port's
  ``SharedPoolSegment`` JAX's) byte for byte; ``unshare_data`` copies back
  and unlinks; a payload off the CPU is refused as the reference refuses a
  non-numpy backing; a tier chain's segment joins the tiers in id order;
* the pool and journal ops: every encoder's bytes are JAX's, the handler's
  replies to one op stream (flat and tiered) are byte for byte JAX's, the
  journal ops append JAX's records, and JAX's ``PoolRpcClient`` is served by
  the port's ``make_pool_handler`` over one named ring (and the port's
  ``RemotePool`` by JAX's), an exhausted pool raising each side's own
  error; a chunked allocation rolls back whole; slot partitions share a
  ring between threads; ``WorkerPool`` has the whole pool surface;
* ``LeaseLedger``'s epoch rules, equal to ``WorkerLeaseLedger``'s on the
  same scenario; a journal publish ends a lease with no lock; the reconcile
  drops the worker's entry before it probes the index and hands its
  releases to ``release``;
* a client on a dead ring keeps its narrow slot partition; an injector's
  drop window reaches a pipelined read; the reference's refusals of the
  data plane's and the workers' settings, message for message;
* self-healing workers (``test_workerheal.py``'s cluster tests, with the
  helpers and the time limit of ``tests/test_torch_engineproc.py``): a
  worker killed between submits or in the middle of a drain converges with
  the run without the fault (every request done, the same free blocks,
  its leases reconciled), a shard killed under live workers reaches them as
  ``WCMD_ADOPT``, the allocator moves to a fresh ring under them, a RESULTS
  page posted to a dead worker fails fast and retryably, and only requests
  not yet seen done are replayed. A worker's restart is driven by the
  supervisor's ``check()`` or by a command that finds it dead, never by a
  probe thread's timing.
"""

from __future__ import annotations

import os
import struct
import threading
import time
from multiprocessing import shared_memory

import numpy as np
import pytest
import torch

from repro.core import wire as jwire
from repro.core.index import GlobalIndex
from repro.core.pool import BelugaPool, OutOfPoolMemory, PoolLayout
from repro.core.rpc import CxlRpcClient, CxlRpcServer, ShmRing
from repro.core.shm import Doorbell, ShardJournal
from repro.core.shmpool import SharedPoolData, WorkerLeaseLedger
from repro.serving.engineproc import partition_slots as jpartition_slots
from repro.serving.scheduler import Cluster as JCluster
from repro.serving.scheduler import ClusterConfig as JClusterConfig
from repro.tiering import TieredPool as JTieredPool
from repro.tiering import TieringConfig as JTieringConfig
from repro_torch.core import wire
from repro_torch.core.index import PrefixIndex
from repro_torch.core.pool import KVBlockLayout, KVBlockPool, PoolExhausted
from repro_torch.core.rpc import RingClient, RingRetryPolicy, RingServer, RingServiceDied, SlotRing
from repro_torch.core.shm import FifoDoorbell, PublishJournal
from repro_torch.core.shmpool import LeaseLedger, SharedPoolSegment, WorkerPool
from repro_torch.distributed.fault_tolerance import FaultEvent, FaultInjector, FaultPlan
from repro_torch.experiments import exp14_procengine as exp14
from repro_torch.serving import engineproc
from repro_torch.serving.engineproc import partition_slots
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import Cluster, ClusterConfig
from repro_torch.tiering import TieredPool, TieringConfig
from tests.test_torch_engineproc import _cluster, _hygiene, _serve, _workload, time_limit  # noqa: F401

torch.set_num_threads(1)

LAYOUT = KVBlockLayout(block_tokens=8, n_layers_kv=2, n_kv_heads=2, head_dim=8)
JLAYOUT = PoolLayout(block_tokens=8, n_layers_kv=2, n_kv_heads=2, head_dim=8, dtype_bytes=2)


def _gone(name: str) -> bool:
    try:
        seg = shared_memory.SharedMemory(name=name)
    except FileNotFoundError:
        return True
    seg.close()
    return False


def _rows(pool, ids) -> np.ndarray:
    """A pool's payload rows as bytes, (n, block_bytes)."""
    rows, _ = pool.read_blocks(ids)
    return rows.reshape(len(ids), -1).view(torch.uint8).numpy()


# ---------------------------------------------------------------------------
# the FIFO doorbell
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("producer", ["port", "jax"])
def test_doorbell_wakes_parked_waiter_within_ceiling(producer):
    bell = FifoDoorbell.create()
    try:
        bell.open_read()
        woke = []

        def park():
            t0 = time.perf_counter()
            bell.wait(5.0)  # a ceiling far above the expected wake
            woke.append(time.perf_counter() - t0)

        t = threading.Thread(target=park)
        t.start()
        time.sleep(0.05)  # let it block on the FIFO
        if producer == "port":
            p = FifoDoorbell.attach(bell.path)
            assert p.set()
        else:  # the reference's producer rings the port's FIFO by path
            p = Doorbell.attach(bell.path)
            p.ring()
        t.join(timeout=5)
        assert not t.is_alive()
        p.close()
        assert woke and woke[0] < 1.0, woke  # rung, not timed out
    finally:
        bell.close()
    assert not os.path.exists(bell.path)


def test_doorbell_ring_with_no_reader_is_safe_and_attacher_never_unlinks():
    bell = FifoDoorbell.create()
    producer = FifoDoorbell.attach(bell.path)
    assert producer.set() is False  # nobody listens: no raise, no block
    assert producer.set() is False
    producer.close()
    assert os.path.exists(bell.path)  # an attacher's close never unlinks
    bell.close()
    assert not os.path.exists(bell.path)
    bell.close()  # twice is safe


# ---------------------------------------------------------------------------
# the shared payload segment
# ---------------------------------------------------------------------------


def test_share_data_zero_copy_both_directions():
    pool = KVBlockPool(LAYOUT, 64, "cpu", n_shards=4)
    spec = pool.share_data()
    view = SharedPoolSegment(spec)
    jview = SharedPoolData(spec)  # the reference's attach side, same segment
    try:
        ids = pool.allocate(2)
        payload = torch.arange(2 * LAYOUT.block_bytes // 2, dtype=torch.int16).view(
            torch.bfloat16).view(2, *LAYOUT.block_shape)
        # attach-side store, owner-side load: the same bytes, no copy
        eps = view.write_blocks(ids, payload)
        assert torch.equal(pool.read_blocks(ids)[0].view(torch.int16),
                           payload.view(torch.int16))
        assert pool.validate_epochs(ids, eps).all()
        assert np.array_equal(jview.data[ids], _rows(pool, ids))
        assert jview.validate_epochs(ids, eps).all()
        # owner-side store, attach-side load
        pool.data[ids[0]].view(torch.int16).bitwise_xor_(-1)
        got, eps2 = view.read_blocks([ids[0]])
        assert torch.equal(got[0].view(torch.int16), payload[0].view(torch.int16) ^ -1)
        assert int(eps2[0]) == eps[0]
        assert np.array_equal(jview.read_blocks([ids[0]])[0][0], _rows(pool, [ids[0]])[0])
        # fragments: the reference's (k, fragment_bytes) rows, the port's typed
        frags = view.read_fragments(ids[1], [0, 3])
        assert np.array_equal(frags.reshape(2, -1).view(torch.uint8).numpy(),
                              jview.read_fragments(ids[1], [0, 3]))
    finally:
        jview.close()
        view.close()
        assert not _gone(spec["data_shm_name"])  # an attacher's close never unlinks
        pool.unshare_data()
        pool.unshare_meta()
    assert _gone(spec["data_shm_name"]) and _gone(spec["meta"]["shm_name"])


def test_port_attaches_the_reference_s_segment():
    jpool = BelugaPool(JLAYOUT, n_blocks=32, n_shards=4, backing="numpy")
    spec = jpool.share_data()
    view = SharedPoolSegment(spec)
    try:
        ids = jpool.allocate(3)
        jpool.write_blocks(ids, np.random.default_rng(0).integers(
            0, 256, (3, JLAYOUT.block_bytes), dtype=np.uint8))
        got, eps = view.read_blocks(ids)
        assert np.array_equal(got.reshape(3, -1).view(torch.uint8).numpy(), jpool.data[ids])
        assert eps.tolist() == jpool.epochs[ids].tolist()
        view.write_blocks(ids[:1])  # a publish from the port's side
        assert jpool.validate_epoch(ids[0], int(eps[0]) + 1)
    finally:
        view.close()
        jpool.unshare_data()
        jpool.unshare_meta()
    assert _gone(spec["data_shm_name"])


def test_unshare_data_copies_payloads_back():
    pool = KVBlockPool(LAYOUT, 16, "cpu", n_shards=4)
    spec = pool.share_data()
    view = SharedPoolSegment(spec)
    ids = pool.allocate(1)
    view.write_blocks(ids, torch.full((1, *LAYOUT.block_shape), 7.0, dtype=torch.bfloat16))
    view.close()
    pool.unshare_data()
    pool.unshare_meta()
    assert (pool.read_blocks(ids)[0] == 7.0).all()  # survived the unshare
    assert pool.validate_epochs(ids, [int(pool.epochs[ids[0]])]).all()
    assert _gone(spec["data_shm_name"])
    pool.unshare_data()  # twice is safe


@pytest.mark.parametrize("tiered", [False, True])
def test_share_data_requires_numpy_backing(tiered):
    if tiered:
        pool = TieredPool(LAYOUT, 16, 16, "meta", n_shards=4)
        jpool = JTieredPool(JLAYOUT, 16, 16, n_shards=4, backing="meta",
                            cfg=JTieringConfig(enabled=True))
    else:
        pool = KVBlockPool(LAYOUT, 16, "meta", n_shards=4)
        jpool = BelugaPool(JLAYOUT, n_blocks=16, n_shards=4, backing="meta")
    with pytest.raises(ValueError, match="numpy"):
        jpool.share_data()
    with pytest.raises(ValueError, match="numpy"):
        pool.share_data()


def test_tiered_share_data_joins_the_tiers_in_id_order():
    cfg = dict(extra_tiers=((16, "ssd"),))
    pool = TieredPool(LAYOUT, 16, 32, "cpu", n_shards=4, cfg=TieringConfig(enabled=True, **cfg))
    jpool = JTieredPool(JLAYOUT, 16, 32, n_shards=4, backing="numpy",
                        cfg=JTieringConfig(enabled=True, **cfg))
    before = pool.allocate(6)
    pool.write_blocks(before, torch.randn(6, *LAYOUT.block_shape).to(torch.bfloat16))
    rows = _rows(pool, before)
    spec, jspec = pool.share_data(), jpool.share_data()
    try:
        assert spec["tiering"] == jspec["tiering"]
        assert {k: v for k, v in spec.items() if k not in ("data_shm_name", "meta")} == \
            {k: v for k, v in jspec.items() if k not in ("data_shm_name", "meta")}
        jview = SharedPoolData(spec)
        assert np.array_equal(jview.data[before], rows)  # kept across the move
        down = pool.tiers[1].allocate(2)
        pool.tiers[1].write_blocks(down, torch.ones(2, *LAYOUT.block_shape, dtype=torch.bfloat16))
        gids = [16 + b for b in down]  # the chain's global ids
        assert np.array_equal(jview.data[gids], _rows(pool, gids))
        jview.close()
    finally:
        pool.unshare_data()
        pool.unshare_meta()
        jpool.unshare_data()
        jpool.unshare_meta()
    assert np.array_equal(_rows(pool, before), rows)
    assert _gone(spec["data_shm_name"])


# ---------------------------------------------------------------------------
# the pool and journal ops
# ---------------------------------------------------------------------------


def _pool_encodings(mod, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 9))
    ks = [rng.bytes(16) for _ in range(n)]
    ids = rng.integers(0, 1 << 40, size=n).tolist()
    eps = rng.integers(-5, 1 << 40, size=n).tolist()
    shard = int(rng.integers(0, 1 << 32))
    return {
        "POOL_ALLOC": mod.encode_pool_alloc(int(rng.integers(0, 1 << 32))),
        "POOL_ALLOC_KEYS": mod.encode_pool_alloc_keys(ks),
        "POOL_TOUCH": mod.encode_pool_touch(ids, float(rng.normal())),
        "POOL_RETAIN": mod.encode_pool_retain(ids),
        "POOL_RELEASE": mod.encode_pool_release(ids),
        "POOL_FREE": mod.encode_pool_free(),
        "JRNL_PUBLISH": mod.encode_jrnl_publish(shard, ks, ids, eps,
                                                int(rng.integers(-(1 << 31), 1 << 31))),
        "JRNL_RETRACT": mod.encode_jrnl_retract(shard, ids),
        "JRNL_REMAP": mod.encode_jrnl_remap(shard, ks, ids[::-1], eps[::-1]),
    }


@pytest.mark.parametrize("seed", range(4))
def test_pool_frames_are_the_reference_s_bytes(seed):
    mine, ref = _pool_encodings(wire, seed), _pool_encodings(jwire, seed)
    assert mine == ref
    for name, frame in mine.items():
        assert frame[0] == getattr(jwire, "OP_" + name)
        assert wire.pool_reply_bound(frame) == jwire.pool_reply_bound(frame)


def _drive_pool(handler, seed: int, tiered: bool) -> list:
    """The replies to a seeded stream of legal pool frames: allocations,
    retains and releases of held blocks (the oldest first), free counts and,
    on a tier chain, keyed allocations and demand touches. An exhausted pool
    answers with its error's name."""
    rng = np.random.default_rng(seed)
    held: list[int] = []
    replies = []
    for step in range(60):
        r = rng.random()
        if r < 0.3 or not held:
            k = int(rng.integers(1, 6))
            keyed = tiered and rng.random() < 0.5
            frame = (wire.encode_pool_alloc_keys([rng.bytes(16) for _ in range(k)]) if keyed
                     else wire.encode_pool_alloc(k))
        elif r < 0.45:
            frame = wire.encode_pool_retain(
                rng.choice(held, size=min(3, len(held)), replace=False).tolist())
        elif r < 0.75:
            k = int(rng.integers(1, 4))
            frame = wire.encode_pool_release(held[:k])
            del held[:k]
        elif r < 0.85 and tiered:
            frame = wire.encode_pool_touch(
                rng.choice(held, size=min(4, len(held)), replace=False).tolist(), 0.01 * step)
        else:
            frame = wire.encode_pool_free()
        try:
            reply = handler(frame)
        except (PoolExhausted, OutOfPoolMemory):
            replies.append("exhausted")
            continue
        replies.append(reply)
        if frame[0] in (wire.OP_POOL_ALLOC, wire.OP_POOL_ALLOC_KEYS):
            held.extend(wire.decode_pool_alloc_resp(reply))
    return replies


@pytest.mark.parametrize("tiered", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_handler_replies_are_byte_equal_to_the_reference_s(seed, tiered):
    n = 64
    if tiered:
        pool = TieredPool(LAYOUT, 32, 32, "meta", n_shards=4)
        jpool = JTieredPool(JLAYOUT, 32, 32, n_shards=4, backing="meta",
                            cfg=JTieringConfig(enabled=True))
    else:
        pool = KVBlockPool(LAYOUT, n, "meta", n_shards=4)
        jpool = BelugaPool(JLAYOUT, n_blocks=n, n_shards=4, backing="meta")
    mine = _drive_pool(wire.make_pool_handler(pool, max_reply=1024), seed, tiered)
    assert mine == _drive_pool(jwire.make_pool_handler(jpool, max_reply=1024), seed, tiered)
    assert pool.refcounts[np.arange(n)].tolist() == jpool.refcounts[np.arange(n)].tolist()
    assert pool.alloc_count == jpool.alloc_count > 0


def test_pool_handler_refuses_what_the_reference_refuses():
    """Each malformed or oversized frame is refused before it runs, with the
    reference's words; an exhausted pool raises its own error in-band."""
    pool = KVBlockPool(LAYOUT, 16, "meta", n_shards=4)
    jpool = BelugaPool(JLAYOUT, n_blocks=16, n_shards=4, backing="meta")
    handler = wire.make_pool_handler(pool, max_reply=64)
    jhandler = jwire.make_pool_handler(jpool, max_reply=64)
    for frame in (wire.encode_pool_alloc(100), wire.encode_pool_release([16]),
                  wire.encode_pool_retain([-1]), wire.encode_pool_alloc_keys([b"k" * 16])[:-1],
                  bytes([99, 0, 0, 0, 0])):
        with pytest.raises(jwire.WireError) as ref:
            jhandler(frame)
        with pytest.raises(wire.WireFormatError) as got:
            handler(frame)
        assert str(got.value) == str(ref.value)
    assert pool.free_blocks() == jpool.free_blocks() == 16
    with pytest.raises(PoolExhausted):
        wire.make_pool_handler(pool)(wire.encode_pool_alloc(17))


def test_journal_ops_append_the_reference_s_records():
    rng = np.random.default_rng(5)
    keys = [rng.bytes(16) for _ in range(6)]
    frames = [wire.encode_jrnl_publish(1, keys, list(range(6)), [1] * 6, 96),
              wire.encode_jrnl_retract(1, [2, 3]),
              wire.encode_jrnl_remap(1, keys[4:], [40, 41], [7, 8]),
              wire.encode_jrnl_publish(0, keys[:1], [9], [3], 16)]
    mine = [PublishJournal.create(64) for _ in range(2)]
    ref = [ShardJournal.create(capacity=64) for _ in range(2)]
    try:
        for f in frames:
            assert wire.handle_journal_request(f, mine) == jwire.handle_journal_request(f, ref)
        for m, r in zip(mine, ref):
            assert m.records() == r.records()
        with pytest.raises(wire.WireFormatError, match="out of range"):
            wire.handle_journal_request(wire.encode_jrnl_retract(2, [1]), mine)
    finally:
        for j in mine + ref:
            j.close()


def _ring_pair(owner: str, n_slots=16, payload=256):
    """One named ring: (the port's view, JAX's view)."""
    if owner == "port":
        ring = SlotRing.create_shared(n_slots, payload)
        return ring, ShmRing.attach(ring.shm_name, n_slots, payload)
    jring = ShmRing.create_shared(n_slots=n_slots, payload_bytes=payload)
    return SlotRing.attach(jring.shm_name, n_slots, payload), jring


@pytest.mark.parametrize("server", ["port", "jax"])
def test_pool_rpc_ops_and_type_faithful_oom(server):
    """The port's server with JAX's client, or JAX's server with the port's
    client, over one named ring; an exhausted pool raises the client's own
    exhaustion error."""
    ring, jring = _ring_pair(server)
    try:
        if server == "port":
            pool = KVBlockPool(LAYOUT, 32, "cpu", n_shards=4)
            srv = RingServer(ring, wire.make_pool_handler(pool, max_reply=256)).start()
            client = jwire.PoolRpcClient(CxlRpcClient(jring), 32, max_payload=256)
            oom = (OutOfPoolMemory, jwire.RpcError)  # the reference knows its own name only
        else:
            pool = BelugaPool(JLAYOUT, n_blocks=32, n_shards=4, backing="numpy")
            srv = CxlRpcServer(jring, jwire.make_pool_handler(pool, max_reply=256)).start()
            client = wire.RemotePool(RingClient(ring), 32, max_payload=256)
            oom = PoolExhausted
        try:
            ids = client.allocate(4)
            assert pool.free_blocks() == 28 == client.free_blocks()
            assert client.alloc_count() == 4
            client.retain(ids)
            client.release(ids)
            assert pool.refcounts[ids].tolist() == [1] * 4
            client.release(ids)
            assert pool.free_blocks() == 32
            with pytest.raises(oom):
                client.allocate(33)
        finally:
            srv.stop()
    finally:
        ring.close()
        jring.close()


def test_pool_rpc_chunked_allocate_rolls_back_atomically():
    pool = KVBlockPool(LAYOUT, 32, "meta", n_shards=4)
    ring = SlotRing(16, 64)  # small slots: a request goes in chunks
    srv = RingServer(ring, wire.make_pool_handler(pool, max_reply=64)).start()
    try:
        client = wire.RemotePool(RingClient(ring), 32, max_payload=64)
        assert client._max_ids < 32  # the request below really chunks
        with pytest.raises(PoolExhausted):
            client.allocate(40)  # some chunks succeed, then the pool runs dry
        assert pool.free_blocks() == 32  # every block of the failed allocate came back
        assert client.allocate(32) and pool.free_blocks() == 0
    finally:
        srv.stop()


def test_slot_partitioning_shares_one_ring():
    for n_slots in range(4, 70, 3):
        for parts in range(1, 6):
            if n_slots // parts >= 2:
                assert partition_slots(n_slots, parts) == jpartition_slots(n_slots, parts)
    assert partition_slots(10, 3) == [(0, 3), (3, 6), (6, 10)]
    with pytest.raises(ValueError, match=">= 2"):
        partition_slots(8, 5)
    pool = KVBlockPool(LAYOUT, 64, "meta", n_shards=4)
    ring = SlotRing(8, 256)
    srv = RingServer(ring, wire.make_pool_handler(pool, max_reply=256)).start()
    try:
        clients = [wire.RemotePool(RingClient(ring, slot_range=r), 64, max_payload=256)
                   for r in partition_slots(8, 2)]  # one a thread: a client has one owner
        got = []

        def worker(cl):
            for _ in range(20):
                ids = cl.allocate(2)
                cl.release(ids)
                got.extend(ids)

        ts = [threading.Thread(target=worker, args=(c,)) for c in clients]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts)
        assert len(got) == 80 and pool.free_blocks() == 64
        with pytest.raises(ValueError):
            RingClient(ring, slot_range=(4, 3))
    finally:
        srv.stop()


def test_worker_pool_view_full_surface():
    pool = KVBlockPool(LAYOUT, 32, "cpu", n_shards=4)
    spec = pool.share_data()
    ring = SlotRing(16, 256)
    srv = RingServer(ring, wire.make_pool_handler(pool, max_reply=256)).start()
    try:
        view = WorkerPool(SharedPoolSegment(spec),
                          wire.RemotePool(RingClient(ring), 32, max_payload=256))
        assert view.is_tiered is False and view.payload_free is False
        assert view.layout == LAYOUT and view.device.type == "cpu"
        ids = view.allocate(2)
        eps = view.write_blocks(ids, torch.zeros(2, *LAYOUT.block_shape, dtype=torch.bfloat16))
        assert view.validate_epochs(ids, eps).all()
        assert pool.committed[ids].all()  # the owner sees it
        assert view.refcounts[ids].tolist() == [1, 1]
        view.retain(ids)
        view.release(ids)
        assert pool.refcounts[ids].tolist() == [1, 1]
        view.release(ids)
        assert view.free_blocks() == 32
        view.close()
    finally:
        srv.stop()
        pool.unshare_data()
        pool.unshare_meta()


# ---------------------------------------------------------------------------
# the lease ledger
# ---------------------------------------------------------------------------


def _ledger_scenario(port: bool):
    """``test_workerheal.py``'s scenario: worker 0 holds a (allocated, never
    written), b (written and published), c (written, never published), and
    released d, which went to worker 1."""
    if port:
        pool = KVBlockPool(LAYOUT, 64, "meta", n_shards=4)
        idx, led = PrefixIndex(pool), LeaseLedger()
    else:
        pool = BelugaPool(JLAYOUT, n_blocks=64, n_shards=4, backing="meta")
        idx, led = GlobalIndex(pool), WorkerLeaseLedger()
    a, b, c, d = pool.allocate(4)
    led.on_alloc(0, [a, b, c, d], pool)
    [eb] = pool.write_blocks([b])
    idx.publish_many([b"k" * 16], [b], [eb], 8)
    pool.write_blocks([c])
    led.on_release(0, [d])
    pool.release([d])
    [d2] = pool.allocate(1)
    assert d2 == d
    led.on_alloc(1, [d2], pool)
    free0 = pool.free_blocks()
    summary = led.reconcile(0, pool, owners_of=idx.owners_of)
    again = led.reconcile(0, pool, owners_of=idx.owners_of)
    return summary, again, (a, b, c, d), pool.free_blocks() - free0, \
        pool.refcounts[np.arange(64)].tolist(), led.leases(1)


def test_lease_ledger_reconcile_epoch_rules():
    summary, again, (a, b, c, d), freed, rcs, w1 = _ledger_scenario(port=True)
    assert summary["released"] == 2 and summary["blocks"] == sorted([a, c])
    assert b in summary["kept"]
    assert freed == 2 and rcs[b] == 1 and rcs[d] == 1  # the index's and worker 1's refs
    assert again == {"released": 0, "skipped": 0, "blocks": [], "kept": []}  # exactly once
    assert _ledger_scenario(port=False) == (summary, again, (a, b, c, d), freed, rcs, w1)


def test_lease_ledger_publish_clears_lease_and_release_tolerates_unknown():
    out = []
    for pool, led in ((KVBlockPool(LAYOUT, 32, "meta", n_shards=4), LeaseLedger()),
                      (BelugaPool(JLAYOUT, n_blocks=32, n_shards=4, backing="meta"),
                       WorkerLeaseLedger())):
        ids = pool.allocate(2)
        led.on_alloc(0, ids, pool)
        led.on_publish(0, [ids[0]])  # the allocation ref moved to the index
        first = list(led.leases(0))
        # a worker routes the index's eviction releases through its ring too:
        # ids it holds no lease on must not underflow
        led.on_release(0, [ids[0], ids[0], 999])
        out.append((ids, first, led.leases(0)))
    assert out[0] == out[1] and out[0][1] == [out[0][0][1]]


def test_reconcile_probes_index_with_mutex_dropped():
    """The reference drops its ledger mutex around the ``owners_of`` probe.
    The port's reconcile takes no lock: it drops the worker's entry before
    the probe (a second reconcile, or a late mirror call, finds nothing),
    classifies on reads made after the probe, and hands the releases to
    ``release``, never to the pool it reads."""
    pool = KVBlockPool(LAYOUT, 32, "meta", n_shards=4)
    idx = PrefixIndex(pool)
    led = LeaseLedger()
    blocks = pool.allocate(3)
    led.on_alloc(0, blocks, pool)
    [eb] = pool.write_blocks(blocks[:1])
    idx.publish_many([b"r" * 16], blocks[:1], [eb], 8)
    seen = {}

    def probing_owners_of(ids):
        seen["entry_gone"] = led.leases(0) == {}
        return idx.owners_of(ids)

    released = []
    summary = led.reconcile(0, pool, owners_of=probing_owners_of, release=released.extend)
    assert seen == {"entry_gone": True}
    assert blocks[0] in summary["kept"]  # published: the index's ref survives
    assert sorted(released) == sorted(blocks[1:]) == summary["blocks"]
    assert pool.refcounts[blocks].tolist() == [1, 1, 1]  # released through the hook only
    # the reference, on the same scenario, releases the same blocks
    jpool = BelugaPool(JLAYOUT, n_blocks=32, n_shards=4, backing="meta")
    jidx, jled = GlobalIndex(jpool), WorkerLeaseLedger()
    jb = jpool.allocate(3)
    jled.on_alloc(0, jb, jpool)
    [je] = jpool.write_blocks(jb[:1])
    jidx.publish_many([b"r" * 16], jb[:1], [je], 8)
    assert jb == blocks and jled.reconcile(0, jpool, owners_of=jidx.owners_of) == summary


def test_journal_publish_clears_lease_under_ledger_mutex():
    """The reference clears the lease under its mutex; in the port the
    allocator's thread alone runs ``handle_journal_request`` and mutates a
    live worker's leases. Same outcome: the record appended, the lease gone,
    the other worker's untouched."""
    pool = KVBlockPool(LAYOUT, 32, "meta", n_shards=4)
    led = LeaseLedger()
    blocks = pool.allocate(3)
    led.on_alloc(0, blocks[:2], pool)
    led.on_alloc(1, blocks[2:], pool)
    jrnl = PublishJournal.create(16)
    try:
        frame = wire.encode_jrnl_publish(0, [b"j" * 16] * 2, blocks[:2], [1, 1], 8)
        assert wire.handle_journal_request(frame, [jrnl], ledger=led, worker=0) == \
            (2).to_bytes(4, "little")
        assert not led.leases(0) and list(led.leases(1)) == blocks[2:]
        assert [r[2] for r in jrnl.records()] == blocks[:2]
    finally:
        jrnl.close()


def test_pool_handler_mirrors_a_worker_s_traffic_into_the_ledger():
    """``make_pool_handler`` with a ledger: each worker's slot partition names
    it; the slot no worker owns (the reconcile's releases) is not mirrored."""
    pool = KVBlockPool(LAYOUT, 32, "meta", n_shards=4)
    led = LeaseLedger()
    parts = partition_slots(7, 2)
    owner = {s: w for w, (lo, hi) in enumerate(parts) for s in range(lo, hi)}
    jrnl = PublishJournal.create(16)
    ring = SlotRing(8, 256)
    srv = RingServer(ring, wire.make_pool_handler(pool, max_reply=256, ledger=led,
                                                  slot_owner=owner.get, journals=[jrnl])).start()
    try:
        w0, w1, own = (wire.RemotePool(RingClient(ring, slot_range=r), 32)
                       for r in (parts[0], parts[1], (7, 8)))
        a = w0.allocate(3)
        b = w1.allocate(2)
        w1.retain(a[:1])
        w0.release(a[2:])
        own.release(b[1:])  # not a worker's: the ledger keeps worker 1's lease
        assert led.leases(0) == {a[0]: (1, 0), a[1]: (1, 0)}
        assert led.leases(1) == {b[0]: (1, 0), b[1]: (1, 0), a[0]: (1, 0)}
        wire.JournalProxy(w0.rpc, 0).append_publish([b"p" * 16], a[:1], [1], 8)
        assert list(led.leases(0)) == [a[1]] and len(jrnl.records()) == 1
    finally:
        srv.stop()
        jrnl.close()


# ---------------------------------------------------------------------------
# rings: a dead service, a drop window
# ---------------------------------------------------------------------------


def test_dead_ring_retries_cannot_exhaust_a_narrow_slot_partition():
    """A worker owns a narrow slot range of each shared ring; calls that fail
    fast against a dead service must not bleed it dry (a dead ring has no
    writer left, so its quarantined slots come back)."""
    ring = SlotRing(8, 64)
    client = RingClient(ring, liveness=lambda: False, slot_range=(0, 3))
    for _ in range(12):  # four times the partition's width
        with pytest.raises(RingServiceDied):
            client.call(b"\x01ping", timeout=1.0)
    assert client.free_slots() >= 2


def test_fault_injector_intercepts_pipelined_rounds():
    pool = KVBlockPool(KVBlockLayout(8, 2, 2, 8), 256, "meta", n_shards=4)
    index = PrefixIndex(pool)
    ring = SlotRing(8, 256)  # small slots: a 64-key lookup pipelines in chunks
    srv = RingServer(ring, wire.make_index_handler(index, max_reply=256)).start()
    try:
        rpc = RingClient(ring)
        client = wire.RemoteIndex(rpc, 8, retry=RingRetryPolicy(base_backoff=0.05))
        tokens = list(range(64 * 8))
        keys = client.keys_for(tokens)
        assert len(keys) == 64
        ids = pool.allocate(64)
        client.publish_many(keys, ids, pool.write_blocks(ids), len(tokens))
        inj = FaultInjector(FaultPlan([FaultEvent(t=0.0, kind="drop", duration=0.4)]),
                            supervisors=[]).start()
        inj.attach_client(0, rpc)
        t0 = time.perf_counter()
        got = client.lookup_many(keys)  # pipelined, and dropped at the post
        assert time.perf_counter() - t0 > 0.2  # it sat out the window
        assert all(e is not None for e in got)
        assert rpc.stats.retries >= 1  # through the client's own retries
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# the reference's refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,backing", [
    ({"data_plane": "zero_copy"}, "numpy"),
    ({"data_plane": "shared"}, "meta"),
    ({"engine_processes": 1}, "numpy"),
    ({"engine_processes": 1, "data_plane": "shared"}, "numpy"),
    ({"engine_processes": 2, "data_plane": "shared", "index_rpc": True,
      "index_transport": "process"}, "numpy"),
    ({"engine_processes": 1, "data_plane": "shared", "index_rpc": True,
      "index_transport": "process", "policy": "cache_aware"}, "numpy"),
])
def test_data_plane_and_worker_config_gates(kw, backing):
    """Each refusal is the reference's: the same type, the same words."""
    with pytest.raises((ValueError, NotImplementedError)) as ref:
        JCluster(JClusterConfig(n_engines=1, pool_blocks=256, hbm_slots_per_engine=32, **kw),
                 JLAYOUT, backing=backing)
    with pytest.raises(type(ref.value)) as got:
        Cluster(ClusterConfig(n_engines=1, pool_blocks=256, hbm_slots_per_engine=32, **kw),
                LAYOUT, device="cpu" if backing == "numpy" else "meta")
    assert str(got.value) == str(ref.value)


# ---------------------------------------------------------------------------
# self-healing workers (test_workerheal.py)
# ---------------------------------------------------------------------------


HEAL = dict(n_engines=2, engine_processes=2, index_shards=1, data_plane="shared",
            selfheal=True, journal_capacity=2048, supervisor_probe_interval=0.01)


def _heal_cluster(**kw):
    """``test_workerheal.py``'s cluster: two supervised workers, one watched
    shard."""
    return _cluster("port", **{**HEAL, **kw})


@pytest.fixture(scope="module")
def heal_reference():
    """The supervised run without a fault (``test_workerheal.py``'s
    reference): the port's stats and JAX's of the same."""
    stats, _, _, _ = _serve("port", _workload(7), **HEAL)
    jstats, _, _, _ = _serve("jax", _workload(7), **HEAL)
    return stats, jstats


def test_supervised_no_fault_run_equals_reference(heal_reference):
    stats, jstats = heal_reference
    assert stats == jstats and stats["n_done"] == 16


def _submit(c, work) -> None:
    for rid, toks, nout, arr in work:
        c.dispatch(Request(rid, toks, nout, arrival=arr))


def test_worker_kill_between_submits_converges_with_no_fault_run(heal_reference):
    """SIGKILL a worker after half the submits: the next submit that reaches
    it restarts it (reconciled, a fresh command ring, its requests not yet
    done replayed), and the run's final numbers are the run's without the
    fault."""
    want, _ = heal_reference
    work = _workload(7)
    with _heal_cluster() as c:
        _submit(c, work[: len(work) // 2])
        c.workers[0].kill()
        _submit(c, work[len(work) // 2 :])
        got = c.run()
        assert c.workers[0].restarts == 1
        assert all(r.state == "done" and r.t_done is not None for r in c.requests)
        names, paths = c.shm_segment_names(), c.doorbell_paths()
    for k in ("n_done", "hit_tokens", "total_prompt_tokens", "avg_ttft_s", "avg_tpot_s",
              "pool_free"):
        assert got[k] == want[k], k
    assert got["selfheal"]["worker_restarts"] == 1
    _hygiene(names, paths)


def test_worker_kill_mid_drain_reconciles_leases_and_converges(heal_reference):
    """SIGKILL worker 0 while its drain runs and it holds pool leases: the
    collect finds it dead, and only once every worker's run is collected
    does the restart reconcile its leases, once, and make the run again on
    the respawned worker. Every block is accounted for: the free count is
    the run's without the fault."""
    want, _ = heal_reference
    work = _workload(7)
    with _heal_cluster() as c:
        _submit(c, work)
        tokens = [w.post_run(None) for w in c.workers]
        deadline = time.monotonic() + 30.0
        while not c._ledger.held(0) and time.monotonic() < deadline:
            time.sleep(1e-4)  # until worker 0 holds blocks mid-drain
        mid_drain = c._ledger.held(0) > 0
        c.workers[0].kill()
        clocks = [w.collect_run(t) for w, t in zip(c.workers, tokens)]
        assert c.workers[0].restarts == 0  # no restart while a run is out
        for w, t, clock in zip(c.workers, tokens, clocks):
            if clock is None:
                w.rerun(t)  # every run collected: restart, reconcile, run again
        stats = c.run()
        assert mid_drain and c.workers[0].restarts == 1
        assert stats["n_done"] == len(work)
        assert all(r.state == "done" for r in c.requests)
        # conservation: a leaked lease would leave the pool short, a double
        # release trips the pool's own refcount check
        assert c.pool.free_blocks() == want["pool_free"]
        assert exp14.refcounts_accounted(c) == {"settled": True, "overwritten": 0}
        recs = [r for r in c.workers[0].reconciled if r is not None]
        assert recs, "the lease reconcile never ran"
        names, paths = c.shm_segment_names(), c.doorbell_paths()
    _hygiene(names, paths)


def test_reconcile_retires_requests_a_dead_worker_left_unserved(heal_reference, monkeypatch):
    """A request the dead worker left on the allocator ring, which the
    allocator's thread has not served by ``LEASE_DRAIN_S``, is never
    served: the allocator moves to a fresh ring before the reconcile, so the
    respawned worker, on the same slots, is never charged with it. The
    cluster then serves on to the run's final numbers."""
    from repro_torch.serving import scheduler

    monkeypatch.setattr(scheduler, "LEASE_DRAIN_S", 0.2)
    want, _ = heal_reference
    work = _workload(7)
    with _heal_cluster() as c:
        _submit(c, work[: len(work) // 2])
        c.run()
        free = c.pool.free_blocks()
        c.workers[0].kill()
        assert c._pool_server.stop()  # the allocator's thread serves nothing more
        old = c._pool_ring.shm_name
        lo, _ = c._pool_parts()[0]
        # an ALLOC posted on worker 0's first slot, as if it died just after
        poster = RingClient(c._pool_ring, slot_range=(lo, lo + 1))
        poster.post(wire.encode_pool_alloc(4))
        poster.close()
        assert c.workers[0].check() and c.workers[0].restarts == 1
        assert c._pool_ring.shm_name != old and _gone(old)
        assert c.allocator_restarts == 0  # a retirement, not the drill
        assert c.pool.free_blocks() == free  # the ALLOC was never served
        _submit(c, work[len(work) // 2 :])
        stats = c.run()
        assert stats["n_done"] == len(work) and c.pool.free_blocks() == want["pool_free"]
        assert exp14.refcounts_accounted(c) == {"settled": True, "overwritten": 0}
        names, paths = c.shm_segment_names(), c.doorbell_paths()
    _hygiene(names, paths)


def test_shard_kill_with_attached_workers_cuts_over_and_serves(heal_reference):
    """Kill -9 the metadata shard under live workers: its watchdog respawns
    it on a fresh ring from its journal (which holds the workers' publishes,
    proxied over the allocator ring), and the next command carries the new
    ring into each worker (``WCMD_ADOPT``)."""
    want, _ = heal_reference
    work = _workload(7)
    with _heal_cluster() as c:
        _submit(c, work[: len(work) // 2])
        c.run()
        wd = c.plane.services[0]
        ring0 = wd.generation.service.ring.shm_name
        wd.kill()
        deadline = time.monotonic() + 60.0
        while wd.restarts == 0 and time.monotonic() < deadline:
            time.sleep(0.01)  # the watchdog's probe thread restarts it
        assert wd.restarts == 1, "the shard never came back"
        assert wd.generation.service.ring.shm_name != ring0
        _submit(c, work[len(work) // 2 :])
        stats = c.run()
        assert stats["selfheal"]["restarts"] == 1
        assert stats["selfheal"]["worker_restarts"] == 0  # the workers lived on
        assert all(r.state == "done" for r in c.requests)
        assert c.pool.free_blocks() == want["pool_free"]
        names, paths = c.shm_segment_names(), c.doorbell_paths()
    _hygiene(names, paths)


def test_allocator_rolling_restart_is_invisible_to_workers(heal_reference):
    want, _ = heal_reference
    work = _workload(7)
    with _heal_cluster() as c:
        _submit(c, work[: len(work) // 2])
        c.run()
        old = c._pool_ring.shm_name
        c.restart_allocator()
        assert c._pool_ring.shm_name != old and _gone(old)
        _submit(c, work[len(work) // 2 :])
        stats = c.run()
        assert stats["selfheal"]["allocator_restarts"] == 1
        assert stats["selfheal"]["worker_restarts"] == 0
        assert stats["n_done"] == len(work)
        assert all(r.state == "done" for r in c.requests)
        assert c.pool.free_blocks() == want["pool_free"]
        names, paths = c.shm_segment_names(), c.doorbell_paths()
    _hygiene(names, paths)


def test_results_page_kill_surfaces_retryable_error_in_bounded_time():
    """A RESULTS page left pending on a killed worker fails with
    ``RingServiceDied`` (retryable) within the liveness bound, never a hang
    or a half-decoded page; the supervised surface then restarts the worker
    and pages the results back from the new generation."""
    with _heal_cluster(n_engines=1, engine_processes=1) as c:
        _submit(c, _workload(7, 4))
        c.run()
        sup = c.workers[0]
        host = sup.host
        host.kill()
        slot = host.client.post(struct.pack("<BII", engineproc.WCMD_RESULTS, 0, 1 << 20))
        t0 = time.monotonic()
        with pytest.raises(RingServiceDied):
            host.client.collect(slot, timeout=30.0)
        assert time.monotonic() - t0 < 5.0  # bounded, not the timeout
        assert sup.check() and sup.restarts == 1
        sup.apply_results(c.requests)
        assert all(r.state == "done" for r in c.requests)
        names, paths = c.shm_segment_names(), c.doorbell_paths()
    _hygiene(names, paths)


def test_worker_supervisor_replays_only_unacked_submits():
    """Requests seen done (``apply_results``) are not replayed: only the
    ones not yet acknowledged go to the new generation."""
    with _heal_cluster(n_engines=1, engine_processes=1) as c:
        work = _workload(7, 8)
        _submit(c, work[:4])
        c.run()  # done and acknowledged: out of the ledger
        sup = c.workers[0]
        assert sup.load() == 0
        _submit(c, work[4:])
        assert sup.load() == 4
        sup.kill()
        stats = c.run()  # the run's collect finds it dead and restarts it
        assert sup.restarts == 1
        assert stats["n_done"] == 8  # both phases, folded here
        assert sup.host.n_submitted == 4  # the new worker saw the replay only
        assert sup.load() == 0
