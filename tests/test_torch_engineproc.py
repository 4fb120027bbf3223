"""Engine worker processes over the shared data plane, against the JAX
package's: twins of the cluster tests of ``tests/test_engineproc.py`` and
of ``tests/test_workerheal.py`` (their unit tests are in
``tests/test_torch_shmpool.py``), each with the same scenario.

* the worker command codec: JAX's opcodes, structs and ADOPT frames;
* ``data_plane="shared"`` in this process, and with one worker process:
  the whole ``run()`` dict equals JAX's for the same settings, flat and
  tiered, with and without ``selfheal``, and equals the port's private run;
* two workers share one segment (each moves bytes, JAX's dict again),
  the elastic calls refused, the tiered self-healing stack across 4 shards,
  a parked worker that ends on ``CTRL_STOP`` alone, a boot that fails and a
  ``kill -9``, each leaving no segment and no FIFO behind;
* the exp14 twin at ``--fast`` in a subprocess under a hard time limit,
  its parity numbers JAX's on this tree.

The self-healing workers' twins (``test_workerheal.py``) are in
``tests/test_torch_shmpool.py``, with the lease ledger they reconcile. Each
test that spawns has its own time limit (``LIMIT_S``).
"""

from __future__ import annotations

import inspect
import json
import os
import signal
import subprocess
import sys
import time
from multiprocessing import shared_memory

import numpy as np
import pytest
import torch

from repro.core.pool import PoolLayout
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import Cluster as JCluster
from repro.serving.scheduler import ClusterConfig as JClusterConfig
from repro.tiering import TieringConfig as JTieringConfig
from repro_torch.core.index import shard_of_key
from repro_torch.core.pool import KVBlockLayout
from repro_torch.core.procserver import PARK_S
from repro_torch.core.rpc import CTRL_STOP
from repro_torch.core.wire import KEY_BYTES, RemoteIndex
from repro_torch.experiments import exp14_procengine as exp14
from repro_torch.serving import engineproc
from repro_torch.serving.engineproc import EngineWorkerSupervisor
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import Cluster, ClusterConfig
from repro_torch.tiering import TieringConfig

torch.set_num_threads(1)

LAYOUT = KVBlockLayout(block_tokens=8, n_layers_kv=2, n_kv_heads=2, head_dim=8)
JLAYOUT = PoolLayout(block_tokens=8, n_layers_kv=2, n_kv_heads=2, head_dim=8, dtype_bytes=2)
LIMIT_S = 120  # a test's own limit: a hung worker or service fails it, bounded
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def time_limit(request):
    """Fail a test that runs past its limit (``LIMIT_S``, or its ``limit``
    parameter) by raising in it; its ``with`` blocks still close."""
    limit = getattr(request, "param", LIMIT_S)

    def expired(signum, frame):
        raise TimeoutError(f"{request.node.name} ran past its {limit} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.setitimer(signal.ITIMER_REAL, limit)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def _gone(name: str) -> bool:
    try:
        seg = shared_memory.SharedMemory(name=name)
    except FileNotFoundError:
        return True
    seg.close()
    return False


def _hygiene(names, paths) -> None:
    assert names and paths
    for n in names:
        assert _gone(n), n
    for p in paths:
        assert not os.path.exists(p), p


def _workload(seed: int = 3, n: int = 16):
    """``test_engineproc.py``'s (seed 3) and ``test_workerheal.py``'s (seed 7)
    workload: odd requests share a 64-token prefix, even ones do not, so with
    round robin over two workers no key is written by both."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 1000, 64).tolist()
    out = []
    for i in range(n):
        toks = (base + rng.integers(0, 1000, 24).tolist() if i % 2
                else rng.integers(0, 1000, 80).tolist())
        out.append((f"r{i}", [int(t) for t in toks], 8, i * 0.03))
    return out


def _cluster(side: str, *, tiered: bool = False, **kw):
    """One side's cluster with ``test_engineproc.py``'s settings."""
    common = dict(n_engines=1, policy="round_robin", pool_blocks=512, pool_shards=4,
                  hbm_slots_per_engine=64, block_tokens=8, index_rpc=True,
                  index_transport="process", index_shards=2)
    common.update(kw)
    if side == "port":
        if tiered:
            common["tiering"] = TieringConfig(enabled=True, spill_blocks=256)
        return Cluster(ClusterConfig(**common), LAYOUT, device="cpu")
    if tiered:
        common["tiering"] = JTieringConfig(enabled=True, spill_blocks=256)
    return JCluster(JClusterConfig(**common), JLAYOUT, backing="numpy")


def _serve(side: str, work, **kw):
    """Run ``work`` on a fresh cluster: (stats, segments, FIFOs, per-worker
    stats), the cluster closed."""
    R = Request if side == "port" else JRequest
    with _cluster(side, **kw) as c:
        for rid, toks, nout, arr in work:
            c.dispatch(R(rid, toks, nout, arrival=arr))
        stats = c.run()
        wstats = [w.stats_dict() for w in c.workers]
        names, paths = c.shm_segment_names(), c.doorbell_paths()
    return stats, names, paths, wstats


# ---------------------------------------------------------------------------
# the worker command codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_worker_command_frames_are_the_reference_s_bytes(seed):
    """The command ring's codec is the reference's, byte for byte: the same
    opcodes, the same structs (so SUBMIT, RUN, RESULTS and STATS frames and
    replies pack alike), and the same ADOPT frames."""
    from repro.serving import engineproc as jengineproc

    for name in ("WCMD_SUBMIT", "WCMD_RUN", "WCMD_RESULTS", "WCMD_STATS", "WCMD_ADOPT"):
        assert getattr(engineproc, name) == getattr(jengineproc, name)
    for name in ("_U32", "_SUB_HDR", "_ADOPT_HDR", "_RUN", "_RUN_RESP", "_RES_REQ", "_RES_REC",
                 "_STATS_REQ", "_STATS_RESP"):
        assert getattr(engineproc, name).format == getattr(jengineproc, name).format, name
    # the constants the port has for the reference's keyword defaults
    host = inspect.signature(jengineproc.EngineWorkerHost).parameters
    sup = inspect.signature(jengineproc.EngineWorkerSupervisor).parameters
    assert (engineproc.CMD_SLOTS, engineproc.CMD_PAYLOAD, engineproc.MAX_RESTARTS) == (
        host["cmd_slots"].default, host["cmd_payload"].default, sup["max_restarts"].default)
    rng = np.random.default_rng(seed)
    args = (int(rng.integers(0, 2)), int(rng.integers(0, 1 << 32)), int(rng.integers(1, 1 << 16)),
            int(rng.integers(1, 1 << 20)), f"psm_{rng.integers(0, 1 << 30):x}",
            "" if seed % 2 else f"/tmp/beluga-doorbell-{seed}")
    assert engineproc.encode_adopt(*args) == jengineproc.encode_adopt(*args)
    with pytest.raises(engineproc.WireFormatError, match="truncated"):
        engineproc._string(engineproc.encode_adopt(*args)[:-1], engineproc._ADOPT_HDR.size + 4
                           + len(args[4]))


# ---------------------------------------------------------------------------
# parity: the shared data plane in process and in one worker
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tiered", [False, True], ids=["flat", "tiered"])
def test_shared_data_plane_inprocess_bit_identical(tiered):
    work = _workload()
    ref, _, _, _ = _serve("port", work, tiered=tiered, data_plane="private")
    shared, names, _, _ = _serve("port", work, tiered=tiered, data_plane="shared")
    assert ref == shared  # the whole stats dict, the index's counters too
    assert ref["n_done"] == 16 and ref["hit_tokens"] > 0
    for n in names:
        assert _gone(n), n
    jref, _, _, _ = _serve("jax", work, tiered=tiered, data_plane="private")
    jshared, _, _, _ = _serve("jax", work, tiered=tiered, data_plane="shared")
    assert jref == jshared == shared


@pytest.mark.parametrize("selfheal", [False, True], ids=["plain", "selfheal"])
@pytest.mark.parametrize("tiered", [False, True], ids=["flat", "tiered"])
def test_worker_process_n1_bit_identical(tiered, selfheal):
    """One engine worker process gives JAX's one-worker run, key by key; on
    a flat pool also (without the self-healing keys) the port's private
    run. A tier chain's worker counts its tier hits in its own process, as
    the reference's does, so the parent's count stays 0 there."""
    work = _workload()
    w1, names, paths, _ = _serve("port", work, tiered=tiered, selfheal=selfheal,
                                 data_plane="shared", engine_processes=1)
    _hygiene(names, paths)
    jw1, _, _, _ = _serve("jax", work, tiered=tiered, selfheal=selfheal,
                          data_plane="shared", engine_processes=1)
    assert w1 == jw1
    if not tiered:
        ref, _, _, _ = _serve("port", work, data_plane="private")
        assert {k: v for k, v in w1.items() if k != "selfheal"} == ref


def test_worker_processes_n2_share_one_segment():
    work = _workload()
    with _cluster("port", n_engines=2, data_plane="shared", engine_processes=2) as c:
        assert len(c.workers) == 2
        for rid, toks, nout, arr in work:
            c.dispatch(Request(rid, toks, nout, arrival=arr))
        stats = c.run()
        assert stats["n_done"] == 16
        # both workers moved bytes, on the one shared pool
        per_worker = [w.stats_dict() for w in c.workers]
        assert all(ws["transfer"]["bytes_written"] > 0 for ws in per_worker)
        assert {r.engine_id for r in c.requests} == {0, 1}
        assert exp14.refcounts_accounted(c) == {"settled": True, "overwritten": 0}
        names, paths = c.shm_segment_names(), c.doorbell_paths()
        assert len(names) == 7  # meta, data, the allocator's ring, 2 shard rings, 2 command rings
    _hygiene(names, paths)
    # no key is written by both workers here, so the run is JAX's
    jstats, _, _, jws = _serve("jax", work, n_engines=2, data_plane="shared", engine_processes=2)
    assert stats == jstats
    assert [w["transfer"] for w in per_worker] == [w["transfer"] for w in jws]


@pytest.mark.parametrize("selfheal", [False, True], ids=["counted", "journalled"])
def test_refcounts_accounted_sees_a_written_block_no_entry_holds(selfheal):
    """A written block that no entry holds and no second publish of its key
    explains is a leak, not an overwrite: ``refcounts_accounted`` counts
    such blocks against the blocks written (without journals) or names
    them in the journals (with them)."""
    with _cluster("port", data_plane="shared", selfheal=selfheal) as c:
        for rid, toks, nout, arr in _workload():
            c.dispatch(Request(rid, toks, nout, arrival=arr))
        c.run()
        assert exp14.refcounts_accounted(c) == {"settled": True, "overwritten": 0}
        c.pool.write_blocks(c.pool.allocate(1))  # an allocation ref leaked after its write
        assert exp14.refcounts_accounted(c) == {"settled": False, "overwritten": 1}


@pytest.mark.parametrize("case", ["swapped", "single"])
def test_refcounts_accounted_names_a_key_published_twice_in_either_order(case):
    """A client publishes to its shard's ring and appends to the journal in
    two calls, and two workers' calls to each serialise apart, so the
    journal may hold a key's two publishes in the other order from the
    index's. ``swapped``: the index applies ``b1`` then ``b2`` and keeps
    ``b2``; the journal holds ``b2`` then ``b1``; ``b1`` is left over
    (committed, refcount 1, no entry) and is named by the key's publish
    under ``b2``, before it in the journal. A rule that names a left block
    only by a later publish of its key under another block fails this case.
    ``single``: a block whose key went under it alone, its allocation ref
    never taken by an entry, is still a leak, and its id is ``unnamed``."""
    with _cluster("port", data_plane="shared", selfheal=True) as c:
        for rid, toks, nout, arr in _workload():
            c.dispatch(Request(rid, toks, nout, arrival=arr))
        c.run()
        before = exp14.refcounts_accounted(c, diagnose=True)
        assert before == {"settled": True, "overwritten": 0, "unnamed": [], "miscounted": []}
        remote = c.plane.remote
        key = bytes(range(KEY_BYTES))  # no chain key of the workload
        assert remote.lookup_many([key]) == [None]
        s = shard_of_key(key, remote.n_shards)
        index_only = RemoteIndex(remote.rpcs[s], c.cfg.block_tokens)  # no journal
        journal = remote.journals[s]
        if case == "swapped":
            b1, b2 = c.pool.allocate(2)
            e1, e2 = c.pool.write_blocks([b1, b2])
            index_only.publish_many([key], [b1], [e1], 8)
            index_only.publish_many([key], [b2], [e2], 8)
            journal.append_publish([key], [b2], [e2], 8)
            journal.append_publish([key], [b1], [e1], 8)
            assert remote.lookup_many([key])[0].block_id == b2
            assert exp14.refcounts_accounted(c, diagnose=True) == {
                "settled": True, "overwritten": before["overwritten"] + 1, "unnamed": [],
                "miscounted": []}
        else:
            (b,) = c.pool.allocate(1)
            (e,) = c.pool.write_blocks([b])
            journal.append_publish([key], [b], [e], 8)  # and no entry takes its ref
            got = exp14.refcounts_accounted(c, diagnose=True)
            assert got["settled"] is False and b in got["unnamed"]
            assert got["overwritten"] == before["overwritten"] + 1


def test_worker_mode_elastic_scaling_gated():
    with _cluster("port", pool_blocks=256, hbm_slots_per_engine=32, index_shards=1,
                  data_plane="shared", engine_processes=1) as c:
        with pytest.raises(NotImplementedError, match="elastic"):
            c.add_engine()
        with pytest.raises(NotImplementedError, match="elastic"):
            c.remove_engine(0)


def test_tiering_rides_the_full_production_stack():
    """Tiering, 4 watched shards, the shared data plane, two supervised
    workers: one legal cluster that serves through the workers (keyed
    allocations and demand touches over the allocator ring), migrates here,
    equals JAX's run and leaves nothing behind."""
    kw = dict(n_engines=2, engine_processes=2, data_plane="shared", index_shards=4,
              selfheal=True, pool_blocks=256, hbm_slots_per_engine=32, journal_capacity=512,
              tiered=True)
    cluster = _cluster("port", **kw)
    try:
        assert cluster.migrator is not None
        assert "tiering" in cluster.pool.share_data()  # one segment over the chain
        for rid, toks, nout, arr in _workload():
            cluster.dispatch(Request(rid, toks, nout, arrival=arr))
        stats = cluster.run()
        assert stats["n_done"] == 16
        assert stats["tiering"]["fast_writes"] + stats["tiering"]["spill_writes"] > 0
        assert stats["index"]["hits"] > 0  # prefixes reused across the workers
        names, paths = cluster.shm_segment_names(), cluster.doorbell_paths()
    finally:
        assert cluster.close() == []
    _hygiene(names, paths)
    jstats, _, _, _ = _serve("jax", _workload(), **kw)
    assert stats == jstats


def test_selfheal_plus_workers_builds_and_tears_down_cleanly():
    cluster = _cluster("port", n_engines=2, engine_processes=2, data_plane="shared",
                       index_shards=1, selfheal=True, pool_blocks=256, hbm_slots_per_engine=32,
                       journal_capacity=512)
    names, fifos = cluster.shm_segment_names(), cluster.doorbell_paths()
    with cluster:
        assert all(isinstance(w, EngineWorkerSupervisor) for w in cluster.workers)
        for i in range(4):
            cluster.dispatch(Request(req_id=f"r{i}", tokens=list(range(24)), n_output=4))
        stats = cluster.run()
        assert stats["n_done"] == 4
        assert all(r.state == "done" for r in cluster.requests)
        assert stats["selfheal"]["worker_restarts"] == 0
    _hygiene(names, fifos)


def test_parked_worker_wakes_on_stop_without_a_doorbell_ring():
    """A worker parked on its FIFO whose poster died can never be rung awake:
    the park is bounded (``PARK_S``), so ``CTRL_STOP`` alone, with no write
    to the FIFO, ends the worker promptly."""
    assert PARK_S <= 0.1  # the bound's source
    with _cluster("port", pool_blocks=256, hbm_slots_per_engine=32, index_shards=1,
                  data_plane="shared", engine_processes=1) as c:
        host = c.workers[0]
        time.sleep(0.4)  # idle long enough to park on the FIFO
        assert host.running()
        t0 = time.perf_counter()
        host.ring.ctrl[CTRL_STOP] = 1  # and no doorbell write
        host.proc.join(timeout=5.0)
        woke = time.perf_counter() - t0
        assert not host.running(), "the worker never woke from its park"
        assert woke < 2.0, f"the wake took {woke:.2f} s"


def test_worker_boot_failure_leaks_nothing(monkeypatch):
    """A worker that never reaches CTRL_READY aborts the construction; every
    segment and FIFO made before the failure is gone."""
    seen: list = []
    real_ready = engineproc.EngineWorkerHost.wait_ready

    def failing_ready(self, timeout=30.0):
        seen.append(self)
        real_ready(self, timeout=30.0)
        return False  # as if the boot timed out

    monkeypatch.setattr(engineproc.EngineWorkerHost, "wait_ready", failing_ready)
    with pytest.raises(RuntimeError, match="failed to boot"):
        _cluster("port", pool_blocks=256, hbm_slots_per_engine=32, index_shards=1,
                 data_plane="shared", engine_processes=1)
    assert seen
    for host in seen:
        assert _gone(host.ring.shm_name)
        assert not os.path.exists(host.doorbell.path)
        assert not host.running()


def test_worker_kill9_leaves_no_leaks():
    c = _cluster("port", pool_blocks=256, hbm_slots_per_engine=32, index_shards=1,
                 data_plane="shared", engine_processes=1)
    names, paths = c.shm_segment_names(), c.doorbell_paths()
    c.workers[0].kill()  # SIGKILL: no atexit, no finally
    assert not c.workers[0].running()
    assert c.close() == []
    _hygiene(names, paths)


@pytest.mark.parametrize("time_limit", [240], indirect=True)
def test_exp14_procengine_smoke_under_hard_timeout(time_limit, tmp_path):
    """The exp14 twin at --fast (parity, the sweep, the chaos drill) in a
    subprocess under a hard limit, so a hung worker or service fails in
    bounded time; its parity numbers are JAX's run of this tree."""
    out = tmp_path / "exp14.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.experiments.exp14_procengine", "--fast",
         "--json", str(out)],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=200)
    assert proc.returncode == 0, (proc.stdout[-1500:], proc.stderr[-3000:])
    assert "bit_identical=True" in proc.stdout and "restarts=1" in proc.stdout
    res = json.loads(out.read_text())
    assert res["parity"]["pinned_mismatches"] == []
    assert exp14.one_engine_settled(res["parity"], res["sweep"])
    for cell in res["sweep"]:
        assert cell["n_done"] == 48 and cell["hygiene"]["settled"]
        assert cell["hygiene"]["left"] == []
        assert cell["bytes_moved_total"] <= res["sweep"][0]["bytes_moved_total"]
    ch = res["chaos"]
    assert (ch["restarts"], ch["allocator_restarts"], ch["n_done"], ch["settled"]) == (1, 1, 48,
                                                                                        True)
    assert len(ch["worker_boot_s"]) == 1
    # PINNED is the JAX package's parity on this tree
    from benchmarks.exp14_procengine import _run_once

    jref, _, _ = _run_once(True, 1, data_plane="private")
    assert {k: jref[k] for k in exp14.PARITY_KEYS} == exp14.PINNED["fast"]
