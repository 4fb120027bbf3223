"""Engine worker processes over the shared data plane (paper §5.1).

Twin of ``repro/serving/engineproc.py``. One worker process per modeled GPU
hosts the whole serving stack (``EngineInstance``, ``KVCacheManager``, HBM
cache, ``PoolTransfer``) and runs it against:

  * the pool's shared payload segment (``core/shmpool.SharedPoolSegment``):
    a fetch or a writeback moves KV blocks by loads and stores on memory
    every process maps, with no copy through the parent;
  * the allocator ring back to the pool-owning parent (``core/wire.
    RemotePool``), its slots partitioned so that N workers share it;
  * the metadata rings of the shard service processes, likewise
    partitioned between the parent and the workers.

The parent drives a worker over a small command ring of its own (the slot
protocol of ``core/rpc.py``, the codec below, byte for byte the
reference's): submit requests, run the virtual clock, page results and
counters back. Only token ids, times and counters cross it; KV bytes exist
only in the shared segment. An idle worker parks on a FIFO doorbell as a
shard service does (``core/procserver.serve``).

``EngineWorkerSupervisor`` keeps one worker alive across crashes: it
reconciles the dead worker's pool leases (``on_worker_death``), respawns it
on a fresh command ring and replays the requests not yet seen done.
``CutoverForwarder`` carries a new ring generation into a worker: a shard
respawned by its watchdog, or the allocator restarted
(``serving/scheduler.Cluster.restart_allocator``), becomes a ``WCMD_ADOPT``
over the command ring.

Differences from the reference, by design:

  * A worker is forked from multiprocessing's forkserver
    (``worker_context``), never from the parent, which has torch's thread
    pools and on the card a CUDA context (the reference forks the parent
    unless jax is loaded). The forkserver, started once a process, imports
    the worker's stack with its thread pools held to one thread, so it
    forks from a single thread and a worker, or a respawn, starts without
    a fresh interpreter's ``import torch`` (``EngineWorkerSupervisor.
    boot_s`` times each respawn). A worker runs torch on the CPU only (it
    makes no CUDA context) with one thread, so that N workers do not
    oversubscribe the host.
  * The supervisor has no probe thread and takes no lock. Its owner's
    thread alone restarts a worker: in ``check()``, or when a command finds
    the worker dead (its liveness is exact: the child's exit code), and the
    new ``host`` is published as one attribute. The reference's supervisor
    also restarts from a probe thread after a heartbeat grace window
    (``src/repro/serving/engineproc.py:754``).
  * A watchdog does not call the forwarders. The owner calls ``forward()``
    before it commands the workers, and a forwarder sends ``WCMD_ADOPT``
    when its shard's watchdog has published a generation the worker has not
    adopted. The reference's supervisor calls every registered client's
    ``adopt_ring`` from its probe thread.
  * The idle knobs are ``core/procserver``'s constants; the reference
    carries them in the worker's spec. The command ring's geometry
    (``CMD_SLOTS``, ``CMD_PAYLOAD``) and ``MAX_RESTARTS`` are constants
    too, where the reference takes them as keyword arguments.
  * A run that finds its worker dead is healed by ``rerun`` once the
    owner has collected every worker's run, so that the restart's lease
    reconcile meets no live worker's traffic; the reference restarts it at
    once, under its ledger's mutex.
"""

from __future__ import annotations

import atexit
import math
import os
import struct
import time
from dataclasses import dataclass

import numpy as np

from repro_torch.core import diag
from repro_torch.core.procserver import READY_TIMEOUT_S, serve
from repro_torch.core.rpc import (
    CTRL_READY,
    CTRL_STOP,
    RESP_ERROR,
    RESP_READY,
    RingClient,
    RingError,
    RingRetryPolicy,
    RingServiceDied,
    SlotRing,
)
from repro_torch.core.shm import FifoDoorbell
from repro_torch.core.wire import WireFormatError
from repro_torch.serving.request import Request

# ---------------------------------------------------------------------------
# the command codec (parent -> worker, little-endian; the reference's bytes)
# ---------------------------------------------------------------------------
#     SUBMIT  := op:u8 n:u32 arrival:f64 n_output:i32 req_idx:u32 tokens[n*i32]
#             -> n_queued:u32
#     RUN     := op:u8 mode:u8 until:f64      (mode 0 = drain, 1 = advance)
#             -> clock:f64 n_done:u32
#     RESULTS := op:u8 start:u32 max:u32
#             -> total:u32 m:u32 m * (req_idx:u32 t_admitted:f64 t_first:f64
#                t_done:f64 tokens_out:i32 hit_tokens:i32 state:u8)
#                (NaN stands for a None time)
#     STATS   := op:u8 -> _STATS_RESP (engine, manager and transfer counters
#                and the worker's virtual clock)
#     ADOPT   := op:u8 plane:u8 shard:u32 n_slots:u32 payload:u32
#                ring_len:u32 ring_name db_len:u32 doorbell_path
#             -> ok:u32
#                (plane 0: index shard ``shard``'s ring; plane 1: the
#                allocator's. The worker attaches the named segment and moves
#                its own client onto it.)
WCMD_SUBMIT, WCMD_RUN, WCMD_RESULTS, WCMD_STATS, WCMD_ADOPT = 1, 2, 3, 4, 5

_U32 = struct.Struct("<I")
_SUB_HDR = struct.Struct("<BIdiI")
_ADOPT_HDR = struct.Struct("<BBIII")
_RUN = struct.Struct("<BBd")
_RUN_RESP = struct.Struct("<dI")
_RES_REQ = struct.Struct("<BII")
_RES_REC = struct.Struct("<IdddiiB")
_STATS_REQ = struct.Struct("<B")
# clock | prefills decode_steps | busy fetch writeback | 7 manager counters
# | writes reads bytes_w bytes_r requests_issued | modeled_write modeled_read
_STATS_RESP = struct.Struct("<dQQdddQQQQQQQQQQQQdd")

# what a worker's stack imports, which the workers' forkserver imports once;
# the thread pools an import would start, held to one thread there
WORKER_PRELOAD = ["repro_torch.serving.scheduler"]
_ONE_THREAD = ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS", "MKL_NUM_THREADS")

_STATE_CODE = {"queued": 0, "running": 1, "done": 2}
_STATE_NAME = ["queued", "running", "done"]
PLANE_INDEX, PLANE_POOL = 0, 1
RUN_TIMEOUT_S = 600.0  # a drain's longest wait
CMD_SLOTS, CMD_PAYLOAD = 8, 1 << 16  # a command ring's geometry
MAX_RESTARTS = 16  # a supervisor's respawns of one worker


def _opt(v: float | None) -> float:
    return float("nan") if v is None else float(v)


def _unopt(v: float) -> float | None:
    return None if math.isnan(v) else v


def _unpack(st: struct.Struct, buf: bytes, off: int = 0) -> tuple:
    if len(buf) < off + st.size:
        raise WireFormatError(f"truncated worker command: need {off + st.size} B, "
                              f"have {len(buf)} B")
    return st.unpack_from(buf, off)


def _string(buf: bytes, off: int) -> tuple[str, int]:
    (n,) = _unpack(_U32, buf, off)
    off += 4
    if len(buf) < off + n:
        raise WireFormatError("truncated worker command string")
    return buf[off : off + n].decode(), off + n


def partition_slots(n_slots: int, n_parts: int) -> list[tuple[int, int]]:
    """Split one ring's slots into ``n_parts`` disjoint ``[lo, hi)`` ranges,
    the last taking the remainder. Each needs two slots or more, so that an
    owner keeps a call outstanding while one slot sits quarantined."""
    per = n_slots // n_parts
    if per < 2:
        raise ValueError(f"{n_slots} slots cannot be split {n_parts} ways (need >= 2 each)")
    return [(i * per, (i + 1) * per if i < n_parts - 1 else n_slots) for i in range(n_parts)]


def encode_adopt(plane: int, shard: int, n_slots: int, payload_bytes: int, ring_name: str,
                 doorbell_path: str = "") -> bytes:
    """ADOPT: move one of the worker's clients onto a new ring generation
    (plane 0: index shard ``shard``; plane 1: the allocator). An empty
    doorbell path means no doorbell."""
    rn, dp = ring_name.encode(), doorbell_path.encode()
    return (_ADOPT_HDR.pack(WCMD_ADOPT, plane, shard, n_slots, payload_bytes)
            + _U32.pack(len(rn)) + rn + _U32.pack(len(dp)) + dp)


_CTX = None  # the workers' forkserver context, once started


def worker_context():
    """multiprocessing's ``forkserver`` context, its server running: started
    at the first call, it imports ``WORKER_PRELOAD`` while the caller goes on
    (a first ``start`` waits for it). Its environment alone holds the
    ``_ONE_THREAD`` variables at 1 and this package's directory at the head
    of ``PYTHONPATH``: Python 3.12.3's forkserver does not apply the
    parent's ``sys.path`` before it imports, and a failed import there is
    silent (every worker then imports torch itself). Only that first call
    sets ``os.environ``, for the server's start; a caller starts the server
    before it starts threads that spawn (``Cluster`` does)."""
    global _CTX
    if _CTX is not None:
        return _CTX
    import multiprocessing.forkserver

    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(WORKER_PRELOAD)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {k: "1" for k in _ONE_THREAD}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        multiprocessing.forkserver.ensure_running()
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
    _CTX = ctx
    return ctx


def _ring_liveness(client: RingClient):
    """A worker's clients have no handle on the service's process: a
    retired ring has ``CTRL_STOP`` set (by the watchdog or the allocator's
    restart), so the client's current ring says whether to keep waiting."""

    def live() -> bool:
        ctrl = client.ring.ctrl
        return ctrl is not None and not ctrl[CTRL_STOP]

    return live


@dataclass(frozen=True)
class EngineWorkerSpec:
    """What a worker needs to build its stack: names and numbers (the pool's
    attach spec is plain data too); nothing live crosses into the child."""

    engine_id: int
    pool_spec: dict  # KVBlockPool.share_data() / TieredPool.share_data()
    cmd_ring_name: str
    cmd_slots: int
    cmd_payload: int
    cmd_doorbell_name: str
    pool_ring_name: str
    pool_slots: int
    pool_payload: int
    pool_doorbell_name: str
    pool_slot_range: tuple[int, int]
    index_ring_names: tuple[str, ...]
    index_slots: int
    index_payload: int
    index_doorbell_names: tuple[str, ...]
    index_slot_range: tuple[int, int]
    hbm_slots: int
    transfer_mode: str  # beluga | rdma | none
    super_block_tokens: int
    straggler_cutover: float | None
    runner: object  # serving.engine.SimRunnerConfig
    # self-healing: the clients' liveness reads CTRL_STOP, the index plane
    # retries and degrades, and its journal appends go to the parent's
    # journals over the allocator ring
    selfheal: bool = False
    retry: RingRetryPolicy | None = None


# ---------------------------------------------------------------------------
# the worker's side
# ---------------------------------------------------------------------------
def _build_worker_stack(spec: EngineWorkerSpec):
    """Attach the segments and rings and build the serving stack. Returns
    (engine, clients, closeables): ``clients`` names the worker's service
    clients (``{"pool": RingClient, "index": [RingClient, ...]}``) for
    ``WCMD_ADOPT``; closing each closeable is the worker's teardown."""
    from repro_torch.core.shmpool import SharedPoolSegment, TieredWorkerPool, WorkerPool
    from repro_torch.core.transfer import PoolTransfer
    from repro_torch.core.wire import JournalProxy, RemotePool, ShardedRemoteIndex
    from repro_torch.kvcache.hbm_cache import HbmPagedCache
    from repro_torch.kvcache.manager import KVCacheManager
    from repro_torch.serving.engine import EngineInstance, SimRunner
    from repro_torch.serving.scheduler import _no_offload_plan

    closeables = []
    shared = SharedPoolSegment(spec.pool_spec)
    closeables.append(shared)

    def client(name: str, n_slots: int, payload: int, bell: str, slot_range) -> RingClient:
        ring = SlotRing.attach(name, n_slots, payload)
        closeables.append(ring)
        rpc = RingClient(ring, doorbell=FifoDoorbell.attach(bell), slot_range=slot_range)
        closeables.append(rpc)
        if spec.selfheal:
            rpc.liveness = _ring_liveness(rpc)
        return rpc

    pool_rpc = client(spec.pool_ring_name, spec.pool_slots, spec.pool_payload,
                      spec.pool_doorbell_name, spec.pool_slot_range)
    alloc = RemotePool(pool_rpc, spec.pool_spec["n_blocks"], max_payload=spec.pool_payload)
    tiering = spec.pool_spec.get("tiering")
    pool = WorkerPool(shared, alloc) if tiering is None else TieredWorkerPool(shared, alloc, tiering)
    bt = spec.pool_spec["block_tokens"]
    index_rpcs = [client(name, spec.index_slots, spec.index_payload, bell, spec.index_slot_range)
                  for name, bell in zip(spec.index_ring_names, spec.index_doorbell_names)]
    # an eviction's freed ids go back to the pool's owner over the allocator
    # ring; under selfheal, publishes are journalled in the parent's journals
    # (a respawned shard replays workers' publishes too), and the index
    # plane retries and degrades
    journals = ([JournalProxy(pool_rpc, s, max_payload=spec.pool_payload, retry=spec.retry)
                 for s in range(len(index_rpcs))] if spec.selfheal else None)
    index = ShardedRemoteIndex(index_rpcs, bt, retry=spec.retry if spec.selfheal else None,
                               on_freed=alloc.release, journals=journals, degrade=spec.selfheal)
    transfer = PoolTransfer(pool, mode="beluga" if spec.transfer_mode == "none"
                            else spec.transfer_mode, super_block_tokens=spec.super_block_tokens)
    mgr = KVCacheManager(pool, index, HbmPagedCache(spec.hbm_slots, bt), transfer,
                         recompute_cutover=spec.straggler_cutover,
                         prefill_tok_per_s=spec.runner.prefill_tok_per_s,
                         degraded_ok=spec.selfheal)
    if spec.transfer_mode == "none":
        mgr.plan_fetch = _no_offload_plan(mgr)
        mgr.writeback = lambda *a, **k: 0
    engine = EngineInstance(spec.engine_id, mgr, SimRunner(spec.runner))
    return engine, {"pool": pool_rpc, "index": index_rpcs}, closeables


def _make_worker_handler(engine, reqs: list, clients: dict, closeables: list):
    """The command ring's dispatcher, run in the worker's serve loop."""

    def adopt(payload: bytes) -> bytes:
        _, plane, shard, n_slots, payload_bytes = _unpack(_ADOPT_HDR, payload)
        ring_name, off = _string(payload, _ADOPT_HDR.size)
        bell_path, _ = _string(payload, off)
        if plane == PLANE_POOL:
            target = clients["pool"]
        elif shard < len(clients["index"]):
            target = clients["index"][shard]
        else:
            raise WireFormatError(f"adopt: index shard {shard} out of range")
        ring = SlotRing.attach(ring_name, n_slots, payload_bytes)
        closeables.append(ring)
        old = target.ring
        target.adopt_ring(ring, liveness=_ring_liveness(target),
                          doorbell=FifoDoorbell.attach(bell_path) if bell_path else None)
        # one thread: no call is in flight on the retired ring, so it goes now
        closeables.remove(old)
        old.close()
        return _U32.pack(1)

    def handler(payload: bytes) -> bytes:
        if not payload:
            raise WireFormatError("empty worker command")
        op = payload[0]
        if op == WCMD_ADOPT:
            return adopt(payload)
        if op == WCMD_SUBMIT:
            _, n, arrival, n_output, req_idx = _unpack(_SUB_HDR, payload)
            if len(payload) < _SUB_HDR.size + 4 * n:
                raise WireFormatError("truncated SUBMIT tokens")
            tokens = np.frombuffer(payload, np.int32, n, _SUB_HDR.size).tolist()
            req = Request(req_id=f"w{engine.engine_id}-{req_idx}", tokens=tokens,
                          n_output=n_output, arrival=arrival)
            reqs.append((req_idx, req))
            engine.submit(req)
            return _U32.pack(engine.n_queued)
        if op == WCMD_RUN:
            _, mode, until = _unpack(_RUN, payload)
            if mode == 0:
                engine.drain()
            else:
                engine.advance(until)
            return _RUN_RESP.pack(engine.clock, sum(1 for _, r in reqs if r.state == "done"))
        if op == WCMD_RESULTS:
            _, start, max_items = _unpack(_RES_REQ, payload)
            page = reqs[start : start + max_items]
            out = [_U32.pack(len(reqs)), _U32.pack(len(page))]
            out += [_RES_REC.pack(idx, _opt(r.t_admitted), _opt(r.t_first_token),
                                  _opt(r.t_done), r.tokens_out, r.hit_tokens,
                                  _STATE_CODE[r.state]) for idx, r in page]
            return b"".join(out)
        if op == WCMD_STATS:
            es, ms = engine.stats, engine.manager.stats
            ts = engine.manager.transfer.stats
            return _STATS_RESP.pack(
                engine.clock, es.prefills, es.decode_steps, es.busy_s, es.fetch_s,
                es.writeback_s, ms.prefix_hits_tokens, ms.prefix_miss_tokens, ms.fetches,
                ms.writebacks, ms.recompute_cutovers, ms.pool_evictions, ms.degraded_ops,
                ts.writes, ts.reads, ts.bytes_written, ts.bytes_read, ts.requests_issued,
                ts.modeled_write_s, ts.modeled_read_s)
        raise WireFormatError(f"unknown worker command {op}")

    return handler


def _engine_worker_main(spec: EngineWorkerSpec) -> None:
    """The child: build the stack, serve the command ring until
    ``CTRL_STOP``, close everything."""
    import torch

    torch.set_num_threads(1)  # N workers share the host's cores
    cmd_ring = SlotRing.attach(spec.cmd_ring_name, spec.cmd_slots, spec.cmd_payload)
    bell = FifoDoorbell.attach(spec.cmd_doorbell_name)
    engine, clients, closeables = _build_worker_stack(spec)
    handler = _make_worker_handler(engine, [], clients, closeables)
    try:
        serve(cmd_ring, handler, bell)
    finally:
        handler = engine = clients = None  # drop the views before the mappings go
        for c in closeables:
            c.close()
        bell.close()
        cmd_ring.close()
    # everything the worker opened is closed: skip the interpreter's teardown
    # of torch (about 0.7 s a worker on an 8-core host), which frees nothing
    # the exit does not
    os._exit(0)


# ---------------------------------------------------------------------------
# the parent's side
# ---------------------------------------------------------------------------
class EngineWorkerHost:
    """The parent's handle on one worker process. It owns the command ring
    and its doorbell (and unlinks both); the data segment and the allocator
    and metadata rings belong to others, and only their names go to the
    worker. ``stop`` sets ``CTRL_STOP`` and escalates to SIGTERM and
    SIGKILL; ``close`` also unlinks, may run twice, and is held by an
    ``atexit`` hook from construction on."""

    def __init__(self, spec_kwargs: dict):
        self.ring = self.doorbell = self.proc = self.client = None
        self._closed = False
        atexit.register(self.close)
        try:
            self.ring = SlotRing.create_shared(CMD_SLOTS, CMD_PAYLOAD)
            self.doorbell = FifoDoorbell.create()
        except BaseException:
            self.close()
            raise
        self.spec = EngineWorkerSpec(cmd_ring_name=self.ring.shm_name, cmd_slots=CMD_SLOTS,
                                     cmd_payload=CMD_PAYLOAD,
                                     cmd_doorbell_name=self.doorbell.path, **spec_kwargs)
        self.engine_id = self.spec.engine_id
        self.client = RingClient(self.ring, liveness=self.running,
                                 doorbell=FifoDoorbell.attach(self.doorbell.path))
        self.proc = worker_context().Process(
            target=_engine_worker_main, args=(self.spec,), daemon=True, name="engine-worker")
        self.n_submitted = 0

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "EngineWorkerHost":
        self.proc.start()
        return self

    @property
    def ready(self) -> bool:
        ctrl = None if self.ring is None else self.ring.ctrl
        return ctrl is not None and bool(ctrl[CTRL_READY])

    def running(self) -> bool:
        """The child was started and has no exit code yet: the command
        client's liveness. It reaps (a forkserver child's exit code is read
        off its sentinel, which reads empty afterwards), so the owner's
        thread alone asks."""
        p = self.proc
        return p is not None and p.pid is not None and p.exitcode is None

    def wait_ready(self, timeout: float = READY_TIMEOUT_S) -> bool:
        deadline = time.monotonic() + timeout
        while not self.ready:
            if self.proc.pid is not None and not self.running():
                return False
            if time.monotonic() > deadline:
                return False
            time.sleep(1e-3)
        return True

    def kill(self) -> None:
        """Crash the worker (SIGKILL) and wait until it has exited."""
        if self.running():
            self.proc.kill()
            self.proc.join(5.0)

    def stop(self, timeout: float = 5.0) -> None:
        """Set ``CTRL_STOP`` (also on a dead worker's ring, so that anything
        still holding it fails fast), wake the worker and reap it."""
        if self.ring is not None and self.ring.ctrl is not None:
            self.ring.ctrl[CTRL_STOP] = 1
            self.doorbell.set()
        p = self.proc
        if p is None or p.pid is None:
            return
        p.join(timeout)
        if p.is_alive():
            p.terminate()
            p.join(1.0)
        if p.is_alive():
            p.kill()
            p.join(1.0)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self.stop()
        finally:
            if self.client is not None:
                self.client.close()
            if self.ring is not None:
                self.ring.close()
            if self.doorbell is not None:
                self.doorbell.close()
            atexit.unregister(self.close)

    def segment_names(self) -> list[str]:
        return [self.spec.cmd_ring_name]

    def doorbell_paths(self) -> list[str]:
        return [self.spec.cmd_doorbell_name]

    # -- commands ---------------------------------------------------------
    def submit_indexed(self, req: Request, req_idx: int) -> None:
        """Ship one request; ``req_idx`` (the parent's index) comes back
        with its results."""
        body = np.asarray(req.tokens, np.int32).tobytes()
        if _SUB_HDR.size + len(body) > self.spec.cmd_payload:
            raise WireFormatError(f"prompt of {len(req.tokens)} tokens exceeds the "
                                  f"{self.spec.cmd_payload} B command slot")
        req.engine_id = self.engine_id
        self.client.call(_SUB_HDR.pack(WCMD_SUBMIT, len(req.tokens), req.arrival, req.n_output,
                                       req_idx) + body)
        self.n_submitted += 1

    def post_run(self, until: float | None = None) -> int:
        """Post a run without waiting, so that every worker's clock starts
        before the parent collects any."""
        mode, horizon = (0, 0.0) if until is None else (1, until)
        return self.client.post(_RUN.pack(WCMD_RUN, mode, horizon))

    def collect_run(self, slot: int, timeout: float = RUN_TIMEOUT_S) -> float:
        """Wait out a drain with 2 ms naps on the slot's status word (the
        parent's allocator thread needs the interpreter meanwhile), then
        collect; returns the worker's clock."""
        ring = self.client.ring
        deadline = time.perf_counter() + timeout
        while int(ring.status[slot]) not in (RESP_READY, RESP_ERROR):
            if not self.running() or time.perf_counter() > deadline:
                break  # collect says which: died or timed out
            time.sleep(2e-3)
        return _RUN_RESP.unpack(self.client.collect(slot, timeout))[0]

    def run(self, until: float | None = None, timeout: float = RUN_TIMEOUT_S) -> float:
        return self.collect_run(self.post_run(until), timeout)

    def adopt(self, msg: bytes) -> None:
        """Send one ``WCMD_ADOPT`` (``encode_adopt``)."""
        self.client.call(msg, timeout=60.0)

    def fetch_results(self) -> list[tuple]:
        """Every request's record, paged: (req_idx, t_admitted, t_first,
        t_done, tokens_out, hit_tokens, state)."""
        page = max(1, (self.spec.cmd_payload - 16) // _RES_REC.size)
        out: list[tuple] = []
        while True:
            resp = self.client.call(_RES_REQ.pack(WCMD_RESULTS, len(out), page))
            total, m = _unpack(_U32, resp)[0], _unpack(_U32, resp, 4)[0]
            for j in range(m):
                idx, ta, tf, td, tout, hit, st = _unpack(_RES_REC, resp, 8 + j * _RES_REC.size)
                out.append((idx, _unopt(ta), _unopt(tf), _unopt(td), tout, hit,
                            _STATE_NAME[st]))
            if len(out) >= total or m == 0:
                return out

    def apply_results(self, requests: list[Request]) -> None:
        """Fold the worker's times into the parent's requests, matched by
        the echoed index."""
        for rec in self.fetch_results():
            _fold(requests, rec, self.engine_id)

    def stats_dict(self) -> dict:
        (clock, prefills, decode_steps, busy_s, fetch_s, writeback_s, hit_tok, miss_tok,
         fetches, writebacks, cutovers, evictions, degraded, t_writes, t_reads, t_bw, t_br,
         t_reqs, t_mw, t_mr) = _unpack(_STATS_RESP,
                                       self.client.call(_STATS_REQ.pack(WCMD_STATS)))
        return {
            "clock": clock,
            "engine": {"prefills": prefills, "decode_steps": decode_steps, "busy_s": busy_s,
                       "fetch_s": fetch_s, "writeback_s": writeback_s},
            "manager": {"prefix_hits_tokens": hit_tok, "prefix_miss_tokens": miss_tok,
                        "fetches": fetches, "writebacks": writebacks,
                        "recompute_cutovers": cutovers, "pool_evictions": evictions,
                        "degraded_ops": degraded},
            "transfer": {"writes": t_writes, "reads": t_reads, "bytes_written": t_bw,
                         "bytes_read": t_br, "requests_issued": t_reqs,
                         "modeled_write_s": t_mw, "modeled_read_s": t_mr},
        }


def _fold(requests: list[Request], rec: tuple, engine_id: int) -> None:
    idx, ta, tf, td, tout, hit, state = rec
    r = requests[idx]
    r.t_admitted, r.t_first_token, r.t_done = ta, tf, td
    r.tokens_out, r.hit_tokens, r.state = tout, hit, state
    r.engine_id = engine_id


_WORKER_DOWN = (RingServiceDied, TimeoutError)


class EngineWorkerSupervisor:
    """Keeps one engine worker alive across crashes (the reference's
    supervisor, without its probe thread and its lock).

    A worker's requests in flight die with it, so the supervisor keeps the
    requests submitted and not yet seen done (``_pending``) and replays
    them, in submit order, into the respawned worker. The engines are
    deterministic virtual-clock simulators, so a replayed worker converges
    with a run without the fault on what the data plane shows (requests
    done, free blocks, the index).

    A restart happens on the owner's thread: in ``check()``, when a command
    finds the worker dead, or in ``rerun`` for a run that found it dead,
    which the owner calls once it has collected every worker's run. It
    reaps the old worker, sets its ring's ``CTRL_STOP``, calls
    ``on_worker_death(engine_id)`` (the cluster reconciles the dead
    worker's pool leases there), builds the new worker's spec with
    ``spec_factory`` (so it attaches the current ring generations),
    publishes the new ``host``, and replays. At most ``MAX_RESTARTS``
    restarts; ``boot_s`` holds each respawn's host wall seconds from its
    start to ``CTRL_READY``."""

    def __init__(self, spec_factory, *, on_worker_death=None):
        self._spec_factory = spec_factory
        self.on_worker_death = on_worker_death
        self.restarts = 0
        self.reconciled: list = []  # one reconcile summary a restart
        self.boot_s: list[float] = []
        self.host = EngineWorkerHost(spec_factory())
        self.engine_id = self.host.engine_id
        self._retired: list[EngineWorkerHost] = []
        self._pending: dict[int, Request] = {}
        self._closed = False

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "EngineWorkerSupervisor":
        self.host.start()
        return self

    def wait_ready(self, timeout: float = READY_TIMEOUT_S) -> bool:
        return self.host.wait_ready(timeout)

    def running(self) -> bool:
        """Any generation's worker has not exited."""
        return any(h.running() for h in (self.host, *self._retired))

    def kill(self) -> None:
        """Crash the current worker (SIGKILL)."""
        self.host.kill()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for h in (self.host, *self._retired):
            h.close()

    def segment_names(self) -> list[str]:
        """Every generation's command ring."""
        return [n for h in (self.host, *self._retired) for n in h.segment_names()]

    def doorbell_paths(self) -> list[str]:
        return [p for h in (self.host, *self._retired) for p in h.doorbell_paths()]

    # -- restarting --------------------------------------------------------
    def check(self) -> bool:
        """One probe step; True when it restarted the worker."""
        if self._closed or self.host.running():
            return False
        return self._restart()

    def _heal(self, seen: int) -> None:
        """A command found the worker dead: restart it, unless that already
        happened since the command's generation ``seen``."""
        if self.restarts == seen:
            self.check()

    def _restart(self) -> bool:
        if self.restarts >= MAX_RESTARTS:
            return False
        old = self.host
        old.stop()  # reap; sets the retired ring's CTRL_STOP
        self._retired.append(old)
        if self.on_worker_death is not None:
            try:
                self.reconciled.append(self.on_worker_death(self.engine_id))
            except (RingError, TimeoutError):  # healing goes on; the leases leak
                diag.note("engineproc.reconcile_hook.failed")
                self.reconciled.append(None)
        host = EngineWorkerHost(self._spec_factory())
        t0 = time.perf_counter()
        host.start()
        self.host = host
        self.restarts += 1
        if host.wait_ready():
            self.boot_s.append(time.perf_counter() - t0)
            try:
                for idx in sorted(self._pending):
                    host.submit_indexed(self._pending[idx], idx)
            except _WORKER_DOWN:
                diag.note("engineproc.replay.worker_down")  # the next heal replays again
        return True

    # -- the engine's surface, healing on a dead worker --------------------
    def submit_indexed(self, req: Request, req_idx: int) -> None:
        self._pending[req_idx] = req  # first: a crash mid-submit still replays it
        gen = self.restarts
        try:
            self.host.submit_indexed(req, req_idx)
        except _WORKER_DOWN:
            self._heal(gen)
            if self.restarts == gen:
                raise  # no restart: alive after all, or out of restarts
            # the restart replayed _pending, this request with it

    def load(self) -> float:
        """Requests submitted and not yet seen done."""
        return float(len(self._pending))

    def post_run(self, until: float | None = None):
        """Post a run; a worker found dead here is left to ``rerun``."""
        try:
            slot = self.host.post_run(until)
        except RuntimeError:  # no free slot on a dead worker's ring
            slot = None
        return (self.restarts, self.host, slot, until)

    def collect_run(self, token, timeout: float = RUN_TIMEOUT_S) -> float | None:
        """The worker's clock, or None when the worker died under this run
        (or a live worker's run failed in-band): the owner then calls
        ``rerun(token)`` once no other worker holds a command."""
        _, host, slot, _ = token
        if slot is None:
            return None
        try:
            return host.collect_run(slot, timeout)
        except (RuntimeError, TimeoutError):
            return None

    def rerun(self, token, timeout: float = RUN_TIMEOUT_S) -> float:
        """Restart the worker if it is dead, then run again on the current
        generation, whose replayed submits cover the lost run."""
        gen, _, _, until = token
        self._heal(gen)
        return self.host.run(until, timeout)

    def _with_heal(self, op, attempts: int = 3):
        for i in range(attempts):
            gen = self.restarts
            try:
                return op(self.host)
            except _WORKER_DOWN:
                if i == attempts - 1:
                    raise
                self._heal(gen)

    def adopt(self, msg: bytes) -> None:
        self._with_heal(lambda h: h.adopt(msg))

    def fetch_results(self) -> list[tuple]:
        return self._with_heal(lambda h: h.fetch_results())

    def apply_results(self, requests: list[Request]) -> None:
        for rec in self.fetch_results():
            _fold(requests, rec, self.engine_id)
            if rec[6] == "done":
                self._pending.pop(rec[0], None)  # acknowledged: out of the ledger

    def stats_dict(self) -> dict:
        return self._with_heal(lambda h: h.stats_dict())


class CutoverForwarder:
    """Carries a new ring generation into one worker (the reference's
    ``_WorkerCutoverForwarder``): ``adopt_ring`` sends ``WCMD_ADOPT``, so that
    the client inside the worker attaches the fresh segment itself; only
    names cross. With a ``source`` (a shard's ``core/procserver.
    ShardWatchdog``), ``forward()`` does so when the watchdog has published a
    generation this forwarder has not carried yet. A worker that is down is
    passed over: its respawn spec names the current rings."""

    def __init__(self, worker, plane: int, shard: int = 0, source=None):
        self.worker = worker  # EngineWorkerHost or EngineWorkerSupervisor
        self.plane = plane
        self.shard = shard
        self.source = source
        self._seen = None if source is None else source.generation.number

    def forward(self) -> bool:
        """Adopt the source's newest generation in the worker if it moved;
        True when a cutover was sent."""
        gen = self.source.generation
        if gen.number == self._seen:
            return False
        self._seen = gen.number
        srv = gen.service
        self.adopt_ring(srv.ring, bell_path=srv.spec.doorbell_path)
        return True

    def adopt_ring(self, ring: SlotRing, bell_path: str = "") -> None:
        msg = encode_adopt(self.plane, self.shard, ring.n_slots, ring.payload_bytes,
                           ring.shm_name, bell_path)
        try:
            self.worker.adopt(msg)
        except _WORKER_DOWN:
            diag.note("engineproc.cutover_forward.worker_down")
