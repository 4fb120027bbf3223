"""``RealEngine`` with its prefix index behind CXL-RPC rings (``chip_smoke.py``
phase 20 (ii)-(iv); ``tests/test_torch_fault_tolerance.py`` and
``tests/test_torch_selfheal.py`` run it on a reduced config on the CPU).

The paper's deployment shape: engines reach the index over CXL-RPC. Here
the engine's ``index`` field is swapped, as any caller could, for the
client side of S rings; ``RealEngine`` itself is unchanged. Each ring is
served either by a ``RingServer`` thread over a ``PrefixIndex`` shard of
the engine's pool (``core/wire.RingPlane``, the thread transport; the
threads park on a doorbell when idle), or by a shard service process of
its own over the pool's shared metadata (``core/procserver.ProcessPlane``,
the process transport), optionally under a ``ShardWatchdog`` with no probe
thread, whose owner restarts a dead shard with ``check``.

  * ``serve(eng, prompts, max_new, n_shards, transport, watched)`` serves
    prompts on a fresh pool with a ``PrefixIndex`` (``n_shards`` 0) or over
    ``n_shards`` rings whose client retries under a ``RingRetryPolicy``,
    and returns per request the tokens, the logits, the hit tokens, the
    block ids and epochs the index holds for the prompt's chain afterwards
    (``chain_state``), the TTFT, the host time spent in index calls, the
    ring round trips, and the clients' wait on them (post to answer;
    ``mean_wait_s`` a round trip);
  * ``faulted(eng, plane, prompts, plan)`` serves prompts again through a
    thread plane under a ``FaultPlan`` (delay and drop windows on the ring
    clients' posts, ``distributed/fault_tolerance.py``);
  * ``respawn(plane)`` kills a watched plane's first shard service
    (``kill -9``) and restarts it from its journal with one ``check``;
    ``rerun(eng, plane, prompts)`` serves prompts again through a plane.

Times are the host's clock (``time.perf_counter``).
"""

from __future__ import annotations

import time

from repro_torch.core.index import PrefixIndex, ShardedPrefixIndex
from repro_torch.core.pool import KVBlockPool
from repro_torch.core.procserver import ProcessPlane, process_plane
from repro_torch.core.rpc import RingRetryPolicy
from repro_torch.core.wire import RingPlane, ring_plane
from repro_torch.distributed.fault_tolerance import FaultInjector, FaultPlan

N_SLOTS, PAYLOAD = 64, 1 << 16  # ClusterConfig's index_rpc_slots / index_rpc_payload


def chain_state(index, prompt, block_tokens: int) -> tuple[list, list]:
    """The block ids and epochs ``index`` holds for ``prompt``'s full
    blocks (None where a key is missing)."""
    keys = index.keys_for(prompt)[: len(prompt) // block_tokens]
    ents = index.lookup_many(list(keys))
    return ([None if e is None else e.block_id for e in ents],
            [None if e is None else e.epoch for e in ents])


def fresh_pool(eng) -> KVBlockPool:
    """Give ``eng`` a new, empty pool of its pool's geometry (the old one is
    dropped first, so that two never stand at once)."""
    layout, n, dev, shards = eng.pool.layout, eng.pool.n_blocks, eng.pool.device, eng.pool.n_shards
    eng.pool = None
    eng.pool = KVBlockPool(layout, n, dev, n_shards=shards)
    return eng.pool


class _TimedIndex:
    """An index whose calls add their host time to ``spent``."""

    def __init__(self, inner):
        self.inner = inner
        self.spent = 0.0

    def __getattr__(self, name):
        fn = getattr(self.inner, name)

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.spent += time.perf_counter() - t0

        return timed


def _generate_all(eng, prompts, max_new: int, plane: RingPlane | ProcessPlane | None,
                  backing) -> list[dict]:
    out = []
    timed = _TimedIndex(eng.index)
    eng.index = timed
    try:
        for p in prompts:
            rt0 = plane.round_trips() if plane else 0
            w0 = plane.total_wait() if plane else 0.0
            timed.spent = 0.0
            toks, info = eng.generate(p, max_new=max_new)
            n_rt = (plane.round_trips() - rt0) if plane else 0
            # read before chain_state, whose lookup crosses a process plane's ring
            wait = (plane.total_wait() - w0) if plane else 0.0
            ids, epochs = chain_state(backing, p, eng.pool.layout.block_tokens)
            out.append({
                "tokens": toks, "logits": info["logits"].cpu(), "hit_tokens": info["hit_tokens"],
                "block_ids": ids, "epochs": epochs,
                "ttft_s": info["ttft_s"], "index_s": timed.spent, "round_trips": n_rt,
                "wait_s": wait,
            })
            out[-1]["mean_wait_s"] = out[-1]["wait_s"] / n_rt if n_rt else 0.0
    finally:
        eng.index = timed.inner
    return out


def serve(eng, prompts, max_new: int, n_shards: int = 0, transport: str = "thread",
          watched: bool = False) -> tuple[list[dict], RingPlane | ProcessPlane | None]:
    """Serve ``prompts`` on ``eng`` with a fresh pool and a fresh index: a
    ``PrefixIndex`` (``n_shards`` 0), or the client side of ``n_shards``
    rings over the new pool, served by threads (``transport="thread"``) or
    by shard service processes (``"process"``, each under a
    ``ShardWatchdog`` without a probe thread when ``watched``). The plane
    is returned still serving (the caller closes it)."""
    pool = fresh_pool(eng)
    if not n_shards:
        eng.index = PrefixIndex(pool)
        return _generate_all(eng, prompts, max_new, None, eng.index), None
    if transport == "process":
        plane = process_plane(pool, n_shards, N_SLOTS, PAYLOAD, selfheal=watched,
                              retry=RingRetryPolicy(), probe=False)
        backing = plane.remote
    else:
        backing = ShardedPrefixIndex(pool, n_shards) if n_shards > 1 else PrefixIndex(pool)
        plane = ring_plane(backing, N_SLOTS, PAYLOAD, retry=RingRetryPolicy())
    eng.index = plane.remote
    try:
        return _generate_all(eng, prompts, max_new, plane, backing), plane
    except BaseException:
        plane.close()
        raise


def rerun(eng, plane: RingPlane | ProcessPlane, prompts, max_new: int) -> list[dict]:
    """Serve ``prompts`` again through ``plane`` (its services running, its
    pool the engine's)."""
    eng.index = plane.remote
    backing = plane.remote if isinstance(plane, ProcessPlane) else plane.backing
    return _generate_all(eng, prompts, max_new, plane, backing)


def respawn(plane: ProcessPlane) -> dict:
    """``kill -9`` the first shard's service of a watched plane, then one
    ``check`` restarts it from the journal; returns the restart's wall
    time (kill to the new service ready) and the journal records it
    replayed."""
    wd = plane.services[0]
    records = len(wd.journal)
    t0 = time.perf_counter()
    wd.kill()
    if not wd.check():
        raise RuntimeError("the watchdog did not restart the killed shard")
    return {"respawn_s": time.perf_counter() - t0, "replayed": records,
            "ready": wd.generation.service.ready}


def faulted(eng, plane: RingPlane, prompts, max_new: int, plan: FaultPlan) -> list[dict]:
    """Serve ``prompts`` through ``plane`` (its servers running, its pool the
    engine's) with ``plan``'s windows on its clients' posts, each dict with
    the retries its request took. The plan's clock starts just before each
    request."""
    inj = FaultInjector(plan, supervisors=())
    for s, c in enumerate(plane.clients):
        inj.attach_client(s, c)
    eng.index = plane.remote
    out = []
    try:
        for p in prompts:
            inj.start()
            r0 = plane.retries()
            out.extend(_generate_all(eng, [p], max_new, plane, plane.backing))
            out[-1]["retries"] = plane.retries() - r0
    finally:
        for c in plane.clients:
            del c.post  # the injector's wrapper goes; the method is back
    return out
