"""Exp #11 (Fig. 15) on the port: the CXL-RPC metadata plane, real index
ops over the shared-memory ring, served by threads and by processes.

Twin of ``benchmarks/exp11_rpc.py``. A ``PrefixIndex`` is served through the
wire codec (``core/wire.py``) by a ``RingServer`` thread, and a
``RemoteIndex`` sends the traffic a request really makes:

  * ``match_prefix`` at QD=1 for one key, and for a paper-scale chain
    (15,000 tokens: 937 keys) in one framed message;
  * batched against per-key: the chain as one message, as one OP_BATCH of
    single-key ops, and as 937 round trips; ``publish_many`` likewise;
  * several client threads over one ring, each with its own ``RingClient``
    over a disjoint ``slot_range`` (the port's clients have one owner);
  * the shard sweep, for both transports: the same multi-client load against
    S in {1, 2, 4} rings (one ``PrefixIndex`` shard each, served by a thread
    of this process, or by a service process of its own over the pool's
    shared metadata, ``core/procserver.ShardProcess``;
    ``ShardedRemoteIndex`` posting to every ring before it collects), wall
    keys/s and CAPACITY keys/s = chain keys over the bottleneck shard's
    service time, read from the ring's own busy-ns counter around a
    single-threaded run of each shard's sub-chain;
  * the chaos sweep: a ``kill -9`` of one of two watched shards
    (``core/procserver.ShardWatchdog``) under match load, the outage
    served with holes and retries until the respawned shard, rebuilt from
    its journal, answers a full match (``recovery_s``);
  * the paper's CXL and RDMA round trips (Fig. 15), MODELED.

Every time but the MODELED row is host wall time, measured here: on the
card's machine it is the wall time of that machine's host CPU. Threads
share one interpreter's GIL, so the thread rows' wall keys/s stays near one
thread's rate whatever S; the process rows' service side owns its cores,
and the client threads, which share one interpreter, cap them.

    python -m repro_torch.experiments.exp11_rpc [--fast] [--json PATH]
"""

from __future__ import annotations

import argparse
import json
import threading
import time

from repro_torch.core import fabric, wire
from repro_torch.core.index import PrefixIndex, ShardedPrefixIndex, partition_keys
from repro_torch.core.pool import KVBlockLayout, KVBlockPool
from repro_torch.core.procserver import ShardProcess, process_plane
from repro_torch.core.rpc import RingClient, RingServer, SlotRing
from repro_torch.experiments.common import emit

LAYOUT = KVBlockLayout(block_tokens=16, n_layers_kv=4, n_kv_heads=2, head_dim=8)
N_SLOTS, PAYLOAD = 64, 1 << 16
HOST_NOTE = ("# exp11 rows: host wall time of this machine's CPU (rings served by threads, "
             "or by processes in the shard_sweep_process and chaos rows), except "
             "modeled_rtt_comparison: MODELED (the paper's Fig. 15)")


def _best(fn, iters: int, repeat: int = 3) -> float:
    """Seconds a call, the best of ``repeat`` runs."""
    best = float("inf")
    for _ in range(repeat):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def slot_ranges(n_slots: int, n_parts: int) -> list[tuple[int, int]]:
    """Disjoint [lo, hi) slot ranges, one per client, as even as they go."""
    cuts = [n_slots * i // n_parts for i in range(n_parts + 1)]
    return list(zip(cuts[:-1], cuts[1:]))


def _pool() -> KVBlockPool:
    return KVBlockPool(LAYOUT, 65536, "meta", n_shards=32)


def _run_clients(make_clients, keys, n_threads: int, per: int, hasher) -> float:
    """``n_threads`` threads, thread i with its own clients
    (``make_clients(i)``), matching ``keys`` ``per`` times. Returns the wall
    seconds."""
    errors: list[BaseException] = []

    def worker(i: int) -> None:
        clients = make_clients(i)
        try:
            p = wire.ShardedRemoteIndex(clients, LAYOUT.block_tokens, hasher=hasher)
            for _ in range(per):
                p.match_prefix_keys(keys)
        except BaseException as e:  # noqa: BLE001 - re-raised in the caller
            errors.append(e)
        finally:
            for c in clients:
                c.close()

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    dt = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in ts):
        raise RuntimeError(f"client threads failed: {errors[:1]}")
    return dt


def _thread_shards(pool, n_shards: int):
    """(servers, ring i's client over a slot range) of S server threads."""
    sidx = ShardedPrefixIndex(pool, n_shards)
    servers = []
    for shard in sidx.shards:
        ring = SlotRing(N_SLOTS, PAYLOAD)
        servers.append(RingServer(ring, wire.make_index_handler(shard, max_reply=PAYLOAD)))
    return servers, lambda rng: [RingClient(srv.ring, slot_range=rng) for srv in servers]


def _process_shards(pool, n_shards: int):
    """(services, their clients over a slot range) of S service processes
    over ``pool``'s shared metadata."""
    spec = pool.share_meta()
    servers = [ShardProcess(spec, N_SLOTS, PAYLOAD) for _ in range(n_shards)]
    return servers, lambda rng: [srv.client(rng) for srv in servers]


def shard_sweep(n_tokens: int, fast: bool, transport: str = "thread",
                shard_counts: tuple = (1, 2, 4)) -> list[dict]:
    """Multi-client batched-match throughput against the shard count, each
    shard served by a thread (``transport="thread"``) or a service process
    (``"process"``)."""
    shards_of = {"thread": _thread_shards, "process": _process_shards}.get(transport)
    if shards_of is None:
        raise ValueError(f"unknown transport {transport!r}")
    n_threads, per = (4, 10) if fast else (8, 30)
    svc_iters = 20 if fast else 50
    parts = slot_ranges(N_SLOTS, n_threads + 1)
    cells = []
    for n_shards in shard_counts:
        pool = _pool()
        servers, clients_of = shards_of(pool, n_shards)
        clients = []
        try:
            for srv in servers:
                srv.start()
            if transport == "process" and not all(srv.wait_ready() for srv in servers):
                raise RuntimeError("a shard service never became ready")
            clients = clients_of(parts[0])
            proxy = wire.ShardedRemoteIndex(clients, LAYOUT.block_tokens,
                                            on_freed=pool.release if transport == "process"
                                            else None)
            keys = proxy.keys_for(list(range(n_tokens)))
            blocks = pool.allocate(len(keys))
            proxy.publish_many(list(keys), blocks, pool.write_blocks(blocks), 16)
            for _ in range(5):  # warm
                proxy.match_prefix_keys(keys)
            dt = _run_clients(lambda i: clients_of(parts[i + 1]), keys, n_threads, per,
                              proxy.hasher)
            served = [srv.served for srv in servers]
            # each shard's service time, from the ring's own busy-ns counter
            # around a single-threaded run of its sub-chain
            key_lists, _ = partition_keys(keys, n_shards)
            service_s = []
            for srv, cl, kl in zip(servers, clients, key_lists):
                msg = wire.encode_match(kl)
                cl.call(msg)
                b0 = srv.busy_ns
                for _ in range(svc_iters):
                    cl.call(msg)
                service_s.append((srv.busy_ns - b0) / svc_iters / 1e9)
        finally:
            for c in clients:
                c.close()
            for srv in servers:
                if transport == "thread":
                    srv.stop()
                else:
                    srv.close()
            pool.unshare_meta()  # a no-op for the thread transport
        cells.append({
            "transport": transport, "n_shards": n_shards, "n_clients": n_threads,
            "chains": n_threads * per, "wall_s": dt,
            "wall_keys_per_s": n_threads * per * len(keys) / dt,
            "shard_service_us": [s * 1e6 for s in service_s],
            "capacity_keys_per_s": len(keys) / max(service_s),
            "served_per_shard": served,
            "errors": sum(c.stats.errors for c in clients),
            "timeouts": sum(c.stats.timeouts for c in clients),
        })
    return cells


def chaos_sweep(n_tokens: int, fast: bool, n_shards: int = 2) -> dict:
    """``kill -9`` one of ``n_shards`` watched shards under match load and
    time the service through kill, journal rebuild and adoption against the
    steady state: steady keys/s (one client, before the kill), outage keys/s
    (keys matched between the kill and the first full match, over that
    window), ``recovery_s`` (kill to the first full match), post-recovery
    keys/s, and the restart, retry and degraded counts. The watchdogs run
    their probe threads (10 ms); the client retries and degrades."""
    pool = _pool()
    plane = process_plane(pool, n_shards, N_SLOTS, PAYLOAD, selfheal=True,
                          journal_capacity=65536, probe_interval=0.01)
    proxy, wds = plane.remote, plane.services
    try:
        keys = proxy.keys_for(list(range(n_tokens)))
        blocks = pool.allocate(len(keys))
        proxy.publish_many(list(keys), blocks, pool.write_blocks(blocks), 16)
        for _ in range(5):
            proxy.match_prefix_keys(keys)
        iters = 20 if fast else 80
        t0 = time.perf_counter()
        for _ in range(iters):
            proxy.match_prefix_keys(keys)
        steady_s = (time.perf_counter() - t0) / iters
        t_kill = time.perf_counter()
        wds[0].kill()
        matched = chains = 0
        recovery_s = None
        while time.perf_counter() - t_kill < 30.0:
            hits = proxy.match_prefix_keys(keys)
            chains += 1
            matched += len(hits)
            if len(hits) == len(keys):
                recovery_s = time.perf_counter() - t_kill
                break
        window_s = time.perf_counter() - t_kill
        t0 = time.perf_counter()
        for _ in range(iters):
            proxy.match_prefix_keys(keys)
        post_s = (time.perf_counter() - t0) / iters
        return {
            "n_shards": n_shards, "n_keys": len(keys),
            "steady_keys_per_s": len(keys) / steady_s,
            "outage_keys_per_s": matched / window_s,
            "outage_chains": chains, "recovery_s": recovery_s,
            "post_recovery_keys_per_s": len(keys) / post_s,
            "restarts": plane.restarts(), "rpc_retries": plane.retries(),
            "rpc_degraded_ops": sum(c.stats.degraded_ops for c in plane.clients),
            "journal_records": [len(w.journal) for w in wds],
        }
    finally:
        plane.close()


def run(fast: bool = False) -> tuple[list[tuple], dict]:
    """(rows, results) of every section, the reference's rows."""
    n_tokens = 2048 if fast else 15000
    pool = _pool()
    idx = PrefixIndex(pool)
    ring = SlotRing(N_SLOTS, PAYLOAD)
    server = RingServer(ring, wire.make_index_handler(idx, max_reply=ring.payload_bytes)).start()
    n_threads, per = (4, 20) if fast else (8, 50)
    parts = slot_ranges(N_SLOTS, n_threads + 1)
    client = RingClient(ring, slot_range=parts[0])
    proxy = wire.RemoteIndex(client, LAYOUT.block_tokens, hasher=idx.hasher)
    results: dict = {"fast": fast, "n_tokens": n_tokens}
    try:
        keys = proxy.keys_for(list(range(n_tokens)))
        n_keys = len(keys)
        results["n_keys"] = n_keys
        blocks = pool.allocate(n_keys)
        epochs = pool.write_blocks(blocks)
        bt = LAYOUT.block_tokens
        per_iters = 2 if fast else 3

        def publish_per_key():
            for k, b, e in zip(keys, blocks, epochs):
                proxy.publish_many([k], [b], [e], bt)

        per_key_pub_s = _best(publish_per_key, per_iters)
        batched_pub_s = _best(lambda: proxy.publish_many(keys, blocks, epochs, bt),
                              8 if fast else 16)
        results["publish"] = {"per_key_keys_per_s": n_keys / per_key_pub_s,
                              "batched_keys_per_s": n_keys / batched_pub_s,
                              "speedup": per_key_pub_s / batched_pub_s}

        one_key = keys[:1]
        for _ in range(50):
            proxy.match_prefix_keys(one_key)
        results["match_rtt_us_qd1"] = _best(lambda: proxy.match_prefix_keys(one_key),
                                            200 if fast else 400) * 1e6

        def match_per_key():
            for k in keys:
                proxy.match_prefix_keys([k])

        per_key_match_s = _best(match_per_key, per_iters)
        batched_match_s = _best(lambda: proxy.match_prefix_keys(keys), 8 if fast else 16)
        one_key_msgs = [wire.encode_match([k]) for k in keys]
        op_batch_s = _best(lambda: proxy.call_batch(one_key_msgs), 4 if fast else 8)
        results["match"] = {"chain_rtt_us": batched_match_s * 1e6,
                            "per_key_keys_per_s": n_keys / per_key_match_s,
                            "op_batch_keys_per_s": n_keys / op_batch_s,
                            "batched_keys_per_s": n_keys / batched_match_s,
                            "speedup": per_key_match_s / batched_match_s}

        dt = _run_clients(lambda i: [RingClient(ring, slot_range=parts[i + 1])], keys,
                          n_threads, per, idx.hasher)
        results["threaded"] = {"n_threads": n_threads, "chains_per_s": n_threads * per / dt,
                               "keys_per_s": n_threads * per * n_keys / dt}
        results["modeled_rtt_us"] = {"cxl": fabric.CXL_RPC_RTT * 1e6,
                                     "rdma_rc": fabric.RDMA_RC_RPC_RTT * 1e6,
                                     "rdma_ud": fabric.RDMA_UD_RPC_RTT * 1e6}
        results["client_stats"] = {"requests_ok": client.stats.requests,
                                   "errors": client.stats.errors,
                                   "timeouts": client.stats.timeouts,
                                   "avg_wait_us": client.stats.avg_wait() * 1e6}
    finally:
        server.stop()

    # the sweeps run at paper-scale chains, as the reference's
    results["shard_sweep"] = shard_sweep(15000, fast)
    results["shard_sweep_process"] = shard_sweep(15000, fast, "process")
    results["chaos"] = chaos_sweep(15000, fast)
    results["shard_scaling_s4_vs_s1"] = {}
    sweeps = {"thread": results["shard_sweep"], "process": results["shard_sweep_process"]}
    for transport, cells in sweeps.items():
        by_s = {c["n_shards"]: c for c in cells}
        results["shard_scaling_s4_vs_s1"][transport] = {
            "capacity": by_s[4]["capacity_keys_per_s"] / by_s[1]["capacity_keys_per_s"],
            "wall": by_s[4]["wall_keys_per_s"] / by_s[1]["wall_keys_per_s"]}
    return rows_of(results), results


def rows_of(results: dict) -> list[tuple]:
    """The reference's rows, in its order and format."""
    m, p, t = results["match"], results["publish"], results["threaded"]
    cxl, rc, ud = (results["modeled_rtt_us"][k] for k in ("cxl", "rdma_rc", "rdma_ud"))
    cs = results["client_stats"]
    rows = [
        ("exp11.match_prefix_rtt_qd1", f"{results['match_rtt_us_qd1']:.1f}",
         f"1-key index op over shm ring; paper-modeled rtt={cxl:.2f}us"),
        ("exp11.match_prefix_chain", f"{m['chain_rtt_us']:.1f}",
         f"{results['n_keys']}keys/1rpc;batched={m['batched_keys_per_s']:.0f}keys/s;"
         f"per_key={m['per_key_keys_per_s']:.0f}keys/s;"
         f"op_batch={m['op_batch_keys_per_s']:.0f}keys/s;speedup={m['speedup']:.1f}x"),
        ("exp11.publish_many_chain", f"{1e6 * results['n_keys'] / p['batched_keys_per_s']:.1f}",
         f"batched={p['batched_keys_per_s']:.0f}keys/s;"
         f"per_key={p['per_key_keys_per_s']:.0f}keys/s;speedup={p['speedup']:.1f}x"),
        ("exp11.threaded_match", f"{1e6 / t['chains_per_s']:.1f}",
         f"{t['n_threads']}threads;{t['keys_per_s']/1e6:.2f}Mkeys/s "
         f"(one client per thread; paper: 12.13Mops @QD=128)"),
        ("exp11.modeled_rtt_comparison", f"{cxl:.2f}",
         f"cxl=2.11us vs rdma_rc={rc:.2f}us vs rdma_ud={ud:.2f}us (4.0x, Fig. 15)"),
        ("exp11.client_accounting", f"{cs['avg_wait_us']:.1f}",
         f"requests_ok={cs['requests_ok']};errors={cs['errors']};"
         f"timeouts={cs['timeouts']} (failed round-trips counted + waited)"),
    ]
    for tag in ("shard_sweep", "shard_sweep_process"):
        for c in results[tag]:
            rows.append((f"exp11.{tag}.s{c['n_shards']}",
                         f"{1e6 * c['wall_s'] / c['chains']:.1f}",
                         f"wall={c['wall_keys_per_s']:.0f}keys/s;"
                         f"capacity={c['capacity_keys_per_s']:.0f}keys/s;"
                         f"bottleneck_service_us={max(c['shard_service_us']):.0f};"
                         f"clients={c['n_clients']};errors={c['errors']}"))
    sc = results["shard_scaling_s4_vs_s1"]
    rows.append(("exp11.shard_scaling", f"{sc['thread']['capacity']:.2f}",
                 f"S4/S1 capacity={sc['thread']['capacity']:.2f}x (>=1.5x floor);"
                 f"wall thread={sc['thread']['wall']:.2f}x (GIL-capped) vs "
                 f"process={sc['process']['wall']:.2f}x (service owns its cores; "
                 f"client side is the residual cap on few-core hosts)"))
    ch = results["chaos"]
    rows.append(("exp11.chaos_recovery", f"{(ch['recovery_s'] or -1) * 1e3:.0f}",
                 f"kill->rebuild->recover={ch['recovery_s']:.3f}s;"
                 f"steady={ch['steady_keys_per_s']:.0f}keys/s;"
                 f"outage={ch['outage_keys_per_s']:.0f}keys/s;"
                 f"post={ch['post_recovery_keys_per_s']:.0f}keys/s;"
                 f"restarts={ch['restarts']};retries={ch['rpc_retries']};"
                 f"degraded={ch['rpc_degraded_ops']}"
                 if ch["recovery_s"] is not None
                 else "shard NEVER recovered within the 30s chaos window"))
    return rows


def main(argv: list[str] | None = None) -> list[tuple]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true", help="small iteration counts")
    ap.add_argument("--json", help="write the results here")
    args = ap.parse_args(argv)
    rows, results = run(fast=args.fast)
    print(HOST_NOTE)
    emit(rows)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    return rows


if __name__ == "__main__":
    main()
