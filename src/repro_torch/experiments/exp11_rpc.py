"""Exp #11 (Fig. 15) on the port: the CXL-RPC metadata plane, real index
ops over the shared-memory ring, served by threads.

Twin of ``benchmarks/exp11_rpc.py``'s thread rows. A ``PrefixIndex`` is
served through the wire codec (``core/wire.py``) by a ``RingServer`` thread,
and a ``RemoteIndex`` sends the traffic a request really makes:

  * ``match_prefix`` at QD=1 for one key, and for a paper-scale chain
    (15,000 tokens: 937 keys) in one framed message;
  * batched against per-key: the chain as one message, as one OP_BATCH of
    single-key ops, and as 937 round trips; ``publish_many`` likewise;
  * several client threads over one ring, each with its own ``RingClient``
    over a disjoint ``slot_range`` (the port's clients have one owner);
  * the shard sweep: the same multi-client load against S in {1, 2, 4}
    rings (one ``PrefixIndex`` shard and one server thread each,
    ``ShardedRemoteIndex`` posting to every ring before it collects), wall
    keys/s and CAPACITY keys/s = chain keys over the bottleneck shard's
    service time, read from the ring's own busy-ns counter around a
    single-threaded run of each shard's sub-chain;
  * the paper's CXL and RDMA round trips (Fig. 15), MODELED.

Every time but the MODELED row is host wall time, measured here: on the
card's machine it is the wall time of that machine's host CPU, and threads
share one interpreter's GIL, so wall keys/s stays near one thread's rate
whatever S. The reference's process rows (one service process per shard)
and its chaos sweep need the process transport: ``shard_sweep(...,
transport="process")`` and ``chaos_sweep`` raise a ``ValueError`` naming
``ROADMAP.md`` queue 1 item 7e-ii.

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
from repro_torch.core.rpc import RingClient, RingServer, SlotRing
from repro_torch.experiments.common import emit

ITEM_PROCESS = "ROADMAP.md queue 1 item 7e-ii (the process transport and self-healing)"
LAYOUT = KVBlockLayout(block_tokens=16, n_layers_kv=4, n_kv_heads=2, head_dim=8)
N_SLOTS, PAYLOAD = 64, 1 << 16
HOST_NOTE = ("# exp11 rows: host wall time of this machine's CPU (ring served by a thread), "
             "except modeled_rtt_comparison: MODELED (the paper's Fig. 15)")


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


def _run_clients(rings, keys, n_threads: int, per: int, hasher) -> float:
    """``n_threads`` threads, each with its own clients (slot range i + 1
    of every ring; range 0 is the caller's), matching ``keys`` ``per``
    times. Returns the wall seconds."""
    parts = slot_ranges(N_SLOTS, n_threads + 1)
    errors: list[BaseException] = []

    def worker(i: int) -> None:
        try:
            p = wire.ShardedRemoteIndex([RingClient(r, slot_range=parts[i + 1]) for r in rings],
                                        LAYOUT.block_tokens, hasher=hasher)
            for _ in range(per):
                p.match_prefix_keys(keys)
        except BaseException as e:  # noqa: BLE001 - re-raised in the caller
            errors.append(e)

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


def shard_sweep(n_tokens: int, fast: bool, transport: str = "thread",
                shard_counts: tuple = (1, 2, 4)) -> list[dict]:
    """Multi-client batched-match throughput against the shard count, with
    one server thread per shard. ``transport="process"`` is not ported."""
    if transport != "thread":
        raise ValueError(f"exp11 shard sweep over transport={transport!r} is not ported yet: "
                         f"{ITEM_PROCESS}")
    n_threads, per = (4, 10) if fast else (8, 30)
    svc_iters = 20 if fast else 50
    parts = slot_ranges(N_SLOTS, n_threads + 1)
    cells = []
    for n_shards in shard_counts:
        pool = _pool()
        sidx = ShardedPrefixIndex(pool, n_shards)
        rings, servers = [], []
        try:
            for shard in sidx.shards:
                ring = SlotRing(N_SLOTS, PAYLOAD)
                rings.append(ring)
                servers.append(RingServer(
                    ring, wire.make_index_handler(shard, max_reply=ring.payload_bytes)).start())
            clients = [RingClient(r, slot_range=parts[0]) for r in rings]
            proxy = wire.ShardedRemoteIndex(clients, LAYOUT.block_tokens, hasher=sidx.hasher)
            keys = proxy.keys_for(list(range(n_tokens)))
            blocks = pool.allocate(len(keys))
            proxy.publish_many(list(keys), blocks, pool.write_blocks(blocks), 16)
            for _ in range(5):  # warm
                proxy.match_prefix_keys(keys)
            dt = _run_clients(rings, keys, n_threads, per, sidx.hasher)
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
            for srv in servers:
                srv.stop()
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
    """The reference kills a supervised shard service under load; the port
    has no service process to kill yet."""
    raise ValueError(f"exp11 chaos sweep is not ported yet: {ITEM_PROCESS}")


def run(fast: bool = False) -> tuple[list[tuple], dict]:
    """(rows, results) of the thread rows."""
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

        dt = _run_clients([ring], keys, n_threads, per, idx.hasher)
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

    # the sweep runs at paper-scale chains, as the reference's
    results["shard_sweep"] = shard_sweep(15000, fast)
    by_s = {c["n_shards"]: c for c in results["shard_sweep"]}
    results["shard_scaling_s4_vs_s1"] = {
        "capacity": by_s[4]["capacity_keys_per_s"] / by_s[1]["capacity_keys_per_s"],
        "wall": by_s[4]["wall_keys_per_s"] / by_s[1]["wall_keys_per_s"]}
    return rows_of(results), results


def rows_of(results: dict) -> list[tuple]:
    """The reference's thread rows, in its order and format."""
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
    for c in results["shard_sweep"]:
        rows.append((f"exp11.shard_sweep.s{c['n_shards']}",
                     f"{1e6 * c['wall_s'] / c['chains']:.1f}",
                     f"wall={c['wall_keys_per_s']:.0f}keys/s;"
                     f"capacity={c['capacity_keys_per_s']:.0f}keys/s;"
                     f"bottleneck_service_us={max(c['shard_service_us']):.0f};"
                     f"clients={c['n_clients']};errors={c['errors']}"))
    sc = results["shard_scaling_s4_vs_s1"]
    rows.append(("exp11.shard_scaling", f"{sc['capacity']:.2f}",
                 f"S4/S1 capacity={sc['capacity']:.2f}x (>=1.5x floor);"
                 f"wall thread={sc['wall']:.2f}x (GIL-capped)"))
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
