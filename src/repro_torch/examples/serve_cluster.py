"""End-to-end cluster serving example (the paper's Exp #5 scenario) on the
port's cluster simulator.

Twin of ``examples/serve_cluster.py``: 16 LLM instances and a shared KV
pool serve batched long-context requests; it compares the transfer modes,
then scales out and fails an instance mid-run. Every time it prints is
MODELED (``core/fabric.py``, ``SimRunnerConfig``); no device is timed.

    PYTHONPATH=src python -m repro_torch.examples.serve_cluster
"""

from __future__ import annotations

from repro_torch.experiments.cluster_common import lveval_requests, qwen32b_layout
from repro_torch.serving.request import summarize
from repro_torch.serving.scheduler import Cluster, ClusterConfig


def main():
    layout = qwen32b_layout()
    print(f"Qwen3-32B pool layout: {layout.n_fragments} fragments x "
          f"{layout.fragment_bytes//1024} KiB = {layout.block_bytes/2**20:.1f} MiB/block")
    print("(every time below is MODELED)")

    print("\n--- populate vs cache-hit, three transfer modes ---")
    for mode, sbt in [("none", 0), ("rdma", 256), ("beluga", 0)]:
        cfg = ClusterConfig(n_engines=16, transfer_mode=mode,
                            pool_blocks=262144, super_block_tokens=sbt)
        c = Cluster(cfg, layout)
        for r in lveval_requests(128, 15000, 64):
            c.dispatch(r)
        s1 = c.run()
        t0 = max(e.clock for e in c.engines)
        for r in lveval_requests(128, 15000, 64, tag="h", arrival0=t0):
            c.dispatch(r)
        c.run()
        hits = [r for r in c.requests if r.req_id.startswith("h")]
        s2 = summarize(hits, max(x.t_done for x in hits) - t0)
        print(f"{mode:7s} populate TTFT {s1['avg_ttft_s']:6.2f}s QPS {s1['qps']:5.2f} | "
              f"cache-hit TTFT {s2['avg_ttft_s']:6.2f}s QPS {s2['qps']:6.2f}")

    print("\n--- elastic scaling + failure (no KV rebalancing needed) ---")
    cfg = ClusterConfig(n_engines=8, transfer_mode="beluga", pool_blocks=131072)
    c = Cluster(cfg, layout)
    for r in lveval_requests(64, 8000, 32):
        c.dispatch(r)
    for e in c.engines:
        e.advance(2.0)
    dead = c.remove_engine(3)
    print(f"killed engine 3 mid-run; requeued {len(dead)} in-flight requests")
    c.add_engine()
    c.add_engine()
    print("added 2 engines (scale-out); they serve pool hits immediately")
    stats = c.run()
    print(f"all done: {stats['n_done']}/64, avg TTFT {stats['avg_ttft_s']:.2f}s, "
          f"index hit-rate {stats['index']['hit_rate']:.2f}")


if __name__ == "__main__":
    main()
