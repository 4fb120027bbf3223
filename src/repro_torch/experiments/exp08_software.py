"""Exp #8 (Fig. 13) on the port: software configurations, through the
port's cluster simulator.

Twin of ``benchmarks/exp08_software.py``, with its rows:

(a) prefill/decode disaggregated: 8 prefill instances write the pool, and
    8 decode instances of a second cluster, sharing the first cluster's
    pool and index, fetch every context from it (paper: a beluga/rdma QPS
    ratio of 3.41x-9.47x);
(b) KVCache block size: RDMA needs 256-token super-blocks; Beluga runs at
    vLLM's native 16 (paper: 13.0 s against 76.8 s TTFT for RDMA);
(c) the scheduler policy on the shared pool (paper §6.3): cache-oblivious
    against cache-aware and round-robin routing.

MODELED (``core/fabric.py``, ``SimRunnerConfig``); no device is timed.

    python -m repro_torch.experiments.exp08_software
"""

from __future__ import annotations

from repro_torch.experiments.cluster_common import (
    lveval_requests, qwen32b_layout, run_populate_then_hit)
from repro_torch.experiments.common import emit
from repro_torch.serving.request import summarize
from repro_torch.serving.scheduler import Cluster, ClusterConfig


def _pd_disagg(mode: str, sbt: int) -> dict:
    """8 prefill + 8 decode instances: decode always fetches from the pool."""
    layout = qwen32b_layout()
    cfg = ClusterConfig(n_engines=8, transfer_mode=mode, pool_blocks=262144,
                        super_block_tokens=sbt)
    pre = Cluster(cfg, layout)
    for r in lveval_requests(128, 8192, 1):  # prefill-only phase
        pre.dispatch(r)
    pre.run()
    t0 = max(e.clock for e in pre.engines)
    # the decode cluster shares the SAME pool and index
    dec = Cluster(cfg, layout)
    dec.pool = pre.pool
    dec.index = pre.index
    for e in dec.engines:
        e.manager.pool = pre.pool
        e.manager.index = pre.index
        e.manager.transfer.pool = pre.pool
    for r in lveval_requests(128, 8192, 128, tag="d", arrival0=t0):
        dec.dispatch(r)
    dec.run()
    ds = [r for r in dec.requests if r.req_id.startswith("d")]
    return summarize(ds, max(x.t_done for x in ds) - t0)


def run() -> list[tuple]:
    rows = []
    pd = {}
    for mode, sbt in [("rdma", 256), ("beluga", 0)]:
        s = _pd_disagg(mode, sbt)
        pd[mode] = s
        rows.append(
            (f"exp08.pd_disagg.{mode}", f"{s['avg_ttft_s']*1e6:.0f}",
             f"ttft={s['avg_ttft_s']:.2f}s;qps={s['qps']:.2f}")
        )
    ratio = pd["beluga"]["qps"] / max(pd["rdma"]["qps"], 1e-9)
    rows.append(("exp08.pd_qps_ratio", f"{ratio:.2f}", "paper: 3.41x-9.47x"))

    # (b) block-size sweep for the RDMA path + beluga at native 16
    layout = qwen32b_layout()
    for name, mode, sbt in [
        ("rdma_block256", "rdma", 256),
        ("rdma_block16", "rdma", 16),
        ("beluga_block16", "beluga", 0),
    ]:
        cfg = ClusterConfig(n_engines=16, transfer_mode=mode, pool_blocks=262144,
                            super_block_tokens=sbt)
        _, s2, _ = run_populate_then_hit(cfg, layout, n=128, in_len=15000)
        rows.append(
            (f"exp08.blocksize.{name}", f"{s2['avg_ttft_s']*1e6:.0f}",
             f"hit_ttft={s2['avg_ttft_s']:.2f}s "
             f"(paper: rdma256=13.0s rdma16=76.8s beluga=1.36s)")
        )

    # (c) scheduler policy on the shared pool (cache-oblivious wins on load
    # balance; cache-aware skews -- paper §6.3)
    for policy in ("cache_oblivious", "cache_aware", "round_robin"):
        cfg = ClusterConfig(n_engines=16, transfer_mode="beluga", pool_blocks=262144,
                            policy=policy)
        _, s2, c = run_populate_then_hit(cfg, layout, n=192, in_len=8192)
        loads = [e.stats.busy_s for e in c.engines]
        imb = max(loads) / max(min(loads), 1e-9)
        rows.append(
            (f"exp08.policy.{policy}", f"{s2['avg_ttft_s']*1e6:.0f}",
             f"hit_ttft={s2['avg_ttft_s']:.2f}s;load_imbalance={imb:.2f}x")
        )
    return rows


if __name__ == "__main__":
    print("# exp08 rows: MODELED (core/fabric.py, SimRunnerConfig); no device timed")
    emit(run())
