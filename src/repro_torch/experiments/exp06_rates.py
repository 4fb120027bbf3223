"""Exp #6 (Fig. 11) on the port: TTFT / TPOT against the request arrival
rate, through the port's cluster simulator.

Twin of ``benchmarks/exp06_rates.py``, with its rows. Open-loop Poisson
arrivals on a pool populated by the same prompts (all requests hit),
0.3 to 9.0 requests/s offered, Beluga against MoonCake-RDMA. MODELED
(``core/fabric.py``, ``SimRunnerConfig``); no device is timed.

    python -m repro_torch.experiments.exp06_rates
"""

from __future__ import annotations

from repro_torch.experiments.cluster_common import lveval_requests, qwen32b_layout
from repro_torch.experiments.common import emit
from repro_torch.serving.request import summarize
from repro_torch.serving.scheduler import Cluster, ClusterConfig


def run() -> list[tuple]:
    layout = qwen32b_layout()
    rows = []
    for mode, sbt in [("rdma", 256), ("beluga", 0)]:
        for rate in (0.3, 1.0, 3.0, 6.0, 9.0):
            cfg = ClusterConfig(n_engines=16, transfer_mode=mode, pool_blocks=262144,
                                super_block_tokens=sbt)
            c = Cluster(cfg, layout)
            # phase 1: populate (warm pool) with the same prompt set
            for r in lveval_requests(96, 15000, 16):
                c.dispatch(r)
            c.run()
            t0 = max(e.clock for e in c.engines)
            # phase 2: open-loop arrivals, all cache hits
            for r in lveval_requests(96, 15000, 64, rate=rate, tag="h", arrival0=t0):
                c.dispatch(r)
            c.run()
            hits = [r for r in c.requests if r.req_id.startswith("h")]
            s = summarize(hits, max(x.t_done for x in hits) - t0)
            rows.append(
                (f"exp06.{mode}.rate_{rate}", f"{s['avg_ttft_s']*1e6:.0f}",
                 f"ttft={s['avg_ttft_s']:.2f}s;tpot={s['avg_tpot_s']:.3f}s;"
                 f"qps={s['qps']:.2f}")
            )
    return rows


if __name__ == "__main__":
    print("# exp06 rows: MODELED (core/fabric.py, SimRunnerConfig); no device timed")
    emit(run())
