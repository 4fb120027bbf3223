"""Exp #7 (Fig. 12) on the port: sensitivity to the input context length
(2K / 4K / 8K / 15K), through the port's cluster simulator.

Twin of ``benchmarks/exp07_context.py``, with its rows. The paper finds
Beluga's edge growing with the context (KV reads and writes take a larger
share of the end-to-end latency). MODELED (``core/fabric.py``,
``SimRunnerConfig``); no device is timed.

    python -m repro_torch.experiments.exp07_context
"""

from __future__ import annotations

from repro_torch.experiments.cluster_common import qwen32b_layout, run_populate_then_hit
from repro_torch.experiments.common import emit
from repro_torch.serving.scheduler import ClusterConfig


def run() -> list[tuple]:
    layout = qwen32b_layout()
    rows = []
    gains = []
    for in_len in (2048, 4096, 8192, 15000):
        res = {}
        for mode, sbt in [("rdma", 256), ("beluga", 0)]:
            cfg = ClusterConfig(n_engines=16, transfer_mode=mode, pool_blocks=262144,
                                super_block_tokens=sbt)
            _, s2, _ = run_populate_then_hit(cfg, layout, n=128, in_len=in_len)
            res[mode] = s2
            rows.append(
                (f"exp07.{mode}.ctx_{in_len}", f"{s2['avg_ttft_s']*1e6:.0f}",
                 f"ttft={s2['avg_ttft_s']:.2f}s;p99={s2['p99_ttft_s']:.2f}s")
            )
        gain = res["rdma"]["avg_ttft_s"] / max(res["beluga"]["avg_ttft_s"], 1e-9)
        gains.append((in_len, gain))
        rows.append(
            (f"exp07.gain.ctx_{in_len}", f"{gain:.2f}",
             "beluga TTFT speedup over rdma (paper: grows with context)")
        )
    monotone = all(gains[i][1] <= gains[i + 1][1] * 1.15 for i in range(len(gains) - 1))
    rows.append(("exp07.gain_grows_with_context", "0", f"ok={monotone}"))
    return rows


if __name__ == "__main__":
    print("# exp07 rows: MODELED (core/fabric.py, SimRunnerConfig); no device timed")
    emit(run())
