"""Exp #5 (Table 5) on the port: end-to-end LV-Eval — vLLM / +MoonCake(RDMA)
/ +Beluga, through the port's cluster simulator.

Twin of ``benchmarks/exp05_e2e.py``, with its ``PAPER`` table and its rows.
Closed-loop 256 clients, 16 instances, the Qwen3-32B layout, a pool of
262,144 blocks (payload-free: 640 GiB of KV as metadata). Two phases per
mode: cache-populate (the first run), then cache-hit (the same prompts
again). Every number is MODELED: fabric constants from the paper's CXL
testbed (``core/fabric.py``) and ``SimRunnerConfig`` calibrated to an H20.
No device is timed and no card's name goes beside them.

``PINNED`` holds the summaries at the paper's size (n 256, 15,000-token
prompts), as the reference computes them; ``tests/test_torch_cluster.py``
holds them against ``benchmarks/exp05_e2e.run()``, and ``chip_smoke.py``
phase 18 runs the port at that size where no JAX exists and holds it to
them.

    python -m repro_torch.experiments.exp05_e2e [--n 256] [--in-len 15000]
"""

from __future__ import annotations

import argparse
import time

from repro_torch.experiments.cluster_common import (
    mismatches, qwen32b_layout, run_populate_then_hit)
from repro_torch.experiments.common import emit
from repro_torch.serving.scheduler import ClusterConfig

PAPER = {  # Table 5 (s / req/s)
    "vllm": {"pop_ttft": 18.76, "pop_qps": 0.96, "hit_ttft": 18.23, "hit_qps": 0.96},
    "rdma": {"pop_ttft": 19.66, "pop_qps": 1.02, "hit_ttft": 13.00, "hit_qps": 1.54},
    "beluga": {"pop_ttft": 17.22, "pop_qps": 1.24, "hit_ttft": 1.36, "hit_qps": 11.32},
}
MODES = [("vllm", "none", 0), ("rdma", "rdma", 256), ("beluga", "beluga", 0)]
MODELED_NOTE = ("# exp05 rows: MODELED (the paper's CXL/RDMA fabric, core/fabric.py; "
                "SimRunnerConfig calibrated to an H20); no device timed")


def cluster_config(mode: str, super_block_tokens: int) -> ClusterConfig:
    return ClusterConfig(n_engines=16, transfer_mode=mode, pool_blocks=262144,
                         super_block_tokens=super_block_tokens)


def run_mode(name: str, n: int = 256, in_len: int = 15000):
    """(populate stats, cache-hit summary, cluster) of one mode."""
    _, mode, sbt = next(m for m in MODES if m[0] == name)
    return run_populate_then_hit(cluster_config(mode, sbt), qwen32b_layout(), n=n, in_len=in_len)


def rows_of(res: dict) -> list[tuple]:
    """The reference's rows from {mode: (populate, cache_hit)} summaries."""
    rows = []
    for name, _, _ in MODES:
        s1, s2 = res[name]
        p = PAPER[name]
        rows.append(
            (f"exp05.{name}.populate", f"{s1['avg_ttft_s']*1e6:.0f}",
             f"ttft={s1['avg_ttft_s']:.2f}s;p99={s1['p99_ttft_s']:.2f};"
             f"tpot={s1['avg_tpot_s']:.3f};qps={s1['qps']:.2f};"
             f"paper_ttft={p['pop_ttft']};paper_qps={p['pop_qps']}")
        )
        rows.append(
            (f"exp05.{name}.cache_hit", f"{s2['avg_ttft_s']*1e6:.0f}",
             f"ttft={s2['avg_ttft_s']:.2f}s;p99={s2['p99_ttft_s']:.2f};"
             f"tpot={s2['avg_tpot_s']:.3f};qps={s2['qps']:.2f};"
             f"paper_ttft={p['hit_ttft']};paper_qps={p['hit_qps']}")
        )
    qps_ratio = res["beluga"][1]["qps"] / res["rdma"][1]["qps"]
    ttft_cut = 1 - res["beluga"][1]["avg_ttft_s"] / res["rdma"][1]["avg_ttft_s"]
    rows.append(
        ("exp05.beluga_vs_rdma", f"{qps_ratio:.2f}",
         f"qps_ratio={qps_ratio:.2f}x(paper 7.35x);"
         f"ttft_cut={100*ttft_cut:.1f}%(paper 89.6%)")
    )
    return rows


def run(n: int = 256, in_len: int = 15000) -> list[tuple]:
    res = {}
    for name, _, _ in MODES:
        s1, s2, _ = run_mode(name, n, in_len)
        res[name] = (s1, s2)
    return rows_of(res)


# the summaries at n 256, in_len 15000, as the reference computes them
# (benchmarks/exp05_e2e.run(); tests/test_torch_cluster.py holds them to it)
PINNED = {
    "vllm": {
        "populate": {
            "n_done": 256,
            "avg_ttft_s": 11.745412499999995,
            "p99_ttft_s": 23.941199999999988,
            "avg_tpot_s": 0.09019069940476192,
            "p99_tpot_s": 0.15280714285714275,
            "qps": 9.833748194585278,
            "hit_tokens": 0,
            "total_prompt_tokens": 3840000,
            "index": {
                "entries": 0,
                "hits": 0,
                "misses": 0,
                "hit_rate": 0.0
            },
            "pool_free": 262144,
            "shard_occupancy_max": 0
        },
        "cache_hit": {
            "n_done": 256,
            "avg_ttft_s": 11.74541250000015,
            "p99_ttft_s": 23.941200000000435,
            "avg_tpot_s": 0.09019069940476503,
            "p99_tpot_s": 0.1528071428571463,
            "qps": 9.833748194585109,
            "hit_tokens": 0,
            "total_prompt_tokens": 3840000
        }
    },
    "rdma": {
        "populate": {
            "n_done": 256,
            "avg_ttft_s": 13.596619634765618,
            "p99_ttft_s": 27.43744471249999,
            "avg_tpot_s": 0.09951228438972597,
            "p99_tpot_s": 0.17361812328869045,
            "qps": 8.669430470659005,
            "hit_tokens": 1146480,
            "total_prompt_tokens": 3840000,
            "index": {
                "entries": 168217,
                "hits": 71655,
                "misses": 168217,
                "hit_rate": 0.29872181830309497
            },
            "pool_free": 93927,
            "shard_occupancy_max": 5257
        },
        "cache_hit": {
            "n_done": 256,
            "avg_ttft_s": 15.637344853515742,
            "p99_ttft_s": 31.267190312500368,
            "avg_tpot_s": 0.10972303964766537,
            "p99_tpot_s": 0.1964142280505983,
            "qps": 7.674139187957007,
            "hit_tokens": 3837952,
            "total_prompt_tokens": 3840000
        }
    },
    "beluga": {
        "populate": {
            "n_done": 256,
            "avg_ttft_s": 9.162038327068807,
            "p99_ttft_s": 19.039228477692298,
            "avg_tpot_s": 0.07712120687876796,
            "p99_tpot_s": 0.12362874093864464,
            "qps": 11.927169914163278,
            "hit_tokens": 1146480,
            "total_prompt_tokens": 3840000,
            "index": {
                "entries": 168217,
                "hits": 71655,
                "misses": 168217,
                "hit_rate": 0.29872181830309497
            },
            "pool_free": 93927,
            "shard_occupancy_max": 5257
        },
        "cache_hit": {
            "n_done": 256,
            "avg_ttft_s": 2.8299169895432685,
            "p99_ttft_s": 7.159090803846148,
            "avg_tpot_s": 0.04544673267394501,
            "p99_tpot_s": 0.05291363573717943,
            "qps": 27.673608969133618,
            "hit_tokens": 3837952,
            "total_prompt_tokens": 3840000
        }
    }
}


def pinned_mismatches(name: str, s1: dict, s2: dict, pinned: dict | None = None,
                      rel: float = 1e-12) -> list[str]:
    """Each number of one mode's summaries against the pinned one: an
    integer exactly, a float within ``rel`` of it. Returns what differs."""
    want = (pinned or PINNED)[name]
    return (mismatches(s1, want["populate"], f"{name}.populate.", rel)
            + mismatches(s2, want["cache_hit"], f"{name}.cache_hit.", rel))


def main(argv: list[str] | None = None) -> list[tuple]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=256, help="closed-loop clients")
    ap.add_argument("--in-len", type=int, default=15000, help="prompt tokens")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    rows = run(args.n, args.in_len)
    print(MODELED_NOTE)
    emit(rows)
    print(f"# wall {time.perf_counter() - t0:.1f} s on the host")
    return rows


if __name__ == "__main__":
    main()
