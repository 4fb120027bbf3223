"""Exp #13 on the port: the tiered pool under capacity pressure.

Twin of ``benchmarks/exp13_tiering.py``, with its protocol, cells and rows.
Over a document-reuse workload it sweeps the pool pressure (working set /
fast-tier capacity) and the Zipf skew of the re-requests, comparing

* **baseline**: a flat pool of the fast tier's size; on exhaustion the
  index destroys least recently used prefixes, and each re-request of one
  is a full recompute;
* **tiered**: the same fast tier plus a spill tier (RDMA DRAM) under the
  migration engine: cold prefixes are demoted ahead of pressure and stay
  fetchable at the spill medium's latency.

Per cell: every document is written once, then TTFT is measured over a
Zipf re-request stream, dispatched as virtual time reaches each arrival
with the engines advancing in lockstep windows. ``tier_chain_cell``
compares chain depths at one fast capacity and one spill budget:
destroy-on-evict (flat), two tiers, and three with an SSD tier below;
from 2x oversubscription the three-tier chain must beat destroy-on-evict.
``zero_cost_check`` runs a disabled tiering config against the reference's
``REFERENCE_PR1`` (copied unchanged); the reference's own run differs from
it in the last bit of four floats (``ROADMAP.md`` §3), so the row prints
what the reference prints.

Every number is MODELED (the paper's CXL constants and the spill media's,
``core/fabric.py``; ``SimRunnerConfig``); no device is timed. ``PINNED``
holds the full-size (``fast=False``) results as the reference computes
them (``tests/test_torch_tiering.py`` holds them to it; ``chip_smoke.py``
phase 19 holds the port's run to them). The run writes no file unless
asked (``--json PATH``).

    python -m repro_torch.experiments.exp13_tiering [--fast] [--json PATH]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.experiments.cluster_common import mismatches, qwen32b_layout, run_populate_then_hit
from repro_torch.experiments.common import emit
from repro_torch.serving.request import Request, summarize
from repro_torch.serving.scheduler import Cluster, ClusterConfig
from repro_torch.tiering import TieringConfig

MODELED_NOTE = ("# exp13 rows: MODELED (the paper's CXL constants and the spill media's, "
                "core/fabric.py; SimRunnerConfig); no device timed")

# the reference's record of the flat pool's stats before tiering existed
# (benchmarks/exp13_tiering.py:55-76), copied unchanged
REFERENCE_PR1 = {
    "populate": {
        "n_done": 64,
        "avg_ttft_s": 2.8039488662139376,
        "p99_ttft_s": 7.089036169999989,
        "avg_tpot_s": 0.045259955066344205,
        "p99_tpot_s": 0.05249664386904753,
        "qps": 6.937195787229816,
        "hit_tokens": 38304,
        "total_prompt_tokens": 131072,
    },
    "cache_hit": {
        "n_done": 64,
        "avg_ttft_s": 1.8867119865384638,
        "p99_ttft_s": 5.383646092307693,
        "avg_tpot_s": 0.040713094120116054,
        "p99_tpot_s": 0.04234551245421243,
        "qps": 8.561591044588884,
        "hit_tokens": 131072,
        "total_prompt_tokens": 131072,
    },
}


# ---------------------------------------------------------------------------
def _doc_tokens(d: int, in_len: int) -> list[int]:
    return np.random.default_rng(9000 + d).integers(0, 1000, size=in_len).tolist()


def zipf_docs(n: int, n_docs: int, skew: float, seed: int = 13) -> np.ndarray:
    """Zipf(``skew``) document popularity: hot documents recur quickly,
    the tail slowly."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_docs + 1, dtype=np.float64)
    p = ranks ** -skew
    p /= p.sum()
    return rng.choice(n_docs, size=n, p=p)


def run_stream(cluster: Cluster, reqs: list[Request], window_s: float = 0.25) -> None:
    """Dispatch each request as virtual time reaches its arrival, all
    engines advancing in lockstep windows."""
    reqs = sorted(reqs, key=lambda r: r.arrival)
    i, now = 0, min(r.arrival for r in reqs)
    while i < len(reqs) or any(e.has_backlog() for e in cluster.engines):
        while i < len(reqs) and reqs[i].arrival <= now:
            cluster.dispatch(reqs[i])
            i += 1
        backlog = sum(e.n_queued + len(e.running) for e in cluster.engines)
        clocks = [e.clock for e in cluster.engines]
        for e in cluster.engines:
            e.advance(now)
        stalled = (
            i >= len(reqs)
            and backlog == sum(e.n_queued + len(e.running) for e in cluster.engines)
            and clocks == [e.clock for e in cluster.engines]
        )
        if stalled and now > max(clocks):
            # no arrivals left, the window passed every clock, nothing moved:
            # drained or capacity-deadlocked
            break
        now += window_s


# ---------------------------------------------------------------------------
def _round_shards(n: int, shards: int) -> int:
    return max(shards, -(-n // shards) * shards)


def _measure(cfg: ClusterConfig, layout, skew: float, n: int, n_docs: int, in_len: int,
             out_len: int, rate: float, check=None, label: str = "") -> dict:
    """Write every document once, then measure TTFT over a Zipf re-request
    stream: one cluster config. ``check(label, cluster, requests)`` sees
    the cluster when the stream is done."""
    c = Cluster(cfg, layout)
    populate = [Request(f"p{d}", _doc_tokens(d, in_len), out_len, arrival=0.1 * d)
                for d in range(n_docs)]
    run_stream(c, populate)
    t0 = max(e.clock for e in c.engines)
    rng = np.random.default_rng(17)
    t = t0
    stream = []
    for i, d in enumerate(zipf_docs(n, n_docs, skew).tolist()):
        stream.append(Request(f"z{i}", _doc_tokens(d, in_len), out_len, arrival=t))
        t += rng.exponential(1.0 / rate)
    run_stream(c, stream)
    finished = [r.t_done for r in stream if r.t_done is not None]
    span = (max(finished) - t0) if finished else 0.0
    s = summarize(stream, span)
    out = {"avg_ttft_s": s["avg_ttft_s"], "p99_ttft_s": s["p99_ttft_s"], "qps": s["qps"],
           "hit_tokens": s["hit_tokens"]}
    if c.migrator is not None:
        out["stats"] = c.pool.stats_dict()
        out["stats"]["migrator_steps"] = c.migrator.steps
    if check is not None:
        check(label, c, populate + stream)
    return out


def _base_cfg(fast_blocks: int, shards: int, n_engines: int) -> dict:
    return dict(n_engines=n_engines, transfer_mode="beluga", pool_blocks=fast_blocks,
                pool_shards=shards, hbm_slots_per_engine=6750)


def sweep_cell(oversub: float, skew: float, n: int, n_docs: int, in_len: int, out_len: int = 8,
               rate: float = 8.0, n_engines: int = 4, check=None) -> dict:
    layout = qwen32b_layout()
    working_set = n_docs * (in_len // layout.block_tokens)
    shards = 32
    fast_blocks = _round_shards(int(working_set / oversub), shards)
    spill_blocks = _round_shards(4 * fast_blocks, shards)
    base = _base_cfg(fast_blocks, shards, n_engines)
    configs = {
        "baseline": ClusterConfig(**base),
        "tiered": ClusterConfig(**base, tiering=TieringConfig(enabled=True,
                                                              spill_blocks=spill_blocks)),
    }
    out = {"oversubscription": oversub, "zipf_skew": skew, "working_set_blocks": working_set,
           "fast_blocks": fast_blocks, "spill_blocks": spill_blocks}
    for name, cfg in configs.items():
        out[name] = _measure(cfg, layout, skew, n, n_docs, in_len, out_len, rate, check,
                             f"os{oversub:g}.zipf{skew:g}.{name}")
    out["ttft_ratio"] = out["baseline"]["avg_ttft_s"] / max(out["tiered"]["avg_ttft_s"], 1e-12)
    return out


def tier_chain_cell(oversub: float, skew: float, n: int, n_docs: int, in_len: int,
                    out_len: int = 8, rate: float = 8.0, n_engines: int = 4, check=None) -> dict:
    """Destroy-on-evict vs two tiers vs three at one fast capacity. The RDMA
    DRAM spill budget stays 1x fast (far memory is constrained); the three-
    tier chain hangs a 4x SSD tier below it."""
    layout = qwen32b_layout()
    working_set = n_docs * (in_len // layout.block_tokens)
    shards = 32
    fast_blocks = _round_shards(int(working_set / oversub), shards)
    spill_blocks = _round_shards(fast_blocks, shards)
    deep_blocks = _round_shards(4 * fast_blocks, shards)
    base = _base_cfg(fast_blocks, shards, n_engines)
    configs = {
        "destroy": ClusterConfig(**base),  # flat: evict == destroy
        "two_tier": ClusterConfig(**base, tiering=TieringConfig(enabled=True,
                                                                spill_blocks=spill_blocks)),
        "three_tier": ClusterConfig(**base, tiering=TieringConfig(
            enabled=True, spill_blocks=spill_blocks, extra_tiers=((deep_blocks, "ssd"),))),
    }
    out = {"oversubscription": oversub, "zipf_skew": skew, "working_set_blocks": working_set,
           "fast_blocks": fast_blocks, "spill_blocks": spill_blocks, "deep_blocks": deep_blocks}
    for name, cfg in configs.items():
        out[name] = _measure(cfg, layout, skew, n, n_docs, in_len, out_len, rate, check,
                             f"chain.os{oversub:g}.zipf{skew:g}.{name}")
    out["ttft_ratio_3t"] = out["destroy"]["avg_ttft_s"] / max(out["three_tier"]["avg_ttft_s"], 1e-12)
    out["ttft_ratio_2t"] = out["destroy"]["avg_ttft_s"] / max(out["two_tier"]["avg_ttft_s"], 1e-12)
    return out


# ---------------------------------------------------------------------------
def zero_cost_check(check=None) -> dict:
    """A disabled tiering config against the flat pool's reference stats."""
    cfg = ClusterConfig(n_engines=4, transfer_mode="beluga", pool_blocks=8192,
                        hbm_slots_per_engine=1024, tiering=TieringConfig(enabled=False))
    s1, s2, c = run_populate_then_hit(cfg, qwen32b_layout(), n=64, in_len=2048, out_len=64)
    got = {
        "populate": {k: s1[k] for k in REFERENCE_PR1["populate"]},
        "cache_hit": {k: s2[k] for k in REFERENCE_PR1["cache_hit"]},
    }
    if check is not None:
        check("zero_cost", c, c.requests)
    return {"identical": got == REFERENCE_PR1, "got": got, "reference": REFERENCE_PR1}


# ---------------------------------------------------------------------------
def results_of(fast: bool = False, check=None) -> dict:
    """Every cell of a run: the sweep, the chain depths, the zero-cost check."""
    if fast:
        cells, chain_cells = [(2.0, 1.1)], [(2.0, 1.1)]
        n, n_docs, in_len = 64, 16, 1024
    else:
        cells = [(1.0, 1.1), (2.0, 0.8), (2.0, 1.1), (4.0, 1.1)]
        chain_cells = [(2.0, 1.1), (4.0, 1.1)]
        n, n_docs, in_len = 96, 24, 2048
    return {
        "fast": fast,
        "cells": [sweep_cell(o, s, n=n, n_docs=n_docs, in_len=in_len, check=check)
                  for o, s in cells],
        "tier_chain": [tier_chain_cell(o, s, n=n, n_docs=n_docs, in_len=in_len, check=check)
                       for o, s in chain_cells],
        "zero_cost": zero_cost_check(check),
    }


def rows_of(results: dict) -> list[tuple]:
    """The reference's rows."""
    rows = []
    for cell in results["cells"]:
        t = cell["tiered"]["stats"]
        rows.append((
            f"exp13.tiering.os{cell['oversubscription']:g}.zipf{cell['zipf_skew']:g}",
            f"{cell['tiered']['avg_ttft_s'] * 1e6:.0f}",
            f"ttft_flat={cell['baseline']['avg_ttft_s'] * 1e3:.0f}ms;"
            f"ttft_tiered={cell['tiered']['avg_ttft_s'] * 1e3:.0f}ms;"
            f"ratio={cell['ttft_ratio']:.2f}x;"
            f"demotions={t.get('demotions', 0)};"
            f"promotions={t.get('promotions', 0)};"
            f"spill_hits={t.get('spill_hit_blocks', 0)}",
        ))
    for cell in results["tier_chain"]:
        t3 = cell["three_tier"]["stats"]
        rows.append((
            f"exp13.tier_chain.os{cell['oversubscription']:g}.zipf{cell['zipf_skew']:g}",
            f"{cell['three_tier']['avg_ttft_s'] * 1e6:.0f}",
            f"ttft_destroy={cell['destroy']['avg_ttft_s'] * 1e3:.0f}ms;"
            f"ttft_2t={cell['two_tier']['avg_ttft_s'] * 1e3:.0f}ms;"
            f"ttft_3t={cell['three_tier']['avg_ttft_s'] * 1e3:.0f}ms;"
            f"ratio_3t={cell['ttft_ratio_3t']:.2f}x;"
            f"tier_writes={t3.get('tier_writes')};"
            f"spill_evictions={t3.get('spill_evictions', 0)}",
        ))
    rows.append(("exp13.zero_cost_when_disabled", "0",
                 f"identical={results['zero_cost']['identical']}"))
    return rows


def run(fast: bool = False, out_path: str | None = None) -> list[tuple]:
    """The rows; the results go to ``out_path`` as JSON when one is named."""
    results = results_of(fast)
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(results, f, indent=2)
    return rows_of(results)


def pinned_mismatches(results: dict, pinned: dict | None = None, rel: float = 1e-12) -> list[str]:
    """Every number of a full-size run against ``PINNED``: integers (and
    strings) exactly, floats within ``rel``. Returns what differs."""
    want = pinned or PINNED
    bad = []
    for part in ("cells", "tier_chain"):
        if len(results[part]) != len(want[part]):
            bad.append(f"{part}: {len(results[part])} cells, pinned {len(want[part])}")
            continue
        for i, (g, w) in enumerate(zip(results[part], want[part])):
            bad += mismatches(g, w, f"{part}[{i}].", rel)
    bad += mismatches(results["zero_cost"]["got"], want["zero_cost"], "zero_cost.", rel)
    return bad


def chain_gate(results: dict) -> list[str]:
    """The reference's gate: from 2x oversubscription the three-tier chain
    beats destroy-on-evict on average TTFT. Returns the cells that fail."""
    return [f"os{c['oversubscription']:g}: ratio_3t {c['ttft_ratio_3t']!r}"
            for c in results["tier_chain"]
            if c["oversubscription"] >= 2.0 and not c["ttft_ratio_3t"] > 1.0]


def main(argv: list[str] | None = None) -> list[tuple]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true", help="one small cell of each kind")
    ap.add_argument("--json", default=None, help="write the results to this path")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    rows = run(args.fast, args.json)
    print(MODELED_NOTE)
    emit(rows)
    print(f"# wall {time.perf_counter() - t0:.1f} s on the host")
    return rows


# the full-size results (fast=False) as the reference computes them
# (benchmarks/exp13_tiering.run(); "zero_cost" is the disabled config's
# summaries, the check's "got")
PINNED: dict = {
    "cells": [
        {
            "oversubscription": 1.0, "zipf_skew": 1.1, "working_set_blocks": 3072,
            "fast_blocks": 3072, "spill_blocks": 12288,
            "baseline": {
                "avg_ttft_s": 0.014690371631962332, "p99_ttft_s": 0.04074109708363283,
                "qps": 7.772877840471168, "hit_tokens": 196608,
            },
            "tiered": {
                "avg_ttft_s": 0.019546900815239753, "p99_ttft_s": 0.045450709057646144,
                "qps": 7.763897187429631, "hit_tokens": 196608,
                "stats": {
                    "fast_hit_blocks": 8540, "spill_hit_blocks": 3748, "fast_writes": 2944,
                    "spill_writes": 128, "ghost_admits": 0, "demotions": 192, "promotions": 11,
                    "spill_evictions": 0, "migrated_bytes": 532152320,
                    "migration_busy_s": 0.03575917941693723, "fast_blocks": 3072,
                    "spill_blocks": 12288, "fast_occupancy": 0.8994140625,
                    "spill_occupancy": 0.025146484375, "ghost_entries": 0,
                    "tier_blocks": [3072, 12288], "tier_occupancy": [0.8994140625, 0.025146484375],
                    "tier_media": ["cxl", "rdma_dram"], "tier_writes": [2944, 128],
                    "migrator_steps": 300,
                },
            },
            "ttft_ratio": 0.7515447983707461,
        },
        {
            "oversubscription": 2.0, "zipf_skew": 0.8, "working_set_blocks": 3072,
            "fast_blocks": 1536, "spill_blocks": 6144,
            "baseline": {
                "avg_ttft_s": 0.08452797408758832, "p99_ttft_s": 0.1892388998827328,
                "qps": 7.678637239279611, "hit_tokens": 108544,
            },
            "tiered": {
                "avg_ttft_s": 0.025616925225058634, "p99_ttft_s": 0.05185025146927513,
                "qps": 7.7630595858724885, "hit_tokens": 196608,
                "stats": {
                    "fast_hit_blocks": 3462, "spill_hit_blocks": 8826, "fast_writes": 2304,
                    "spill_writes": 768, "ghost_admits": 0, "demotions": 960, "promotions": 37,
                    "spill_evictions": 0, "migrated_bytes": 2613575680,
                    "migration_busy_s": 0.17524795532332252, "fast_blocks": 1536,
                    "spill_blocks": 6144, "fast_occupancy": 0.8990885416666666,
                    "spill_occupancy": 0.2752278645833333, "ghost_entries": 0,
                    "tier_blocks": [1536, 6144],
                    "tier_occupancy": [0.8990885416666666, 0.2752278645833333],
                    "tier_media": ["cxl", "rdma_dram"], "tier_writes": [2304, 768],
                    "migrator_steps": 301,
                },
            },
            "ttft_ratio": 3.29969242385509,
        },
        {
            "oversubscription": 2.0, "zipf_skew": 1.1, "working_set_blocks": 3072,
            "fast_blocks": 1536, "spill_blocks": 6144,
            "baseline": {
                "avg_ttft_s": 0.06274432717700795, "p99_ttft_s": 0.18474495900402577,
                "qps": 7.772877840471168, "hit_tokens": 135168,
            },
            "tiered": {
                "avg_ttft_s": 0.025396769016278502, "p99_ttft_s": 0.05407776949209975,
                "qps": 7.765890535828365, "hit_tokens": 196608,
                "stats": {
                    "fast_hit_blocks": 3748, "spill_hit_blocks": 8540, "fast_writes": 2304,
                    "spill_writes": 768, "ghost_admits": 0, "demotions": 960, "promotions": 37,
                    "spill_evictions": 0, "migrated_bytes": 2613575680,
                    "migration_busy_s": 0.17524795532332252, "fast_blocks": 1536,
                    "spill_blocks": 6144, "fast_occupancy": 0.8990885416666666,
                    "spill_occupancy": 0.2752278645833333, "ghost_entries": 0,
                    "tier_blocks": [1536, 6144],
                    "tier_occupancy": [0.8990885416666666, 0.2752278645833333],
                    "tier_media": ["cxl", "rdma_dram"], "tier_writes": [2304, 768],
                    "migrator_steps": 300,
                },
            },
            "ttft_ratio": 2.4705633672059184,
        },
        {
            "oversubscription": 4.0, "zipf_skew": 1.1, "working_set_blocks": 3072,
            "fast_blocks": 768, "spill_blocks": 3072,
            "baseline": {
                "avg_ttft_s": 0.10362951781636288, "p99_ttft_s": 0.19331857209162706,
                "qps": 7.678637239279611, "hit_tokens": 83968,
            },
            "tiered": {
                "avg_ttft_s": 0.028450015277615356, "p99_ttft_s": 0.05185025146927513,
                "qps": 7.7630595858724885, "hit_tokens": 196608,
                "stats": {
                    "fast_hit_blocks": 1024, "spill_hit_blocks": 11264, "fast_writes": 2048,
                    "spill_writes": 1024, "ghost_admits": 0, "demotions": 1408, "promotions": 50,
                    "spill_evictions": 0, "migrated_bytes": 3822059520,
                    "migration_busy_s": 0.2561916279085497, "fast_blocks": 768,
                    "spill_blocks": 3072, "fast_occupancy": 0.8984375,
                    "spill_occupancy": 0.775390625, "ghost_entries": 0, "tier_blocks": [768, 3072],
                    "tier_occupancy": [0.8984375, 0.775390625], "tier_media": ["cxl", "rdma_dram"],
                    "tier_writes": [2048, 1024], "migrator_steps": 301,
                },
            },
            "ttft_ratio": 3.6425118512291,
        },
    ],
    "tier_chain": [
        {
            "oversubscription": 2.0, "zipf_skew": 1.1, "working_set_blocks": 3072,
            "fast_blocks": 1536, "spill_blocks": 1536, "deep_blocks": 6144,
            "destroy": {
                "avg_ttft_s": 0.06274432717700795, "p99_ttft_s": 0.18474495900402577,
                "qps": 7.772877840471168, "hit_tokens": 135168,
            },
            "two_tier": {
                "avg_ttft_s": 0.03381171283150226, "p99_ttft_s": 0.19095599364239035,
                "qps": 7.772877840471168, "hit_tokens": 179232,
                "stats": {
                    "fast_hit_blocks": 8206, "spill_hit_blocks": 2996, "fast_writes": 3263,
                    "spill_writes": 768, "ghost_admits": 0, "demotions": 1920, "promotions": 39,
                    "spill_evictions": 1114, "migrated_bytes": 5135400960,
                    "migration_busy_s": 0.3436388294439934, "fast_blocks": 1536,
                    "spill_blocks": 1536, "fast_occupancy": 0.8997395833333334,
                    "spill_occupancy": 0.9993489583333334, "ghost_entries": 1114,
                    "tier_blocks": [1536, 1536],
                    "tier_occupancy": [0.8997395833333334, 0.9993489583333334],
                    "tier_media": ["cxl", "rdma_dram"], "tier_writes": [3263, 768],
                    "migrator_steps": 300,
                },
            },
            "three_tier": {
                "avg_ttft_s": 0.04124523615311822, "p99_ttft_s": 0.08532252805645824,
                "qps": 7.74959387002025, "hit_tokens": 196608,
                "stats": {
                    "fast_hit_blocks": 3748, "spill_hit_blocks": 8540, "fast_writes": 2304,
                    "spill_writes": 768, "ghost_admits": 0, "demotions": 1344, "promotions": 37,
                    "spill_evictions": 0, "migrated_bytes": 3620208640,
                    "migration_busy_s": 0.36288940009469706, "fast_blocks": 1536,
                    "spill_blocks": 7680, "fast_occupancy": 0.8990885416666666,
                    "spill_occupancy": 0.22018229166666667, "ghost_entries": 0,
                    "tier_blocks": [1536, 1536, 6144],
                    "tier_occupancy": [0.8990885416666666, 0.875, 0.056477864583333336],
                    "tier_media": ["cxl", "rdma_dram", "ssd"], "tier_writes": [2304, 768, 0],
                    "migrator_steps": 301,
                },
            },
            "ttft_ratio_3t": 1.5212502831618377, "ttft_ratio_2t": 1.8556979792679795,
        },
        {
            "oversubscription": 4.0, "zipf_skew": 1.1, "working_set_blocks": 3072,
            "fast_blocks": 768, "spill_blocks": 768, "deep_blocks": 3072,
            "destroy": {
                "avg_ttft_s": 0.10362951781636288, "p99_ttft_s": 0.19331857209162706,
                "qps": 7.678637239279611, "hit_tokens": 83968,
            },
            "two_tier": {
                "avg_ttft_s": 0.07734447765565952, "p99_ttft_s": 0.18474495900402577,
                "qps": 7.772877840471168, "hit_tokens": 123440,
                "stats": {
                    "fast_hit_blocks": 6146, "spill_hit_blocks": 1569, "fast_writes": 5675,
                    "spill_writes": 1392, "ghost_admits": 78, "demotions": 4992, "promotions": 395,
                    "spill_evictions": 2843, "migrated_bytes": 14121697280,
                    "migration_busy_s": 0.9510371177286268, "fast_blocks": 768,
                    "spill_blocks": 768, "fast_occupancy": 0.8359375,
                    "spill_occupancy": 0.9973958333333334, "ghost_entries": 3008,
                    "tier_blocks": [768, 768], "tier_occupancy": [0.8359375, 0.9973958333333334],
                    "tier_media": ["cxl", "rdma_dram"], "tier_writes": [5675, 1392],
                    "migrator_steps": 300,
                },
            },
            "three_tier": {
                "avg_ttft_s": 0.06073891717508865, "p99_ttft_s": 0.08734244022934945,
                "qps": 7.740192299843364, "hit_tokens": 196608,
                "stats": {
                    "fast_hit_blocks": 1024, "spill_hit_blocks": 11264, "fast_writes": 2048,
                    "spill_writes": 1024, "ghost_admits": 0, "demotions": 3008, "promotions": 50,
                    "spill_evictions": 0, "migrated_bytes": 8016363520,
                    "migration_busy_s": 1.0081204468344156, "fast_blocks": 768,
                    "spill_blocks": 3840, "fast_occupancy": 0.8984375,
                    "spill_occupancy": 0.6203125, "ghost_entries": 0,
                    "tier_blocks": [768, 768, 3072],
                    "tier_occupancy": [0.8984375, 0.8333333333333334, 0.5670572916666666],
                    "tier_media": ["cxl", "rdma_dram", "ssd"], "tier_writes": [2048, 832, 192],
                    "migrator_steps": 301,
                },
            },
            "ttft_ratio_3t": 1.7061469422913143, "ttft_ratio_2t": 1.3398437866207507,
        },
    ],
    "zero_cost": {
        "populate": {
            "n_done": 64, "avg_ttft_s": 2.8039488662139385, "p99_ttft_s": 7.089036169999989,
            "avg_tpot_s": 0.04525995506634422, "p99_tpot_s": 0.05249664386904753,
            "qps": 6.937195787229816, "hit_tokens": 38304, "total_prompt_tokens": 131072,
        },
        "cache_hit": {
            "n_done": 64, "avg_ttft_s": 1.886711986538464, "p99_ttft_s": 5.383646092307693,
            "avg_tpot_s": 0.04071309412011604, "p99_tpot_s": 0.04234551245421243,
            "qps": 8.561591044588884, "hit_tokens": 131072, "total_prompt_tokens": 131072,
        },
    },
}



if __name__ == "__main__":
    main()
