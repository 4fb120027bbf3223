"""Exp #3 (Fig. 7) on the port: concurrent skewed access, pool interleaving
on and off, through the pool devices' queue model.

Twin of ``benchmarks/exp03_skew.py``, with its rows. 16 synchronized
workers issue 16 KB operations at zipf(0.99)-chosen block addresses into
``fabric.PoolDeviceQueues``: without interleaving, the first device is the
bottleneck (lower aggregate bandwidth, higher p99). The queue model's own
``interleave`` flag makes the split, as in the reference; the pool's
allocator plays no part. Every number is MODELED (the paper's CXL device
bandwidth); no device is timed.

    python -m repro_torch.experiments.exp03_skew
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import fabric
from repro_torch.experiments.common import emit

MODELED_NOTE = ("# exp03 rows: MODELED (the pool devices' queues at the paper's CXL "
                "device bandwidth, core/fabric.py); no device timed")


def zipf_addrs(n: int, n_blocks: int, a: float = 0.99, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_blocks + 1, dtype=np.float64)
    p = ranks ** (-a)
    p /= p.sum()
    return rng.choice(n_blocks, size=n, p=p)


def run() -> list[tuple]:
    rows = []
    size = 16 * 1024
    n_ops = 4000
    n_threads = 16
    n_blocks = 4096
    blocks = zipf_addrs(n_ops, n_blocks)
    for interleave in (True, False):
        q = fabric.PoolDeviceQueues(n_devices=32,
                                    total_bytes=n_blocks * fabric.INTERLEAVE_BYTES)
        lat = []
        done_max = 0.0
        for i, b in enumerate(blocks):
            now = (i // n_threads) * 2e-6  # batched thread issue
            addr = int(b) * fabric.INTERLEAVE_BYTES  # block-sized regions
            done = q.submit(now, addr, size, interleave)
            lat.append(done - now)
            done_max = max(done_max, done)
        lat_us = np.array(lat) * 1e6
        bw = n_ops * size / done_max / 2**30
        tag = "interleave" if interleave else "no_interleave"
        rows.append(
            (f"exp03.{tag}", f"{np.median(lat_us):.2f}",
             f"p99={np.percentile(lat_us, 99):.2f}us;agg_bw={bw:.1f}GiB/s")
        )
    rows.append(("exp03.paper_note", "0", "paper: no-interleave bottlenecks on first device (O9)"))
    return rows


if __name__ == "__main__":
    print(MODELED_NOTE)
    emit(run())
