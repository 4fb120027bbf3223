"""Exp #4 (Fig. 8) on the port: 64 B operation latency under background
bandwidth pressure, through the pool devices' queue model.

Twin of ``benchmarks/exp04_background.py``, with its rows. Server B streams
0-15 GB/s at one memory device while server A issues 64 B operations at
it: the median stays flat, the p99 rises with the pressure. Every number
is MODELED (``fabric.PoolDeviceQueues`` at the paper's CXL device
bandwidth and switch latency); no device is timed.

    python -m repro_torch.experiments.exp04_background
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import fabric
from repro_torch.experiments.common import emit

MODELED_NOTE = ("# exp04 rows: MODELED (one pool device's queue at the paper's CXL "
                "device bandwidth, core/fabric.py); no device timed")


def run() -> list[tuple]:
    rows = []
    size = 64
    for bg_gbps in (0, 5, 10, 15):
        q = fabric.PoolDeviceQueues(n_devices=1)
        chunk = 256 * 1024  # background chunks arriving to sustain bg_gbps
        horizon = 0.01
        lat = []
        bg_interval = chunk / (bg_gbps * 2**30) if bg_gbps else None
        bg_t = 0.0
        for i in range(2000):
            now = i * horizon / 2000
            if bg_interval:
                while bg_t <= now:
                    q.submit(bg_t, 0, chunk, interleave=False)
                    bg_t += bg_interval
            done = q.submit(now, 0, size, interleave=False)
            lat.append((done - now) + fabric.CXL_64B_LATENCY)
        lat_us = np.array(lat) * 1e6
        rows.append(
            (f"exp04.bg_{bg_gbps}GBps", f"{np.median(lat_us):.3f}",
             f"p99={np.percentile(lat_us, 99):.3f}us")
        )
    return rows


if __name__ == "__main__":
    print(MODELED_NOTE)
    emit(run())
