"""The paper's CXL / RDMA fabric cost model: the port's copy of what the
exp09 and exp10 twins read from ``repro/core/fabric.py``.

Pure Python. Every constant has the value of the reference's field of the
same name in lower case (``FabricConstants`` at ``fabric.py:31``, traced
there to the paper's measurements). ``gpu_transfer_latency`` is the
reference's ``fused_kernel`` path (``fabric.py:137``) and
``rdma_transfer_latency`` its ``gpu_side=True`` path (``:161``), the only
paths the twins price. What they return is MODELED: the latency of the
paper's CXL switch and RDMA NIC, never a time measured on any device here.
Callers print it as modeled, not beside a card's name.

All times in seconds, sizes in bytes.
"""

from __future__ import annotations

import math

US = 1e-6
GB = 1024**3

# --- CXL path (Beluga) ---
CXL_64B_LATENCY = 0.75 * US  # switch port-to-port, §2.3
GPU_CXL_BW = 26.0 * GB  # GPU<->CXL through root complex, §5.3
KERNEL_LAUNCH = 7.9 * US  # CUDA kernel launch + sync (§3.2)
# --- RDMA path (MoonCake-style baseline) ---
RDMA_BASE_LATENCY = 3.2 * US  # one-sided verb, QD=1 small msg
RDMA_BW = 50.0 * GB  # 400 Gbps NIC
RDMA_REQUEST_OVERHEAD = 1.0 * US  # WQE prep + doorbell + CQ poll
RDMA_SGL_MAX = 30  # ConnectX-7 sglist entries (§6.1)
BOUNCE_COPY_BW = 40.0 * GB  # GPU->host bounce buffer copy
HOST_SYNC_OVERHEAD = 8.0 * US  # CPU<->GPU coordination (§3.2)


def gpu_transfer_latency(size: int) -> float:
    """GPU <-> CXL pool transfer of ``size`` bytes in any number of
    fragments: one fused copy kernel moves them all (Beluga)."""
    return KERNEL_LAUNCH + CXL_64B_LATENCY + size / GPU_CXL_BW


def rdma_transfer_latency(size: int, n_fragments: int) -> float:
    """CPU-driven RDMA path (MoonCake): GPU -> host bounce copy, then
    ceil(frags / 30) RDMA requests, plus host <-> GPU synchronisation."""
    t = HOST_SYNC_OVERHEAD + (KERNEL_LAUNCH + size / BOUNCE_COPY_BW)  # the reference's order
    t +=math.ceil(n_fragments / RDMA_SGL_MAX) * (RDMA_BASE_LATENCY + RDMA_REQUEST_OVERHEAD)
    return t + size / RDMA_BW
