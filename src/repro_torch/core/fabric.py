"""The paper's CXL / RDMA fabric cost model: the port's copy of what the
exp09 and exp10 twins and the cluster simulator read from
``repro/core/fabric.py``.

Pure Python. Every constant has the value of the reference's field of the
same name in lower case (``FabricConstants`` at ``fabric.py:31``, traced
there to the paper's measurements). ``gpu_transfer_latency`` is the
reference's ``fused_kernel`` path (``fabric.py:137``) and
``rdma_transfer_latency`` its ``gpu_side=True`` path (``:161``), the only
paths the twins price. ``spill_transfer_latency`` and ``SPILL_MEDIA`` price
the tiered pool's media below the CXL pool (``fabric.py:79-102``,
``:186-196``), and ``PoolDeviceQueues`` is the reference's ``DeviceQueues``
(``:203-244``): per-device FIFO queues of the pool's memory devices, which
the exp03 / exp04 twins and the tiered pool's migrator load. What they
return is MODELED: the latency of the paper's CXL switch, RDMA NIC and
spill media, never a time measured on any device here. Callers print it as
modeled, not beside a card's name.

All times in seconds, sizes in bytes.
"""

from __future__ import annotations

import math

US = 1e-6
MB = 1024 * 1024
GB = 1024**3

# --- CXL path (Beluga) ---
CXL_64B_LATENCY = 0.75 * US  # switch port-to-port, §2.3
CXL_DEV_BW = 22.5 * GB  # per memory device, §5.3
CXL_ADAPTER_READ_BW = 46.2 * GB  # per PCIe5 x16 adapter, §5.3
CXL_ADAPTER_WRITE_BW = 33.0 * GB  # root-complex write bottleneck, §5.3
GPU_CXL_BW = 26.0 * GB  # GPU<->CXL through root complex, §5.3
N_DEVICES = 32  # memory devices in the pool (Table 2)
INTERLEAVE_BYTES = 2 * MB  # software interleaving granularity, §5.3
KERNEL_LAUNCH = 7.9 * US  # CUDA kernel launch + sync (§3.2)
# --- RDMA path (MoonCake-style baseline) ---
RDMA_BASE_LATENCY = 3.2 * US  # one-sided verb, QD=1 small msg
RDMA_BW = 50.0 * GB  # 400 Gbps NIC
RDMA_REQUEST_OVERHEAD = 1.0 * US  # WQE prep + doorbell + CQ poll
RDMA_SGL_MAX = 30  # ConnectX-7 sglist entries (§6.1)
# CPU-side allocation + staging per (super-)block transfer in the
# MoonCake/LMCache path, calibrated to Fig. 13c's block-size sweep
RDMA_SW_PER_SUPERBLOCK = 25.0 * US * 1000
BOUNCE_COPY_BW = 40.0 * GB  # GPU->host bounce buffer copy
HOST_SYNC_OVERHEAD = 8.0 * US  # CPU<->GPU coordination (§3.2)
# --- spill-tier media below the CXL pool (the tiered pool, Exp #13) ---
# far-NUMA DRAM over one-sided RDMA, an NVMe SSD and an archival disk:
# media access plus a bandwidth term, paid on every down-chain block touched
SPILL_DRAM_RDMA_LATENCY = 4.0 * US  # far-memory one-sided read
SPILL_DRAM_RDMA_BW = 20.0 * GB  # shared far-NUMA / RDMA fabric
SPILL_SSD_LATENCY = 80.0 * US  # NVMe read latency class
SPILL_SSD_BW = 6.0 * GB  # PCIe4 x4 NVMe device
SPILL_HDD_LATENCY = 4000.0 * US  # archival spindle / SMR class
SPILL_HDD_BW = 0.25 * GB

# medium name -> (latency, bandwidth): the tiered pool prices each boundary
# of its chain from this table
SPILL_MEDIA: dict[str, tuple[float, float]] = {
    "rdma_dram": (SPILL_DRAM_RDMA_LATENCY, SPILL_DRAM_RDMA_BW),
    "ssd": (SPILL_SSD_LATENCY, SPILL_SSD_BW),
    "hdd": (SPILL_HDD_LATENCY, SPILL_HDD_BW),
}


def gpu_transfer_latency(size: int) -> float:
    """GPU <-> CXL pool transfer of ``size`` bytes in any number of
    fragments: one fused copy kernel moves them all (Beluga)."""
    return KERNEL_LAUNCH + CXL_64B_LATENCY + size / GPU_CXL_BW


def rdma_transfer_latency(size: int, n_fragments: int) -> float:
    """CPU-driven RDMA path (MoonCake): GPU -> host bounce copy, then
    ceil(frags / 30) RDMA requests, plus host <-> GPU synchronisation."""
    t = HOST_SYNC_OVERHEAD + (KERNEL_LAUNCH + size / BOUNCE_COPY_BW)  # the reference's order
    t += math.ceil(n_fragments / RDMA_SGL_MAX) * (RDMA_BASE_LATENCY + RDMA_REQUEST_OVERHEAD)
    return t + size / RDMA_BW


def spill_transfer_latency(size: int, media: str) -> float:
    """Access to a spill tier below the pool, priced per medium from
    ``SPILL_MEDIA``; an unknown medium raises ``ValueError``."""
    try:
        latency, bw = SPILL_MEDIA[media]
    except KeyError:
        raise ValueError(media) from None
    return latency + size / bw


class PoolDeviceQueues:
    """Per-memory-device FIFO queues of the pool (Exp #3 / #4, O9).

    Service time is bytes / ``CXL_DEV_BW``. A request reaches devices either
    interleaved round-robin at ``INTERLEAVE_BYTES`` (``interleave=True``) or
    by its address's partition of the pool, so that hot (zipf) regions all
    land on the first devices (the paper's §5.3 bottleneck).
    """

    def __init__(self, n_devices: int = N_DEVICES, total_bytes: int = 8 * (1024**4)):
        self.n_devices = n_devices
        self.total_bytes = total_bytes  # 8 TB pool (Table 2)
        self.busy_until = [0.0] * n_devices

    def submit(self, now: float, addr: int, size: int, interleave: bool) -> float:
        """Queue a request at ``now``; returns its completion time."""
        if interleave:
            n_chunks = max(1, math.ceil(size / INTERLEAVE_BYTES))
            per_chunk = size / n_chunks
            done = now
            start_dev = (addr // INTERLEAVE_BYTES) % self.n_devices
            for i in range(n_chunks):
                d = (start_dev + i) % self.n_devices
                svc = per_chunk / CXL_DEV_BW
                start = max(now, self.busy_until[d])
                self.busy_until[d] = start + svc
                done = max(done, start + svc)
            return done
        region = max(1, self.total_bytes // self.n_devices)
        d = min(self.n_devices - 1, addr // region)
        svc = size / CXL_DEV_BW
        start = max(now, self.busy_until[d])
        self.busy_until[d] = start + svc
        return start + svc
