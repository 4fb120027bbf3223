"""Exp #2 (Fig. 5) on the port: latency against I/O size for every CPU and
GPU path to the pool.

Twin of ``benchmarks/exp02_latency.py``, with its rows and its two
crossovers: DSA beats CPU stores above a few KB (O4), and the fused copy
kernel beats per-fragment cudaMemcpy for small reads from UC memory (O6,
the < 24 KB pathology). Every number is MODELED (``core/fabric.py``); no
device is timed.

    python -m repro_torch.experiments.exp02_latency
"""

from __future__ import annotations

from repro_torch.core import fabric
from repro_torch.experiments.common import emit

MODELED_NOTE = ("# exp02 rows: MODELED (the paper's fabric costs, core/fabric.py); "
                "no device timed")
SIZES = [256, 1024, 4096, 16384, 65536, 262144, 1048576]


def run() -> list[tuple]:
    rows = []
    cross_cpu = None
    for s in SIZES:
        cpu_direct = fabric.cpu_write_latency(s, "ntstore") * 1e6
        cpu_dsa = fabric.cpu_write_latency(s, "dsa") * 1e6
        gpu_fused = fabric.gpu_transfer_latency(s, 1, "fused_kernel") * 1e6
        gpu_memcpy = fabric.gpu_transfer_latency(s, 1, "cudamemcpy") * 1e6
        rdma = fabric.rdma_transfer_latency(s, 1) * 1e6
        dram = fabric.local_dram_latency(s) * 1e6
        rows.append((f"exp02.write_{s}B", f"{cpu_direct:.2f}",
                     f"dsa={cpu_dsa:.2f};gpu_fused={gpu_fused:.2f};"
                     f"gpu_memcpy={gpu_memcpy:.2f};rdma={rdma:.2f};dram={dram:.2f}"))
        if cross_cpu is None and cpu_dsa < cpu_direct:
            cross_cpu = s
    rows.append(("exp02.dsa_crossover_bytes", str(cross_cpu),
                 "paper: DSA wins above ~4-16KB (O4)"))
    small = fabric.gpu_transfer_latency(16384, 1, "cudamemcpy", "read") * 1e6
    fused = fabric.gpu_transfer_latency(16384, 1, "fused_kernel", "read") * 1e6
    rows.append(("exp02.gpu_16k_uc_memcpy_vs_fused", f"{small:.1f}",
                 f"fused={fused:.1f}us; paper: memcpy ~1230us <24KB on UC (O6)"))
    return rows


if __name__ == "__main__":
    print(MODELED_NOTE)
    emit(run())
