"""Exp #1 (Table 4) on the port: the latency of the software coherence
methods for 16 KB operations.

Twin of ``benchmarks/exp01_coherence.py``, with its rows: the paper's
coherence-method matrix from the fabric model (``core/fabric.py``), and the
check of the paper's ordering (O1-O3): ntstore best for CPU writes,
CLFLUSH-before-read the only viable CPU load, DSA cheaper than a flushed
store. Every number is MODELED; no device is timed.

    python -m repro_torch.experiments.exp01_coherence
"""

from __future__ import annotations

from repro_torch.core import fabric
from repro_torch.experiments.common import emit

MODELED_NOTE = ("# exp01 rows: MODELED (the paper's Table 4 costs, core/fabric.py); "
                "no device timed")
PAPER = {  # Table 4, microseconds
    "write_store_uc": 281.56, "write_store_clflush": 8.50,
    "write_ntstore": 2.41, "write_dsa_uc": 1.69,
    "read_load_uc": 166.49, "read_load_clflush": 5.98, "read_dsa_uc": 2.12,
    "write_gpu_ddio_off": 9.14, "read_gpu_uc": 10.55,
}


def run() -> list[tuple]:
    kb16 = 16 * 1024
    ours = {
        "write_store_uc": fabric.cpu_write_latency(kb16, "uncacheable") * 1e6,
        "write_store_clflush": fabric.cpu_write_latency(kb16, "clflush") * 1e6,
        "write_ntstore": fabric.cpu_write_latency(kb16, "ntstore") * 1e6,
        "write_dsa_uc": fabric.cpu_write_latency(kb16, "dsa") * 1e6,
        "read_load_uc": fabric.cpu_read_latency(kb16, "uncacheable") * 1e6,
        "read_load_clflush": fabric.cpu_read_latency(kb16, "clflush") * 1e6,
        "read_dsa_uc": fabric.cpu_read_latency(kb16, "dsa") * 1e6,
        "write_gpu_ddio_off": fabric.gpu_transfer_latency(kb16, 1, "fused_kernel", "write") * 1e6,
        "read_gpu_uc": fabric.gpu_transfer_latency(kb16, 1, "fused_kernel") * 1e6,
    }
    rows = [(f"exp01.{k}", f"{v:.2f}", f"paper={PAPER[k]}us") for k, v in ours.items()]
    ok = (ours["write_ntstore"] < ours["write_store_clflush"] < ours["write_store_uc"]
          and ours["read_load_clflush"] < ours["read_load_uc"]
          and ours["write_dsa_uc"] < ours["write_store_clflush"])
    rows.append(("exp01.guideline_ordering_holds", "0", f"ok={ok}"))
    return rows


if __name__ == "__main__":
    print(MODELED_NOTE)
    emit(run())
