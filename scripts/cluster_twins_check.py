"""The port's cluster experiment twins against the JAX package's, in full.

Runs ``repro_torch.experiments.exp05_e2e`` / ``exp06_rates`` /
``exp07_context`` / ``exp08_software`` and their ``benchmarks/`` originals
on this host's CPU and prints, per experiment, whether every row is
string-equal, with each side's wall seconds; exits 1 if any row differs.
The tests hold the same modules at smaller sizes (and exp05 at 64 and 256
clients); this covers the full-size sweeps, about a minute of CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/cluster_twins_check.py
"""

from __future__ import annotations

import importlib
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

NAMES = ["exp05_e2e", "exp06_rates", "exp07_context", "exp08_software"]


def main() -> int:
    ok = True
    for name in NAMES:
        t0 = time.perf_counter()
        port = importlib.import_module(f"repro_torch.experiments.{name}").run()
        t1 = time.perf_counter()
        ref = importlib.import_module(f"benchmarks.{name}").run()
        t2 = time.perf_counter()
        same = port == ref
        ok &= same
        print(f"{name}: {len(port)} rows, equal={same}, port {t1 - t0:.1f} s, "
              f"JAX package {t2 - t1:.1f} s", flush=True)
        for a, b in zip(port, ref):
            if a != b:
                print(f"  port {a}\n  ref  {b}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
