"""How fast a tier migration's copy moves KV rows on the card.

A migration of the tiered pool (``tiering/migrator.py``) reads its source
rows from one tier and writes them into another, both on the card. This
probe times that copy for 70 rows of the Qwen3-32B layout (2.5 MiB each,
a typical batch of ``chip_smoke.py`` phase 19's churn), in turns, each
the median of 16 calls timed with CUDA events, beside the copy bound
(2 x bytes / 3.35 TB/s):

* ``pool``: ``KVBlockPool.read_blocks`` then ``write_blocks``, as the
  migrator calls them (``index_select`` and ``index_copy_`` on the rows'
  2-D view, the ids uploaded each call, the epochs kept on the host);
* ``advanced``: ``data[ids]`` then ``data[ids] = rows``, the ids uploaded
  each call, and again with the ids already on the card;
* ``row loop``: one ``copy_`` a row, each byte read and written once.

Device times on one card;
the card's name and power limit are printed first.

    python -m repro_torch.experiments.tier_copy_probe
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from repro_torch.core.pool import KVBlockPool
from repro_torch.experiments.cluster_common import qwen32b_layout
from repro_torch.experiments.common import HBM_BYTES_PER_S

N_ROWS = 70


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("tier_copy_probe: no CUDA device")
    layout = qwen32b_layout()
    src = KVBlockPool(layout, 1024, "cuda", n_shards=32)
    dst = KVBlockPool(layout, 2048, "cuda", n_shards=32)
    src.data.view(torch.int16).random_(-100, 100)
    rng = np.random.default_rng(0)
    pairs = [(rng.choice(1024, N_ROWS, replace=False), rng.choice(2048, N_ROWS, replace=False))
             for _ in range(16)]
    on_card = [(torch.as_tensor(a, device="cuda"), torch.as_tensor(b, device="cuda"))
               for a, b in pairs]
    s2, d2 = src.data.flatten(1), dst.data.flatten(1)

    def pool(i):
        a, b = pairs[i]
        rows, _ = src.read_blocks(a)
        dst.write_blocks(b, rows)

    def advanced_on_card(i):
        a, b = on_card[i]
        dst.data[b] = src.data[a]

    def advanced(i):
        a, b = (torch.as_tensor(x, device="cuda") for x in pairs[i])
        dst.data[b] = src.data[a]

    def row_loop(i):
        a, b = pairs[i]
        for x, y in zip(a.tolist(), b.tolist()):
            d2[y].copy_(s2[x])

    def median_ms(fn):
        for i in range(2):
            fn(i)
        torch.cuda.synchronize()
        ms = []
        for i in range(16):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn(i)
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
        return float(np.median(ms))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    nbytes = N_ROWS * layout.block_bytes
    print(f"# {smi}; {N_ROWS} rows of {layout.block_bytes} B; copy bound "
          f"{2 * nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
    for turn in range(2):
        for name, fn in (("pool", pool), ("advanced", advanced),
                         ("advanced, ids on the card", advanced_on_card), ("row loop", row_loop)):
            ms = median_ms(fn)
            print(f"turn {turn} {name:26s} {ms:.4f} ms {nbytes / ms / 1e6:.1f} GB/s")


if __name__ == "__main__":
    main()
