"""Which kernels a torch.profiler window misses, and whether settling helps.

``chip_smoke.py`` counts device kernels in profiled windows (one paged
kernel per layer and decode step; one kernel per call). On an H100 a
decode window of 8 steps now and then came back about one layer's kernels
short while the launch counters saw every launch. This probe opens
windows shaped like a decode window: ``STEPS`` steps, each a
host-to-device copy of its token and an index op, then ``LAYERS`` layers
of an add, a multiply and a small product. In two forms, taken in turns:

* ``cold``: the first copy is made as soon as the window opens, as
  ``chip_smoke.py``'s windows did;
* ``settled``: the card is synchronised and ``SETTLE_S`` waited inside the
  window before the first launch (``chip_smoke.profiled``).

A window is whole when every kernel's and copy's count is a multiple of
the steps. Each row gives the windows that were not whole and the kernels
and copies they missed against the fullest window of their form. Run on
the card:

    PYTHONPATH=src python -m repro_torch.experiments.profiler_probe
"""

from __future__ import annotations

import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.experiments.common import device_name, emit

STEPS, LAYERS = 8, 32
WINDOWS = 100  # of each form
SETTLE_S = 0.002


def _window(body, settle: bool) -> list[int]:
    """Each device kernel's and copy's count in a profiled window of ``body``."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if settle:
            torch.cuda.synchronize()
            time.sleep(SETTLE_S)
        body()
        torch.cuda.synchronize()
    return [e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def run() -> list[tuple]:
    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.zeros(1 << 20, device=dev)
    table = torch.randn(1024, 64, device=dev)
    a = torch.randn(64, 64, device=dev)
    b = torch.empty_like(a)

    def steps():
        for i in range(STEPS):
            row = table[torch.tensor([i], device=dev)]  # a copy and an index op
            for _ in range(LAYERS):
                x.add_(1.0)
                x.mul_(0.5)
                torch.mm(a, a, out=b)
            del row

    counts = {"cold": [], "settled": []}
    _window(steps, True)  # the profiler's first start in this process
    for _ in range(WINDOWS):
        for form in counts:
            counts[form].append(_window(steps, form == "settled"))
    card = device_name(dev)
    rows = []
    for form, got in counts.items():
        want = max(sum(c) for c in got)
        torn = [c for c in got if any(n % STEPS for n in c)]
        rows.append((f"profiler_probe.{form}", "not measured",
                     f"windows={len(got)};not_whole={len(torn)};"
                     f"missing={sum(want - sum(c) for c in got)};"
                     f"kernels_and_copies_a_window={want};card={card}"))
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profiler_probe: runs on the card only")
    emit(run())


if __name__ == "__main__":
    main()
