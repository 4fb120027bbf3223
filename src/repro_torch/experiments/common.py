"""What the port's experiment twins share: CSV rows and device timing.

Rows are ``(name, us, derived)`` as in ``benchmarks/common.py``; a time
that no device run gave is written "not measured".
"""

from __future__ import annotations

import itertools

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
QUEUE_SPIN_CYCLES = 50_000_000  # about 25 ms at the H100's boost clock
NOT_MEASURED = "not measured"


def emit(rows: list[tuple]) -> None:
    """CSV rows: name,us_per_call,derived."""
    for name, us, derived in rows:
        print(f"{name},{us},{derived}")


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call of ``fn``: CUDA events around ``iters`` calls,
    queued behind a spin on the card long enough that the host's launch
    overhead (tens of microseconds a call through a Python wrapper, more
    than a short kernel takes) does not stand in for the device's time."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cycled_ms(fn, inputs, iters: int = 20) -> float:
    """``device_ms`` of ``fn(x)`` with x cycling through ``inputs``: each call
    reads other data than the calls just before it, so that a short kernel
    finds its data cold in the 50 MB L2 when ``inputs`` outgrow it together,
    as on the paths, instead of timing the cache."""
    it = itertools.cycle(inputs)
    return device_ms(lambda: fn(next(it)), iters)


def graph_ms(fn, inputs, replays: int = 20) -> float:
    """Device time of one call of ``fn(x)`` replayed from ONE captured CUDA
    graph of the calls over every x in ``inputs``: ``device_ms`` of the
    replay divided by len(inputs). Each x is run once on a side stream
    first, so ``fn`` is built and its plans cached before the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for x in inputs:
            fn(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for x in inputs:
            fn(x)
    return device_ms(graph.replay, replays) / len(inputs)


def byte_bound_us(n_bytes: int) -> float:
    """The least time the card takes to move ``n_bytes`` through HBM."""
    return n_bytes / HBM_BYTES_PER_S * 1e6


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
