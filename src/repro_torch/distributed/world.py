"""A world of ranks on one host: spawned, joined on a clock, torn down.

``run_world(fn, n, args)`` starts ``n`` processes with the ``spawn`` start
method (CUDA forbids ``fork`` once it is initialised), each joining one
gloo group through a ``file://`` rendezvous in a fresh directory, and calls
``fn(rank, n, *args)`` in each. ``fn`` must be a module-level function (the
child imports it by name). Rank 0's return value comes back to the caller,
saved with ``torch.save`` (tensors on the card are brought to the host
first). A rank that raises fails the run with its traceback; a world that
has not finished within ``timeout_s`` is terminated and raises
``TimeoutError``, so a collective that one rank never reached cannot hang
the caller. Every process started is stopped before the call returns.
"""

from __future__ import annotations

import os
import tempfile
import time
from datetime import timedelta

import torch

RESULT = "result.pt"


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _entry(rank: int, fn, n: int, workdir: str, timeout_s: float, threads: int, args) -> None:
    import torch.distributed as dist

    torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous", rank=rank,
                            world_size=n, timeout=timedelta(seconds=timeout_s))
    try:
        out = fn(rank, n, *args)
        if rank == 0:
            torch.save(_to_host(out), os.path.join(workdir, RESULT))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_world(fn, n: int, args: tuple = (), timeout_s: float = 300.0, threads: int = 1,
              workdir: str | None = None):
    """Rank 0's result of ``fn(rank, n, *args)`` over ``n`` spawned ranks."""
    import torch.multiprocessing as mp

    own = workdir is None
    tmp = tempfile.TemporaryDirectory(prefix="world_") if own else None
    workdir = tmp.name if own else workdir
    os.makedirs(workdir, exist_ok=True)
    for stale in ("rendezvous", RESULT):
        if os.path.exists(os.path.join(workdir, stale)):
            os.remove(os.path.join(workdir, stale))
    ctx = mp.start_processes(_entry, args=(fn, n, workdir, timeout_s, threads, args),
                             nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.1, min(1.0, deadline - time.monotonic()))):
            if time.monotonic() > deadline:
                raise TimeoutError(f"a world of {n} ranks running {fn.__name__} did not "
                                   f"finish in {timeout_s:.0f} s")
        return torch.load(os.path.join(workdir, RESULT), weights_only=False)
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(10)
            if p.is_alive():
                p.kill()
        if tmp is not None:
            tmp.cleanup()
