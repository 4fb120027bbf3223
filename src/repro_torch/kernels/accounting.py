"""What a launch of work outside PyTorch's dispatcher tells the op analyzer.

A hand-written kernel launches through ``ctypes`` and a collective runs
through ``torch.distributed``; neither is an aten op, so
``launch.op_analysis.OpAnalyzer`` (a ``TorchDispatchMode``) would see only
the ops around them: a kernel's output allocations, a collective's host
copies. So each kernel wrapper (``kernels/*.py``) runs its launch, or the
shape-only stand-in it takes on the ``meta`` device, inside ``kernel``, and
each collective (``distributed/collectives.py``) its staging and its call,
or its abstract stand-in, inside ``collective``. Every listener added with
``listening`` records the entry and leaves out the aten ops dispatched
inside it, so that a dry run on ``meta`` and the same call on the card
count alike. With no listener both are empty contexts.
"""

from __future__ import annotations

import contextlib

# the devices a kernel wrapper takes: on meta it allocates its outputs and
# launches nothing (the dry run's shape-only stand-in)
DEVICES = ("cuda", "meta")
_LISTENERS: list = []


@contextlib.contextmanager
def listening(listener):
    """``listener`` hears every kernel and collective until the block ends.
    It has ``enter_kernel(name, flops, nbytes)``,
    ``enter_collective(kind, axes, nbytes, out_nbytes, dtype)`` and
    ``exit_region()``."""
    _LISTENERS.append(listener)
    try:
        yield listener
    finally:
        _LISTENERS.remove(listener)


@contextlib.contextmanager
def kernel(name: str, cost: tuple):
    """One launch of kernel ``name`` whose work is ``cost`` = (FLOPs, bytes)."""
    heard = list(_LISTENERS)
    for lst in heard:
        lst.enter_kernel(name, *cost)
    try:
        yield
    finally:
        for lst in heard:
            lst.exit_region()


@contextlib.contextmanager
def collective(kind: str, axes: tuple, nbytes: int, out_nbytes: int, dtype):
    """One collective of ``kind`` (JAX's names: "all-reduce", "all-gather",
    "reduce-scatter", "all-to-all") over mesh ``axes``, sending ``nbytes``
    per device (its operand's bytes, as JAX's analyzer counts them) of
    ``dtype`` and leaving a result of ``out_nbytes``."""
    heard = list(_LISTENERS)
    for lst in heard:
        lst.enter_collective(kind, axes, nbytes, out_nbytes, dtype)
    try:
        yield
    finally:
        for lst in heard:
            lst.exit_region()
