"""Named shared-memory segments: the stand-in for the paper's CXL pool
mappings, which every participant reads and writes by load / store.

Twin of the segment helpers of ``repro/core/shm.py``. A ring
(``core/rpc.SlotRing.create_shared``) lives in one such segment, so two
processes, or the JAX package and the port in one process, can map the
same slots by name. The rule is creator-unlinks: only the creator of a
segment removes its name; an attacher only drops its mapping.

  * ``create_segment`` makes a zero-filled segment (the caller owns the
    unlink);
  * ``attach_segment`` maps one by name without registering it with the
    ``resource_tracker``: on Python < 3.13 the tracker otherwise takes an
    attacher for an owner and unlinks the segment when the attacher exits;
  * ``close_segment`` drops the mapping (retrying through ``gc.collect()``
    when a numpy view still holds the export) and, for the creator,
    unlinks; it may run twice.
"""

from __future__ import annotations

import gc
from multiprocessing import shared_memory

from repro_torch.core import diag


def create_segment(size: int) -> shared_memory.SharedMemory:
    """Create a zero-filled named segment (the caller owns the unlink)."""
    seg = shared_memory.SharedMemory(create=True, size=size)
    seg.buf[:] = bytes(len(seg.buf))
    return seg


def attach_segment(name: str) -> shared_memory.SharedMemory:
    """Map an existing segment without taking on its unlink."""
    try:
        from multiprocessing import resource_tracker
    except ImportError:  # no tracker on this platform: plain attach
        return shared_memory.SharedMemory(name=name)
    orig_register = resource_tracker.register
    resource_tracker.register = lambda *a, **k: None
    try:
        return shared_memory.SharedMemory(name=name)
    finally:
        resource_tracker.register = orig_register


def close_segment(seg: shared_memory.SharedMemory | None, *, unlink: bool) -> None:
    """Close (and, for the creator, unlink) a segment; safe to repeat."""
    if seg is None:
        return
    try:
        seg.close()
    except BufferError:
        gc.collect()  # a dropped numpy view still held the export
        try:
            seg.close()
        except BufferError:
            pass
    except Exception:  # noqa: BLE001
        diag.note("shm.close_segment.close_failed")
    if unlink:
        try:
            seg.unlink()
        except FileNotFoundError:
            pass
        except Exception:  # noqa: BLE001
            diag.note("shm.close_segment.unlink_failed")
