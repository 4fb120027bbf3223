"""Software-managed multi-host coherence (paper §5.1, O1-O3).

Twin of ``repro/core/coherence.py`` over the port's pool. A CXL 2.0
switch gives one address space but no cross-host cache coherence, so the
paper publishes under one writer and many readers:

  WRITER: write the payload by a cache-bypassing method, fence, bump the
          block's epoch, then publish (key, block, epoch) in the index;
  READER: read (block, epoch) from the index, invalidate local lines, copy
          the payload, and check that the epoch is unchanged (an eviction
          and rewrite in between would have bumped it), else retry.

On the card the same obligation holds: a pool block is not readable before
its payload write completes, and a reader must see a recycled block. The
epoch check is that obligation. Each read and write also adds its Table 4
cost (``core/fabric.cpu_write_latency`` / ``cpu_read_latency``, MODELED) to
the counters.

The reference's ``CoherentWriter``, ``CoherentReader``, ``CoherenceStats``
and ``CoherenceError`` are ``CoherentBlockWriter``,
``CoherentBlockReader``, ``CoherenceCounters`` and ``StaleEpochError``
here: the same fields and rules, under names of the port's own.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.core import fabric
from repro_torch.core.pool import KVBlockPool


class StaleEpochError(RuntimeError):
    """A reader met a recycled or torn block (its epoch moved)."""


@dataclass
class CoherenceCounters:
    writes: int = 0
    write_bytes: int = 0
    reads: int = 0
    read_bytes: int = 0
    retries: int = 0
    modeled_write_s: float = 0.0
    modeled_read_s: float = 0.0


@dataclass
class CoherentBlockWriter:
    """The one writer of a set of blocks (one LLM instance)."""

    pool: KVBlockPool
    method: str = "ntstore"  # O1: ntstore | clflush | uncacheable | dsa
    stats: CoherenceCounters = field(default_factory=CoherenceCounters)

    def write_block(self, block_id: int, payload: torch.Tensor | None) -> int:
        """Store a block's payload (one block's shape; None on a
        payload-free pool) and publish it; returns the publish epoch."""
        size = self.pool.layout.block_bytes
        self.stats.modeled_write_s += fabric.cpu_write_latency(size, self.method)
        [epoch] = self.pool.write_blocks([block_id], None if payload is None else payload[None])
        self.stats.writes += 1
        self.stats.write_bytes += size
        return epoch


@dataclass
class CoherentBlockReader:
    pool: KVBlockPool
    method: str = "clflush"  # O1: clflush | uncacheable | dsa
    max_retries: int = 3
    stats: CoherenceCounters = field(default_factory=CoherenceCounters)

    def read_block(self, block_id: int, expected_epoch: int) -> torch.Tensor | None:
        """Check the epoch, copy, check again; raises ``StaleEpochError``
        once the epoch is no longer the expected one. Returns the payload
        (None on a payload-free pool)."""
        size = self.pool.layout.block_bytes
        for _ in range(self.max_retries):
            if not self.pool.validate_epochs([block_id], [expected_epoch])[0]:
                raise StaleEpochError(f"block {block_id}: epoch {expected_epoch} no longer valid")
            rows, eps = self.pool.read_blocks([block_id])
            self.stats.modeled_read_s += fabric.cpu_read_latency(size, self.method)
            if int(eps[0]) == expected_epoch:
                self.stats.reads += 1
                self.stats.read_bytes += size
                return None if rows is None else rows[0]
            self.stats.retries += 1  # recycled meanwhile: check again
        raise StaleEpochError(f"block {block_id}: unstable epoch after retries")
