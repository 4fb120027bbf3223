"""Per-tier counters of the tiered pool, reported by ``Cluster.run``.

Twin of ``repro/tiering/stats.py``: the same fields, in the same order.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class TierStats:
    fast_hit_blocks: int = 0  # prefix-hit blocks served from the fast tier
    spill_hit_blocks: int = 0  # ... and from the tiers below it
    fast_writes: int = 0  # fresh blocks admitted to the fast tier
    spill_writes: int = 0  # fresh blocks admitted straight down-chain
    ghost_admits: int = 0  # pressured writes forced fast by the ghost filter
    demotions: int = 0  # blocks migrated one tier down
    promotions: int = 0  # blocks migrated back to the fast tier
    spill_evictions: int = 0  # bottom-tier blocks destroyed to make room
    migrated_bytes: int = 0
    migration_busy_s: float = 0.0  # MODELED media time spent migrating

    def as_dict(self) -> dict:
        return dict(self.__dict__)
