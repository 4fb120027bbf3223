"""The tiered pool: a hotness-managed chain of pools below the card's HBM.

Twin of ``repro/tiering``: ``tiers.TieredPool`` (a fast CXL tier, a spill
tier and optional deeper media in one block-id space, behind the pool's
allocate / retain / release / payload / epoch calls), ``policy`` (decayed
access heat and the ghost list's admission filter), ``migrator`` (the
background engine that demotes cold blocks ahead of pressure and promotes
re-hot ones, on the cluster's virtual clock) and ``stats``. Every latency
it adds is MODELED (``core/fabric.py``); on ``cuda`` the tiers' payloads
are real rows on the card, and a migration copies them there.
"""

from repro_torch.tiering.migrator import MigrationEngine
from repro_torch.tiering.policy import HotnessTracker
from repro_torch.tiering.stats import TierStats
from repro_torch.tiering.tiers import TieredPool, TieringConfig

__all__ = ["HotnessTracker", "MigrationEngine", "TierStats", "TieredPool", "TieringConfig"]
