"""Hotness tracking and the ghost list's admission filter of the tiered pool.

Twin of ``repro/tiering/policy.py``, with the same numpy calls, so that the
same blocks move:

* **decayed access counters**: one float per block, decayed with virtual
  time (half-life ``HALF_LIFE_S``) lazily, from the time of the block's last
  update, and bumped on every touch: O(blocks touched);
* **the ghost list**: a recency list of at most ``GHOST_CAPACITY`` keys whose blocks were
  destroyed (evicted, not demoted). A key that comes back proves the
  eviction a mistake, so the admission filter sends its fresh block to the
  fast tier even under pressure, once.

``coldest`` / ``hottest`` take ``np.argpartition`` and then a stable
``np.argsort``, as the reference does: ``torch.topk`` breaks ties in
another order and would pick other blocks.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np

# the reference's ``TieringConfig`` defaults, which no caller changes
HALF_LIFE_S = 30.0  # hotness decay half-life (virtual s)
GHOST_CAPACITY = 8192  # admission-filter memory (keys)


class HotnessTracker:
    """Per-block decayed heat + the ghost list's admission filter."""

    def __init__(self, n_blocks: int):
        self.n_blocks = n_blocks
        self._decay_rate = math.log(2.0) / HALF_LIFE_S
        self.heat = np.zeros(n_blocks, np.float64)
        self._last = np.zeros(n_blocks, np.float64)
        self._ghost: OrderedDict[bytes, None] = OrderedDict()
        self.ghost_hits = 0

    # ------------------------------------------------------------------
    def touch(self, block_ids, now: float) -> None:
        """Decay to ``now``, then add one."""
        ids = np.asarray(block_ids, np.intp)
        if not len(ids):
            return
        dt = np.maximum(0.0, now - self._last[ids])
        self.heat[ids] = self.heat[ids] * np.exp(-self._decay_rate * dt) + 1.0
        self._last[ids] = now

    def heat_at(self, block_ids, now: float) -> np.ndarray:
        """Decayed heat at ``now``, without a bump."""
        ids = np.asarray(block_ids, np.intp)
        if not len(ids):
            return np.zeros(0, np.float64)
        dt = np.maximum(0.0, now - self._last[ids])
        return self.heat[ids] * np.exp(-self._decay_rate * dt)

    def reset(self, block_ids) -> None:
        """Forget the history of freshly allocated blocks."""
        ids = np.asarray(block_ids, np.intp)
        if len(ids):
            self.heat[ids] = 0.0

    def move(self, src_ids, dst_ids) -> None:
        """Carry heat across a migration: the block moved, its data's
        popularity did not."""
        src = np.asarray(src_ids, np.intp)
        dst = np.asarray(dst_ids, np.intp)
        if not len(src):
            return
        self.heat[dst] = self.heat[src]
        self._last[dst] = self._last[src]
        self.heat[src] = 0.0

    def coldest(self, candidate_ids, k: int, now: float) -> np.ndarray:
        """The k coldest candidates, coldest first."""
        ids = np.asarray(candidate_ids, np.intp)
        heats = self.heat_at(ids, now)
        if len(ids) > k:
            part = np.argpartition(heats, k)[:k]
            ids, heats = ids[part], heats[part]
        order = np.argsort(heats, kind="stable")
        return ids[order]

    def hottest(self, candidate_ids, k: int, now: float) -> np.ndarray:
        """The k hottest candidates, hottest first."""
        ids = np.asarray(candidate_ids, np.intp)
        heats = self.heat_at(ids, now)
        if len(ids) > k:
            part = np.argpartition(-heats, k)[:k]
            ids, heats = ids[part], heats[part]
        order = np.argsort(-heats, kind="stable")
        return ids[order]

    # ------------------------------------------------------------------
    def ghost_add(self, keys: list[bytes]) -> None:
        """Record destroyed keys (wired to ``PrefixIndex.on_evict``)."""
        g = self._ghost
        for k in keys:
            g[k] = None
            g.move_to_end(k)
        while len(g) > GHOST_CAPACITY:
            g.popitem(last=False)

    def ghost_contains(self, key: bytes | None) -> bool:
        """Peek without consuming it (placement may still clamp the block
        down-chain)."""
        return key is not None and key in self._ghost

    def admit_hot(self, key: bytes | None) -> bool:
        """True if the key was destroyed recently and has come back: its
        fresh block goes fast. Consumes the entry: call only when the
        admission is honoured."""
        if key is None or key not in self._ghost:
            return False
        del self._ghost[key]
        self.ghost_hits += 1
        return True

    def ghost_len(self) -> int:
        return len(self._ghost)
