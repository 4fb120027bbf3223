"""The tiered pool's background migration engine (virtual clock, budgets).

Twin of ``repro/tiering/migrator.py``. Every ``migrate_interval_s`` of the
cluster's virtual time it takes one step, and a step moves at most
``migrate_batch_blocks`` blocks across each boundary of the chain:

* **demotion**, ahead of pressure: when a tier's occupancy reaches
  ``high_watermark``, its coldest unreferenced indexed blocks move one tier
  down until it is back at ``demote_target``; a demoted prefix stays fetchable,
  at that medium's modeled latency, instead of being recomputed;
* **promotion**: down-chain blocks whose decayed heat reached
  ``promote_min_heat`` (``TieredPool.promote_pending``) move back to the
  fast tier, which stays under its watermark;
* **bottom-tier eviction**, the last resort: when the last tier is full,
  its coldest blocks are destroyed through ``PrefixIndex.evict_blocks``
  and their keys enter the ghost list. A tier in between never destroys:
  its own boundary drains it further down.

A migration copies the payload rows (on the card, on a ``cuda`` chain),
re-points the index entries, rolls back a copy whose remap lost a race, and
frees the sources, whose epochs move on. Its MODELED media time goes to
``TierStats.migration_busy_s`` and, with ``queues``, the fast-tier side of
the copy occupies the pool devices' queues (``fabric.PoolDeviceQueues``),
where foreground fetches wait behind it (the ``Cluster`` always passes
them: the reference's ``model_contention`` default). ``EngineInstance.advance`` drives
``run_until`` between steps of every engine: steps fire on the monotone
maximum of their clocks (one daemon, many clocks).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import fabric
from repro_torch.tiering.tiers import TieredPool, TieringConfig


class MigrationEngine:
    def __init__(self, pool: TieredPool, index, cfg: TieringConfig | None = None,
                 queues: fabric.PoolDeviceQueues | None = None):
        self.pool = pool
        self.index = index
        self.cfg = cfg or pool.cfg
        self.queues = queues
        self.clock = 0.0
        self.steps = 0

    # ------------------------------------------------------------------
    def run_until(self, now: float) -> None:
        """Advance the daemon's virtual clock to ``now`` (monotone)."""
        interval = self.cfg.migrate_interval_s
        while self.clock + interval <= now:
            self.clock += interval
            self._step(self.clock)
            self.steps += 1

    def _step(self, now: float) -> None:
        self.pool.tick(now)
        cfg, pool = self.cfg, self.pool
        fast = pool.tiers[0]
        if pool.tier_occupancy(0) >= cfg.high_watermark:
            used = fast.n_blocks - fast.free_blocks()
            target = int(cfg.demote_target * fast.n_blocks)
            k = min(cfg.migrate_batch_blocks, used - target)
            if k > 0:
                self._demote(0, k, now)
        elif fast.free_blocks() > 0:
            self._promote(now)
        # deeper boundaries drain on their own (tier t -> t + 1), each at the
        # same watermark, with its own budget
        for t in range(1, pool.n_tiers - 1):
            if pool.tier_occupancy(t) < cfg.high_watermark:
                continue
            tp = pool.tiers[t]
            used = tp.n_blocks - tp.free_blocks()
            target = int(cfg.demote_target * tp.n_blocks)
            k = min(cfg.migrate_batch_blocks, used - target)
            if k > 0:
                self._demote(t, k, now)
        # last, so that even a step whose bottom-tier eviction destroyed
        # enqueued ids leaves the pending set clean
        self._prune_pending()

    def _prune_pending(self) -> None:
        """Drop freed, re-referenced or uncommitted ids from
        ``promote_pending`` on every step: after a step it names only live
        refcount-1 blocks."""
        pool = self.pool
        pending = pool.promote_pending
        if not pending:
            return
        cand = np.fromiter(pending, np.intp, len(pending))
        dead = ~((pool.refcounts[cand] == 1) & pool.committed[cand])
        if dead.any():
            pending.difference_update(cand[dead].tolist())

    # ------------------------------------------------------------------
    def _candidates(self, tier, offset: int) -> np.ndarray:
        """Global ids of a tier's migration candidates: committed, held by
        the index alone (refcount 1)."""
        return np.where((tier.refcounts == 1) & tier.committed)[0] + offset

    def _demote(self, src_t: int, k: int, now: float) -> None:
        pool = self.pool
        dst_t = src_t + 1
        cand = self._candidates(pool.tiers[src_t], int(pool._starts[src_t]))
        if not len(cand):
            return
        chosen = pool.policy.coldest(cand, k, now)
        dst = pool.tiers[dst_t]
        short = len(chosen) - dst.free_blocks()
        if short > 0:
            if dst_t == pool.n_tiers - 1:
                # the bottom of the chain: destroy its coldest blocks (their
                # keys reach the ghost list through index.on_evict)
                sc = self._candidates(dst, int(pool._starts[dst_t]))
                victims = pool.policy.coldest(sc, short, now)
                freed = self.index.evict_blocks(victims.tolist())
                pool.tier_stats.spill_evictions += len(freed)
            # a tier in between is drained by its own boundary: take what fits
            if len(chosen) > dst.free_blocks():
                chosen = chosen[: dst.free_blocks()]
        if not len(chosen):
            return
        moved = self._migrate(chosen.tolist(), dst_t)
        pool.tier_stats.demotions += len(moved)
        self._account(len(moved), now, pool.tier_media[dst_t], to_fast=False)

    def _promote(self, now: float) -> None:
        """Promote from ``promote_pending``: O(blocks touched), never a
        sweep of the chain."""
        pool, cfg = self.pool, self.cfg
        pending = pool.promote_pending
        if not pending:
            return
        # stay strictly under the watermark: a promotion landing on it would
        # trip the demotion trigger on the next step
        cap = int(cfg.high_watermark * pool.fast.n_blocks)
        used = pool.fast.n_blocks - pool.fast.free_blocks()
        budget = min(cfg.migrate_batch_blocks, cap - used - 1)
        if budget <= 0:
            return
        cand = np.fromiter(pending, np.intp, len(pending))
        # stale entries go, and so do entries whose heat decayed below the
        # threshold while they waited
        live = cand[(pool.refcounts[cand] == 1) & pool.committed[cand]]
        live = live[pool.policy.heat_at(live, now) >= cfg.promote_min_heat]
        chosen = pool.policy.hottest(live, budget, now)
        pending.difference_update(cand.tolist())
        pending.update(live.tolist())  # what the budget left retries next step
        pending.difference_update(chosen.tolist())
        if not len(chosen):
            return
        moved = self._migrate(chosen.tolist(), 0)
        pool.tier_stats.promotions += len(moved)
        if moved:
            # sources in different media each pay their own
            _, tix = pool._split_tiers(moved)
            for t in sorted(set(tix.tolist())):
                self._account(int((tix == t).sum()), now, pool.tier_media[t], to_fast=True)

    # ------------------------------------------------------------------
    def _migrate(self, src_ids: list[int], dst_t: int) -> list[int]:
        """Copy payloads to tier ``dst_t``, re-point the index, free the
        sources. Returns the global ids migrated (the sources)."""
        pool, index = self.pool, self.index
        keys, src_ids, old_eps = index.owners_of(src_ids)
        if not keys:
            return []
        dst_pool = pool.tiers[dst_t]
        dst_off = int(pool._starts[dst_t])
        dst_local = dst_pool.allocate(len(src_ids))
        new_eps = self._copy_payloads(src_ids, dst_pool, dst_local)
        dst_ids = [b + dst_off for b in dst_local]
        ok = index.remap_many(keys, src_ids, old_eps, dst_ids, new_eps)
        moved_src = [s for s, o in zip(src_ids, ok) if o]
        moved_dst = [d for d, o in zip(dst_ids, ok) if o]
        lost_dst = [d - dst_off for d, o in zip(dst_ids, ok) if not o]
        if lost_dst:  # lost a race with an eviction or a re-publish: roll back
            dst_pool.release(lost_dst)
        if moved_src:
            pool.policy.move(moved_src, moved_dst)
            # freeing a source moves its epoch on: a reader that matched the
            # old entry fails validation and plans again (§5.1)
            pool.release(moved_src)
        return moved_src

    def _copy_payloads(self, src_ids: list[int], dst_pool, dst_local: list[int]) -> list[int]:
        """Read the sources' rows and publish them into ``dst_local`` of the
        destination tier (device to device on a ``cuda`` chain; nothing
        moves on ``meta``). Returns the publish epochs."""
        payloads, _ = self.pool.read_blocks(src_ids)
        return dst_pool.write_blocks(dst_local, payloads)

    def _account(self, n_blocks: int, now: float, media: str, to_fast: bool) -> None:
        if not n_blocks:
            return
        size = n_blocks * self.pool.layout.block_bytes
        spill_t = fabric.spill_transfer_latency(size, media)
        fast_t = fabric.CXL_64B_LATENCY + size / (
            fabric.CXL_ADAPTER_WRITE_BW if to_fast else fabric.CXL_ADAPTER_READ_BW
        )
        self.pool.tier_stats.migrated_bytes += size
        self.pool.tier_stats.migration_busy_s += spill_t + fast_t
        if self.queues is not None:
            # the fast-tier side of the copy occupies the pool devices
            addr = self.steps * self.pool.layout.block_bytes
            self.queues.submit(now, addr, size, interleave=True)
