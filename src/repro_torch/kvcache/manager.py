"""Two-tier KVCache manager: HBM paged cache <-> KV block pool (paper §6).

Twin of ``repro/kvcache/manager.py``, one per engine instance:

  new request  -> PrefixIndex.match_prefix_keys
               -> hit blocks: scatter-read pool -> HBM slots (PoolTransfer)
               -> miss tokens: prefill computes them -> gather-write to pool
               -> publish (key, block, epoch) in the index
  decode       -> paged attention over HBM slots
  eviction     -> HBM slots recycled per sequence; pool blocks LRU-evicted
                  by the index when the pool fills

Straggler mitigation (fetch-vs-recompute cutover): if the modeled fetch
latency of the hit prefix exceeds ``recompute_cutover`` x the estimated
recompute time, the manager recomputes instead of waiting on a slow pool.

On a tiered pool (``tiering.TieredPool``) a planned fetch bumps the hit
blocks' heat (``touch_demand``) and is priced per tier
(``PoolTransfer.tiered_fetch_latency``), behind the migrator's backlog in
the shared ``queues``; a fetch made counts its blocks per tier; a writeback
moves the pool's hotness clock and passes its keys to the ghost list's
admission filter.

The degraded mode of a remote metadata plane (``degraded_ok``) comes with
the cross-process planes, ``ROADMAP.md`` queue 1 item 7e.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.index import PrefixIndex
from repro_torch.core.pool import PAYLOAD_DTYPES, KVBlockPool, PoolExhausted
from repro_torch.core.transfer import PoolTransfer
from repro_torch.kvcache.hbm_cache import HbmPagedCache, OutOfHbmBlocks

@dataclass
class FetchPlan:
    n_hit_tokens: int
    n_miss_tokens: int
    hit_blocks: list[tuple[bytes, int, int]]  # (key, block_id, epoch)
    fetch_latency: float  # modeled
    recompute: bool  # cutover decision
    keys: list[bytes] | None = None  # full chain (hashed once per request)


@dataclass
class ManagerStats:
    prefix_hits_tokens: int = 0
    prefix_miss_tokens: int = 0
    fetches: int = 0
    writebacks: int = 0
    recompute_cutovers: int = 0
    pool_evictions: int = 0


class KVCacheManager:
    def __init__(
        self,
        pool: KVBlockPool,
        index: PrefixIndex,
        hbm: HbmPagedCache,
        transfer: PoolTransfer,
        recompute_cutover: float | None = None,
        prefill_tok_per_s: float = 8000.0,
        queues=None,
    ):
        self.pool = pool  # a KVBlockPool or a tiering.TieredPool
        self.index = index
        self.hbm = hbm
        self.transfer = transfer
        self.recompute_cutover = recompute_cutover
        self.prefill_tok_per_s = prefill_tok_per_s
        # the pool devices' fabric.PoolDeviceQueues, shared with the
        # migrator on a tiered pool: a fetch queues behind migration traffic
        self.queues = queues
        self.stats = ManagerStats()

    # ------------------------------------------------------------------
    def plan_fetch(self, tokens: list[int], now: float = 0.0) -> FetchPlan:
        """Prefix match + fetch-vs-recompute decision. ``now`` (the engine's
        virtual time) matters on a tiered pool alone: it drives the hotness
        decay and the queues' backlog."""
        bt = self.pool.layout.block_tokens
        keys = self.index.keys_for(tokens)
        hits = self.index.match_prefix_keys(keys)
        n_hit = len(hits) * bt
        n_miss = len(tokens) - n_hit
        lat = 0.0
        if hits:
            if self.pool.is_tiered:
                counts = self.pool.touch_demand([b for _, b, _ in hits], now)
                lat = self.transfer.tiered_fetch_latency(counts, now, self.queues)
            else:
                lat = self.transfer.fetch_latency(len(hits))
        recompute_time = n_hit / self.prefill_tok_per_s
        # recompute instead of waiting on a fetch slower than `cutover x` the
        # recompute time; off by default, so RDMA behaves as MoonCake
        cutover = (
            self.recompute_cutover is not None
            and bool(hits)
            and lat > self.recompute_cutover * max(recompute_time, 1e-9)
        )
        if cutover:
            self.stats.recompute_cutovers += 1
            hits, n_hit, n_miss = [], 0, len(tokens)
        self.stats.prefix_hits_tokens += n_hit
        self.stats.prefix_miss_tokens += max(0, n_miss)
        return FetchPlan(n_hit, max(0, n_miss), hits, lat, cutover, keys)

    # ------------------------------------------------------------------
    def fetch_into_hbm(self, seq_id: str, plan: FetchPlan) -> list[int]:
        """Scatter-read hit blocks into freshly allocated HBM slots.

        On any failure the sequence is still registered (empty) and every
        intermediate resource is rolled back, so the caller can fall back
        to a full recompute with no leaked pool refs or HBM slots."""
        if not plan.hit_blocks:
            self.hbm.register_sequence(seq_id, [])
            return []
        keys = [k for k, _, _ in plan.hit_blocks]
        block_ids = [b for _, b, _ in plan.hit_blocks]
        epochs = [e for _, _, e in plan.hit_blocks]
        self.pool.retain(block_ids)
        try:
            slots = self.hbm.allocate(len(block_ids), keys=keys)
        except OutOfHbmBlocks:
            self.pool.release(block_ids)
            self._fetch_failed(seq_id, plan)
            raise
        try:
            self.transfer.scatter_read(block_ids, epochs)
            self.stats.fetches += 1
        except BaseException:
            self.pool.release(block_ids)
            self.hbm.release(slots)
            self._fetch_failed(seq_id, plan)
            raise
        self.pool.release(block_ids)
        if self.pool.is_tiered:
            self.pool.count_tier_hits(block_ids)
        self.hbm.register_sequence(seq_id, slots)
        return slots

    def _fetch_failed(self, seq_id: str, plan: FetchPlan) -> None:
        """The caller falls back to a full recompute, so the planned hit
        tokens were in fact missed."""
        self.hbm.register_sequence(seq_id, [])
        self.stats.prefix_hits_tokens -= plan.n_hit_tokens
        self.stats.prefix_miss_tokens += plan.n_hit_tokens

    def writeback(self, seq_id: str, tokens: list[int], kv_payload=None, keys=None,
                  now: float = 0.0) -> int:
        """After prefill: gather-write the new full blocks to the pool and
        publish them. Returns the number of blocks written.

        ``kv_payload`` optionally carries their KV, (n_new, 2L, bt, hkv, hd);
        on a payload pool without it, zeros are written. ``keys`` is the
        chain from ``plan_fetch`` (hash once). ``now`` moves a tiered pool's
        hotness clock."""
        bt = self.pool.layout.block_tokens
        tiered = self.pool.is_tiered
        if tiered:
            self.pool.tick(now)
        if keys is None:
            keys = self.index.keys_for(tokens)
        # only blocks not already in the pool need writing
        missing = self.index.filter_unpublished(keys)
        new_keys = [(i, keys[i]) for i in missing]
        if not new_keys:
            return 0

        def alloc():
            if tiered:  # the keys feed the ghost list's admission filter
                return self.pool.allocate(len(new_keys), keys=[k for _, k in new_keys])
            return self.pool.allocate(len(new_keys))

        try:
            block_ids = alloc()
        except PoolExhausted:
            freed = self.index.evict_lru(len(new_keys) * 2)
            self.stats.pool_evictions += len(freed)
            try:
                block_ids = alloc()
            except PoolExhausted:
                return 0  # pool full of referenced blocks: skip offload
        if kv_payload is None and not self.pool.payload_free:
            lay = self.pool.layout
            kv_payload = torch.zeros((len(new_keys), *lay.block_shape),
                                     dtype=PAYLOAD_DTYPES[lay.dtype_bytes], device=self.pool.device)
        epochs = self.transfer.gather_write(block_ids, kv_payload)
        self.index.publish_many([key for _, key in new_keys], block_ids, epochs, bt)
        self.stats.writebacks += 1
        return len(new_keys)

    # ------------------------------------------------------------------
    def finish(self, seq_id: str) -> None:
        self.hbm.finish_sequence(seq_id)
