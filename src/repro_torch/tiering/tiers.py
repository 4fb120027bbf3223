"""TieredPool: an ordered chain of pools behind the pool's calls.

Twin of ``repro/tiering/tiers.py``. N ``KVBlockPool`` tiers share one
global block-id space:

    tier 0   the fast CXL pool           ids [0, fast_blocks)
    tier 1   spill (RDMA DRAM or SSD)    ids [fast_blocks, fast + spill)
    tier 2+  optional deeper media       ids stacked after the spill tier

so that ``PrefixIndex``, ``PoolTransfer`` and ``KVCacheManager`` work
unchanged: each call splits its ids by tier, dispatches, and merges the
results in the caller's order. A deeper tier's size is rounded up to the
shard multiple. Every tier is a ``KVBlockPool`` on the chain's one device:
payload-free on ``meta`` (the twin of ``backing="meta"``), real payload rows
on ``cpu`` or ``cuda`` (the twin of ``backing="numpy"``). Only the modeled
latency differs between tiers (``fabric.spill_transfer_latency``).

Placement (write admission) is decided at allocation:

* below the fast tier's high watermark every fresh block lands fast;
* above it, fresh blocks go down-chain, except keys the ghost list
  recognises as destroyed and returned (forced fast, once);
* down-chain blocks fill the tiers in chain order, nearest medium first,
  and either end overflows into the other before the pool is exhausted.

Demotion and promotion along the chain are ``migrator.MigrationEngine``'s.
``share_meta`` moves every tier's metadata into one segment laid out over
the global id space, byte for byte a flat pool's of ``n_blocks``, so that a
shard service process attaches it as it would a flat pool's
(``core/procserver.PoolMetaView``); each tier's arrays become slices of
it. ``share_data`` does the same for the payload: one segment of rows in
global-id order, shaped as a flat pool's, each tier's ``data`` a slice of
it, and a ``tiering`` entry (each tier's first id and medium) in the attach
spec, which an engine worker's pool (``core/shmpool.TieredWorkerPool``)
reads. The scalar payload calls (``write_block``, ``read_block``,
``read_fragments``, ``validate_epoch``) are not ported: the port's coherent
reader and writer (``core/coherence.py``) reach a pool through its batched
calls.
"""

from __future__ import annotations

import atexit
import bisect
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.pool import (
    KVBlockLayout,
    KVBlockPool,
    PoolExhausted,
    data_spec,
    shared_data_segment,
    shared_meta_segment,
)
from repro_torch.core.shm import close_segment
from repro_torch.tiering.policy import HotnessTracker
from repro_torch.tiering.stats import TierStats


@dataclass
class TieringConfig:
    """Knobs of the tiered pool (``ClusterConfig.tiering``): the
    reference's that the port's callers set, with its defaults. Its other
    knobs stay at their defaults here: ``half_life_s`` and
    ``ghost_capacity`` are ``policy.HALF_LIFE_S`` / ``GHOST_CAPACITY``,
    ``model_contention`` is always on, every boundary uses
    ``high_watermark`` / ``demote_target``, and neither the prefix
    admission nor the suffix touch decay is ported."""

    enabled: bool = False
    spill_blocks: int = 0  # 0 -> 4x the fast tier
    spill_media: str = "rdma_dram"  # rdma_dram | ssd | hdd
    high_watermark: float = 0.90  # demote when fast occupancy reaches this
    demote_target: float = 0.75  # ... down to this occupancy
    migrate_interval_s: float = 0.05  # background engine step period
    migrate_batch_blocks: int = 64  # per-step migration budget a boundary
    promote_min_heat: float = 2.0  # down-chain heat that earns promotion
    # tiers below the spill tier, fast to slow: ((blocks, media), ...)
    extra_tiers: tuple = ()


class _TierView:
    """Read-only per-block metadata over the chain, by global id: scalars,
    fancy index arrays (empty ones too) and boolean masks over the global
    id space index it as they would one concatenated array."""

    __slots__ = ("_arrays", "_starts", "_bounds")

    def __init__(self, arrays, starts):
        self._arrays = list(arrays)
        self._starts = np.asarray(starts, np.intp)  # first id of each tier
        self._bounds = [int(s) for s in starts]

    def _tier_of(self, i: int) -> int:
        return bisect.bisect_right(self._bounds, i) - 1

    def __getitem__(self, i):
        if isinstance(i, (int, np.integer)):
            t = self._tier_of(i)
            return self._arrays[t][i - self._bounds[t]]
        ids = np.asarray(i)
        if ids.dtype == np.bool_:
            ids = np.flatnonzero(ids)  # a mask over the global id space selects
        elif ids.ndim == 0:
            t = self._tier_of(int(ids))
            return self._arrays[t][int(ids) - self._bounds[t]]
        ids = ids.astype(np.intp, copy=False)
        out = np.empty(len(ids), self._arrays[0].dtype)
        t = np.searchsorted(self._starts, ids, side="right") - 1
        for k, arr in enumerate(self._arrays):
            m = t == k
            if m.any():
                out[m] = arr[ids[m] - self._starts[k]]
        return out

    def __len__(self):
        return sum(len(a) for a in self._arrays)


class TieredPool:
    """N-tier pool chain in one global block-id space (fast first)."""

    is_tiered = True

    def __init__(
        self,
        layout: KVBlockLayout,
        fast_blocks: int,
        spill_blocks: int,
        device: str | torch.device = "meta",
        n_shards: int = 32,
        interleave: bool = True,
        cfg: TieringConfig | None = None,
    ):
        self.layout = layout
        self.interleave = interleave
        self.cfg = cfg or TieringConfig(enabled=True)
        sizes = [fast_blocks, spill_blocks]
        media = ["cxl", self.cfg.spill_media]
        for eb, em in self.cfg.extra_tiers:
            sizes.append(-(-int(eb) // n_shards) * n_shards)
            media.append(em)
        self.tiers = [KVBlockPool(layout, nb, device, n_shards, interleave) for nb in sizes]
        self.tier_media = tuple(media)
        self._starts = np.cumsum([0] + sizes[:-1]).astype(np.intp)
        self.n_blocks = int(sum(sizes))
        self.fast = self.tiers[0]
        self.offset = fast_blocks  # the first down-chain id
        self.policy = HotnessTracker(self.n_blocks)
        self.tier_stats = TierStats()
        self.tier_writes = [0] * len(self.tiers)
        self.now = 0.0  # virtual time high-water mark (the decay clock)
        # down-chain blocks whose heat crossed the promotion threshold, fed
        # by touch_demand and drained by the migrator
        self.promote_pending: set[int] = set()
        self._meta_segment = None
        self._meta_spec: dict | None = None
        self._data_segment = None
        self._data_spec: dict | None = None
        self._rebuild_views()

    def _rebuild_views(self) -> None:
        self.refcounts = _TierView([t.refcounts for t in self.tiers], self._starts)
        self.epochs = _TierView([t.epochs for t in self.tiers], self._starts)
        self.committed = _TierView([t.committed for t in self.tiers], self._starts)

    # ------------------------------------------------------------------
    def share_meta(self) -> dict:
        """Every tier's metadata in one named segment over the global id
        space (idempotent); returns the attach spec of a flat pool of
        ``n_blocks``. The chain's views become the segment's arrays."""
        if self._meta_spec is None:
            seg, arrays = shared_meta_segment(self.n_blocks)
            for t, o in zip(self.tiers, self._starts.tolist()):
                tn = t.n_blocks
                for whole, name in zip(arrays, ("epochs", "refcounts", "committed")):
                    whole[o : o + tn] = getattr(t, name)
                    setattr(t, name, whole[o : o + tn])
            self.epochs, self.refcounts, self.committed = arrays
            self._meta_segment = seg
            self._meta_spec = {"shm_name": seg.name, "n_blocks": self.n_blocks,
                               "block_tokens": self.layout.block_tokens}
            atexit.register(self.unshare_meta)
        return self._meta_spec

    def unshare_meta(self) -> None:
        """Copy the metadata back into private per-tier arrays and unlink;
        safe to repeat, and when never shared."""
        seg = self._meta_segment
        if seg is None:
            return
        for t in self.tiers:
            t.epochs = np.array(t.epochs, np.int64)
            t.refcounts = np.array(t.refcounts, np.int32)
            t.committed = np.array(t.committed, bool)
        self._rebuild_views()
        self._meta_segment = self._meta_spec = None
        close_segment(seg, unlink=True)
        atexit.unregister(self.unshare_meta)

    def share_data(self) -> dict:
        """Every tier's payload in one named segment, in global-id order
        (idempotent; implies ``share_meta``); returns a flat pool's attach
        spec of ``n_blocks`` plus ``tiering``: ``starts`` (each tier's
        first id) and ``media``. Each tier's ``data`` becomes its slice."""
        if self._data_spec is None:
            if self.device.type != "cpu":
                raise ValueError("share_data requires device='cpu' (the reference's "
                                 f"backing='numpy'), not {self.device.type!r}")
            meta = self.share_meta()
            seg, whole = shared_data_segment(self.n_blocks, self.layout)
            for t, o in zip(self.tiers, self._starts.tolist()):
                whole[o : o + t.n_blocks].copy_(t.data)
                t.data = whole[o : o + t.n_blocks]
            self._data_segment = seg
            self._data_spec = {
                **data_spec(seg.name, meta, self.n_blocks, self.layout),
                "tiering": {"starts": self._starts.tolist(), "media": list(self.tier_media)}}
            atexit.register(self.unshare_data)
        return self._data_spec

    def unshare_data(self) -> None:
        """Copy the payload back into private per-tier tensors and unlink;
        safe to repeat, and when never shared."""
        seg = self._data_segment
        if seg is None:
            return
        for t in self.tiers:
            t.data = t.data.clone()
        self._data_segment = self._data_spec = None
        close_segment(seg, unlink=True)
        atexit.unregister(self.unshare_data)

    # ------------------------------------------------------------------
    @property
    def alloc_count(self) -> int:
        return sum(t.alloc_count for t in self.tiers)

    @property
    def payload_free(self) -> bool:
        return self.tiers[0].payload_free

    @property
    def device(self) -> torch.device:
        return self.tiers[0].device

    @property
    def n_tiers(self) -> int:
        return len(self.tiers)

    def tick(self, now: float) -> None:
        self.now = max(self.now, now)

    def free_blocks(self) -> int:
        return sum(t.free_blocks() for t in self.tiers)

    def shard_occupancy(self) -> list[int]:
        out: list[int] = []
        for t in self.tiers:
            out += t.shard_occupancy()
        return out

    def tier_occupancy(self, t: int) -> float:
        p = self.tiers[t]
        if p.n_blocks == 0:  # an empty tier is never occupied
            return 0.0
        return (p.n_blocks - p.free_blocks()) / p.n_blocks

    def fast_occupancy(self) -> float:
        return self.tier_occupancy(0)

    def _split_tiers(self, block_ids) -> tuple[np.ndarray, np.ndarray]:
        """(ids, the tier of each)."""
        ids = np.asarray(block_ids, np.intp)
        return ids, np.searchsorted(self._starts, ids, side="right") - 1

    # ------------------------------------------------------------------
    def allocate(self, n: int, keys: list[bytes] | None = None) -> list[int]:
        """Allocate n blocks, choosing each one's tier. ``keys`` (from the
        writeback path) feed the ghost list's admission filter; without
        them placement follows the watermark alone."""
        frees = [t.free_blocks() for t in self.tiers]
        if sum(frees) < n:
            raise PoolExhausted(f"need {n}, have {frees[0]} fast + {sum(frees[1:])} spill")
        pressured = self.fast_occupancy() >= self.cfg.high_watermark
        ghost_hot = [False] * n
        if keys is not None and pressured:
            # peek only: an entry is consumed below, and only for a block
            # the capacity clamp lets into the fast tier
            ghost_hot = [self.policy.ghost_contains(k) for k in keys]
        want_fast = [(not pressured) or ghost_hot[i] for i in range(n)]
        n_fast = sum(want_fast)
        # clamp to the fast tier's room, tail first; positions that are not
        # ghost-hot yield their fast slot before the ghost-hot ones
        if n_fast > frees[0]:
            flip = n_fast - frees[0]
            for only_ghost in (False, True):
                for i in range(n - 1, -1, -1):
                    if not flip:
                        break
                    if want_fast[i] and ghost_hot[i] == only_ghost:
                        want_fast[i] = False
                        flip -= 1
            n_fast = frees[0]
        n_rest = n - n_fast
        if n_rest > sum(frees[1:]):
            flip = n_rest - sum(frees[1:])  # overflow back into fast, head first
            for i in range(n):
                if not flip:
                    break
                if not want_fast[i]:
                    want_fast[i] = True
                    flip -= 1
            n_fast, n_rest = n - sum(frees[1:]), sum(frees[1:])
        # down-chain positions go to tiers 1..k in chain order
        counts = [n_fast] + [0] * (len(self.tiers) - 1)
        tier_at = [0] * n
        j, avail = 1, frees[1] if len(frees) > 1 else 0
        for i in range(n):
            if want_fast[i]:
                continue
            while avail == 0:
                j += 1
                avail = frees[j]
            tier_at[i] = j
            counts[j] += 1
            avail -= 1
        its = []
        for k, (t, c) in enumerate(zip(self.tiers, counts)):
            base = int(self._starts[k])
            its.append(iter([b + base for b in t.allocate(c)]) if c else iter([]))
        out = [next(its[tier_at[i]]) for i in range(n)]
        n_ghost = 0
        if keys is not None:
            for i, wf in enumerate(want_fast):
                if wf and ghost_hot[i] and self.policy.admit_hot(keys[i]):
                    n_ghost += 1
        self.tier_stats.fast_writes += n_fast
        self.tier_stats.spill_writes += n_rest
        self.tier_stats.ghost_admits += n_ghost
        for k, c in enumerate(counts):
            self.tier_writes[k] += c
        self.policy.reset(out)  # recycled blocks start cold
        return out

    def retain(self, block_ids: list[int]) -> None:
        if not len(block_ids):
            return
        ids, tix = self._split_tiers(block_ids)
        for k, t in enumerate(self.tiers):
            m = tix == k
            if m.any():
                t.retain((ids[m] - self._starts[k]).tolist())

    def release(self, block_ids: list[int]) -> None:
        if not len(block_ids):
            return
        ids, tix = self._split_tiers(block_ids)
        for k, t in enumerate(self.tiers):
            m = tix == k
            if m.any():
                t.release((ids[m] - self._starts[k]).tolist())

    # ------------------------------------------------------------------
    def write_blocks(self, block_ids: list[int], payloads: torch.Tensor | None = None) -> list[int]:
        """Store (unless payload-free) and publish blocks across the chain;
        the write touches their heat. Returns the publish epochs."""
        ids, tix = self._split_tiers(block_ids)
        self.policy.touch(ids, self.now)
        eps = np.empty(len(ids), np.int64)
        store = payloads is not None and not self.payload_free
        for k, t in enumerate(self.tiers):
            m = tix == k
            if not m.any():
                continue
            sub = None
            if store:
                sub = payloads if m.all() else payloads[_rows(m, payloads.device)]
            eps[m] = t.write_blocks((ids[m] - self._starts[k]).tolist(), sub)
        return eps.tolist()

    def read_blocks(self, block_ids, out: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor | None, np.ndarray]:
        """(payload rows in the caller's order, into ``out`` when given, or
        None when payload-free; the epochs at the read)."""
        ids, tix = self._split_tiers(block_ids)
        eps = np.empty(len(ids), np.int64)
        dst = out
        for k, t in enumerate(self.tiers):
            m = tix == k
            if not m.any():
                continue
            if m.all():  # one tier holds them all: its rows, no second copy
                dst, eps[:] = t.read_blocks(ids - self._starts[k], out)
                continue
            p, e = t.read_blocks(ids[m] - self._starts[k])
            eps[m] = e
            if p is None:
                continue
            if dst is None:
                dst = p.new_empty((len(ids), *p.shape[1:]))
            dst[_rows(m, p.device)] = p
        if dst is None and not self.payload_free:
            dst = self.tiers[0].data[:0].clone()
        return dst, eps

    def validate_epochs(self, block_ids, epochs) -> np.ndarray:
        ids, tix = self._split_tiers(block_ids)
        exp = np.asarray(epochs)
        out = np.empty(len(ids), bool)
        for k, t in enumerate(self.tiers):
            m = tix == k
            if m.any():
                out[m] = t.validate_epochs(ids[m] - self._starts[k], exp[m])
        return out

    # ------------------------------------------------------------------
    def touch_demand(self, block_ids, now: float) -> tuple[int, ...]:
        """Bump the heat of a planned access (the demand signal: it fires
        even when the cutover then recomputes). Down-chain blocks whose heat
        reaches ``promote_min_heat`` enter ``promote_pending``, which the
        migrator drains. Returns the blocks per tier, fast first."""
        self.tick(now)
        ids, tix = self._split_tiers(block_ids)
        self.policy.touch(ids, self.now)
        rest = ids[tix > 0]
        if len(rest):
            hot = rest[self.policy.heat[rest] >= self.cfg.promote_min_heat]
            self.promote_pending.update(hot.tolist())
        return tuple(int((tix == k).sum()) for k in range(len(self.tiers)))

    def count_tier_hits(self, block_ids) -> None:
        """Count a fetch that was made (after ``scatter_read`` succeeded)."""
        ids = np.asarray(block_ids, np.intp)
        n_fast = int((ids < self.offset).sum())
        self.tier_stats.fast_hit_blocks += n_fast
        self.tier_stats.spill_hit_blocks += len(ids) - n_fast

    def stats_dict(self) -> dict:
        d = self.tier_stats.as_dict()
        rest_blocks = sum(t.n_blocks for t in self.tiers[1:])
        rest_used = sum(t.n_blocks - t.free_blocks() for t in self.tiers[1:])
        d["fast_blocks"] = self.tiers[0].n_blocks
        d["spill_blocks"] = rest_blocks
        d["fast_occupancy"] = self.fast_occupancy()
        d["spill_occupancy"] = rest_used / rest_blocks if rest_blocks else 0.0
        d["ghost_entries"] = self.policy.ghost_len()
        d["tier_blocks"] = [t.n_blocks for t in self.tiers]
        d["tier_occupancy"] = [self.tier_occupancy(k) for k in range(len(self.tiers))]
        d["tier_media"] = list(self.tier_media)
        d["tier_writes"] = list(self.tier_writes)
        return d


def _rows(mask: np.ndarray, device) -> torch.Tensor:
    """The positions a numpy mask selects, as an index tensor on ``device``."""
    return torch.as_tensor(np.flatnonzero(mask), dtype=torch.long, device=device)
