"""The attach side of a pool's shared payload: what an engine worker process
maps to move KV blocks by plain loads and stores (the paper's §5.1 data
plane, across real process boundaries).

Twin of ``repro/core/shmpool.py``. ``KVBlockPool.share_data`` (and
``TieredPool.share_data``) move a pool's payload into one named segment of
``(n_blocks, block_bytes)`` rows and imply ``share_meta``; this module is
what another process makes of the attach spec:

  * ``SharedPoolSegment`` (the reference's ``SharedPoolData``) maps both
    segments: the payload as a tensor of the pool's block shape, the
    epochs, refcounts and committed flags as numpy arrays, with the pool's
    batched payload calls over them. It never unlinks: the creator does.
  * ``WorkerPool`` (``WorkerPoolView``) joins it to a ``core/wire.RemotePool``
    into the surface ``KVCacheManager`` and ``PoolTransfer`` expect: payloads
    on the segment, the allocator's calls over a ring to the pool-owning
    process. ``TieredWorkerPool`` (``TieredWorkerPoolView``) adds a tier
    chain's control calls: keyed allocation and the demand touch over the
    ring, the hotness clock left to the owner, tier hits counted here.
  * ``LeaseLedger`` (``WorkerLeaseLedger``) is the owner's record of the
    blocks each worker holds, so that a dead worker's refs are released
    exactly once (``reconcile``).

Payload stores need no cross-process lock: a block is written only between
its allocation (one worker owns it) and its publish, after which everyone
reads it until its refcount is back at zero in the owner's pool.

Differences from the reference, by design:

  * The ledger takes no lock. While a worker lives, its leases change only
    in the allocator ring's handler (``core/wire.make_pool_handler``), on
    the thread that alone mutates the pool. ``reconcile`` runs once the
    worker is dead, no other worker holds a command and the dead worker's
    slots on that ring hold no request (the caller sees to all three), so
    the allocator's thread is idle and nothing else touches the ledger;
    it reads the pool's shared metadata and hands the releases to
    ``release``, which in a cluster is a ``RemotePool`` on a slot no
    worker owns: the releases too are run by the allocator's thread.
    Another thread polls only ``held``.
  * The payload calls are the port pool's batched ones (``write_blocks``,
    ``read_blocks``, ``validate_epochs``) plus ``read_fragments``; the
    scalar ones are not ported (``tiering/tiers.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.pool import PAYLOAD_DTYPES, KVBlockLayout, gather_rows
from repro_torch.core.shm import attach_segment, close_segment
from repro_torch.tiering.stats import TierStats


class SharedPoolSegment:
    """A pool's shared payload and metadata, attached by ``share_data``'s
    spec (plain data: names and numbers)."""

    payload_free = False
    device = torch.device("cpu")

    def __init__(self, spec: dict):
        self.layout = KVBlockLayout(
            block_tokens=spec["block_tokens"], n_layers_kv=spec["n_layers_kv"],
            n_kv_heads=spec["n_kv_heads"], head_dim=spec["head_dim"],
            dtype_bytes=spec["dtype_bytes"])
        n = self.n_blocks = spec["n_blocks"]
        self._data_segment = attach_segment(spec["data_shm_name"])
        self._meta_segment = attach_segment(spec["meta"]["shm_name"])
        # through numpy: the mapping cannot close under a live view
        raw = torch.from_numpy(np.frombuffer(self._data_segment.buf, np.uint8))
        self.data = raw.view(PAYLOAD_DTYPES[self.layout.dtype_bytes]).view(
            n, *self.layout.block_shape)
        buf = self._meta_segment.buf
        self.epochs = np.frombuffer(buf, np.int64, n, 0)
        self.refcounts = np.frombuffer(buf, np.int32, n, 8 * n)
        self.committed = np.frombuffer(buf, np.bool_, n, 12 * n)

    def _index(self, ids: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(ids, dtype=torch.long)

    def write_blocks(self, block_ids, payloads: torch.Tensor | None = None) -> list[int]:
        """Store ``payloads`` (n, *block_shape) into the blocks' rows when
        given, then publish: one batched epoch bump. The caller owns these
        freshly allocated blocks until this publish."""
        ids = np.asarray(block_ids, np.intp)
        if payloads is not None:
            rows = payloads.to("cpu", self.data.dtype).reshape(len(ids), -1)
            self.data.flatten(1).index_copy_(0, self._index(ids), rows)
        self.epochs[ids] += 1
        self.committed[ids] = True
        return self.epochs[ids].tolist()

    def read_blocks(self, block_ids, out: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, np.ndarray]:
        """(payload rows (n, *block_shape), into ``out`` when given; the
        epochs snapshot before the copy: §5.1's protocol)."""
        ids = np.asarray(block_ids, np.intp)
        eps = self.epochs[ids].copy()
        return gather_rows(self.data, self._index(ids), out), eps

    def read_fragments(self, block_id: int, frag_ids) -> torch.Tensor:
        """Fragments ``frag_ids`` of one block, (k, block_tokens, hkv, hd)."""
        return self.data[block_id][self._index(np.asarray(frag_ids, np.intp))]

    def validate_epochs(self, block_ids, epochs) -> np.ndarray:
        ids = np.asarray(block_ids, np.intp)
        return self.committed[ids] & (self.epochs[ids] == np.asarray(epochs))

    def close(self) -> None:
        """Drop the mappings; never unlinks (the creator does)."""
        if self._data_segment is None:
            return
        self.data = self.epochs = self.refcounts = self.committed = None
        close_segment(self._data_segment, unlink=False)
        close_segment(self._meta_segment, unlink=False)
        self._data_segment = self._meta_segment = None


class WorkerPool:
    """The pool's surface in a worker: payload calls on the shared segment,
    the allocator's over the ring (a ``core/wire.RemotePool``). A manager
    and a transfer cannot tell it from a ``KVBlockPool``."""

    is_tiered = False
    payload_free = False

    def __init__(self, shared: SharedPoolSegment, alloc):
        self._shared = shared
        self._alloc = alloc
        self.layout = shared.layout
        self.n_blocks = shared.n_blocks
        self.device = shared.device

    # -- the allocator, over the ring --------------------------------------
    def allocate(self, n: int) -> list[int]:
        return self._alloc.allocate(n)

    def retain(self, block_ids) -> None:
        self._alloc.retain(block_ids)

    def release(self, block_ids) -> None:
        self._alloc.release(block_ids)

    def free_blocks(self) -> int:
        return self._alloc.free_blocks()

    # -- the payload and its metadata, on the segment ----------------------
    @property
    def data(self) -> torch.Tensor:
        return self._shared.data

    @property
    def epochs(self) -> np.ndarray:
        return self._shared.epochs

    @property
    def refcounts(self) -> np.ndarray:
        return self._shared.refcounts

    @property
    def committed(self) -> np.ndarray:
        return self._shared.committed

    def write_blocks(self, block_ids, payloads=None) -> list[int]:
        return self._shared.write_blocks(block_ids, payloads)

    def read_blocks(self, block_ids, out=None):
        return self._shared.read_blocks(block_ids, out)

    def read_fragments(self, block_id, frag_ids):
        return self._shared.read_fragments(block_id, frag_ids)

    def validate_epochs(self, block_ids, epochs) -> np.ndarray:
        return self._shared.validate_epochs(block_ids, epochs)

    def close(self) -> None:
        self._shared.close()


class TieredWorkerPool(WorkerPool):
    """A worker's surface of a shared ``TieredPool``: the payload plane is a
    flat pool's over the global ids; a keyed allocation and the demand
    touch run where the chain's policy is, in the pool-owning process;
    ``tick`` does nothing (the owner's hotness clock moves with every
    touch); tier hits are counted here, against the chain's tier starts
    (bookkeeping, not policy)."""

    is_tiered = True

    def __init__(self, shared: SharedPoolSegment, alloc, tiering: dict):
        super().__init__(shared, alloc)
        self._starts = np.asarray(tiering["starts"], np.intp)
        self.tier_media = tuple(tiering["media"])
        self.spill_media = self.tier_media[1] if len(self.tier_media) > 1 else self.tier_media[0]
        self.tier_stats = TierStats()

    def allocate(self, n: int, keys=None) -> list[int]:
        return self._alloc.allocate(n, keys=keys)

    def touch_demand(self, block_ids, now: float) -> tuple[int, ...]:
        return self._alloc.touch_demand(block_ids, now)

    def tick(self, now: float) -> None:
        """The owner's clock moves with every touch; a worker's own clock
        would race it."""

    def count_tier_hits(self, block_ids) -> None:
        ids = np.asarray(block_ids, np.intp)
        if not len(ids):
            return
        n_fast = int((ids < self._starts[1]).sum()) if len(self._starts) > 1 else len(ids)
        self.tier_stats.fast_hit_blocks += n_fast
        self.tier_stats.spill_hit_blocks += len(ids) - n_fast


class LeaseLedger:
    """The blocks each worker holds, kept by the pool-owning process.

    The allocator ring's handler mirrors each worker's ALLOC, RETAIN and
    RELEASE here (the posting slot names the worker), and a proxied
    journal publish ends the lease on the published blocks (their
    allocation ref now belongs to the index). When a worker dies,
    ``reconcile`` releases exactly the refs it still held, by the epochs:

      * ``epoch == grant``: untouched since the grant (an allocation never
        written, or a retain of a committed block): release;
      * ``epoch == grant + 1`` and committed: the worker wrote it. If the
        index owns ``(block, grant + 1)`` (``owners_of``), the publish
        landed and its allocation ref survives; otherwise it is a write
        that was never published: release. Without ``owners_of`` nothing
        of this kind is released;
      * anything else: the lease has moved on; keep (a leak, never a free
        under a new owner).
    """

    def __init__(self):
        self._leases: dict[int, dict[int, list[int]]] = {}  # worker -> {block: [refs, grant]}

    # -- the handler's mirror ----------------------------------------------
    def on_alloc(self, worker: int, block_ids, pool) -> None:
        held = self._leases.setdefault(worker, {})
        eps = pool.epochs
        for b in block_ids:
            b = int(b)
            lease = held.get(b)
            if lease is None:
                held[b] = [1, int(eps[b])]
            else:
                lease[0] += 1
                lease[1] = int(eps[b])

    on_retain = on_alloc  # one more ref, at the current epoch

    def on_release(self, worker: int, block_ids) -> None:
        """Ids the worker holds no lease on are passed over: a worker also
        routes the index's eviction releases (``on_freed``) through its
        ring, and those were the index's refs."""
        held = self._leases.get(worker)
        if held is None:
            return
        for b in block_ids:
            lease = held.get(int(b))
            if lease is None:
                continue
            lease[0] -= 1
            if lease[0] <= 0:
                del held[int(b)]

    def on_publish(self, worker: int, block_ids) -> None:
        """The allocation ref moved to the index with the publish."""
        self.on_release(worker, block_ids)

    # -- the supervisor's side ---------------------------------------------
    def leases(self, worker: int) -> dict[int, tuple[int, int]]:
        """The worker's leases; read by the thread that owns the ledger."""
        return {b: (c, e) for b, (c, e) in self._leases.get(worker, {}).items()}

    def held(self, worker: int) -> int:
        """How many blocks the worker holds leases on: two reads that
        iterate nothing, so any thread may poll them while the allocator's
        thread mirrors traffic."""
        return len(self._leases.get(worker, ()))

    def reconcile(self, worker: int, pool, owners_of=None, release=None) -> dict:
        """Release a dead worker's leases once, by the rules above. ``pool``
        is read (epochs, refcounts, committed); ``release`` (default
        ``pool.release``) frees. The worker's entry goes first, so a second
        call finds nothing. Blocks the worker wrote once are probed with
        ``owners_of`` (a round trip to the index), then every lease is
        classified on fresh reads of the pool. Returns the refs released and
        skipped and the blocks of each."""
        held = self._leases.pop(worker, {})
        if not held:
            return {"released": 0, "skipped": 0, "blocks": [], "kept": []}
        eps, committed, refcounts = pool.epochs, pool.committed, pool.refcounts
        probe_ids = [b for b, (_, grant) in held.items()
                     if int(refcounts[b]) > 0 and int(eps[b]) == grant + 1 and bool(committed[b])]
        probe_set = set(probe_ids)
        owned: set | None = None
        if probe_ids and owners_of is not None:
            _, ids, owner_eps = owners_of(probe_ids)
            owned = set(zip(ids, owner_eps))
        eps, committed, refcounts = pool.epochs, pool.committed, pool.refcounts
        to_release: list[int] = []
        kept: list[int] = []
        for b, (count, grant) in held.items():
            rc = int(refcounts[b])
            if rc <= 0:
                kept.append(b)  # already free: nothing to reclaim
                continue
            ec = int(eps[b])
            if ec == grant:
                to_release.extend([b] * min(count, rc))
            elif ec == grant + 1 and bool(committed[b]):
                count = min(count, rc)
                if owned is None or b not in probe_set:
                    kept.append(b)  # not probed: leak rather than guess
                elif (b, grant + 1) in owned:
                    # the publish landed: the index's ref must survive
                    if count > 1:
                        to_release.extend([b] * (count - 1))
                    else:
                        kept.append(b)
                else:
                    to_release.extend([b] * count)
            else:
                kept.append(b)  # the lease moved on
        if to_release:
            (pool.release if release is None else release)(to_release)
        return {"released": len(to_release), "skipped": len(kept),
                "blocks": sorted(set(to_release)), "kept": sorted(set(kept))}
