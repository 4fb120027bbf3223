"""Prefix index: token-block hash chain -> pool block (paper §6).

Twin of ``repro.core.index`` for the serving path. Keys are byte-identical
to the reference's: block key = blake2b(parent_key | int64 token bytes,
16-byte digest), chained from ``b"ROOT"``. The answers follow the same
rules:

  * ``match_prefix`` walks the chain until the first absent key, checks the
    present entries' (block_id, epoch) against the pool, returns the valid
    prefix, refreshes it to most recently used, and drops the first stale
    entry it met;
  * ``match_prefix_keys`` does the same over a chain hashed once by the
    caller (``keys_for``, which remembers the last requests' chains);
  * ``filter_unpublished`` gives the positions of a chain with no valid
    entry: the blocks a writeback still has to write;
  * ``publish_many`` keeps the last occurrence of a key repeated in one
    batch; fresh keys join the most-recently-used end in batch order, a
    re-published key keeps its place;
  * ``evict_lru`` frees, least recently used first, only blocks the index
    still owns (refcount 1, committed, epoch current) and drops stale
    entries without releasing their blocks a second time;
  * ``evict_blocks`` frees the entries owning given blocks by the same
    victim rule (the tiered pool's migrator makes room at the bottom of its
    chain with it); both fire ``on_evict`` with the destroyed keys, in
    the order they were destroyed, and never for a stale entry;
  * ``owners_of`` and ``remap_many`` are the migrator's snapshot and
    re-point of (key -> block, epoch) entries: a remap succeeds only where
    the entry still holds the old block at the old epoch, and leaves the
    LRU order as it was;
  * ``stats`` counts a hit per matched block and a miss per key of the
    chain past the match, as the reference's ``GlobalIndex.stats``.

  * ``publish`` (one key) moves a re-published key to the most recently
    used end, as the reference's; ``restore_entries`` publishes one by one
    so, and ``snapshot_entries`` pages the entries least recently used
    first: the surface the wire serves (``core/wire.py``), with
    ``lookup_many``, ``n_entries``, ``keys_of_blocks`` and ``seed_stats``.

The reference's flat arrays and array-linked LRU with timestamps are its
answer to lock contention across threads; the port's index is owned by one
thread (the engine's, or a ring server's), so one ``OrderedDict`` (least
recently used first) holds the entries, and its order is the LRU. A dict
from block id to the key that owns it is the reverse map (the reference's
``_block2row``). ``ChainHasher`` is the chain hashing with its memo, which
a remote index client runs on its own side (only keys cross a ring).

The sharded plane (``ShardedPrefixIndex`` and the functions before it) is
the reference's ``ShardedIndex``: keys route by digest
(``shard_of_key``), chain ops fan out by position and merge back, cutting a
match at the first hole; ``evict_lru`` drains the fullest shards first
(``evict_lru_pressure``), which ``core/wire.ShardedRemoteIndex`` shares so
that the in-process and ring planes free the same blocks.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from itertools import islice
from typing import TYPE_CHECKING, Callable

import numpy as np

from repro_torch.core.shm import live_entries

if TYPE_CHECKING:  # a shard service imports this module without torch
    from repro_torch.core.pool import KVBlockPool

ROOT = b"ROOT"
_REQUEST_MEMO_MAX = 256  # chains remembered by keys_for, as the reference's


def _hash_link(parent: bytes, token_bytes: bytes) -> bytes:
    return hashlib.blake2b(parent + b"|" + token_bytes, digest_size=16).digest()


def chain_keys(tokens: list[int], block_tokens: int) -> tuple[bytes, ...]:
    """Keys of the prompt's full blocks, each chained to its parent's."""
    n = len(tokens) // block_tokens
    arr = np.asarray(tokens[: n * block_tokens], np.int64).reshape(n, block_tokens)
    keys: list[bytes] = []
    parent = ROOT
    for i in range(n):
        parent = _hash_link(parent, arr[i].tobytes())
        keys.append(parent)
    return tuple(keys)


@dataclass(slots=True)
class PrefixEntry:
    block_id: int
    epoch: int
    n_tokens: int


class ChainHasher:
    """``chain_keys`` with a memo of the last requests' chains: a request
    seen again (the cluster hashes a prompt at admission and at every
    routing probe) is hashed once."""

    def __init__(self, block_tokens: int):
        self.block_tokens = block_tokens
        self._memo: OrderedDict[tuple[int, ...], tuple[bytes, ...]] = OrderedDict()

    def keys_for(self, tokens: list[int]) -> tuple[bytes, ...]:
        sig = tuple(tokens)
        keys = self._memo.get(sig)
        if keys is None:
            keys = chain_keys(tokens, self.block_tokens)
            self._memo[sig] = keys
            if len(self._memo) > _REQUEST_MEMO_MAX:
                self._memo.popitem(last=False)
        return keys


class PrefixIndex:
    def __init__(self, pool: KVBlockPool, hasher: ChainHasher | None = None):
        self.pool = pool
        self.block_tokens = pool.layout.block_tokens
        self._entries: OrderedDict[bytes, PrefixEntry] = OrderedDict()
        self.hasher = hasher if hasher is not None else ChainHasher(self.block_tokens)
        # block id -> the key whose entry owns it
        self._owner: dict[int, bytes] = {}
        # fired with the keys of entries destroyed by eviction (the tiered
        # pool's ghost list subscribes); None costs nothing
        self.on_evict: Callable[[list[bytes]], None] | None = None
        self.hits = 0
        self.misses = 0

    def keys_for(self, tokens: list[int]) -> tuple[bytes, ...]:
        return self.hasher.keys_for(tokens)

    # ------------------------------------------------------------------
    def match_prefix(self, tokens: list[int]) -> list[tuple[bytes, int, int]]:
        """Longest cached prefix: [(key, block_id, epoch)] with valid epochs."""
        return self.match_prefix_keys(self.keys_for(tokens))

    def match_prefix_keys(self, keys) -> list[tuple[bytes, int, int]]:
        """``match_prefix`` over a chain the caller has already hashed."""
        present: list[PrefixEntry] = []
        for k in keys:
            e = self._entries.get(k)
            if e is None:
                break
            present.append(e)
        out: list[tuple[bytes, int, int]] = []
        if present:
            ok = self.pool.validate_epochs(
                [e.block_id for e in present], [e.epoch for e in present]
            )
            n_ok = len(present) if ok.all() else int(np.argmin(ok))
            for k, e in zip(keys[:n_ok], present[:n_ok]):
                self._entries.move_to_end(k)
                out.append((k, e.block_id, e.epoch))
            if n_ok < len(present):  # stale entry: drop it
                self._drop(keys[n_ok])
        self.hits += len(out)
        self.misses += len(keys) - len(out)
        return out

    def filter_unpublished(self, keys) -> list[int]:
        """Positions in ``keys`` with no valid (committed, current-epoch)
        entry: the blocks a writeback still has to write."""
        ok = np.zeros(len(keys), bool)
        pos, ids, eps = [], [], []
        for i, k in enumerate(keys):
            e = self._entries.get(k)
            if e is not None:
                pos.append(i)
                ids.append(e.block_id)
                eps.append(e.epoch)
        if pos:
            ok[pos] = self.pool.validate_epochs(ids, eps)
        return np.nonzero(~ok)[0].tolist()

    def publish_many(
        self, keys: list[bytes], block_ids: list[int], epochs: list[int], n_tokens: int
    ) -> None:
        """Publish blocks AFTER their payload is in the pool (coherence)."""
        last = {k: i for i, k in enumerate(keys)}
        owner = self._owner
        for k, i in sorted(last.items(), key=lambda kv: kv[1]):
            e = self._entries.get(k)
            if e is None:
                self._entries[k] = PrefixEntry(block_ids[i], epochs[i], n_tokens)
            else:
                if owner.get(e.block_id) == k:  # the entry leaves its old block
                    del owner[e.block_id]
                e.block_id, e.epoch, e.n_tokens = block_ids[i], epochs[i], n_tokens
            owner[block_ids[i]] = k

    def publish(self, key: bytes, block_id: int, epoch: int, n_tokens: int) -> None:
        """Publish one block; a re-published key moves to the most recently
        used end (``publish_many`` keeps its place)."""
        owner = self._owner
        e = self._entries.get(key)
        if e is None:
            self._entries[key] = PrefixEntry(block_id, epoch, n_tokens)
        else:
            if owner.get(e.block_id) == key:
                del owner[e.block_id]
            e.block_id, e.epoch, e.n_tokens = block_id, epoch, n_tokens
            self._entries.move_to_end(key)
        owner[block_id] = key

    def _drop(self, key: bytes) -> None:
        """Forget an entry and, where it still owns its block, the block's
        owner."""
        b = self._entries.pop(key).block_id
        if self._owner.get(b) == key:
            del self._owner[b]

    def entries(self) -> list[PrefixEntry]:
        """Copies of every entry, least recently used first."""
        return [dataclasses.replace(e) for e in self._entries.values()]

    def items(self) -> list[tuple[bytes, PrefixEntry]]:
        """(key, a copy of its entry), least recently used first."""
        return [(k, dataclasses.replace(e)) for k, e in self._entries.items()]

    def lookup(self, key: bytes) -> PrefixEntry | None:
        e = self._entries.get(key)
        return None if e is None else dataclasses.replace(e)

    def lookup_many(self, keys) -> list[PrefixEntry | None]:
        return [self.lookup(k) for k in keys]

    def n_entries(self) -> int:
        """Occupancy: the sharded plane's eviction-pressure signal."""
        return len(self._entries)

    def keys_of_blocks(self, block_ids) -> list[bytes | None]:
        """The key owning each block, None for an unindexed one."""
        return [self._owner.get(int(b)) for b in block_ids]

    def snapshot_entries(self, start: int, max_items: int
                         ) -> tuple[int, list[bytes], list[int], list[int], list[int]]:
        """One page, least recently used first: (total, keys, block ids,
        epochs, n_tokens) of at most ``max_items`` entries from ``start``."""
        page = list(islice(self._entries.items(), start, start + max_items))
        return (len(self._entries), [k for k, _ in page], [e.block_id for _, e in page],
                [e.epoch for _, e in page], [e.n_tokens for _, e in page])

    def restore_entries(self, keys, block_ids, epochs, n_tokens) -> int:
        """Publish entries one by one, in order (a rebuilt shard's refill)."""
        for k, b, e, t in zip(keys, block_ids, epochs, n_tokens):
            self.publish(k, int(b), int(e), int(t))
        return len(keys)

    def rebuild_from_journal(self, records) -> int:
        """Replay journal records (``live_entries``' fold) into this fresh
        index, one publish a surviving entry in journal order, without
        checking epochs against the pool: an entry stale before the crash
        comes back stale, as the reference's does. Returns the entries."""
        live = live_entries(records)
        for k, (bid, epoch, ntk) in live.items():
            self.publish(k, bid, epoch, max(0, ntk))
        return len(live)

    def seed_stats(self, hits: int, misses: int) -> None:
        """Set the hit / miss counters (a restarted shard's, from before)."""
        self.hits, self.misses = int(hits), int(misses)

    def evict_lru(self, n: int) -> list[int]:
        """Evict up to n unreferenced blocks; returns the freed block ids."""
        refcounts, epochs, committed = (
            self.pool.refcounts, self.pool.epochs, self.pool.committed,
        )
        freed: list[int] = []
        dropped: list[bytes] = []
        stale: list[bytes] = []
        for k, e in self._entries.items():
            if len(freed) >= n:
                break
            b = e.block_id
            if refcounts[b] == 1 and committed[b] and epochs[b] == e.epoch:
                freed.append(b)
                dropped.append(k)
            elif refcounts[b] <= 0 or epochs[b] != e.epoch:
                stale.append(k)  # dead entry: forget it, do not release again
        for k in dropped + stale:
            self._drop(k)
        if freed:
            self.pool.release(freed)
        if dropped and self.on_evict is not None:
            self.on_evict(dropped)
        return freed

    def evict_blocks(self, block_ids) -> list[int]:
        """Evict the entries owning the given blocks (the first occurrence
        of a repeated id counts), by ``evict_lru``'s victim rule: a block
        with an in-flight reference stays; a stale entry is dropped without
        a second release. Returns the freed ids."""
        owner = self._owner
        cand: list[tuple[int, bytes]] = []
        for b in dict.fromkeys(int(b) for b in block_ids):
            k = owner.get(b)
            if k is not None:
                cand.append((b, k))
        if not cand:
            return []
        ids = [b for b, _ in cand]
        current = self.pool.validate_epochs(ids, [self._entries[k].epoch for _, k in cand])
        refs = self.pool.refcounts[np.asarray(ids, np.intp)]
        freed: list[int] = []
        dropped: list[bytes] = []
        for (b, k), cur, rc in zip(cand, current.tolist(), refs.tolist()):
            if cur and rc == 1:
                freed.append(b)
                dropped.append(k)
                self._drop(k)
            elif not cur and rc <= 1:
                self._drop(k)
        if freed:
            self.pool.release(freed)
        if dropped and self.on_evict is not None:
            self.on_evict(dropped)
        return freed

    def owners_of(self, block_ids) -> tuple[list[bytes], list[int], list[int]]:
        """(keys, block ids, epochs) of the indexed blocks among
        ``block_ids``, in their order: the migrator's snapshot before it
        copies."""
        keys, ids, eps = [], [], []
        for b in block_ids:
            k = self._owner.get(int(b))
            if k is not None:
                keys.append(k)
                ids.append(int(b))
                eps.append(self._entries[k].epoch)
        return keys, ids, eps

    def remap_many(self, keys, old_ids, old_epochs, new_ids, new_epochs) -> list[bool]:
        """Re-point entries after a tier migration. Each succeeds only if
        its entry still holds (old id, old epoch); a lost one is the
        caller's to roll back. The LRU order does not move."""
        ents = [self._entries.get(k) for k in keys]
        ok = [e is not None and e.block_id == o and e.epoch == oe
              for e, o, oe in zip(ents, old_ids, old_epochs)]
        owner = self._owner
        for k, o, good in zip(keys, old_ids, ok):
            if good and owner.get(o) == k:
                del owner[o]
        for k, e, n, ne, good in zip(keys, ents, new_ids, new_epochs, ok):
            if good:
                e.block_id, e.epoch = int(n), int(ne)
                owner[int(n)] = k
        return ok

    def stats(self) -> dict:
        return {
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / max(1, self.hits + self.misses),
        }


# ---------------------------------------------------------------------------
# the sharded metadata plane (paper §6: the service scales out, one shard
# behind each ring)
# ---------------------------------------------------------------------------
def shard_of_key(key: bytes, n_shards: int) -> int:
    """A key's shard: its first 4 bytes, little-endian, mod S (keys are
    uniform digests)."""
    return int.from_bytes(key[:4], "little") % n_shards


def partition_keys(keys, n_shards: int) -> tuple[list[list[bytes]], list[list[int]]]:
    """Per-shard key lists in chain order, and each key's position. A
    shard's own first miss lies at or after the global one, so merging the
    shards' hits by position and cutting at the first hole gives the
    global all-hit prefix."""
    key_lists: list[list[bytes]] = [[] for _ in range(n_shards)]
    pos_lists: list[list[int]] = [[] for _ in range(n_shards)]
    for i, k in enumerate(keys):
        s = shard_of_key(k, n_shards)
        key_lists[s].append(k)
        pos_lists[s].append(i)
    return key_lists, pos_lists


def evict_blocks_sharded(shards, block_ids) -> list[int]:
    """``evict_blocks`` over the shards in turn; a block one shard freed is
    offered to no later shard (a stale alias must not free it again)."""
    remaining = list(block_ids)
    freed: list[int] = []
    for sh in shards:
        if not remaining:
            break
        got = sh.evict_blocks(remaining)
        if got:
            freed.extend(got)
            gs = set(got)
            remaining = [b for b in remaining if b not in gs]
    return freed


def evict_lru_pressure(shards, n: int) -> list[int]:
    """Evict ``n`` blocks over per-shard LRU lists, draining the fullest
    shards toward a common level (a waterfill on ``n_entries``, ties to the
    lower shard): the reference's policy, shared by the in-process and the
    ring planes. A shard that frees fewer than asked is out of victims and
    drops out; each round frees a block or drops a shard."""
    freed: list[int] = []
    alive = list(range(len(shards)))
    while len(freed) < n and alive:
        occ = {s: shards[s].n_entries() for s in alive}
        alive = [s for s in alive if occ[s] > 0]
        if not alive:
            break
        need = min(n - len(freed), sum(occ[s] for s in alive))
        lo, hi = 0, max(occ[s] for s in alive)
        while lo < hi:
            mid = (lo + hi) // 2
            if sum(occ[s] - mid for s in alive if occ[s] > mid) <= need:
                hi = mid
            else:
                lo = mid + 1
        level = lo
        quota = {s: max(0, occ[s] - level) for s in alive}
        left = need - sum(quota.values())
        for s in alive:
            if left <= 0:
                break
            if occ[s] >= level > 0:
                quota[s] += 1
                left -= 1
        survivors = []
        for s in alive:
            k = quota[s]
            if k <= 0:
                survivors.append(s)  # under the level: spared
                continue
            got = shards[s].evict_lru(k)
            freed.extend(got)
            if len(got) >= k:
                survivors.append(s)
        alive = survivors
    return freed


def merge_owners(block_ids, answers) -> tuple[list[bytes], list[int], list[int]]:
    """``owners_of`` over shards: each shard's (keys, ids, epochs) merged
    back into ``block_ids``' order."""
    owner: dict[int, tuple[bytes, int]] = {}
    for keys, ids, eps in answers:
        for k, b, e in zip(keys, ids, eps):
            owner[b] = (k, e)
    keys_o: list[bytes] = []
    ids_o: list[int] = []
    eps_o: list[int] = []
    for b in block_ids:
        f = owner.get(int(b))
        if f is not None:
            keys_o.append(f[0])
            ids_o.append(int(b))
            eps_o.append(f[1])
    return keys_o, ids_o, eps_o


def merge_stats(per: list[dict]) -> dict:
    """The sharded plane's ``stats``: sums, and each shard's entries."""
    hits = sum(p["hits"] for p in per)
    misses = sum(p["misses"] for p in per)
    return {
        "entries": sum(p["entries"] for p in per),
        "hits": hits,
        "misses": misses,
        "hit_rate": hits / max(1, hits + misses),
        "shards": [p["entries"] for p in per],
    }


class ShardedPrefixIndex:
    """S ``PrefixIndex`` shards behind one front, keys routed by
    ``shard_of_key``; a block belongs to the shard of the key that
    published it. S=1 hands every op to the one shard unchanged. For S>1 a
    shard refreshes (and drops stale entries among) its hits past the
    global cut, and the counters count them, as the reference's do."""

    def __init__(self, pool: KVBlockPool, n_shards: int):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.pool = pool
        self.n_shards = n_shards
        self.block_tokens = pool.layout.block_tokens
        self.hasher = ChainHasher(self.block_tokens)
        self.shards = [PrefixIndex(pool, self.hasher) for _ in range(n_shards)]

    @property
    def on_evict(self):
        return self.shards[0].on_evict

    @on_evict.setter
    def on_evict(self, fn) -> None:
        for sh in self.shards:  # ring-served evictions run on the shards
            sh.on_evict = fn

    def keys_for(self, tokens: list[int]) -> tuple[bytes, ...]:
        return self.hasher.keys_for(tokens)

    def match_prefix(self, tokens: list[int]) -> list[tuple[bytes, int, int]]:
        return self.match_prefix_keys(self.keys_for(tokens))

    def _split(self, keys):
        key_lists, pos_lists = partition_keys(keys, self.n_shards)
        return [(sh, kl, pl) for sh, kl, pl in zip(self.shards, key_lists, pos_lists) if kl]

    def match_prefix_keys(self, keys) -> list[tuple[bytes, int, int]]:
        if self.n_shards == 1:
            return self.shards[0].match_prefix_keys(keys)
        found: list[tuple[int, int] | None] = [None] * len(keys)
        for sh, kl, pl in self._split(keys):
            for (_, b, e), i in zip(sh.match_prefix_keys(kl), pl):
                found[i] = (b, e)
        out: list[tuple[bytes, int, int]] = []
        for k, f in zip(keys, found):
            if f is None:
                break  # the first hole ends the global prefix
            out.append((k, f[0], f[1]))
        return out

    def publish(self, key: bytes, block_id: int, epoch: int, n_tokens: int) -> None:
        self.shards[shard_of_key(key, self.n_shards)].publish(key, block_id, epoch, n_tokens)

    def publish_many(self, keys, block_ids, epochs, n_tokens: int) -> None:
        if self.n_shards == 1:
            return self.shards[0].publish_many(keys, block_ids, epochs, n_tokens)
        for sh, kl, pl in self._split(keys):
            sh.publish_many(kl, [block_ids[i] for i in pl], [epochs[i] for i in pl], n_tokens)

    def lookup(self, key: bytes) -> PrefixEntry | None:
        return self.shards[shard_of_key(key, self.n_shards)].lookup(key)

    def lookup_many(self, keys) -> list[PrefixEntry | None]:
        out: list[PrefixEntry | None] = [None] * len(keys)
        for sh, kl, pl in self._split(keys):
            for e, i in zip(sh.lookup_many(kl), pl):
                out[i] = e
        return out

    def filter_unpublished(self, keys) -> list[int]:
        if self.n_shards == 1:
            return self.shards[0].filter_unpublished(keys)
        out: list[int] = []
        for sh, kl, pl in self._split(keys):
            out.extend(pl[p] for p in sh.filter_unpublished(kl))
        return sorted(out)

    def evict_lru(self, n: int) -> list[int]:
        if self.n_shards == 1:
            return self.shards[0].evict_lru(n)
        return evict_lru_pressure(self.shards, n)

    def evict_blocks(self, block_ids) -> list[int]:
        if self.n_shards == 1:
            return self.shards[0].evict_blocks(block_ids)
        return evict_blocks_sharded(self.shards, block_ids)

    def keys_of_blocks(self, block_ids) -> list[bytes | None]:
        out: list[bytes | None] = [None] * len(block_ids)
        for sh in self.shards:
            for i, k in enumerate(sh.keys_of_blocks(block_ids)):
                if k is not None:
                    out[i] = k
        return out

    def owners_of(self, block_ids) -> tuple[list[bytes], list[int], list[int]]:
        if self.n_shards == 1:
            return self.shards[0].owners_of(block_ids)
        return merge_owners(block_ids, [sh.owners_of(block_ids) for sh in self.shards])

    def remap_many(self, keys, old_ids, old_epochs, new_ids, new_epochs) -> list[bool]:
        if self.n_shards == 1:
            return self.shards[0].remap_many(keys, old_ids, old_epochs, new_ids, new_epochs)
        ok = [False] * len(keys)
        for sh, kl, pl in self._split(keys):
            sub = sh.remap_many(kl, [old_ids[i] for i in pl], [old_epochs[i] for i in pl],
                                [new_ids[i] for i in pl], [new_epochs[i] for i in pl])
            for o, i in zip(sub, pl):
                ok[i] = o
        return ok

    def n_entries(self) -> int:
        return sum(sh.n_entries() for sh in self.shards)

    def entries(self) -> list[PrefixEntry]:
        """Every shard's entries, shard by shard."""
        return [e for sh in self.shards for e in sh.entries()]

    def stats(self) -> dict:
        if self.n_shards == 1:
            return self.shards[0].stats()
        return merge_stats([sh.stats() for sh in self.shards])
