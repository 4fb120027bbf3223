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

The reference's flat arrays and array-linked LRU with timestamps are its
answer to lock contention across threads; the port's engine is
single-threaded, so one ``OrderedDict`` (least recently used first) holds
the entries, and its order is the LRU. A dict from block id to the key
that owns it is the reverse map (the reference's ``_block2row``).
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable

import numpy as np

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


class PrefixIndex:
    def __init__(self, pool: KVBlockPool):
        self.pool = pool
        self.block_tokens = pool.layout.block_tokens
        self._entries: OrderedDict[bytes, PrefixEntry] = OrderedDict()
        # token tuple -> chain: a request seen again (the cluster hashes a
        # prompt at admission and at every routing probe) is hashed once
        self._memo: OrderedDict[tuple[int, ...], tuple[bytes, ...]] = OrderedDict()
        # block id -> the key whose entry owns it
        self._owner: dict[int, bytes] = {}
        # fired with the keys of entries destroyed by eviction (the tiered
        # pool's ghost list subscribes); None costs nothing
        self.on_evict: Callable[[list[bytes]], None] | None = None
        self.hits = 0
        self.misses = 0

    def keys_for(self, tokens: list[int]) -> tuple[bytes, ...]:
        sig = tuple(tokens)
        keys = self._memo.get(sig)
        if keys is None:
            keys = chain_keys(tokens, self.block_tokens)
            self._memo[sig] = keys
            if len(self._memo) > _REQUEST_MEMO_MAX:
                self._memo.popitem(last=False)
        return keys

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
