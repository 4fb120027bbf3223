"""Prefix index: token-block hash chain -> pool block (paper §6).

Twin of ``repro.core.index`` for the serving path. Keys are byte-identical
to the reference's: block key = blake2b(parent_key | int64 token bytes,
16-byte digest), chained from ``b"ROOT"``. The answers follow the same
rules:

  * ``match_prefix`` walks the chain until the first absent key, checks the
    present entries' (block_id, epoch) against the pool, returns the valid
    prefix, refreshes it to most recently used, and drops the first stale
    entry it met;
  * ``publish_many`` keeps the last occurrence of a key repeated in one
    batch; fresh keys join the most-recently-used end in batch order, a
    re-published key keeps its place;
  * ``evict_lru`` frees, least recently used first, only blocks the index
    still owns (refcount 1, committed, epoch current) and drops stale
    entries without releasing their blocks a second time.

The reference's flat arrays and array-linked LRU with timestamps are its
answer to lock contention across threads; the port's engine is
single-threaded, so one ``OrderedDict`` (least recently used first) holds
the entries, and its order is the LRU.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from repro_torch.core.pool import KVBlockPool

ROOT = b"ROOT"


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
        self.hits = 0
        self.misses = 0

    def keys_for(self, tokens: list[int]) -> tuple[bytes, ...]:
        return chain_keys(tokens, self.block_tokens)

    # ------------------------------------------------------------------
    def match_prefix(self, tokens: list[int]) -> list[tuple[bytes, int, int]]:
        """Longest cached prefix: [(key, block_id, epoch)] with valid epochs."""
        keys = self.keys_for(tokens)
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
                del self._entries[keys[n_ok]]
        self.hits += len(out)
        self.misses += len(keys) - len(out)
        return out

    def publish_many(
        self, keys: list[bytes], block_ids: list[int], epochs: list[int], n_tokens: int
    ) -> None:
        """Publish blocks AFTER their payload is in the pool (coherence)."""
        last = {k: i for i, k in enumerate(keys)}
        for k, i in sorted(last.items(), key=lambda kv: kv[1]):
            e = self._entries.get(k)
            if e is None:
                self._entries[k] = PrefixEntry(block_ids[i], epochs[i], n_tokens)
            else:
                e.block_id, e.epoch, e.n_tokens = block_ids[i], epochs[i], n_tokens

    def lookup(self, key: bytes) -> PrefixEntry | None:
        e = self._entries.get(key)
        return None if e is None else dataclasses.replace(e)

    def evict_lru(self, n: int) -> list[int]:
        """Evict up to n unreferenced blocks; returns the freed block ids."""
        refcounts, epochs, committed = (
            self.pool.refcounts, self.pool.epochs, self.pool.committed,
        )
        freed: list[int] = []
        drop: list[bytes] = []
        for k, e in self._entries.items():
            if len(freed) >= n:
                break
            b = e.block_id
            if refcounts[b] == 1 and committed[b] and epochs[b] == e.epoch:
                freed.append(b)
                drop.append(k)
            elif refcounts[b] <= 0 or epochs[b] != e.epoch:
                drop.append(k)  # dead entry: forget it, do not release again
        for k in drop:
            del self._entries[k]
        if freed:
            self.pool.release(freed)
        return freed

    def stats(self) -> dict:
        return {
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / max(1, self.hits + self.misses),
        }
