"""Device-tier paged KV cache: block allocator + per-sequence block tables.

Twin of ``repro/kvcache/hbm_cache.py``: vLLM-style PagedAttention
bookkeeping for ONE engine instance:
  * a fixed pool of HBM slots (16-token blocks by default);
  * per-sequence block tables (slot lists);
  * refcounted prefix sharing inside the instance, by block key;
  * free slots reused last freed, first taken, in the reference's order.

The KV payloads live in per-layer device tensors owned by the model runner;
this class owns the slot arithmetic only. Refcounts live in a flat numpy
array, so a finished sequence releases its whole table in one batch.
"""

from __future__ import annotations

import numpy as np


class OutOfHbmBlocks(RuntimeError):
    pass


class HbmPagedCache:
    def __init__(self, n_slots: int, block_tokens: int = 16):
        self.n_slots = n_slots
        self.block_tokens = block_tokens
        self.refcounts = np.zeros(n_slots, np.int32)
        self._slot_key: list[bytes | None] = [None] * n_slots
        self._free: list[int] = list(range(n_slots))
        self._by_key: dict[bytes, int] = {}
        self.seq_tables: dict[str, list[int]] = {}

    # ------------------------------------------------------------------
    def free_slots(self) -> int:
        return len(self._free)

    def has_key(self, key: bytes) -> bool:
        """Whether a slot holds this prefix block (no refcount change: the
        cache-aware scheduler's locality probe)."""
        return key in self._by_key

    def lookup_shared(self, key: bytes) -> int | None:
        """Reuse of a prefix block inside the instance (no transfer)."""
        slot = self._by_key.get(key)
        if slot is not None:
            self.refcounts[slot] += 1
        return slot

    def allocate(self, n: int, keys: list[bytes] | None = None) -> list[int]:
        free = self._free
        if len(free) < n:
            raise OutOfHbmBlocks(f"need {n} slots, have {len(free)}")
        out = free[len(free) - n:]
        out.reverse()  # the order of n pops
        del free[len(free) - n:]
        self.refcounts[out] = 1
        if keys:
            slot_key = self._slot_key
            by_key = self._by_key
            for slot, key in zip(out, keys):
                slot_key[slot] = key
                if key is not None:
                    by_key[key] = slot
        return out

    def release(self, slots: list[int]) -> None:
        if not len(slots):
            return
        uniq, counts = np.unique(np.asarray(slots, np.intp), return_counts=True)
        self.refcounts[uniq] -= counts.astype(np.int32)
        left = self.refcounts[uniq]
        if (left < 0).any():
            raise ValueError("double free of HBM slot")
        freed = uniq[left == 0]
        if not len(freed):
            return
        slot_key = self._slot_key
        free_append = self._free.append
        for slot in freed.tolist():
            key = slot_key[slot]
            if key is not None:
                self._by_key.pop(key, None)
                slot_key[slot] = None
            free_append(slot)

    # ------------------------------------------------------------------
    def register_sequence(self, seq_id: str, slots: list[int]) -> None:
        self.seq_tables[seq_id] = list(slots)

    def extend_sequence(self, seq_id: str, n_new_tokens: int, seq_len: int) -> list[int]:
        """Ensure the table covers seq_len + n_new_tokens; allocate as needed."""
        table = self.seq_tables[seq_id]
        need = -(-(seq_len + n_new_tokens) // self.block_tokens)
        new = []
        if need > len(table):
            new = self.allocate(need - len(table))
            table.extend(new)
        return new

    def finish_sequence(self, seq_id: str) -> None:
        table = self.seq_tables.pop(seq_id, [])
        self.release(table)

    def table(self, seq_id: str) -> list[int]:
        return self.seq_tables[seq_id]
