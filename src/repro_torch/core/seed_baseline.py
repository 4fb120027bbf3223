"""The frozen seed control plane: the yardstick the pool is held to.

Twin of ``repro/core/seed_baseline.py``. These are the first, slow
versions of three hot paths, kept exactly as they were so that
``experiments/exp12_control_plane.py`` can time the port against them and
the tests can hold ``KVBlockPool`` to their observable behaviour on
recorded traces:

* ``SeedAllocator``: one flat free list. ``allocate`` rebuilds a by-shard
  dict of the whole free list on every call, walks it round-robin from the
  fullest shard and falls back once past ``4 * n_shards + 2n`` iterations;
  ``shard_occupancy`` scans all ``n_blocks``; each block's metadata is a
  Python object (``SeedBlockRecord``); ``write_block`` / ``read_block`` /
  ``validate_epoch`` take one block at a time. The payload is a
  ``(n_blocks, block_bytes)`` uint8 tensor on ``device="cpu"`` and absent on
  ``"meta"`` (the reference's ``backing="numpy"`` / ``"meta"``).
* ``seed_block_key`` / ``seed_keys_for``: blake2b chain hashing over the
  per-int ``str()`` encoding, the reference's bytes.
* ``seed_scatter_read``: a read, a copy and a view per block. A moved epoch
  raises ``StaleBlockError`` (the reference raises its coherence error).

Nothing here is vectorised, on purpose, and nothing on a serving path uses
it. The allocator has one owner and takes no lock (the reference's takes
one, which the port's lint bars).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import torch

from repro_torch.core.pool import PAYLOAD_DTYPES, KVBlockLayout, PoolExhausted
from repro_torch.core.transfer import StaleBlockError


@dataclass
class SeedBlockRecord:
    epoch: int = 0
    refcount: int = 0
    committed: bool = False


class SeedAllocator:
    """Seed allocator: one flat free list, per-call by-shard rebuild."""

    def __init__(
        self,
        layout: KVBlockLayout,
        n_blocks: int,
        n_shards: int = 32,
        device: str = "meta",
        interleave: bool = True,
    ):
        if n_blocks % n_shards:
            raise ValueError(f"n_blocks={n_blocks} is not a multiple of {n_shards} shards")
        if device not in ("meta", "cpu"):
            raise ValueError(f"device must be 'meta' or 'cpu', got {device!r}")
        self.layout = layout
        self.n_blocks = n_blocks
        self.n_shards = n_shards
        self.interleave = interleave
        self._free: list[int] = list(range(n_blocks))
        self.meta: list[SeedBlockRecord] = [SeedBlockRecord() for _ in range(n_blocks)]
        self.alloc_count = 0
        self.data = (torch.zeros((n_blocks, layout.block_bytes), dtype=torch.uint8)
                     if device == "cpu" else None)

    def shard_of(self, block_id: int) -> int:
        if self.interleave:
            return block_id % self.n_shards
        return block_id // (self.n_blocks // self.n_shards)

    def free_blocks(self) -> int:
        return len(self._free)

    def shard_occupancy(self) -> list[int]:
        occ = [0] * self.n_shards
        free = set(self._free)
        for b in range(self.n_blocks):
            if b not in free:
                occ[self.shard_of(b)] += 1
        return occ

    def allocate(self, n: int) -> list[int]:
        if len(self._free) < n:
            raise PoolExhausted(f"need {n}, have {len(self._free)}")
        if self.interleave:
            by_shard: dict[int, list[int]] = {}
            for b in self._free:
                by_shard.setdefault(b % self.n_shards, []).append(b)
            out: list[int] = []
            shard_ids = sorted(by_shard, key=lambda s: -len(by_shard[s]))
            i = 0
            while len(out) < n:
                s = shard_ids[i % len(shard_ids)]
                if by_shard[s]:
                    out.append(by_shard[s].pop())
                i += 1
                if i > 4 * self.n_shards + n * 2:
                    remaining = [b for lst in by_shard.values() for b in lst]
                    out.extend(remaining[: n - len(out)])
                    break
        else:
            out = [self._free[i] for i in range(n)]
        taken = set(out)
        self._free = [b for b in self._free if b not in taken]
        for b in out:
            m = self.meta[b]
            m.refcount = 1
            m.committed = False
        self.alloc_count += n
        return out

    def retain(self, block_ids: list[int]) -> None:
        for b in block_ids:
            if self.meta[b].refcount <= 0:
                raise ValueError(f"retain of free block {b}")
            self.meta[b].refcount += 1

    def release(self, block_ids: list[int]) -> None:
        for b in block_ids:
            m = self.meta[b]
            m.refcount -= 1
            if m.refcount < 0:
                raise ValueError(f"double free of block {b}")
            if m.refcount == 0:
                m.committed = False
                m.epoch += 1
                self._free.append(b)

    def write_block(self, block_id: int, payload: torch.Tensor | None) -> int:
        if self.data is not None and payload is not None:
            raw = payload.reshape(-1).view(torch.uint8)
            if raw.numel() != self.layout.block_bytes:
                raise ValueError(f"payload of {raw.numel()} bytes, a block has "
                                 f"{self.layout.block_bytes}")
            self.data[block_id] = raw
        m = self.meta[block_id]
        m.epoch += 1
        m.committed = True
        return m.epoch

    def read_block(self, block_id: int) -> tuple[torch.Tensor, int]:
        e = self.meta[block_id].epoch
        if self.data is None:
            return torch.zeros(self.layout.block_bytes, dtype=torch.uint8), e
        return self.data[block_id].clone(), e

    def validate_epoch(self, block_id: int, epoch: int) -> bool:
        m = self.meta[block_id]
        return m.committed and m.epoch == epoch


# ---------------------------------------------------------------------------
# seed chain hashing: per-int str() encoding, no memoization
# ---------------------------------------------------------------------------

SEED_ROOT = b"ROOT"


def seed_block_key(parent: bytes, tokens: tuple[int, ...]) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(parent)
    h.update(b"|")
    h.update(b",".join(str(t).encode() for t in tokens))
    return h.digest()


def seed_keys_for(tokens: list[int], block_tokens: int) -> list[bytes]:
    bt = block_tokens
    keys, parent = [], SEED_ROOT
    for i in range(0, len(tokens) - len(tokens) % bt, bt):
        k = seed_block_key(parent, tuple(tokens[i : i + bt]))
        keys.append(k)
        parent = k
    return keys


# ---------------------------------------------------------------------------
# seed scatter read: per-block read_block + copy + view/reshape loop
# ---------------------------------------------------------------------------


def seed_scatter_read(pool: SeedAllocator, block_ids: list[int],
                      epochs: list[int] | None = None) -> torch.Tensor:
    """The seed transfer's data loop (latency modelling stripped): (n,
    *block_shape) in the payload dtype (bfloat16 for 2-byte elements)."""
    lay = pool.layout
    dtype = PAYLOAD_DTYPES[lay.dtype_bytes]
    out = torch.empty((len(block_ids), *lay.block_shape), dtype=dtype)
    for i, bid in enumerate(block_ids):
        payload, epoch = pool.read_block(bid)
        if epochs is not None and epoch != epochs[i]:
            raise StaleBlockError(f"block {bid} epoch changed during read")
        out[i] = payload.view(dtype).reshape(lay.block_shape)
    return out
