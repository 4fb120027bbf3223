"""KVBlockPool: the interleaved KV block pool, with its payload on the card.

Twin of ``repro.core.pool.BelugaPool`` for the serving path: the same
allocator (one free stack per shard, allocation round-robin over the
fullest shards first, block ``b`` on shard ``b % n_shards``), the same
per-block epochs, refcounts and committed flags, and the same batched
``write_blocks`` publish. The payload is one device tensor of shape
``(n_blocks, 2L, block_tokens, hkv, hd)``: every layer's K and V fragments
of a block, interleaved ``[k0, v0, k1, v1, ...]`` — the layout that
``kv_gather_write`` packs and ``kv_scatter_read`` unpacks.

The port's engine is single-threaded, so the pool takes no lock.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class KVBlockLayout:
    """Shape of one pool block for a model config."""

    block_tokens: int
    n_layers_kv: int
    n_kv_heads: int
    head_dim: int

    @property
    def block_shape(self) -> tuple[int, int, int, int]:
        """(2L fragments [k0, v0, k1, v1, ...], tokens, kv heads, head_dim)."""
        return (2 * self.n_layers_kv, self.block_tokens, self.n_kv_heads, self.head_dim)

    @classmethod
    def for_model(cls, cfg: ModelConfig, block_tokens: int) -> "KVBlockLayout":
        """For an attention stack: every layer holds KV."""
        return cls(block_tokens, cfg.n_layers, cfg.n_kv_heads, cfg.head_dim)


class PoolExhausted(RuntimeError):
    pass


N_SHARDS = 8  # as the JAX RealEngine's pool


class KVBlockPool:
    """Block allocator + bf16 device payload over interleaved shards."""

    def __init__(self, layout: KVBlockLayout, n_blocks: int, device: torch.device):
        n_shards = N_SHARDS
        if n_blocks % n_shards:
            raise ValueError(f"n_blocks={n_blocks} is not a multiple of {n_shards} shards")
        self.layout = layout
        self.n_blocks = n_blocks
        self.n_shards = n_shards
        self.epochs = np.zeros(n_blocks, np.int64)
        self.refcounts = np.zeros(n_blocks, np.int32)
        self.committed = np.zeros(n_blocks, bool)
        self._free_by_shard: list[list[int]] = [
            list(range(s, n_blocks, n_shards)) for s in range(n_shards)
        ]
        # free-age stamps: ties between equally full shards go to the shard
        # whose oldest free block has been free longest
        self._age = np.arange(n_blocks, dtype=np.int64)
        self._stamp = n_blocks
        self._n_free = n_blocks
        self._occ = [0] * n_shards
        self.data = torch.zeros(
            (n_blocks, *layout.block_shape), dtype=torch.bfloat16, device=device
        )

    # ------------------------------------------------------------------
    def free_blocks(self) -> int:
        return self._n_free

    def shard_occupancy(self) -> list[int]:
        return list(self._occ)

    # ------------------------------------------------------------------
    def allocate(self, n: int) -> list[int]:
        """Allocate n blocks round-robin over the shards, fullest first."""
        if self._n_free < n:
            raise PoolExhausted(f"need {n}, have {self._n_free}")
        stacks, age = self._free_by_shard, self._age
        order = sorted(
            (s for s in range(self.n_shards) if stacks[s]),
            key=lambda s: (-len(stacks[s]), age[stacks[s][0]]),
        )
        out: list[int] = []
        i = 0
        while len(out) < n:
            s = order[i % len(order)]
            if stacks[s]:
                out.append(stacks[s].pop())
                self._occ[s] += 1
            i += 1
            if i > 4 * self.n_shards + n * 2:
                # the round-robin order ran dry: sweep what is left in
                # by-shard order, oldest free block first
                rem = sorted(
                    (s for s in range(self.n_shards) if stacks[s]),
                    key=lambda s: age[stacks[s][0]],
                )
                for s in rem:
                    k = min(len(stacks[s]), n - len(out))
                    if k <= 0:
                        break
                    out.extend(stacks[s][:k])
                    del stacks[s][:k]
                    self._occ[s] += k
                break
        self._n_free -= n
        ids = np.asarray(out, np.intp)
        self.refcounts[ids] = 1
        self.committed[ids] = False
        return out

    def release(self, block_ids: list[int]) -> None:
        if not len(block_ids):
            return
        ids = np.asarray(block_ids, np.intp)
        np.subtract.at(self.refcounts, ids, 1)
        if (self.refcounts[ids] < 0).any():
            raise ValueError("double free")
        zero = self.refcounts[ids] == 0
        if not zero.any():
            return
        # freed blocks re-enter the free stacks in caller order (dedup'd)
        seen: set[int] = set()
        freed = [
            b for b, z in zip(ids.tolist(), zero.tolist())
            if z and not (b in seen or seen.add(b))
        ]
        farr = np.asarray(freed, np.intp)
        self.committed[farr] = False
        self.epochs[farr] += 1  # invalidate readers holding stale ids
        for b in freed:
            s = b % self.n_shards
            self._free_by_shard[s].append(b)
            self._occ[s] -= 1
            self._age[b] = self._stamp
            self._stamp += 1
        self._n_free += len(freed)

    # ------------------------------------------------------------------
    def write_blocks(self, block_ids: list[int]) -> list[int]:
        """Publish blocks whose payload is already in ``data``: one batched
        epoch bump. Returns the publish epochs."""
        ids = np.asarray(block_ids, np.intp)
        self.epochs[ids] += 1
        self.committed[ids] = True
        return self.epochs[ids].tolist()

    def validate_epochs(self, block_ids, epochs) -> np.ndarray:
        """Vectorized committed + epoch check."""
        ids = np.asarray(block_ids, np.intp)
        return self.committed[ids] & (self.epochs[ids] == np.asarray(epochs))
