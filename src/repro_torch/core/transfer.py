"""Modeled cost of the pool's transfers: the accounting of
``repro/core/transfer.py``'s ``TransferEngine``.

``mode`` is ``"beluga"`` (one fused copy kernel per batch of blocks, the
paper's §6.1) or ``"rdma"`` (MoonCake's bounce buffer and sglist-limited
requests, optionally batched into LMCache-style super-blocks).

* ``PoolTransfer`` is the engine's twin over a ``KVBlockPool`` or a
  ``TieredPool``: ``gather_write`` publishes blocks (storing their payload,
  unless the pool is payload-free) and ``scatter_read`` reads them back
  after checking their epochs, raising ``StaleBlockError`` where the
  reference raises its coherence error; both go through the pool's
  ``write_blocks`` / ``read_blocks``, which a tier chain dispatches by id.
  Both add to ``stats`` what the reference adds, priced by
  ``block_transfer_cost``. ``fetch_latency``, ``tiered_fetch_latency`` and
  ``writeback_latency`` are what the cluster simulator charges a request
  for its hit prefix (on a flat pool, and on a tier chain) and its fresh
  blocks (the reference's ``KVCacheManager._fetch_latency`` and
  ``_fetch_latency_tiered``, and ``EngineInstance._writeback_latency``):
  every price of a pool transfer is in this module.
* The plain functions below it price whole blocks and sparse reads for a
  layout and a dtype (the exp09 and exp10 twins call them too; there the
  bytes move through the port's kernels). ``rdma_batching`` is the
  reference's ``TransferEngine._rdma_batching``.

Every time here is MODELED by ``core/fabric.py``.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import fabric
from repro_torch.core.pool import PAYLOAD_DTYPES, KVBlockLayout


class StaleBlockError(RuntimeError):
    """A read found a block whose epoch moved on: recycled or rewritten."""


@dataclass
class PoolTransferStats:
    writes: int = 0
    reads: int = 0
    bytes_written: int = 0
    bytes_read: int = 0
    modeled_write_s: float = 0.0
    modeled_read_s: float = 0.0
    requests_issued: int = 0  # RDMA request count / kernel launches


@dataclass
class PoolTransfer:
    pool: object  # KVBlockPool or tiering.TieredPool
    mode: str = "beluga"  # beluga | rdma
    super_block_tokens: int = 0  # rdma batching (LMCache: 256); 0 = native
    stats: PoolTransferStats = field(default_factory=PoolTransferStats)

    def _price(self, n: int) -> float:
        """Modeled seconds of moving n whole blocks; counts the requests."""
        lay = self.pool.layout
        t, n_req = block_transfer_cost(lay, n, self.mode, lay.dtype_bytes,
                                       self.super_block_tokens)
        self.stats.requests_issued += n_req
        return t

    def fetch_latency(self, n: int) -> float:
        """Modeled seconds of fetching a request's n hit blocks
        (``manager.py:136``). RDMA moves every fragment unbatched and pays
        the LMCache-style staging (allocation and CPU copies) once per
        super-block; ``stats`` is not touched."""
        lay = self.pool.layout
        size = n * lay.block_bytes
        if self.mode == "beluga":
            return fabric.gpu_transfer_latency(size)
        t = fabric.rdma_transfer_latency(size, n * lay.n_fragments)
        sbt = max(self.super_block_tokens, lay.block_tokens)
        n_super = math.ceil(n * lay.block_tokens / sbt)
        return t + n_super * fabric.RDMA_SW_PER_SUPERBLOCK

    def tiered_fetch_latency(self, counts, now: float, queues=None) -> float:
        """Modeled seconds of fetching a hit prefix from a tier chain
        (``manager.py:156-186``), given its blocks per tier (tier 0 first,
        from ``TieredPool.touch_demand``): the fast tier's at
        ``fetch_latency``'s price, each down-chain tier's at its medium's
        price plus its bytes over the GPU ingest bandwidth. With the pool's
        ``fabric.PoolDeviceQueues``, a fetch overlapping the migrator's
        backlog pays up to its own duration again."""
        lay = self.pool.layout
        media = self.pool.tier_media
        lat = self.fetch_latency(counts[0]) if counts[0] else 0.0
        for t, n in enumerate(counts[1:], start=1):
            if not n:
                continue
            size = n * lay.block_bytes
            lat += fabric.spill_transfer_latency(size, media[t]) + size / fabric.GPU_CXL_BW
        if queues is not None:
            backlog = max(queues.busy_until) - now
            if backlog > 0.0:
                lat += min(backlog, lat)
        return lat

    def writeback_latency(self, n: int) -> float:
        """Modeled seconds a prefill waits on writing n fresh blocks back
        (``engine.py:151``): RDMA pays the CPU-driven path synchronously;
        beluga's fused kernel runs in-stream, ~70 % overlapped with
        compute. ``stats`` is not touched."""
        lay = self.pool.layout
        size = n * lay.block_bytes
        if self.mode == "rdma":
            return fabric.rdma_transfer_latency(size, n * lay.n_fragments)
        return 0.3 * fabric.gpu_transfer_latency(size)

    def gather_write(self, block_ids: list[int], kv_blocks: torch.Tensor | None) -> list[int]:
        """kv_blocks: (n_blocks, 2L, block_tokens, hkv, hd), or None on a
        payload-free pool. Returns the publish epochs."""
        n = len(block_ids)
        self.stats.modeled_write_s += self._price(n)
        epochs = self.pool.write_blocks(block_ids, None if self.pool.payload_free else kv_blocks)
        self.stats.writes += n
        self.stats.bytes_written += n * self.pool.layout.block_bytes
        return epochs

    def scatter_read(self, block_ids: list[int], epochs: list[int] | None = None):
        """Returns (n_blocks, 2L, block_tokens, hkv, hd) (on ``meta`` for a
        payload-free pool). With ``epochs``, a block that is no longer
        committed at that epoch (payload-free) or whose epoch moved
        (payload) raises ``StaleBlockError``, as the reference checks."""
        n = len(block_ids)
        self.stats.modeled_read_s += self._price(n)
        out, eps_now = self.pool.read_blocks(block_ids)
        if epochs is not None:
            if self.pool.payload_free:
                ok = self.pool.validate_epochs(block_ids, epochs)
            else:
                ok = eps_now == np.asarray(epochs)
            if not ok.all():
                bad = block_ids[int(np.argmin(ok))]
                raise StaleBlockError(f"block {bad} epoch changed during read")
        if out is None:
            lay = self.pool.layout
            out = torch.empty((n, *lay.block_shape), dtype=PAYLOAD_DTYPES[lay.dtype_bytes],
                              device="meta")
        self.stats.reads += n
        self.stats.bytes_read += n * self.pool.layout.block_bytes
        return out


def n_fragments(layout: KVBlockLayout) -> int:
    return layout.n_fragments


def block_bytes(layout: KVBlockLayout, dtype_bytes: int = 2) -> int:
    """A block's bytes at ``dtype_bytes`` an element (2 bf16, 1 fp8)."""
    return dataclasses.replace(layout, dtype_bytes=dtype_bytes).block_bytes


def rdma_batching(layout: KVBlockLayout, n_blocks: int, super_block_tokens: int = 0) -> int:
    """Fragments the RDMA path moves for n_blocks blocks after super-block
    batching (``transfer.py:197``): fewer requests, larger transfer
    granularity."""
    if super_block_tokens and super_block_tokens > layout.block_tokens:
        group = super_block_tokens // layout.block_tokens
        return math.ceil(n_blocks / group) * n_fragments(layout)
    return n_blocks * n_fragments(layout)


def block_transfer_cost(
    layout: KVBlockLayout,
    n_blocks: int,
    mode: str = "beluga",
    dtype_bytes: int = 2,
    super_block_tokens: int = 0,
) -> tuple[float, int]:
    """(modeled seconds, requests issued) to move n_blocks whole blocks:
    ``gather_write`` (``transfer.py:75``) and ``scatter_read`` (``:111``)
    price a write and a read alike."""
    size = n_blocks * block_bytes(layout, dtype_bytes)
    if mode == "beluga":
        return fabric.gpu_transfer_latency(size), 1
    if mode != "rdma":
        raise ValueError(mode)
    nfrag = rdma_batching(layout, n_blocks, super_block_tokens)
    return (fabric.rdma_transfer_latency(size, nfrag),
            math.ceil(nfrag / fabric.RDMA_SGL_MAX))


def sparse_read_latency(
    layout: KVBlockLayout,
    n_tokens: int,
    contiguous_frac: float = 0.26,
    mode: str = "beluga",
    dtype_bytes: int = 2,
) -> float:
    """Modeled seconds to load the KV of n_tokens sparsely selected tokens
    (``transfer.py:178``): 2 * n_layers * n_kv_heads pieces of head_dim
    elements per token; contiguous neighbours merge, which only helps RDMA
    (fewer sglist entries)."""
    piece = layout.head_dim * dtype_bytes
    n_pieces = n_tokens * layout.n_layers_kv * layout.n_kv_heads * 2
    size = n_pieces * piece
    if mode == "beluga":
        return fabric.gpu_transfer_latency(size)
    if mode != "rdma":
        raise ValueError(mode)
    merged = max(1, int(n_pieces * (1 - contiguous_frac)))
    return fabric.rdma_transfer_latency(size, merged)
