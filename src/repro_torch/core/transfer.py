"""Modeled cost of the pool's transfers: the accounting of
``repro/core/transfer.py``'s ``TransferEngine`` as plain functions over a
block layout.

``mode`` is ``"beluga"`` (one fused copy kernel per batch of blocks, the
paper's §6.1) or ``"rdma"`` (MoonCake's bounce buffer and sglist-limited
requests, optionally batched into LMCache-style super-blocks). Each
function returns what the reference adds to ``modeled_*_s`` and
``requests_issued``; the bytes themselves move elsewhere, through the
port's device pool (``core/pool.py``) and its kernels. Sizes follow the
reference's ``PoolLayout``: the port's ``KVBlockLayout`` plus the bytes of
one element (2 for bf16, 1 for fp8). Every time here is MODELED by
``core/fabric.py``.
"""

from __future__ import annotations

import math

from repro_torch.core import fabric
from repro_torch.core.pool import KVBlockLayout


def fragment_bytes(layout: KVBlockLayout, dtype_bytes: int = 2) -> int:
    """One (layer, k|v) fragment of a block: the paper's 20 KB unit."""
    return layout.block_tokens * layout.n_kv_heads * layout.head_dim * dtype_bytes


def n_fragments(layout: KVBlockLayout) -> int:
    return 2 * layout.n_layers_kv


def block_bytes(layout: KVBlockLayout, dtype_bytes: int = 2) -> int:
    return n_fragments(layout) * fragment_bytes(layout, dtype_bytes)


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
