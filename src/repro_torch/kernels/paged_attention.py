"""Paged decode attention on the card: wrapper of ``csrc/paged_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py``
``paged_attention`` (pallas_call at :128): one query token per row
attends over keys and values held in blocks of ``bt`` tokens, looked up
through a block table. The bound is bytes: the K and V rows below each
row's context, read once, at 3.35 TB/s. The source's header says what the
design does about it.

K and V come as two block views ``(n_blocks, bt, hkv, d)`` that share one
stride between blocks, each block contiguous inside; so the JAX pool
layout ``(n, 2, bt, hkv, d)``, one layer of the port's fused pool
``(n, 2L, bt, hkv, d)`` and a dense decode cache cut into blocks are all
read in place (``pool_layer``, ``dense_blocks``).

Block tables are checked on the host where they are built
(``make_block_table``): entries in [-1, n_blocks), -1 read as block 0. The
kernel trusts a table that already lies on the card, so a decode loop
builds its table once and never syncs to re-check it.

Takes float32 or bfloat16, head_dim 16, 32, 64 or 128, at most 8 query
heads per kv head; raises on anything else. Counts its launches in
``paged_attention.launches``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "paged_attention_fwd": (
        [_P, _P, _P, _LL, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
         ctypes.c_float, _P],
        ctypes.c_int,
    ),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 8
# the context is cut into splits of about this many tokens, each its own
# thread block (at most MAX_SPLITS), and the splits are merged after
SPLIT_TOKENS, MAX_SPLITS = 64, 64


def make_block_table(rows, n_blocks: int, device) -> torch.Tensor:
    """(b, max_blocks) int32 on ``device``; raises on an entry outside [-1, n_blocks)."""
    table = torch.as_tensor(rows, dtype=torch.int32, device="cpu")
    if table.dim() != 2:
        raise ValueError(f"block table must be (b, max_blocks), got {tuple(table.shape)}")
    bad = table[(table < -1) | (table >= n_blocks)]
    if bad.numel():
        raise ValueError(
            f"block table entries {bad.tolist()[:8]} outside [-1, {n_blocks})"
        )
    return table.to(device)


def pool_layer(pool: torch.Tensor, layer: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K and V block views of one layer of a (n, 2L, bt, hkv, d) pool, no copy."""
    return pool[:, 2 * layer], pool[:, 2 * layer + 1]


def dense_blocks(cache: torch.Tensor, bt: int) -> torch.Tensor:
    """A dense (b, max_len, hkv, d) cache as (b * max_len / bt, bt, hkv, d) blocks;
    row i's block j is block i * (max_len / bt) + j."""
    b, max_len, hkv, d = cache.shape
    if max_len % bt:
        raise ValueError(f"max_len {max_len} is not a multiple of the block size {bt}")
    return cache.view(b * (max_len // bt), bt, hkv, d)


def paged_attention(
    q: torch.Tensor,  # (b, hq, d)
    k_blocks: torch.Tensor,  # (n_blocks, bt, hkv, d)
    v_blocks: torch.Tensor,
    block_table: torch.Tensor,  # (b, max_blocks) int32 on the card
    context_lens: torch.Tensor,  # (b,) int32 on the card
) -> torch.Tensor:
    if q.dtype not in _DTYPES:
        raise ValueError(f"paged_attention takes float32 or bfloat16, not {q.dtype}")
    for t in (q, k_blocks, v_blocks, block_table, context_lens):
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError("paged_attention takes tensors on the card, all on one device")
    b, hq, d = q.shape
    n, bt, hkv, _ = k_blocks.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"{hq} query heads over {hkv} kv heads: need a group of <= {MAX_GROUP}")
    if v_blocks.shape != k_blocks.shape or k_blocks.shape[3] != d:
        raise ValueError(f"bad shapes q {q.shape}, k {k_blocks.shape}, v {v_blocks.shape}")
    inner = (hkv * d, d, 1)
    if (k_blocks.dtype != q.dtype or v_blocks.dtype != q.dtype or not q.is_contiguous()
            or k_blocks.stride()[1:] != inner or v_blocks.stride() != k_blocks.stride()):
        raise ValueError("k/v blocks must share q's dtype and one block stride, "
                         "each block contiguous; q contiguous")
    item = q.element_size()
    if (k_blocks.data_ptr() | v_blocks.data_ptr()) % 16 or k_blocks.stride(0) * item % 16:
        raise ValueError("k/v blocks must be 16-byte aligned, as must the block stride")
    if (block_table.dtype != torch.int32 or block_table.dim() != 2
            or block_table.shape[0] != b or not block_table.is_contiguous()):
        raise ValueError(f"block table must be ({b}, max_blocks) int32, contiguous")
    if context_lens.dtype != torch.int32 or tuple(context_lens.shape) != (b,):
        raise ValueError(f"context_lens must be ({b},) int32")
    out = torch.empty_like(q)
    max_blocks = block_table.shape[1]
    splits = max(1, min(MAX_SPLITS, -(-max_blocks * bt // SPLIT_TOKENS)))
    part = torch.empty((2 + d) * b * hq * splits, dtype=torch.float32, device=q.device)
    part_m, part_l = part[: b * hq * splits], part[b * hq * splits: 2 * b * hq * splits]
    part_acc = part[2 * b * hq * splits:]
    lib = build.load("paged_attention", SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_attention_fwd(
            q.data_ptr(), k_blocks.data_ptr(), v_blocks.data_ptr(), k_blocks.stride(0),
            block_table.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
            _DTYPES[q.dtype], b, hq, hkv, d, bt, max_blocks, splits, 1.0 / math.sqrt(d), stream,
        )
    if rc:
        raise RuntimeError(f"paged_attention launch failed: cudaError_t {rc}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
