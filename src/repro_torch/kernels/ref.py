"""Plain PyTorch versions of the kernels on the serving path.

Each ``*_ref`` mirrors ``repro.kernels.ref`` (signature and arithmetic) and
is the numerics ground truth: the dispatcher in ``ops.py`` runs it for
tensors that lie on the CPU, the CPU tests hold it against the JAX oracle,
and ``chip_smoke.py`` holds each CUDA kernel against it on the card.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor,  # (b, sq, hq, d)
    k: torch.Tensor,  # (b, skv, hkv, d)
    v: torch.Tensor,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)
        kpos = torch.arange(skv, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, sq, hq, d).to(q.dtype)


def kv_gather_write_ref(
    k_cache: torch.Tensor,  # (L, T, hkv, hd) dense per-layer cache
    v_cache: torch.Tensor,
    slot_ids: torch.Tensor,  # (n_blocks,) block-aligned slot index
    block_tokens: int,
) -> torch.Tensor:
    """Returns the pool payload (n_blocks, 2L, block_tokens, hkv, hd)."""
    L, T, hkv, hd = k_cache.shape
    n_slots = T // block_tokens
    kc = k_cache.reshape(L, n_slots, block_tokens, hkv, hd)[:, slot_ids]
    vc = v_cache.reshape(L, n_slots, block_tokens, hkv, hd)[:, slot_ids]
    # (L, n, bt, ...) x2 -> (n, L, 2, bt, ...): fragments [k0, v0, k1, v1, ...]
    kv = torch.stack([kc, vc], dim=2).transpose(0, 1)
    return kv.reshape(len(slot_ids), 2 * L, block_tokens, hkv, hd)


def kv_scatter_read_ref(
    pool_blocks: torch.Tensor,  # (n_blocks, 2L, bt, hkv, hd)
    slot_ids: torch.Tensor,  # (n_blocks,) destination slots
    k_cache: torch.Tensor,  # (L, T, hkv, hd) to scatter into
    v_cache: torch.Tensor,
    block_tokens: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Copies block i into slot ``slot_ids[i]`` of fresh copies of the caches."""
    n_blocks, two_l, bt, hkv, hd = pool_blocks.shape
    L = two_l // 2
    kv = pool_blocks.reshape(n_blocks, L, 2, bt, hkv, hd)
    n_slots = k_cache.shape[1] // block_tokens
    k_out = k_cache.clone().reshape(L, n_slots, bt, hkv, hd)
    v_out = v_cache.clone().reshape(L, n_slots, bt, hkv, hd)
    k_out[:, slot_ids] = kv[:, :, 0].transpose(0, 1).to(k_out.dtype)
    v_out[:, slot_ids] = kv[:, :, 1].transpose(0, 1).to(v_out.dtype)
    return k_out.reshape(k_cache.shape), v_out.reshape(v_cache.shape)
