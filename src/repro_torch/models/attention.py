"""Attention: projections and GQA decode.

Twin of ``repro/models/attention.py`` for one device. Prefill attention is
``ops.flash_attention`` (the CUDA kernel on the card), called from
``transformer.forward_full`` where the JAX model calls its jnp chunked
flash; decode attention stays plain PyTorch, as JAX computes it outside
any Pallas kernel.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope

NEG_INF = -1e30


def qkv_proj(p: dict, x: torch.Tensor, cfg: ModelConfig, rope):
    """x: (b, s, d) -> q (b,s,hq,hd), k/v (b,s,hkv,hd), with RoPE applied;
    ``rope`` is ``layers.rope_tables`` of the positions."""
    b, s, d = x.shape
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    wq = p["wq"]  # (d, hq, hd)
    q = (x @ wq.reshape(d, -1)).reshape(b, s, wq.shape[1], hd)
    k2 = x @ p["wk"]
    v2 = x @ p["wv"]
    if "bq" in p:
        q = q + p["bq"]
        k2 = k2 + p["bk"]
        v2 = v2 + p["bv"]
    q = apply_rope(q, rope)
    k = apply_rope(k2.reshape(b, s, hkv, hd), rope)
    return q, k, v2.reshape(b, s, hkv, hd)


def out_proj(p: dict, attn_out: torch.Tensor) -> torch.Tensor:
    b, s, hq, hd = attn_out.shape
    out = attn_out.reshape(b, s, hq * hd) @ p["wo"].reshape(hq * hd, -1)
    if "bo" in p:
        out = out + p["bo"]
    return out


def decode_attention_replicated(
    q: torch.Tensor,  # (b, 1, hq, d)
    k_cache: torch.Tensor,  # (b, s_max, hkv, d)
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,  # (b,)
) -> torch.Tensor:
    """One query token against the whole cache, positions >= cache_len masked."""
    b, _, hq, d = q.shape
    hkv = k_cache.shape[2]
    n_rep = hq // hkv
    # q in the cache dtype, products accumulated in f32 (JAX's
    # preferred_element_type=float32 on cache-dtype operands)
    qg = (q[:, 0] * (1.0 / math.sqrt(d))).to(k_cache.dtype).reshape(b, hkv, n_rep, d)
    s = torch.einsum("bgrd,bkgd->bgrk", qg.float(), k_cache.float())
    pos = torch.arange(k_cache.shape[1], device=q.device)
    mask = pos[None, :] < cache_len.reshape(-1, 1)
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrk,bkgd->bgrd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(b, 1, hq, d).to(q.dtype)


def update_kv_cache(
    k_cache: torch.Tensor,  # (b, s_max, hkv, d)
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # (b, 1, hkv, d)
    v_new: torch.Tensor,
    pos: torch.Tensor,  # (b,) write positions
) -> None:
    """Write one new token per sequence at its position, in place (JAX
    returns new arrays; the port updates the cache it owns)."""
    bidx = torch.arange(k_cache.shape[0], device=k_cache.device)
    k_cache[bidx, pos] = k_new[:, 0].to(k_cache.dtype)
    v_cache[bidx, pos] = v_new[:, 0].to(v_cache.dtype)
