"""Attention: projections, GQA decode and the fp8 KV cache's casts.

Twin of ``repro/models/attention.py`` for one device. Prefill attention is
``ops.flash_attention`` (the CUDA kernel on the card), called from
``transformer.forward_full`` where the JAX model calls its jnp chunked
flash; decode attention stays plain PyTorch, as JAX computes it outside
any Pallas kernel.

An fp8 cache (``RuntimeConfig.use_fp8_kv``) holds K and V as
``float8_e4m3fn``: they are cast on the way in (``to_cache_dtype``) and
dequantized to bf16 at the attention boundary (``kernels.ref.dequant``),
as JAX does.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import dequant
from repro_torch.models.layers import apply_rope

NEG_INF = -1e30
FP8_KV = torch.float8_e4m3fn
# the largest finite e4m3 is 448 = 1.75 * 2**8; the next step, 480, is the
# NaN encoding, so a value rounds to 448 up to the midpoint 464 (a tie goes
# to 448, whose mantissa is even) and to NaN past it
_E4M3_ROUNDS_TO_NAN = 464.0


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x.astype(jnp.float8_e4m3fn)`` bit for bit: round to nearest even,
    and NaN of x's sign where |x| rounds past 448 (infinities included).
    ``Tensor.to(torch.float8_e4m3fn)`` saturates those to +-448 instead."""
    y = x.to(FP8_KV)
    over = x.abs() > _E4M3_ROUNDS_TO_NAN
    bits = y.view(torch.uint8)
    return torch.where(over, bits | 0x7F, bits).view(FP8_KV)


def to_cache_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """New K or V cast to a cache's dtype, as ``jnp.astype`` would."""
    if dtype == FP8_KV:
        return to_e4m3(x)
    if dtype.itemsize == 1 and dtype.is_floating_point:
        raise ValueError(f"an fp8 KV cache is {FP8_KV}, not {dtype}")
    return x.to(dtype)


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
    k_cache, v_cache = dequant(k_cache), dequant(v_cache)
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
    returns new arrays; the port updates the cache it owns). New K and V are
    cast to the cache's dtype (``to_cache_dtype``: e4m3 as JAX casts it)."""
    bidx = torch.arange(k_cache.shape[0], device=k_cache.device)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        _bits(cache)[bidx, pos] = _bits(to_cache_dtype(new[:, 0], cache.dtype))


def _bits(t: torch.Tensor) -> torch.Tensor:
    """An fp8 tensor as its bytes, which every indexing op takes."""
    return t.view(torch.uint8) if t.dtype == FP8_KV else t
