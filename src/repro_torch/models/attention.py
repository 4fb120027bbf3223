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

Under a mesh (``rules`` given) the query heads are sharded over ``model``
and the K/V projections over their flattened columns. When the kv heads
divide the TP degree (``kv_heads_sharded``) each rank attends its heads
with its own kv heads; otherwise the small K/V activations are gathered
and each rank takes the kv heads its query heads read (``kv_for_heads``).
``out_proj`` is row-parallel. Decode under a mesh runs the port's paged
kernel too: ``decode_attention_interleaved`` (Beluga O9, JAX's ``:275-331``)
gives every rank q of all heads and its contiguous shard of the KV
sequence, attends the shard with ``paged_attention``'s log-sum-exp output,
and merges the shards' normalised partials out_i by
out = sum_i exp(lse_i - max lse) out_i / sum_i exp(lse_i - max lse), the
same function as JAX's merge of (num, den, max); a shard with no valid
position has an lse of -inf and weighs exactly 0.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import ParamSpec
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import dense_blocks
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


def attn_param_specs(cfg: ModelConfig, tp: int, dtype: torch.dtype) -> dict:
    """One attention mixer at the tp-padded head count
    (``repro/models/attention.py:38-59``); K and V projections flattened to
    (d, hkv * hd), sharded over ``model`` on that dim."""
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.padded_heads(tp), cfg.n_kv_heads
    p = {
        "wq": ParamSpec((d, hq, hd), dtype, ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, hkv * hd), dtype, ("embed", "kv_flat")),
        "wv": ParamSpec((d, hkv * hd), dtype, ("embed", "kv_flat")),
        "wo": ParamSpec((hq, hd, d), dtype, ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamSpec((hq, hd), dtype, ("heads", "head_dim"), init="zeros")
        p["bk"] = ParamSpec((hkv * hd,), dtype, ("kv_flat",), init="zeros")
        p["bv"] = ParamSpec((hkv * hd,), dtype, ("kv_flat",), init="zeros")
    if cfg.attn_out_bias:
        p["bo"] = ParamSpec((d,), dtype, ("norm",), init="zeros")
    return p


def kv_heads_sharded(cfg: ModelConfig, rules) -> bool:
    """True when the kv heads themselves divide the TP degree."""
    return rules is not None and cfg.n_kv_heads % rules.tp == 0


def qkv_proj(p: dict, x: torch.Tensor, cfg: ModelConfig, rope, rules=None):
    """x: (b, s, d) -> q (b,s,hq,hd), k/v (b,s,hkv,hd), with RoPE applied;
    ``rope`` is ``layers.rope_tables`` of the positions. Under ``rules``:
    q of this rank's heads; k/v of its kv heads when ``kv_heads_sharded``,
    else of all kv heads (the flattened columns gathered over ``model``)."""
    b, s, d = x.shape
    hd = cfg.head_dim
    wq = p["wq"]  # (d, hq, hd)
    q = (x @ wq.reshape(d, -1)).reshape(b, s, wq.shape[1], hd)
    k2 = x @ p["wk"]
    v2 = x @ p["wv"]
    if "bq" in p:
        q = q + p["bq"]
        k2 = k2 + p["bk"]
        v2 = v2 + p["bv"]
    if rules is not None and not kv_heads_sharded(cfg, rules):
        k2 = coll.all_gather(k2, 2, rules.mesh, "model")
        v2 = coll.all_gather(v2, 2, rules.mesh, "model")
    hkv = k2.shape[-1] // hd
    q = apply_rope(q, rope)
    k = apply_rope(k2.reshape(b, s, hkv, hd), rope)
    return q, k, v2.reshape(b, s, hkv, hd)


def kv_for_heads(k: torch.Tensor, cfg: ModelConfig, rules, hq_local: int) -> torch.Tensor:
    """K or V of all kv heads (b, s, hkv, hd) -> the kv heads this rank's
    ``hq_local`` query heads read, as a GQA layout whose group maps query
    head i to kv head i // group: a contiguous run of kv heads when the
    local heads are whole groups or lie in one group, else one kv head per
    query head (group 1)."""
    hkv = k.shape[2]
    rep = hq_local * rules.tp // hkv  # the global group
    first = rules.mesh.axis_index("model") * hq_local
    if hq_local % rep == 0:
        return k[:, :, first // rep: first // rep + hq_local // rep]
    if rep % hq_local == 0:
        return k[:, :, first // rep: first // rep + 1]
    idx = torch.arange(first, first + hq_local, device=k.device) // rep
    return k.index_select(2, idx)


def out_proj(p: dict, attn_out: torch.Tensor, rules=None) -> torch.Tensor:
    b, s, hq, hd = attn_out.shape
    x, w = attn_out.reshape(b, s, hq * hd), p["wo"].reshape(hq * hd, -1)
    out = coll.row_parallel_matmul(x, w, rules) if rules is not None else x @ w
    if "bo" in p:
        out = out + p["bo"]
    return out


def local_heads(t: torch.Tensor, rules, dim: int) -> torch.Tensor:
    """This rank's shard over ``model`` of a dim holding every head."""
    n = t.shape[dim] // rules.tp
    return t.narrow(dim, rules.mesh.axis_index("model") * n, n)


def merge_lse(out: torch.Tensor, lse: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Normalised partial attentions out (b, h, d) with their log-sum-exps
    lse (b, h), one per shard of the sequence over ``axes`` -> the
    attention over the whole sequence, in out's dtype. One collective: every
    shard's (out, lse) is gathered and each rank merges them in shard order."""
    every = coll.all_gather_stacked(torch.cat([out.float(), lse[..., None]], -1), mesh, axes)
    outs, lses = every[..., :-1], every[..., -1]  # (n, b, h, d), (n, b, h)
    g = lses.amax(0)
    g = torch.where(torch.isfinite(g), g, 0.0)  # every shard empty: weights 0
    w = torch.exp(lses - g)
    num = (outs * w[..., None]).sum(0)
    return (num / w.sum(0).clamp_min(1e-30)[..., None]).to(out.dtype)


def decode_attention_interleaved(q, k_shard, v_shard, cache_len, mesh, axes, block_table,
                                 block_tokens: int, mode: str = "auto") -> torch.Tensor:
    """Beluga-O9 decode. q (b, hq, d) of every head; k/v_shard (b, s_loc,
    hkv, d), this rank's contiguous shard of the sequence (shard id
    row-major over ``axes``); cache_len (b,) -> (b, hq, d) over the whole
    sequence. The shard is read by ``paged_attention`` as blocks of
    ``block_tokens`` through ``block_table`` with its own context, cut to
    the shard."""
    s_loc = k_shard.shape[1]
    lo = mesh.axis_index(axes) * s_loc
    ctx = (cache_len - lo).clamp(0, s_loc).to(torch.int32)
    out, lse = ops.paged_attention(q, dense_blocks(k_shard, block_tokens),
                                   dense_blocks(v_shard, block_tokens), block_table, ctx,
                                   mode=mode, return_lse=True)
    return merge_lse(out, lse, mesh, axes)


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


def update_kv_shard(k_cache, v_cache, k_new, v_new, pos, lo: int) -> None:
    """``update_kv_cache`` on a shard of the sequence holding positions
    [lo, lo + s_loc): a row whose ``pos`` falls elsewhere keeps its cache
    (JAX's ``.at[bidx, pos].set`` on a sequence-sharded array lands on the
    shard that owns pos). Nothing is read back to the host."""
    s_loc = k_cache.shape[1]
    bidx = torch.arange(k_cache.shape[0], device=k_cache.device)
    local = pos - lo
    mine = ((local >= 0) & (local < s_loc))[:, None, None]
    at = local.clamp(0, s_loc - 1)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        bits = _bits(cache)
        bits[bidx, at] = torch.where(mine, _bits(to_cache_dtype(new[:, 0], cache.dtype)),
                                     bits[bidx, at])


def _bits(t: torch.Tensor) -> torch.Tensor:
    """An fp8 tensor as its bytes, which every indexing op takes."""
    return t.view(torch.uint8) if t.dtype == FP8_KV else t
