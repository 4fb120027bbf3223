"""Decoder stack over layer periods, on one device.

Twin of ``repro/models/transformer.py``: ``period_length`` and
``layer_kinds`` whole, ``forward_full`` (prefill, optionally collecting the
decode cache) and ``decode_step_stack`` (one token through every layer),
each looping over periods x positions where JAX scans over the periods.
A position's mixer is "attn" (flash attention in prefill, paged attention
in decode) or "ssm" (Mamba-2); its FFN is "mlp", "moe" (``models/moe.py``)
or "none". Parameters keep the JAX tree, ``params["stack"]["pos_<i>"][...]``
with a leading period dimension.

The decode cache of a period-1 stack is the (k, v) pair of
(L, b, max_len, hkv, hd) tensors (attention) or the dict of ``state``
(L, b, nh, n, hp) and ``conv`` (L, b, d_conv - 1, conv_dim) (Mamba-2). A
hybrid period (Jamba) has JAX's per-position tree (``cache_specs``):
``{"pos_<i>": {"k", "v"}}`` at attention positions and ``{"state",
"conv"}`` at SSM positions, each with a leading n_periods dimension. Both
are updated in place. K and V are written in the cache's dtype: with an
fp8 cache, prefill's flash attention still reads the unquantized K and V,
and decode's paged attention reads the e4m3 blocks (``repro/models/
transformer.py:170-187``).

A training forward (grad enabled, no cache) recomputes each period in the
backward under ``remat`` (``RuntimeConfig.remat``, JAX's ``jax.checkpoint``
of the scanned period): "full" keeps only the period's input
(``nothing_saveable``), "dots" also keeps the outputs of matrix products
without batch dimensions (``checkpoint_dots_with_no_batch_dims``), "none"
keeps every activation.

Under a mesh (``MeshContext``) each rank runs the same loop on its shards:
a layer's weights have their FSDP dims gathered at use
(``sharding.gather_tree``) and dropped after; the mixers and FFNs run
tensor-parallel over ``model`` (``attention``, ``mamba``, ``layers``,
``moe``); the batch is this rank's rows. The attention caches are laid out
as ``cache_specs`` says: the sequence over ``model`` (pool-interleaved) or
whole (replicated), the batch over ``data``, every kv head on every rank.
Prefill fills them with a heads-to-sequence all-to-all when the kv heads
were sharded, or a slice when every rank already holds them all; a decode
write lands only on the rank that owns the position.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import ParamSpec, gather_tree
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import dense_blocks, make_block_table
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import mlp_apply, norm_apply, rope_tables

# tokens per block when decode attention reads the dense cache as blocks
DECODE_BLOCK_TOKENS = 16
REMAT = ("none", "full", "dots")


@dataclass(frozen=True)
class MeshContext:
    """What a rank's pass through the stack needs of the mesh: the rules,
    each position's PartitionSpecs of one layer (``pos_<i>`` -> the tree,
    the stacked layer dim dropped), the mesh axes the batch is sharded over
    in this call (() when every rank holds it all), and those the attention
    caches' sequence is sharded over: ("model",) pool-interleaved, ()
    replicated."""

    rules: object
    layer_specs: dict
    batch_axes: tuple
    kv_seq_axes: tuple


@dataclass(frozen=True)
class LayerKind:
    mixer: str  # "attn" | "ssm"
    ffn: str  # "mlp" | "moe" | "none"


def period_length(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        p = cfg.attn_period
        if cfg.moe.enabled:
            p = p * cfg.moe.layer_period // math.gcd(p, cfg.moe.layer_period)
        return p
    return 1


def layer_kinds(cfg: ModelConfig) -> list[LayerKind]:
    """Kind of each position within one period."""
    p = period_length(cfg)
    attn_ids = set(cfg.attn_layer_ids())
    moe_ids = set(cfg.moe_layer_ids())
    kinds = []
    for pos in range(p):
        mixer = "attn" if pos in attn_ids or (p == 1 and cfg.family != "ssm") else "ssm"
        if p == 1:
            mixer = "ssm" if cfg.family == "ssm" else "attn"
        if cfg.family == "ssm":
            ffn = "none"
        elif cfg.moe.enabled and (p == 1 or pos in moe_ids):
            ffn = "moe" if (p > 1 and pos in moe_ids) or (p == 1) else "mlp"
        else:
            ffn = "mlp"
        kinds.append(LayerKind(mixer=mixer, ffn=ffn))
    return kinds


def layer_params(stacked: dict, i: int) -> dict:
    """Layer ``i`` of a stacked parameter subtree."""
    return {
        k: layer_params(v, i) if isinstance(v, dict) else v[i]
        for k, v in stacked.items()
    }


def n_periods(cfg: ModelConfig) -> int:
    p = period_length(cfg)
    if cfg.n_layers % p:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole periods of {p}")
    return cfg.n_layers // p


def position_caches(cache, kinds: list[LayerKind]) -> list[dict]:
    """Each position's decode cache as a dict of tensors with a leading
    period dimension: ``{"k", "v"}`` or ``{"state", "conv"}``. A period-1
    stack's (k, v) pair or SSM dict is seen so; a hybrid's tree is read
    position by position."""
    if len(kinds) > 1:
        return [cache[f"pos_{j}"] for j in range(len(kinds))]
    if kinds[0].mixer == "attn":
        return [{"k": cache[0], "v": cache[1]}]
    return [cache]


def cache_specs(cfg: ModelConfig, batch: int, max_len: int, tp: int, kv_axes: tuple,
                kv_dtype: torch.dtype, dtype: torch.dtype) -> dict:
    """The decode cache as ParamSpec leaves, per position of the period
    (``repro/models/transformer.py:116-165``). ``kv_axes``: the logical
    axes of the kv caches' (batch, seq) dims, ("batch", "kv_seq") or
    ("batch", None); ``tp`` is unused, as in JAX."""
    n = n_periods(cfg)
    b_ax, s_ax = kv_axes
    out = {}
    for j, kind in enumerate(layer_kinds(cfg)):
        if kind.mixer == "attn":
            kv = ParamSpec((n, batch, max_len, cfg.n_kv_heads, cfg.head_dim), kv_dtype,
                           ("layers", b_ax, s_ax, None, None), init="zeros")
            out[f"pos_{j}"] = {"k": kv, "v": kv}
        else:
            _, nh, conv_dim = mamba_lib.ssm_dims(cfg)
            ssm = cfg.ssm
            out[f"pos_{j}"] = {
                "state": ParamSpec((n, batch, nh, ssm.d_state, ssm.head_dim), torch.float32,
                                   ("layers", b_ax, "ssm_inner", None, None), init="zeros"),
                "conv": ParamSpec((n, batch, ssm.d_conv - 1, conv_dim), dtype,
                                  ("layers", b_ax, None, None), init="zeros"),
            }
    return out


def _layer(params: dict, j: int, i: int, mesh_ctx: MeshContext | None) -> dict:
    """Layer i of position j, its FSDP dims gathered under a mesh."""
    lp = layer_params(params["stack"][f"pos_{j}"], i)
    if mesh_ctx is None:
        return lp
    return gather_tree(lp, mesh_ctx.layer_specs[f"pos_{j}"], mesh_ctx.rules.mesh)


def _prefill_kv(t: torch.Tensor, cfg: ModelConfig, mesh_ctx: MeshContext, s_loc: int):
    """Prefill's K or V (b, s, hkv or this rank's kv heads, hd) -> this
    rank's part of the cache: every kv head, at the cache's sequence shard
    (its first rows; the rest stay zero)."""
    rules = mesh_ctx.rules
    mesh, axes = rules.mesh, mesh_ctx.kv_seq_axes
    sharded = attn_lib.kv_heads_sharded(cfg, rules)
    if not axes:  # replicated: every position
        return coll.all_gather(t, 2, mesh, "model") if sharded else t
    if axes != ("model",):
        raise ValueError(f"a prefill cache's sequence sharded over {axes}, not ('model',)")
    n = mesh.axis_size(axes)
    if not sharded:  # every rank holds every kv head: its slice of the sequence
        return t[:, mesh.axis_index(axes) * s_loc:][:, :s_loc]
    # heads -> sequence: sequence chunk i of this rank's heads goes to rank i
    b, s, h_loc, hd = t.shape
    send = F.pad(t, (0, 0, 0, 0, 0, n * s_loc - s)).reshape(b, n, s_loc, h_loc, hd)
    recv = coll.all_to_all(send.transpose(0, 1).contiguous(), mesh, axes)
    return recv.permute(1, 2, 0, 3, 4).reshape(b, s_loc, n * h_loc, hd)


def _ffn(lp: dict, kind: LayerKind, h: torch.Tensor, cfg: ModelConfig,
         moe_dispatch: str, aux: list | None, mesh_ctx: MeshContext | None = None):
    if kind.ffn == "none":
        return h
    rules = mesh_ctx.rules if mesh_ctx is not None else None
    hn = norm_apply(lp["ln2"], h, cfg)
    if kind.ffn == "moe":
        out, stats = moe_lib.moe_apply(lp["moe"], hn, cfg, moe_dispatch, rules,
                                       mesh_ctx.batch_axes if mesh_ctx is not None else None)
        if aux is not None:
            aux.append(stats)
        return h + out
    return h + mlp_apply(lp["mlp"], hn, cfg, rules)


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the outputs of matrix products without batch dimensions (mm,
    addmm: every projection), recompute the rest (``bmm``: attention's
    batched products)."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed(fn, remat: str):
    """``fn`` recomputed in the backward under the ``remat`` policy."""
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def forward_full(
    params: dict,
    x: torch.Tensor,  # (b, s, d) embedded inputs
    positions: torch.Tensor,  # (b, s)
    cfg: ModelConfig,
    kernel_mode: str,
    cache=None,
    moe_dispatch: str = "einsum",
    aux: list | None = None,
    remat: str = "none",
    mesh_ctx: MeshContext | None = None,
) -> torch.Tensor:
    """Run the full stack; returns the hidden states. ``cache``, if given,
    receives each layer's decode state (JAX's ``collect_cache``): k and v in
    positions [0, s) at attention layers, the final SSM state and the conv
    window at SSM layers. ``aux``, if given, receives each MoE layer's aux
    dict (``moe.moe_apply``) in layer order. ``remat`` applies under grad
    and without a cache (module docstring). ``mesh_ctx``: this rank's
    shards under a mesh (module docstring)."""
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r} not in {REMAT}")
    kinds = layer_kinds(cfg)
    caches = position_caches(cache, kinds) if cache is not None else None
    s = x.shape[1]
    rope = None
    if any(kind.mixer == "attn" for kind in kinds):
        rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)

    rules = mesh_ctx.rules if mesh_ctx is not None else None

    def period(h: torch.Tensor, i: int):
        """Period i of the stack: (h, its MoE layers' aux dicts)."""
        stats = []
        for j, kind in enumerate(kinds):
            lp = _layer(params, j, i, mesh_ctx)
            hn = norm_apply(lp["ln1"], h, cfg)
            if kind.mixer == "attn":
                q, k, v = attn_lib.qkv_proj(lp["attn"], hn, cfg, rope, rules)
                ka, va = k, v
                if rules is not None and not attn_lib.kv_heads_sharded(cfg, rules):
                    ka = attn_lib.kv_for_heads(k, cfg, rules, q.shape[2])
                    va = attn_lib.kv_for_heads(v, cfg, rules, q.shape[2])
                o = ops.flash_attention(q, ka, va, causal=True, mode=kernel_mode)
                h = h + attn_lib.out_proj(lp["attn"], o, rules)
                if caches is not None:  # cast to the cache's dtype (e4m3 as JAX casts)
                    for name, t in (("k", k), ("v", v)):
                        dst = caches[j][name]
                        if mesh_ctx is not None:
                            t = _prefill_kv(t, cfg, mesh_ctx, dst.shape[2])
                        dst[i, :, :t.shape[1]] = attn_lib.to_cache_dtype(t, dst.dtype)
            elif caches is not None:
                out, state, conv = mamba_lib.mamba_apply(lp["ssm"], hn, cfg, kernel_mode,
                                                         return_state=True, rules=rules)
                h = h + out
                caches[j]["state"][i] = state
                caches[j]["conv"][i] = conv
            else:
                h = h + mamba_lib.mamba_apply(lp["ssm"], hn, cfg, kernel_mode, rules=rules)
            h = _ffn(lp, kind, h, cfg, moe_dispatch, stats, mesh_ctx)
        return h, stats

    if remat != "none" and caches is None and torch.is_grad_enabled():
        period = _checkpointed(period, remat)
    h = x
    for i in range(n_periods(cfg)):
        h, stats = period(h, i)
        if aux is not None:
            aux.extend(stats)
    return h


def decode_step_stack(
    params: dict,
    cache,  # as ``forward_full`` fills it; updated in place
    x: torch.Tensor,  # (b, 1, d)
    pos: torch.Tensor,  # (b,) write positions
    cfg: ModelConfig,
    kernel_mode: str = "auto",
    block_table: torch.Tensor | None = None,
    moe_dispatch: str = "einsum",
    aux: list | None = None,
    mesh_ctx: MeshContext | None = None,
) -> torch.Tensor:
    """One decode token through the stack; returns the hidden state.
    ``aux`` as in ``forward_full``.

    Attention reads each layer's dense cache (b, max_len, hkv, hd) as
    ``max_len / DECODE_BLOCK_TOKENS`` blocks through ``block_table``, the
    identity table ``identity_block_table`` gives, with context ``pos + 1``.
    Under ``mesh_ctx`` the cache is this rank's (b, s_loc, hkv, hd) shard
    and the table is its own: every rank takes q of all heads, and the
    pool-interleaved layout merges the shards' partial attentions
    (``attention.decode_attention_interleaved``); the replicated layout
    attends its whole cache. Each rank then projects its own heads'
    outputs (row-parallel).
    """
    kinds = layer_kinds(cfg)
    caches = position_caches(cache, kinds)
    if any(kind.mixer == "attn" for kind in kinds):
        if block_table is None:
            raise ValueError("attention decode needs the cache's block table")
        cache_len = (pos + 1).to(torch.int32)  # once, not per layer
        rope = rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)
    rules = mesh_ctx.rules if mesh_ctx is not None else None
    h = x
    for i in range(n_periods(cfg)):
        for j, kind in enumerate(kinds):
            lp = _layer(params, j, i, mesh_ctx)
            c = caches[j]
            hn = norm_apply(lp["ln1"], h, cfg)
            if kind.mixer == "attn" and rules is not None:
                h = h + _sharded_decode_attn(lp["attn"], hn, c["k"][i], c["v"][i], pos,
                                             cache_len, rope, cfg, kernel_mode, block_table,
                                             mesh_ctx)
            elif kind.mixer == "attn":
                q, k_new, v_new = attn_lib.qkv_proj(lp["attn"], hn, cfg, rope)
                attn_lib.update_kv_cache(c["k"][i], c["v"][i], k_new, v_new, pos)
                o = ops.paged_attention(
                    q[:, 0],
                    dense_blocks(c["k"][i], DECODE_BLOCK_TOKENS),
                    dense_blocks(c["v"][i], DECODE_BLOCK_TOKENS),
                    block_table, cache_len, mode=kernel_mode,
                )
                h = h + attn_lib.out_proj(lp["attn"], o[:, None])
            else:
                out, state, conv = mamba_lib.mamba_decode(
                    lp["ssm"], hn, c["state"][i], c["conv"][i], cfg, rules
                )
                c["state"][i] = state
                c["conv"][i] = conv
                h = h + out
            h = _ffn(lp, kind, h, cfg, moe_dispatch, aux, mesh_ctx)
    return h


def _sharded_decode_attn(p, hn, kc, vc, pos, cache_len, rope, cfg, kernel_mode, block_table,
                         mesh_ctx: MeshContext) -> torch.Tensor:
    """One decode token's attention mixer on this rank (JAX's decode
    branch, ``repro/models/transformer.py:271-290``): the new K/V of every
    kv head written where this rank owns pos, q of every head, the
    pool-interleaved or replicated attention, then this rank's heads
    through the row-parallel out projection."""
    rules = mesh_ctx.rules
    mesh, axes = rules.mesh, mesh_ctx.kv_seq_axes
    q, k_new, v_new = attn_lib.qkv_proj(p, hn, cfg, rope, rules)
    if attn_lib.kv_heads_sharded(cfg, rules):  # q, k and v of every head, in one gather
        b, _, hq_l, hd = q.shape
        hkv_l = k_new.shape[2]
        every = coll.all_gather_stacked(torch.cat([q, k_new, v_new], 2), mesh, "model")
        every = every.permute(1, 2, 0, 3, 4)  # (b, 1, n, hq_l + 2 hkv_l, hd)
        q_all = every[:, 0, :, :hq_l].reshape(b, -1, hd)
        k_new = every[:, :, :, hq_l:hq_l + hkv_l].reshape(b, 1, -1, hd)
        v_new = every[:, :, :, hq_l + hkv_l:].reshape(b, 1, -1, hd)
    else:
        q_all = coll.all_gather(q, 2, mesh, "model")[:, 0]  # (b, hq, hd)
    lo = mesh.axis_index(axes) * kc.shape[1] if axes else 0
    attn_lib.update_kv_shard(kc, vc, k_new, v_new, pos, lo)
    if axes:
        o = attn_lib.decode_attention_interleaved(q_all, kc, vc, cache_len, mesh, axes,
                                                  block_table, DECODE_BLOCK_TOKENS, kernel_mode)
    else:
        o = ops.paged_attention(q_all, dense_blocks(kc, DECODE_BLOCK_TOKENS),
                                dense_blocks(vc, DECODE_BLOCK_TOKENS), block_table, cache_len,
                                mode=kernel_mode)
    return attn_lib.out_proj(p, attn_lib.local_heads(o, rules, 1)[:, None], rules)


def identity_block_table(batch: int, max_len: int, device) -> torch.Tensor:
    """Row i of a dense (batch, max_len) cache seen as blocks: i * nb + j."""
    nb = max_len // DECODE_BLOCK_TOKENS
    rows = torch.arange(batch * nb, dtype=torch.int32).reshape(batch, nb)
    return make_block_table(rows, batch * nb, device)
