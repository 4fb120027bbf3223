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
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
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


def _ffn(lp: dict, kind: LayerKind, h: torch.Tensor, cfg: ModelConfig,
         moe_dispatch: str, aux: list | None) -> torch.Tensor:
    if kind.ffn == "none":
        return h
    hn = norm_apply(lp["ln2"], h, cfg)
    if kind.ffn == "moe":
        out, stats = moe_lib.moe_apply(lp["moe"], hn, cfg, moe_dispatch)
        if aux is not None:
            aux.append(stats)
        return h + out
    return h + mlp_apply(lp["mlp"], hn, cfg)


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
) -> torch.Tensor:
    """Run the full stack; returns the hidden states. ``cache``, if given,
    receives each layer's decode state (JAX's ``collect_cache``): k and v in
    positions [0, s) at attention layers, the final SSM state and the conv
    window at SSM layers. ``aux``, if given, receives each MoE layer's aux
    dict (``moe.moe_apply``) in layer order. ``remat`` applies under grad
    and without a cache (module docstring)."""
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r} not in {REMAT}")
    kinds = layer_kinds(cfg)
    caches = position_caches(cache, kinds) if cache is not None else None
    s = x.shape[1]
    rope = None
    if any(kind.mixer == "attn" for kind in kinds):
        rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)

    def period(h: torch.Tensor, i: int):
        """Period i of the stack: (h, its MoE layers' aux dicts)."""
        stats = []
        for j, kind in enumerate(kinds):
            lp = layer_params(params["stack"][f"pos_{j}"], i)
            hn = norm_apply(lp["ln1"], h, cfg)
            if kind.mixer == "attn":
                q, k, v = attn_lib.qkv_proj(lp["attn"], hn, cfg, rope)
                o = ops.flash_attention(q, k, v, causal=True, mode=kernel_mode)
                h = h + attn_lib.out_proj(lp["attn"], o)
                if caches is not None:  # cast to the cache's dtype (e4m3 as JAX casts)
                    for name, t in (("k", k), ("v", v)):
                        dst = caches[j][name]
                        dst[i, :, :s] = attn_lib.to_cache_dtype(t, dst.dtype)
            elif caches is not None:
                out, state, conv = mamba_lib.mamba_apply(lp["ssm"], hn, cfg, kernel_mode,
                                                         return_state=True)
                h = h + out
                caches[j]["state"][i] = state
                caches[j]["conv"][i] = conv
            else:
                h = h + mamba_lib.mamba_apply(lp["ssm"], hn, cfg, kernel_mode)
            h = _ffn(lp, kind, h, cfg, moe_dispatch, stats)
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
) -> torch.Tensor:
    """One decode token through the stack; returns the hidden state.
    ``aux`` as in ``forward_full``.

    Attention reads each layer's dense cache (b, max_len, hkv, hd) as
    ``max_len / DECODE_BLOCK_TOKENS`` blocks through ``block_table``, the
    identity table ``identity_block_table`` gives, with context ``pos + 1``.
    """
    kinds = layer_kinds(cfg)
    caches = position_caches(cache, kinds)
    if any(kind.mixer == "attn" for kind in kinds):
        if block_table is None:
            raise ValueError("attention decode needs the cache's block table")
        cache_len = (pos + 1).to(torch.int32)  # once, not per layer
        rope = rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)
    h = x
    for i in range(n_periods(cfg)):
        for j, kind in enumerate(kinds):
            lp = layer_params(params["stack"][f"pos_{j}"], i)
            c = caches[j]
            hn = norm_apply(lp["ln1"], h, cfg)
            if kind.mixer == "attn":
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
                    lp["ssm"], hn, c["state"][i], c["conv"][i], cfg
                )
                c["state"][i] = state
                c["conv"][i] = conv
                h = h + out
            h = _ffn(lp, kind, h, cfg, moe_dispatch, aux)
    return h


def identity_block_table(batch: int, max_len: int, device) -> torch.Tensor:
    """Row i of a dense (batch, max_len) cache seen as blocks: i * nb + j."""
    nb = max_len // DECODE_BLOCK_TOKENS
    rows = torch.arange(batch * nb, dtype=torch.int32).reshape(batch, nb)
    return make_block_table(rows, batch * nb, device)
