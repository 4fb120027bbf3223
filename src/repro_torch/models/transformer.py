"""Decoder stack for period-1 attention stacks (dense llama/olmo/qwen-style).

Twin of ``repro/models/transformer.py`` restricted to what the serving
path runs: ``forward_full`` (prefill through the flash-attention kernel,
optionally collecting the KV cache)
and ``decode_step_stack`` (one token through every layer). Parameters keep
the JAX tree, ``params["stack"]["pos_0"][...]`` with a leading layer
dimension; where JAX scans over that dimension the port loops.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import mlp_apply, norm_apply, rope_tables


def layer_params(stacked: dict, i: int) -> dict:
    """Layer ``i`` of a stacked parameter subtree."""
    return {
        k: layer_params(v, i) if isinstance(v, dict) else v[i]
        for k, v in stacked.items()
    }


def _ffn(lp: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return h + mlp_apply(lp["mlp"], norm_apply(lp["ln2"], h, cfg), cfg)


def forward_full(
    params: dict,
    x: torch.Tensor,  # (b, s, d) embedded inputs
    positions: torch.Tensor,  # (b, s)
    cfg: ModelConfig,
    kernel_mode: str,
    cache: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Run the full stack; returns the hidden states. ``cache``, if given,
    is a pair of (L, b, max_len, hkv, hd) tensors that receive each layer's
    k and v in positions [0, s) (JAX's ``collect_cache``)."""
    s = x.shape[1]
    stack = params["stack"]["pos_0"]
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    h = x
    for i in range(cfg.n_layers):
        lp = layer_params(stack, i)
        hn = norm_apply(lp["ln1"], h, cfg)
        q, k, v = attn_lib.qkv_proj(lp["attn"], hn, cfg, rope)
        o = ops.flash_attention(q, k, v, causal=True, mode=kernel_mode)
        h = _ffn(lp, h + attn_lib.out_proj(lp["attn"], o), cfg)
        if cache is not None:
            cache[0][i, :, :s] = k
            cache[1][i, :, :s] = v
    return h


def decode_step_stack(
    params: dict,
    cache: tuple[torch.Tensor, torch.Tensor],  # (L, b, s_max, hkv, hd), updated in place
    x: torch.Tensor,  # (b, 1, d)
    pos: torch.Tensor,  # (b,) write positions
    cfg: ModelConfig,
) -> torch.Tensor:
    """One decode token through the stack; returns the hidden state."""
    k_cache, v_cache = cache
    stack = params["stack"]["pos_0"]
    cache_len = pos + 1
    rope = rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)
    h = x
    for i in range(cfg.n_layers):
        lp = layer_params(stack, i)
        hn = norm_apply(lp["ln1"], h, cfg)
        q, k_new, v_new = attn_lib.qkv_proj(lp["attn"], hn, cfg, rope)
        attn_lib.update_kv_cache(k_cache[i], v_cache[i], k_new, v_new, pos)
        o = attn_lib.decode_attention_replicated(q, k_cache[i], v_cache[i], cache_len)
        h = _ffn(lp, h + attn_lib.out_proj(lp["attn"], o), cfg)
    return h
