"""Public model API: parameter init, prefill, decode, cache construction.

Twin of ``repro/models/model.py`` for token-input, period-1 attention
stacks on one device. The parameter tree has the JAX package's names,
shapes and layouts (``param_shapes``), so weights converted from a JAX
``Model.init`` tree are used as they are, and ``init_params`` follows the
JAX init rules: normal(0, 1) * 0.02 drawn in f32 and cast, norms at ones,
biases at zeros.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as stack_lib
from repro_torch.models.layers import embed_apply, norm_apply, unembed_apply

INIT_SCALE = 0.02


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def param_shapes(cfg: ModelConfig) -> dict:
    """Tree of (shape, init) leaves, init in {"normal", "ones", "zeros"}."""
    d, hd, L = cfg.d_model, cfg.head_dim, cfg.n_layers
    hq, hkv, ff, vocab = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.padded_vocab

    def norm(*lead):
        return {} if cfg.nonparametric_ln else {"w": ((*lead, d), "ones")}

    attn = {
        "wq": ((L, d, hq, hd), "normal"),
        "wk": ((L, d, hkv * hd), "normal"),
        "wv": ((L, d, hkv * hd), "normal"),
        "wo": ((L, hq, hd, d), "normal"),
    }
    if cfg.qkv_bias:
        attn |= {
            "bq": ((L, hq, hd), "zeros"),
            "bk": ((L, hkv * hd), "zeros"),
            "bv": ((L, hkv * hd), "zeros"),
        }
    if cfg.attn_out_bias:
        attn["bo"] = ((L, d), "zeros")
    mlp = {
        "wi_gate": ((L, d, ff), "normal"),
        "wi_up": ((L, d, ff), "normal"),
        "wo": ((L, ff, d), "normal"),
    }
    if cfg.mlp_bias:
        mlp |= {
            "bi_gate": ((L, ff), "zeros"),
            "bi_up": ((L, ff), "zeros"),
            "bo": ((L, d), "zeros"),
        }
    embed = {"table": ((vocab, d), "normal")}
    if not cfg.tie_embeddings:
        embed["head"] = ((d, vocab), "normal")
    return {
        "embed": embed,
        "stack": {"pos_0": {"ln1": norm(L), "attn": attn, "ln2": norm(L), "mlp": mlp}},
        "final_ln": norm(),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """Random parameters on ``device``; ``generator`` must live there too.

    Stacked leaves are drawn one layer at a time, so the f32 draw never
    holds more than one layer of one tensor.
    """
    dtype = torch_dtype(cfg.dtype)

    def make(leaf, stacked: bool) -> torch.Tensor:
        shape, init = leaf
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=device)
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=device)
        out = torch.empty(shape, dtype=dtype, device=device)
        for part in (out.unbind(0) if stacked else [out]):
            draw = torch.randn(part.shape, generator=generator, dtype=torch.float32,
                               device=device)
            part.copy_(draw.mul_(INIT_SCALE))
        return out

    def walk(tree: dict, stacked: bool) -> dict:
        return {
            k: walk(v, stacked or k == "stack") if isinstance(v, dict) else make(v, stacked)
            for k, v in tree.items()
        }

    return walk(param_shapes(cfg), False)


class Model:
    """Prefill / decode over a parameter tree for one config."""

    def __init__(self, cfg: ModelConfig, kernel_mode: str = "auto"):
        if cfg.family in ("ssm", "hybrid") or cfg.moe.enabled or cfg.n_heads == 0:
            raise ValueError(f"{cfg.name}: the port runs period-1 attention stacks only")
        if cfg.frontend != "none":
            raise ValueError(f"{cfg.name}: the port takes token inputs only")
        self.cfg = cfg
        self.kernel_mode = kernel_mode

    def prefill_fn(self, params: dict, tokens: torch.Tensor, max_len: int | None = None):
        """tokens (b, s) -> (last-position logits (b, 1, V) f32, (k, v) caches)."""
        b, s = tokens.shape
        x = embed_apply(params["embed"], tokens)
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        cache = self.init_cache(b, max_len if max_len is not None else s, tokens.device)
        h = stack_lib.forward_full(params, x, positions, self.cfg, self.kernel_mode, cache)
        h = norm_apply(params["final_ln"], h, self.cfg)
        return unembed_apply(params["embed"], h[:, -1:]), cache

    def decode_fn(self, params: dict, cache, tokens: torch.Tensor, pos: torch.Tensor):
        """tokens, pos (b,) -> logits (b, V) f32; writes the new KV into ``cache``."""
        x = embed_apply(params["embed"], tokens[:, None])
        h = stack_lib.decode_step_stack(params, cache, x, pos, self.cfg)
        h = norm_apply(params["final_ln"], h, self.cfg)
        return unembed_apply(params["embed"], h)[:, 0]

    def init_cache(self, batch: int, max_len: int, device) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        dtype = torch_dtype(cfg.dtype)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))
