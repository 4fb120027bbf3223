"""Public model API: parameter init, prefill, decode, cache construction.

Twin of ``repro/models/model.py`` for token-input, period-1 stacks on one
device: attention with MLPs (llama, olmo, qwen) or Mamba-2 (ssm). The
parameter tree has the JAX package's names, shapes, layouts and leaf
dtypes (``param_shapes``), so weights converted from a JAX ``Model.init``
tree are used as they are, and ``init_params`` follows the JAX init rules:
normal(0, 1) * 0.02 drawn in f32 and cast, norms and ``D`` at ones, biases
at zeros, and the SSM's ``A_log`` and ``dt_bias`` rules.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as stack_lib
from repro_torch.models.layers import embed_apply, norm_apply, unembed_apply
from repro_torch.models.mamba import mamba_param_shapes, ssm_dims

INIT_SCALE = 0.02


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def param_shapes(cfg: ModelConfig) -> dict:
    """Tree of (shape, init, dtype) leaves, init in {"normal", "ones",
    "zeros", "ssm_a", "ssm_dt"}; dtype the model's, but float32 for the
    SSM's ``A_log``, ``D`` and ``dt_bias``."""
    d, hd, L = cfg.d_model, cfg.head_dim, cfg.n_layers
    hq, hkv, ff, vocab = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.padded_vocab
    dt = torch_dtype(cfg.dtype)

    def norm(*lead):
        return {} if cfg.nonparametric_ln else {"w": ((*lead, d), "ones", dt)}

    embed = {"table": ((vocab, d), "normal", dt)}
    if not cfg.tie_embeddings:
        embed["head"] = ((d, vocab), "normal", dt)
    kind = stack_lib.layer_kinds(cfg)[0]
    layer = {"ln1": norm(L)}
    if kind.mixer == "ssm":
        layer["ssm"] = mamba_param_shapes(cfg, (L,), dt)
    else:
        layer["attn"] = {
            "wq": ((L, d, hq, hd), "normal", dt),
            "wk": ((L, d, hkv * hd), "normal", dt),
            "wv": ((L, d, hkv * hd), "normal", dt),
            "wo": ((L, hq, hd, d), "normal", dt),
        }
        if cfg.qkv_bias:
            layer["attn"] |= {
                "bq": ((L, hq, hd), "zeros", dt),
                "bk": ((L, hkv * hd), "zeros", dt),
                "bv": ((L, hkv * hd), "zeros", dt),
            }
        if cfg.attn_out_bias:
            layer["attn"]["bo"] = ((L, d), "zeros", dt)
    if kind.ffn == "mlp":
        layer["ln2"] = norm(L)
        layer["mlp"] = {
            "wi_gate": ((L, d, ff), "normal", dt),
            "wi_up": ((L, d, ff), "normal", dt),
            "wo": ((L, ff, d), "normal", dt),
        }
        if cfg.mlp_bias:
            layer["mlp"] |= {
                "bi_gate": ((L, ff), "zeros", dt),
                "bi_up": ((L, ff), "zeros", dt),
                "bo": ((L, d), "zeros", dt),
            }
    return {"embed": embed, "stack": {"pos_0": layer}, "final_ln": norm()}


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """Random parameters on ``device``; ``generator`` must live there too.

    Stacked leaves are drawn one layer at a time, so the f32 draw never
    holds more than one layer of one tensor. ``ssm_a``: log of uniform
    [1, 16]; ``ssm_dt``: the inverse softplus of uniform [1e-3, 1e-1]
    (``repro/distributed/sharding.py:215-220``).
    """

    def draw(shape, init: str) -> torch.Tensor:
        if init == "normal":
            return torch.randn(shape, generator=generator, dtype=torch.float32,
                               device=device).mul_(INIT_SCALE)
        u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
        if init == "ssm_a":
            return torch.log(u * 15.0 + 1.0)
        if init == "ssm_dt":
            u = u * (1e-1 - 1e-3) + 1e-3
            return u + torch.log(-torch.expm1(-u))
        raise ValueError(init)

    def make(leaf, stacked: bool) -> torch.Tensor:
        shape, init, dtype = leaf
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=device)
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=device)
        out = torch.empty(shape, dtype=dtype, device=device)
        for part in (out.unbind(0) if stacked else [out]):
            part.copy_(draw(part.shape, init))
        return out

    def walk(tree: dict, stacked: bool) -> dict:
        return {
            k: walk(v, stacked or k == "stack") if isinstance(v, dict) else make(v, stacked)
            for k, v in tree.items()
        }

    return walk(param_shapes(cfg), False)


class Model:
    """Prefill / decode over a parameter tree for one config: a period-1
    stack of attention layers (with MLPs) or of Mamba-2 layers."""

    def __init__(self, cfg: ModelConfig, kernel_mode: str = "auto"):
        if cfg.family == "hybrid" or cfg.moe.enabled:
            raise ValueError(f"{cfg.name}: the port runs period-1 attention or SSM stacks "
                             "without MoE only")
        if cfg.family != "ssm" and cfg.n_heads == 0:
            raise ValueError(f"{cfg.name}: an attention stack without heads")
        if cfg.frontend != "none":
            raise ValueError(f"{cfg.name}: the port takes token inputs only")
        self.cfg = cfg
        self.kernel_mode = kernel_mode
        self.mixer = stack_lib.layer_kinds(cfg)[0].mixer
        # identity block tables of the dense decode caches, built once per
        # (batch, max_len, device) and checked then, never re-checked per step
        self._block_tables: dict[tuple, torch.Tensor] = {}

    def prefill_fn(self, params: dict, tokens: torch.Tensor, max_len: int | None = None):
        """tokens (b, s) -> (last-position logits (b, 1, V) f32, decode cache):
        the (k, v) pair of an attention stack, the SSM dict of an SSM stack."""
        b, s = tokens.shape
        x = embed_apply(params["embed"], tokens)
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        cache = self.init_cache(b, max_len if max_len is not None else s, tokens.device)
        h = stack_lib.forward_full(params, x, positions, self.cfg, self.kernel_mode, cache)
        h = norm_apply(params["final_ln"], h, self.cfg)
        return unembed_apply(params["embed"], h[:, -1:]), cache

    def decode_fn(self, params: dict, cache, tokens: torch.Tensor, pos: torch.Tensor):
        """tokens, pos (b,) -> logits (b, V) f32; updates ``cache`` in place."""
        x = embed_apply(params["embed"], tokens[:, None])
        table = None
        if self.mixer == "attn":
            b, max_len = cache[0].shape[1], cache[0].shape[2]
            key = (b, max_len, cache[0].device)
            if key not in self._block_tables:
                self._block_tables[key] = stack_lib.identity_block_table(
                    b, max_len, cache[0].device)
            table = self._block_tables[key]
        h = stack_lib.decode_step_stack(params, cache, x, pos, self.cfg,
                                        self.kernel_mode, table)
        h = norm_apply(params["final_ln"], h, self.cfg)
        return unembed_apply(params["embed"], h)[:, 0]

    def init_cache(self, batch: int, max_len: int, device):
        """Zeros: the (k, v) pair (L, b, max_len, hkv, hd) of an attention
        stack; for an SSM stack ``state`` (L, b, nh, n, hp) f32 and ``conv``
        (L, b, d_conv - 1, conv_dim) in the model dtype (max_len unused)."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        if self.mixer == "ssm":
            _, nh, conv_dim = ssm_dims(cfg)
            ssm = cfg.ssm
            return {
                "state": torch.zeros((cfg.n_layers, batch, nh, ssm.d_state, ssm.head_dim),
                                     dtype=torch.float32, device=device),
                "conv": torch.zeros((cfg.n_layers, batch, ssm.d_conv - 1, conv_dim),
                                    dtype=dtype, device=device),
            }
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))
