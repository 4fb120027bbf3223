"""Public model API: parameter init, prefill, decode, cache construction.

Twin of ``repro/models/model.py`` for token-input stacks on one device:
attention with MLPs (llama, olmo, qwen) or with MoE FFNs (arctic,
llama4-maverick), Mamba-2 (ssm), and the hybrid period of attention,
Mamba-2, MLP and MoE positions (jamba). The parameter tree has the JAX
package's names, shapes, layouts and leaf dtypes (``param_shapes``), so
weights converted from a JAX ``Model.init`` tree are used as they are, and
``init_params`` follows the JAX init rules: normal(0, 1) * 0.02 drawn in
f32 and cast (the MoE router stays f32), norms and ``D`` at ones, biases at
zeros, and the SSM's ``A_log`` and ``dt_bias`` rules.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as stack_lib
from repro_torch.models.layers import embed_apply, mlp_param_shapes, norm_apply, unembed_apply
from repro_torch.models.mamba import mamba_param_shapes, ssm_dims
from repro_torch.models.moe import DISPATCHES, moe_param_shapes

INIT_SCALE = 0.02


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def param_shapes(cfg: ModelConfig) -> dict:
    """Tree of (shape, init, dtype) leaves, init in {"normal", "ones",
    "zeros", "ssm_a", "ssm_dt"}; dtype the model's, but float32 for the
    SSM's ``A_log``, ``D`` and ``dt_bias`` and the MoE router. The stack has
    one subtree per position of the period, ``pos_<i>``, each leaf with a
    leading n_periods dimension (``repro/models/transformer.py:84-108``)."""
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv, vocab = cfg.n_heads, cfg.n_kv_heads, cfg.padded_vocab
    dt = torch_dtype(cfg.dtype)
    lead = (stack_lib.n_periods(cfg),)

    def norm(*dims):
        return {} if cfg.nonparametric_ln else {"w": ((*dims, d), "ones", dt)}

    def position(kind) -> dict:
        layer = {"ln1": norm(*lead)}
        if kind.mixer == "ssm":
            layer["ssm"] = mamba_param_shapes(cfg, lead, dt)
        else:
            layer["attn"] = {
                "wq": ((*lead, d, hq, hd), "normal", dt),
                "wk": ((*lead, d, hkv * hd), "normal", dt),
                "wv": ((*lead, d, hkv * hd), "normal", dt),
                "wo": ((*lead, hq, hd, d), "normal", dt),
            }
            if cfg.qkv_bias:
                layer["attn"] |= {
                    "bq": ((*lead, hq, hd), "zeros", dt),
                    "bk": ((*lead, hkv * hd), "zeros", dt),
                    "bv": ((*lead, hkv * hd), "zeros", dt),
                }
            if cfg.attn_out_bias:
                layer["attn"]["bo"] = ((*lead, d), "zeros", dt)
        if kind.ffn != "none":
            layer["ln2"] = norm(*lead)
            if kind.ffn == "moe":
                layer["moe"] = moe_param_shapes(cfg, lead, dt)
            else:
                layer["mlp"] = mlp_param_shapes(cfg, cfg.d_ff, lead, dt)
        return layer

    embed = {"table": ((vocab, d), "normal", dt)}
    if not cfg.tie_embeddings:
        embed["head"] = ((d, vocab), "normal", dt)
    stack = {f"pos_{i}": position(kind) for i, kind in enumerate(stack_lib.layer_kinds(cfg))}
    return {"embed": embed, "stack": stack, "final_ln": norm()}


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """Random parameters on ``device``; ``generator`` must live there too.

    Stacked leaves are drawn one layer at a time and stacked expert leaves
    one (layer, expert) at a time, so the f32 draw never holds more than one
    layer of one tensor, or one expert of it (all 128 experts of one Arctic
    layer's tensor would be 17.8 GB of f32). ``ssm_a``: log of uniform [1,
    16]; ``ssm_dt``: the inverse softplus of uniform [1e-3, 1e-1]
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

    def make(leaf, split: int) -> torch.Tensor:
        shape, init, dtype = leaf
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=device)
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=device)
        out = torch.empty(shape, dtype=dtype, device=device)
        for part in out.view(-1, *shape[split:]).unbind(0):
            part.copy_(draw(part.shape, init))
        return out

    def walk(tree: dict, split: int, path: str) -> dict:
        """``split``: the leading dims drawn one index at a time."""
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, max(split, int(k == "stack")), f"{path}/{k}")
            else:
                expert = path.endswith("/moe") and k != "router"
                out[k] = make(v, split + expert)
        return out

    return walk(param_shapes(cfg), 0, "")


class Model:
    """Prefill / decode over a parameter tree for one config: a period-1
    stack of attention layers (with MLP or MoE FFNs) or of Mamba-2 layers,
    or a hybrid period (Jamba).

    ``moe_dispatch`` is ``RuntimeConfig.moe_dispatch`` (``"einsum"``, the
    default, ``"ragged"`` or ``"a2a"``); on one device ``"a2a"`` runs the
    ragged dispatch, as JAX does without a mesh (``models/moe.py``).
    """

    def __init__(self, cfg: ModelConfig, kernel_mode: str = "auto",
                 moe_dispatch: str = "einsum"):
        if cfg.family != "ssm" and cfg.n_heads == 0:
            raise ValueError(f"{cfg.name}: an attention stack without heads")
        if cfg.frontend != "none":
            raise ValueError(f"{cfg.name}: the port takes token inputs only")
        if moe_dispatch not in DISPATCHES:
            raise ValueError(f"moe_dispatch {moe_dispatch!r} not in {DISPATCHES}")
        self.cfg = cfg
        self.kernel_mode = kernel_mode
        self.moe_dispatch = moe_dispatch
        self.kinds = stack_lib.layer_kinds(cfg)
        # identity block tables of the dense decode caches, built once per
        # (batch, max_len, device) and checked then, never re-checked per
        # step; every attention position of a hybrid shares its table
        self._block_tables: dict[tuple, torch.Tensor] = {}

    def prefill_fn(self, params: dict, tokens: torch.Tensor, max_len: int | None = None,
                   aux: list | None = None):
        """tokens (b, s) -> (last-position logits (b, 1, V) f32, decode cache):
        the (k, v) pair of an attention stack, the SSM dict of an SSM stack,
        the per-position tree of a hybrid (``init_cache``). ``aux``, if
        given, receives each MoE layer's aux dict (``moe.moe_apply``)."""
        b, s = tokens.shape
        x = embed_apply(params["embed"], tokens)
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        cache = self.init_cache(b, max_len if max_len is not None else s, tokens.device)
        h = stack_lib.forward_full(params, x, positions, self.cfg, self.kernel_mode, cache,
                                   self.moe_dispatch, aux)
        h = norm_apply(params["final_ln"], h, self.cfg)
        return unembed_apply(params["embed"], h[:, -1:]), cache

    def decode_fn(self, params: dict, cache, tokens: torch.Tensor, pos: torch.Tensor,
                  aux: list | None = None):
        """tokens, pos (b,) -> logits (b, V) f32; updates ``cache`` in place.
        ``aux`` as in ``prefill_fn``."""
        x = embed_apply(params["embed"], tokens[:, None])
        table = None
        attn = [c for c, kind in zip(stack_lib.position_caches(cache, self.kinds), self.kinds)
                if kind.mixer == "attn"]
        if attn:
            kc = attn[0]["k"]
            key = (kc.shape[1], kc.shape[2], kc.device)
            if key not in self._block_tables:
                self._block_tables[key] = stack_lib.identity_block_table(*key)
            table = self._block_tables[key]
        h = stack_lib.decode_step_stack(params, cache, x, pos, self.cfg,
                                        self.kernel_mode, table, self.moe_dispatch, aux)
        h = norm_apply(params["final_ln"], h, self.cfg)
        return unembed_apply(params["embed"], h)[:, 0]

    def init_cache(self, batch: int, max_len: int, device):
        """Zeros. Per position, {"k", "v"} (n_periods, b, max_len, hkv, hd)
        in the model dtype at attention, {"state" (n_periods, b, nh, n, hp)
        f32, "conv" (n_periods, b, d_conv - 1, conv_dim) in the model dtype}
        at SSM positions (``repro/models/transformer.py:116-160``). A period-1
        attention stack returns its position's (k, v) pair, a period-1 SSM
        stack its dict; a hybrid the tree {"pos_<i>": ...}."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        n = stack_lib.n_periods(cfg)

        def position(kind) -> dict:
            if kind.mixer == "attn":
                shape = (n, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
                return {"k": torch.zeros(shape, dtype=dtype, device=device),
                        "v": torch.zeros(shape, dtype=dtype, device=device)}
            _, nh, conv_dim = ssm_dims(cfg)
            ssm = cfg.ssm
            return {
                "state": torch.zeros((n, batch, nh, ssm.d_state, ssm.head_dim),
                                     dtype=torch.float32, device=device),
                "conv": torch.zeros((n, batch, ssm.d_conv - 1, conv_dim),
                                    dtype=dtype, device=device),
            }

        if len(self.kinds) > 1:
            return {f"pos_{i}": position(kind) for i, kind in enumerate(self.kinds)}
        only = position(self.kinds[0])
        return (only["k"], only["v"]) if self.kinds[0].mixer == "attn" else only
