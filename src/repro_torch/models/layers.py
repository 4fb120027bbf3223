"""Shared layers: norms, rotary embeddings, MLPs, embeddings.

Twin of ``repro/models/layers.py``. Parameters are plain dicts of tensors
with the JAX package's names and layouts, so a tree converted from JAX
(``repro_torch.convert``) is used as it is.

Under a mesh (``rules`` given) a function takes this rank's shards, with
the FSDP dims already gathered (``sharding.gather_tree``): the MLP
is column-parallel on ``wi_*`` and row-parallel on ``wo``; the embedding
table and the head are vocab-sharded over ``model``, so a lookup is a
masked local lookup summed over ``model`` and the logits come out
vocab-sharded (``gather_vocab`` makes them whole).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import ParamSpec


def rms_norm(x: torch.Tensor, w: torch.Tensor | None, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    if w is not None:
        x = x * w.float()
    return x.to(dtype)


def act_fn(name: str):
    # JAX's gelu defaults to the tanh approximation
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (..., seq) -> (cos, sin), each (..., seq, 1, head_dim/2) f32.

    Computed once per forward and shared by every layer's q and k (JAX
    recomputes them inside ``apply_rope`` and XLA folds the repeats)."""
    angles = positions[..., None].float() * rope_freqs(head_dim, theta, positions.device)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x: torch.Tensor, rope: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); rope: ``rope_tables`` of its positions."""
    cos, sin = rope
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_param_specs(cfg: ModelConfig, d_ff: int, dtype: torch.dtype) -> dict:
    """One SwiGLU/GeGLU MLP of width ``d_ff`` (``repro/models/layers.py:59-72``)."""
    d = cfg.d_model
    p = {
        "wi_gate": ParamSpec((d, d_ff), dtype, ("embed", "mlp")),
        "wi_up": ParamSpec((d, d_ff), dtype, ("embed", "mlp")),
        "wo": ParamSpec((d_ff, d), dtype, ("mlp", "embed")),
    }
    if cfg.mlp_bias:
        p |= {
            "bi_gate": ParamSpec((d_ff,), dtype, ("mlp",), init="zeros"),
            "bi_up": ParamSpec((d_ff,), dtype, ("mlp",), init="zeros"),
            "bo": ParamSpec((d,), dtype, ("norm",), init="zeros"),
        }
    return p


def embed_param_specs(cfg: ModelConfig, tp: int, dtype: torch.dtype) -> dict:
    """The embedding table and, untied, the head, at the tp-padded vocab
    (``repro/models/layers.py:102-108``)."""
    v = cfg.padded_vocab_tp(tp)
    p = {"table": ParamSpec((v, cfg.d_model), dtype, ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        p["head"] = ParamSpec((cfg.d_model, v), dtype, ("embed", "vocab"))
    return p


def norm_param_specs(cfg: ModelConfig, dtype: torch.dtype) -> dict:
    if cfg.nonparametric_ln:
        return {}
    return {"w": ParamSpec((cfg.d_model,), dtype, ("norm",), init="ones")}


def mlp_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, rules=None) -> torch.Tensor:
    g = x @ p["wi_gate"]
    u = x @ p["wi_up"]
    if "bi_gate" in p:
        g = g + p["bi_gate"]
        u = u + p["bi_up"]
    h = act_fn(cfg.act)(g) * u
    out = coll.row_parallel_matmul(h, p["wo"], rules) if rules is not None else h @ p["wo"]
    if "bo" in p:
        out = out + p["bo"]
    return out


def embed_apply(p: dict, tokens: torch.Tensor, rules=None) -> torch.Tensor:
    table = p["table"]
    if rules is None or rules.tp == 1:
        return table[tokens]
    # this rank's rows of the vocab: a masked local lookup, summed over model
    n = table.shape[0]
    local = tokens - rules.mesh.axis_index("model") * n
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    rows = torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                              device=rows.device))
    return coll.all_reduce(rows, rules.mesh, "model")


def unembed_apply(p: dict, x: torch.Tensor, rules=None) -> torch.Tensor:
    """f32 logits; under ``rules`` this rank's vocab shard of them."""
    head = p["head"] if "head" in p else p["table"].T
    return (x @ head.to(x.dtype)).float()


def gather_vocab(logits: torch.Tensor, rules) -> torch.Tensor:
    """Vocab-sharded logits made whole over ``model``."""
    return coll.all_gather(logits, logits.dim() - 1, rules.mesh, "model")


def sharded_log_softmax_pick(logits: torch.Tensor, targets: torch.Tensor, rules):
    """-> (logsumexp over the whole vocab, the target's logit), both (...,)
    f32, from vocab-sharded logits: a max and a sum of exponentials over
    ``model``, and the target's logit from the shard that holds it. The
    (..., V) logits are never gathered."""
    mesh, n = rules.mesh, logits.shape[-1]
    m = coll.all_reduce(logits.amax(-1), mesh, "model", op="max")
    se = coll.all_reduce(torch.exp(logits - m[..., None]).sum(-1), mesh, "model")
    local = targets - mesh.axis_index("model") * n
    inside = (local >= 0) & (local < n)
    picked = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    picked = coll.all_reduce(torch.where(inside, picked, 0.0), mesh, "model")
    return m + torch.log(se), picked


def norm_apply(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return rms_norm(x, p.get("w"), cfg.norm_eps)
