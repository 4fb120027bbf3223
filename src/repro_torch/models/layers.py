"""Shared layers: norms, rotary embeddings, MLPs, embeddings.

Twin of ``repro/models/layers.py``. Parameters are plain dicts of tensors
with the JAX package's names and layouts, so a tree converted from JAX
(``repro_torch.convert``) is used as it is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


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


def mlp_param_shapes(cfg: ModelConfig, d_ff: int, lead: tuple[int, ...],
                     dtype: torch.dtype) -> dict:
    """One SwiGLU/GeGLU MLP of width ``d_ff`` as (shape, init, dtype) leaves
    (``repro/models/layers.py:59-72``), each shape prefixed by ``lead``."""
    d = cfg.d_model
    p = {
        "wi_gate": ((*lead, d, d_ff), "normal", dtype),
        "wi_up": ((*lead, d, d_ff), "normal", dtype),
        "wo": ((*lead, d_ff, d), "normal", dtype),
    }
    if cfg.mlp_bias:
        p |= {
            "bi_gate": ((*lead, d_ff), "zeros", dtype),
            "bi_up": ((*lead, d_ff), "zeros", dtype),
            "bo": ((*lead, d), "zeros", dtype),
        }
    return p


def mlp_apply(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    g = x @ p["wi_gate"]
    u = x @ p["wi_up"]
    if "bi_gate" in p:
        g = g + p["bi_gate"]
        u = u + p["bi_up"]
    out = (act_fn(cfg.act)(g) * u) @ p["wo"]
    if "bo" in p:
        out = out + p["bo"]
    return out


def embed_apply(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def unembed_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    head = p["head"] if "head" in p else p["table"].T
    return (x @ head.to(x.dtype)).float()


def norm_apply(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return rms_norm(x, p.get("w"), cfg.norm_eps)
