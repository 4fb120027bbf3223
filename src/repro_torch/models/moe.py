"""Mixture-of-Experts feed-forward: top-k routing, capacity, dispatch.

Twin of ``repro/models/moe.py`` on one device: top-k routing (llama4-maverick
top-1, arctic and jamba top-2), the capacity-factor token dropping, the
GShard one-hot einsum dispatch (``"einsum"``, the JAX default) and the
scatter-based ragged dispatch (``"ragged"``), and Arctic's dense residual MLP
beside the experts. ``"a2a"`` behaves as JAX's does without a device mesh
(``rules=None``): its condition (``moe.py:56-61``) fails and the ragged path
runs (``:75-78``); the shard_map all-to-all itself waits for the distributed
port. The expert products are batched matrix products that JAX computes
outside any Pallas kernel, so they stay ``torch.bmm`` here.

Casts follow JAX point for point: the router runs on ``x`` in float32, the
softmax and the top-k renormalisation stay float32, the combine weights are
cast to the expert dtype before the combine, ragged's weights multiply in
the expert dtype and its k contributions are added in that dtype in (token,
k) order, and the output is cast to ``x``'s dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import act_fn, mlp_apply, mlp_param_shapes

DISPATCHES = ("einsum", "ragged", "a2a")


def moe_param_shapes(cfg: ModelConfig, lead: tuple[int, ...], dtype: torch.dtype) -> dict:
    """(shape, init, dtype) leaves of one MoE FFN (``moe.py:23-34``), each
    shape prefixed by ``lead``: the router in float32, the experts' stacked
    SwiGLU weights in the model dtype, and Arctic's dense residual MLP."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    p = {
        "router": ((*lead, d, e), "normal", torch.float32),
        "wi_gate": ((*lead, e, d, f), "normal", dtype),
        "wi_up": ((*lead, e, d, f), "normal", dtype),
        "wo": ((*lead, e, f, d), "normal", dtype),
    }
    if cfg.moe.dense_residual:
        p["dense"] = mlp_param_shapes(cfg, cfg.moe.dense_residual_ff, lead, dtype)
    return p


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert (``moe.py:37-40``): the same Python float arithmetic,
    rounded up to a multiple of 4, at least 4."""
    moe = cfg.moe
    cap = int(moe.capacity_factor * moe.top_k * n_tokens / moe.n_experts)
    return max(4, -(-cap // 4) * 4)


def route(router: torch.Tensor, xt: torch.Tensor, top_k: int):
    """xt (t, d) -> (probs (t, e), top_w (t, k), top_e (t, k), sorted probs
    (t, e)), all float32 but the int64 expert ids. ``jax.lax.top_k`` puts the
    lower index first on equal values, and ``torch.topk`` does not promise
    an order on ties, so the choice is a stable descending sort's first k."""
    probs = torch.softmax(xt.float() @ router, dim=-1)
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = ranked[:, :top_k], order[:, :top_k]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_w, top_e, ranked


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, dispatch: str = "einsum"):
    """x (b, s, d) -> (out (b, s, d) in x's dtype, aux) (``moe.py:43-90``).

    aux holds tensors on x's device, none read back to the host:
    ``load_balance_loss`` as JAX computes it (serving ignores it), and what
    the port adds for monitoring: ``dropped``, the (token, k) pairs over
    their expert's capacity; ``margin``, the smallest gap between a token's
    k-th and (k+1)-th router probability (0 when k is all experts); the
    router's ``probs`` (t, e), its choices ``top_e`` (t, k) and which of
    them kept a slot, ``kept`` (t, k).
    """
    if dispatch not in DISPATCHES:
        raise ValueError(f"moe_dispatch {dispatch!r} not in {DISPATCHES}")
    b, s, d = x.shape
    moe = cfg.moe
    t, k, e = b * s, moe.top_k, moe.n_experts
    xt = x.reshape(t, d)
    probs, top_w, top_e, ranked = route(p["router"], xt, k)
    expert = _einsum_dispatch if dispatch == "einsum" else _ragged_dispatch
    out, kept = expert(p, xt, top_w, top_e, cfg)
    out = out.reshape(b, s, d).to(x.dtype)
    if moe.dense_residual:
        out = out + mlp_apply(p["dense"], x, cfg)

    me = probs.mean(dim=0)
    ce = torch.zeros_like(me).index_add_(
        0, top_e.reshape(-1), torch.ones(t * k, dtype=torch.float32, device=x.device)
    ) / (t * k)
    margin = (ranked[:, k - 1] - ranked[:, k]).min() if k < e else probs.new_zeros(())
    aux = {"load_balance_loss": e * torch.sum(me * ce), "dropped": (~kept).sum().float(),
           "margin": margin, "probs": probs, "top_e": top_e, "kept": kept}
    return out, aux


def _experts(p: dict, xin: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(e, cap, d) rows through each expert's SwiGLU -> (e, cap, d)."""
    h = act_fn(cfg.act)(torch.bmm(xin, p["wi_gate"])) * torch.bmm(xin, p["wi_up"])
    return torch.bmm(h, p["wo"])


def _einsum_dispatch(p, xt, top_w, top_e, cfg):
    """GShard-style dense dispatch with capacity-factor token dropping
    (``moe.py:93-135``) -> (out (t, d) in the expert dtype, kept (t, k))."""
    t, _ = xt.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    cap = capacity(t, cfg)

    # position of each (token, k) within its expert's capacity
    onehot = F.one_hot(top_e, e)  # (t, k, e)
    pos_in_e = (onehot.reshape(t * k, e).cumsum(0) - 1).reshape(t, k, e)
    pos = (pos_in_e * onehot).sum(-1)  # (t, k)
    keep = pos < cap
    w = torch.where(keep, top_w, 0.0)

    # jax.nn.one_hot gives a zero row where pos >= cap; F.one_hot raises
    e_hot = onehot.float()
    c_hot = F.one_hot(torch.where(keep, pos, 0), cap).float() * keep[..., None]
    disp = torch.einsum("tke,tkc->tec", e_hot * keep[..., None], c_hot)
    comb = torch.einsum("tke,tkc->tec", e_hot * w[..., None], c_hot)

    xin = torch.einsum("tec,td->ecd", disp.to(xt.dtype), xt)  # (e, cap, d)
    eo = _experts(p, xin, cfg)
    out = torch.einsum("tec,ecd->td", comb.to(eo.dtype), eo)
    return out, keep


def _ragged_dispatch(p, xt, top_w, top_e, cfg):
    """Scatter-based dispatch (``moe.py:279-320``): the (token, k) rows
    scatter-added into the (e, cap, d) expert buffer and gathered back out
    -> (out (t, d) in the expert dtype, kept (t, k))."""
    t, d = xt.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    cap = capacity(t, cfg)

    flat_e = top_e.reshape(-1)  # (t*k,)
    flat_tok = torch.arange(t, device=xt.device).repeat_interleave(k)
    onehot = F.one_hot(flat_e, e)  # (t*k, e)
    pos = ((onehot.cumsum(0) - 1) * onehot).sum(-1)  # (t*k,)
    keep = pos < cap
    pos = torch.where(keep, pos, cap - 1)
    w = torch.where(keep, top_w.reshape(-1), 0.0)

    # a dropped pair adds a zero row onto its expert's last slot, as in JAX
    xin = torch.zeros((e, cap, d), dtype=xt.dtype, device=xt.device)
    xin.index_put_((flat_e, pos), xt[flat_tok] * keep[:, None].to(xt.dtype), accumulate=True)
    eo = _experts(p, xin, cfg)

    picked = (eo[flat_e, pos] * w[:, None].to(eo.dtype)).reshape(t, k, d)
    # .at[flat_tok].add in the expert dtype: from zeros, in (token, k) order
    out = torch.zeros((t, d), dtype=eo.dtype, device=xt.device)
    for j in range(k):
        out = out + picked[:, j]
    return out, keep.reshape(t, k)
