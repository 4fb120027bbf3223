"""Mixture-of-Experts feed-forward: top-k routing, capacity, dispatch.

Twin of ``repro/models/moe.py`` on one device: top-k routing (llama4-maverick
top-1, arctic and jamba top-2), the capacity-factor token dropping, the
GShard one-hot einsum dispatch (``"einsum"``, the JAX default) and the
scatter-based ragged dispatch (``"ragged"``), and Arctic's dense residual MLP
beside the experts. ``"a2a"`` behaves as JAX's does without a device mesh
(``rules=None``): its condition (``moe.py:56-61``) fails and the ragged path
runs (``:75-78``). The expert products are batched matrix products that
JAX computes outside any Pallas kernel, so they stay ``torch.bmm`` here.

Under a mesh (``rules`` given) the experts are sharded over ``model`` and
the router is whole on every rank. The einsum and ragged dispatches take
each (token, k) pair's capacity slot over the global batch (the choices
gathered over ``data``), run the rank's local experts on its own tokens'
pairs and sum the partial outputs over ``model``. ``"a2a"`` under JAX's
condition is ``_a2a_dispatch`` (``moe.py:142-276``): the tokens are
sequence-sharded over ``model``, each rank routes its share, packs the
pairs per destination rank up to ``cap_pair`` and per local expert up to
``cap_e``, and two all-to-alls carry the rows out and back.

Casts follow JAX point for point: the router runs on ``x`` in float32, the
softmax and the top-k renormalisation stay float32, the combine weights are
cast to the expert dtype before the combine, ragged's weights multiply in
the expert dtype and its k contributions are added in that dtype in (token,
k) order, and the output is cast to ``x``'s dtype.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import ParamSpec
from repro_torch.models.layers import act_fn, mlp_apply, mlp_param_specs

DISPATCHES = ("einsum", "ragged", "a2a")


def one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot``'s int64 result for ids in [0, n), zero rows elsewhere
    (``jax.nn.one_hot``'s), dispatched as the same ops on every device:
    ``F.one_hot`` checks its ids on the host on the CPU, scatters on the
    card and compares on ``meta``, so a dry run would count other ops than
    the card runs."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def moe_param_specs(cfg: ModelConfig, dtype: torch.dtype) -> dict:
    """One MoE FFN (``moe.py:23-34``): the router in float32, the experts'
    stacked SwiGLU weights in the model dtype, and Arctic's dense residual MLP."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    p = {
        "router": ParamSpec((d, e), torch.float32, ("embed", "experts")),
        "wi_gate": ParamSpec((e, d, f), dtype, ("experts", "embed", "expert_mlp")),
        "wi_up": ParamSpec((e, d, f), dtype, ("experts", "embed", "expert_mlp")),
        "wo": ParamSpec((e, f, d), dtype, ("experts", "expert_mlp", "embed")),
    }
    if cfg.moe.dense_residual:
        p["dense"] = mlp_param_specs(cfg, cfg.moe.dense_residual_ff, dtype)
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


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, dispatch: str = "einsum",
              rules=None, batch_axes: tuple[str, ...] | None = None):
    """x (b, s, d) -> (out (b, s, d) in x's dtype, aux) (``moe.py:43-90``).

    aux holds tensors on x's device, none read back to the host:
    ``load_balance_loss`` as JAX computes it (serving ignores it), and what
    the port adds for monitoring: ``dropped``, the (token, k) pairs over
    their expert's capacity; ``margin``, the smallest gap between a token's
    k-th and (k+1)-th router probability (0 when k is all experts); the
    router's ``probs`` (t, e), its choices ``top_e`` (t, k) and which of
    them kept a slot, ``kept`` (t, k).

    Under ``rules`` x holds this rank's batch rows (replicated over
    ``model``), its batch sharded over ``batch_axes`` (default: the rules'
    batch axes; () when every rank holds the whole batch); the aux stats
    are of the global batch, except ``margin``, ``probs``, ``top_e`` and
    ``kept``, which are of the rank's rows.
    """
    if dispatch not in DISPATCHES:
        raise ValueError(f"moe_dispatch {dispatch!r} not in {DISPATCHES}")
    if rules is not None:
        if batch_axes is None:
            batch_axes = rules.batch_axes
        return _moe_sharded(p, x, cfg, dispatch, rules, tuple(batch_axes))
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
    onehot = one_hot(top_e, e)  # (t, k, e)
    pos_in_e = (onehot.reshape(t * k, e).cumsum(0) - 1).reshape(t, k, e)
    pos = (pos_in_e * onehot).sum(-1)  # (t, k)
    keep = pos < cap
    w = torch.where(keep, top_w, 0.0)

    # jax.nn.one_hot gives a zero row where pos >= cap; F.one_hot raises
    e_hot = onehot.float()
    c_hot = one_hot(torch.where(keep, pos, 0), cap).float() * keep[..., None]
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
    onehot = one_hot(flat_e, e)  # (t*k, e)
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


# ---------------------------------------------------------------------------
# Under a mesh
# ---------------------------------------------------------------------------


def _a2a_applies(b: int, s: int, rules) -> bool:
    """JAX's condition for the all-to-all dispatch (``moe.py:56-61``), on
    the global batch b: enough tokens per shard to fill the buffers."""
    dp, tp = max(rules.dp, 1), rules.tp
    return s % tp == 0 and (b // dp if b >= dp else b) * (s // tp) >= 16


def _moe_sharded(p, x, cfg, dispatch, rules, batch_axes):
    b_loc, s, d = x.shape
    moe, mesh = cfg.moe, rules.mesh
    k, e = moe.top_k, moe.n_experts
    b = b_loc * mesh.axis_size(batch_axes)
    router = coll.all_gather(p["router"], 1, mesh, "model")  # whole on every rank
    if dispatch == "a2a" and _a2a_applies(b, s, rules):
        out, aux = _a2a_dispatch(p, x, router, cfg, rules, batch_axes)
    else:
        xt = x.reshape(b_loc * s, d)
        probs, top_w, top_e, ranked = route(router, xt, k)
        out, kept = _local_experts(p, xt, top_w, top_e, cfg, rules, batch_axes,
                                   einsum=dispatch == "einsum")
        out = out.reshape(b_loc, s, d).to(x.dtype)
        t = b * s
        me = coll.all_reduce(probs.sum(0), mesh, batch_axes) / t
        ce = coll.all_reduce(torch.zeros_like(me).index_add_(
            0, top_e.reshape(-1), torch.ones(top_e.numel(), dtype=torch.float32,
                                             device=x.device)), mesh, batch_axes) / (t * k)
        dropped = coll.all_reduce((~kept).sum().float(), mesh, batch_axes)
        margin = (ranked[:, k - 1] - ranked[:, k]).min() if k < e else probs.new_zeros(())
        aux = {"load_balance_loss": e * torch.sum(me * ce), "dropped": dropped,
               "margin": margin, "probs": probs, "top_e": top_e, "kept": kept}
    if moe.dense_residual:
        out = out + mlp_apply(p["dense"], x, cfg, rules)
    return out, aux


def _local_experts(p, xt, top_w, top_e, cfg, rules, batch_axes, einsum: bool):
    """The einsum (GShard) or ragged dispatch on this rank's experts ->
    (the rank's tokens' outputs (t_loc, d) in the expert dtype, summed over
    ``model``; kept (t_loc, k)). Each pair's slot in its expert's capacity
    counts the pairs before it in the global batch, as on one device."""
    mesh = rules.mesh
    t_loc, d = xt.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    all_e = coll.all_gather(top_e, 0, mesh, batch_axes)  # (t, k), global token order
    t = all_e.shape[0]
    cap = capacity(t, cfg)
    onehot = one_hot(all_e.reshape(-1), e)  # (t*k, e)
    pos = ((onehot.cumsum(0) - 1) * onehot).sum(-1).reshape(t, k)
    first = mesh.axis_index(batch_axes) * t_loc if batch_axes else 0
    pos = pos[first: first + t_loc]  # this rank's tokens
    keep = pos < cap
    e_loc = p["wi_gate"].shape[0]
    e0 = mesh.axis_index("model") * e_loc
    local = keep & (top_e >= e0) & (top_e < e0 + e_loc)
    le = (top_e - e0).clamp(0, e_loc - 1)
    w = torch.where(local, top_w, 0.0)
    if einsum:
        e_hot = one_hot(le, e_loc).float() * local[..., None]
        c_hot = one_hot(torch.where(local, pos, 0), cap).float() * local[..., None]
        disp = torch.einsum("tke,tkc->tec", e_hot, c_hot)
        comb = torch.einsum("tke,tkc->tec", one_hot(le, e_loc).float() * w[..., None], c_hot)
        xin = torch.einsum("tec,td->ecd", disp.to(xt.dtype), xt)
        eo = _experts(p, xin, cfg)
        part = torch.einsum("tec,ecd->td", comb.to(eo.dtype).float(), eo.float())
    else:
        flat_le, flat_pos = le.reshape(-1), torch.where(local, pos, cap - 1).reshape(-1)
        flat_tok = torch.arange(t_loc, device=xt.device).repeat_interleave(k)
        xin = torch.zeros((e_loc, cap, d), dtype=xt.dtype, device=xt.device)
        xin.index_put_((flat_le, flat_pos),
                       xt[flat_tok] * local.reshape(-1, 1).to(xt.dtype), accumulate=True)
        eo = _experts(p, xin, cfg)
        picked = eo[flat_le, flat_pos] * w.reshape(-1, 1).to(eo.dtype)
        part = picked.float().reshape(t_loc, k, d).sum(1)
    out = coll.all_reduce(part, mesh, "model").to(eo.dtype)
    return out, keep


def _round4(x: int) -> int:
    return max(4, -(-x // 4) * 4)


def a2a_capacities(b: int, s: int, cfg: ModelConfig, rules) -> tuple[int, int]:
    """(cap_pair, cap_e): the rows a rank sends each destination, and the
    rows each local expert takes (``moe.py:173-186``), for a global batch
    of b sequences of s tokens."""
    moe, tp, dp = cfg.moe, rules.tp, rules.dp
    e_loc = moe.n_experts // tp
    t_shard = (b // dp if b >= dp else b) * (s // tp)
    cap_pair = _round4(int(moe.capacity_factor * moe.top_k * max(t_shard, 1) / tp))
    rows = tp * cap_pair
    return cap_pair, rows if e_loc == 1 else _round4(int(1.25 * rows / e_loc))


def _a2a_dispatch(p, x, router, cfg, rules, batch_axes):
    """The all-to-all expert parallelism of ``moe.py:142-276`` on this rank:
    its batch rows' sequence shard of tokens is routed, packed per
    destination and per local expert, sent out, computed and sent back;
    -> (out (b_loc, s, d) in x's dtype, its sequence gathered over
    ``model``; aux)."""
    mesh, tp, moe = rules.mesh, rules.tp, cfg.moe
    e, k, d = moe.n_experts, moe.top_k, cfg.d_model
    e_loc = e // tp
    b_loc, s, _ = x.shape
    b = b_loc * mesh.axis_size(batch_axes)
    cap_pair, cap_e = a2a_capacities(b, s, cfg, rules)
    sl = s // tp
    x_loc = x[:, mesh.axis_index("model") * sl:][:, :sl]
    tl = b_loc * sl
    xt = x_loc.reshape(tl, d)
    probs, top_w, top_e, _ = route(router, xt, k)

    flat_e, flat_w = top_e.reshape(-1), top_w.reshape(-1)
    flat_tok = torch.arange(tl, device=x.device).repeat_interleave(k)
    dest, leid = flat_e // e_loc, flat_e % e_loc
    onehot_d = one_hot(dest, tp)
    pos = ((onehot_d.cumsum(0) - 1) * onehot_d).sum(-1)
    keep = pos < cap_pair
    pos = torch.where(keep, pos, cap_pair - 1)
    w = torch.where(keep, flat_w, 0.0)
    send_x = torch.zeros((tp, cap_pair, d), dtype=x.dtype, device=x.device)
    send_x.index_put_((dest, pos), xt[flat_tok] * keep[:, None].to(xt.dtype), accumulate=True)
    # a dropped pair shares the last slot with the pair that kept it: the
    # kept pair's expert id wins (JAX's .set leaves the order unspecified)
    send_eid = torch.full((tp * cap_pair,), e_loc, dtype=torch.int64, device=x.device)
    send_eid.scatter_reduce_(0, dest * cap_pair + pos, torch.where(keep, leid, e_loc), "amin")
    send_eid = send_eid.reshape(tp, cap_pair)

    # the forward all-to-all over model
    rows_x = coll.all_to_all(send_x, mesh).reshape(tp * cap_pair, d)
    rows_e = coll.all_to_all(send_eid, mesh).reshape(tp * cap_pair)
    valid = rows_e < e_loc

    # pack the rows by local expert
    onehot_e = one_hot(torch.where(valid, rows_e, e_loc), e_loc + 1)[:, :e_loc]
    pos_e = ((onehot_e.cumsum(0) - 1) * onehot_e).sum(-1)
    keep_e = valid & (pos_e < cap_e)
    pos_e = torch.where(keep_e, pos_e, cap_e - 1)
    eidx = torch.where(valid, rows_e, 0)
    xin = torch.zeros((e_loc, cap_e, d), dtype=rows_x.dtype, device=x.device)
    xin.index_put_((eidx, pos_e), rows_x * keep_e[:, None].to(rows_x.dtype), accumulate=True)
    eo = _experts(p, xin, cfg)
    y_send = (eo[eidx, pos_e] * keep_e[:, None].to(eo.dtype)).reshape(tp, cap_pair, d)

    # the return all-to-all
    y_recv = coll.all_to_all(y_send, mesh)
    picked = (y_recv[dest, pos] * w[:, None].to(y_recv.dtype)).reshape(tl, k, d)
    out = torch.zeros((tl, d), dtype=y_recv.dtype, device=x.device)
    for j in range(k):  # .at[flat_tok].add, in (token, k) order
        out = out + picked[:, j]
    out = out.reshape(b_loc, sl, d).to(x.dtype)

    me = probs.mean(0)
    ce = torch.zeros((e,), dtype=torch.float32, device=x.device).index_add_(
        0, flat_e, torch.ones_like(flat_w)) / max(tl * k, 1)
    lb_axes = tuple(batch_axes) + ("model",)
    lb = coll.all_reduce(e * torch.sum(me * ce), mesh, lb_axes) / mesh.axis_size(lb_axes)
    dropped = coll.all_reduce(((~keep).sum() + (valid & ~keep_e).sum()).float(), mesh,
                              lb_axes)
    # every token's choices in the rank's batch order: (b_loc, s, k)
    top_e_all = coll.all_gather(top_e.reshape(b_loc, sl, k), 1, mesh, "model")
    aux = {"load_balance_loss": lb, "dropped": dropped,
           "top_e": top_e_all.reshape(b_loc * s, k)}
    return coll.all_gather(out, 1, mesh, "model"), aux
