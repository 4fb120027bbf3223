"""Mamba-2 (SSD, state-space duality) mixer: chunked prefill and decode step.

Twin of ``repro/models/mamba.py`` for one device:
  h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t x_t^T ;  y_t = C_t h_t + D x_t
computed chunkwise. The intra-chunk term, the chunk-final states and the
chunks' prefix sums of the log decay go through ``ops.ssd_chunk`` (the CUDA
kernel on the card) on (b * n_chunks) tiles with B and C kept
group-shaped; the inter-chunk recurrence over the
chunks and its contribution stay plain PyTorch, as the TPU kernel's own
docstring splits them, with a loop over the chunks where JAX runs
``associative_scan``.

Under a mesh (``rules`` given) the inner width is sharded over ``model``
(Megatron-Mamba, as JAX's ``ssm_inner`` rule): z, x and dt projections,
``conv_x``, the heads' ``A_log``, ``D`` and ``dt_bias``, ``norm_w`` and the
rows of ``out`` hold this rank's heads; B and C (``wBC``, ``conv_BC``) are
whole on every rank. ``ssd_chunk`` runs on the rank's heads. The gated
RMSNorm normalises over the whole d_inner, so its mean square is a sum over
``model``; ``out`` is row-parallel. The decode state is sharded by head and
the conv window is whole on every rank (``cache_specs``), its x columns
gathered as they arrive.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import ParamSpec
from repro_torch.kernels import ops
from repro_torch.models.layers import rms_norm


def ssm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """-> (d_inner, n_heads, conv_dim)."""
    ssm = cfg.ssm
    di = ssm.d_inner(cfg.d_model)
    nh = ssm.n_heads(cfg.d_model)
    return di, nh, di + 2 * ssm.n_groups * ssm.d_state


def mamba_param_specs(cfg: ModelConfig, dtype: torch.dtype) -> dict:
    """One mixer's leaves (``mamba.py:32-52``): A_log, D and dt_bias in f32."""
    d, ssm = cfg.d_model, cfg.ssm
    di, nh, _ = ssm_dims(cfg)
    gn, ker = ssm.n_groups * ssm.d_state, ssm.d_conv
    f32 = torch.float32
    inner, emb = ("embed", "ssm_inner"), ("embed", "conv_dim")
    return {
        "wz": ParamSpec((d, di), dtype, inner),
        "wx": ParamSpec((d, di), dtype, inner),
        "wBC": ParamSpec((d, 2 * gn), dtype, emb),
        "wdt": ParamSpec((d, nh), dtype, inner),
        "conv_x": ParamSpec((ker, di), dtype, (None, "ssm_inner")),
        "conv_BC": ParamSpec((ker, 2 * gn), dtype, (None, "conv_dim")),
        "conv_bias_x": ParamSpec((di,), dtype, ("ssm_inner",), init="zeros"),
        "conv_bias_BC": ParamSpec((2 * gn,), dtype, ("conv_dim",), init="zeros"),
        "A_log": ParamSpec((nh,), f32, ("ssm_inner",), init="ssm_a"),
        "D": ParamSpec((nh,), f32, ("ssm_inner",), init="ones"),
        "dt_bias": ParamSpec((nh,), f32, ("ssm_inner",), init="ssm_dt"),
        "norm_w": ParamSpec((di,), dtype, ("ssm_inner",), init="ones"),
        "out": ParamSpec((di, d), dtype, ("ssm_inner", "embed")),
    }


def _local_groups(bc: torch.Tensor, cfg: ModelConfig, rules, nh_local: int) -> torch.Tensor:
    """B or C (..., g, n) -> the groups this rank's heads read: all of them
    at one group, else the run of groups its heads cover."""
    g = bc.shape[-2]
    if rules is None or g == 1:
        return bc
    per = cfg.ssm.n_heads(cfg.d_model) // g  # heads a group
    if nh_local % per:
        raise ValueError(f"{cfg.name}: {nh_local} heads a rank split the groups of {per} heads")
    first = rules.mesh.axis_index("model") * nh_local // per
    return bc[..., first: first + nh_local // per, :]


def _gated_norm(y, z, w, cfg: ModelConfig, rules):
    """rms_norm(y * silu(z)) over the whole d_inner; under ``rules`` y, z
    and w hold this rank's columns and the mean square is summed over
    ``model``."""
    if rules is None or rules.tp == 1:
        return rms_norm(y * F.silu(z), w, cfg.norm_eps)
    x = y * F.silu(z)
    xf = x.float()
    ss = coll.all_reduce(xf.square().sum(-1, keepdim=True), rules.mesh, "model")
    var = ss / (x.shape[-1] * rules.tp)
    return (xf * torch.rsqrt(var + cfg.norm_eps) * w.float()).to(x.dtype)


def _out(y, w, rules):
    return coll.row_parallel_matmul(y, w, rules) if rules is not None else y @ w


def _causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv as a sum of shifted slices. x: (b, s, c); w: (k, c)."""
    k, s = w.shape[0], x.shape[1]
    xp, wf = F.pad(x, (0, 0, k - 1, 0)).float(), w.float()
    out = xp[:, :s] * wf[0]  # summed in JAX's order, from the first tap
    for i in range(1, k):
        out += xp[:, i : i + s] * wf[i]
    return (out + bias.float()).to(x.dtype)


def _ssd_chunked(x, a_log, b_mat, c_mat, chunk: int, mode: str = "auto"):
    """Chunked SSD.

    x: (b, s, nh, hp) f32, already multiplied by dt; a_log: (b, s, nh) log
    decay per step (dt * A, <= 0); b_mat, c_mat: (b, s, g, n).
    Returns y (b, s, nh, hp) f32 and the final state (b, nh, n, hp) f32.
    """
    bsz, s_in, nh, hp = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    s = -(-s_in // chunk) * chunk
    if s != s_in:
        # zero dt-scaled inputs and zero log-decay (a = 1): the padded tail
        # neither contributes to nor decays the running state
        pad = (0, 0, 0, 0, 0, s - s_in)
        x, b_mat, c_mat = F.pad(x, pad), F.pad(b_mat, pad), F.pad(c_mat, pad)
        a_log = F.pad(a_log, (0, 0, 0, s - s_in))
    nc = s // chunk
    ar = a_log.float().reshape(bsz * nc, chunk, nh)
    y_intra, states, cum = ops.ssd_chunk(
        x.reshape(bsz * nc, chunk, nh, hp).contiguous(), ar.contiguous(),
        b_mat.reshape(bsz * nc, chunk, g, n), c_mat.reshape(bsz * nc, chunk, g, n),
        return_cum=True, mode=mode,
    )
    states = states.reshape(bsz, nc, nh, n, hp)
    cum = cum.reshape(bsz, nc, chunk, nh)  # the kernel's prefix sums of a_log

    # inter-chunk recurrence: the state entering chunk z is the running
    # state after chunk z - 1
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (b, nc, nh)
    prev = torch.empty_like(states)
    run = torch.zeros_like(states[:, 0])
    for z in range(nc):
        prev[:, z] = run
        run = run * chunk_decay[:, z, :, None, None] + states[:, z]

    # inter-chunk contribution: C_l . prev, decayed from the chunk start
    rep = nh // g
    cr = c_mat.reshape(bsz, nc, chunk, g, n).float()
    y_inter = torch.einsum(
        "bzlgn,bzgrnp->bzlgrp", cr, prev.reshape(bsz, nc, g, rep, n, hp)
    ).reshape(bsz, nc, chunk, nh, hp)
    y_inter = y_inter * torch.exp(cum)[..., None]
    y = y_intra.reshape(bsz, nc, chunk, nh, hp) + y_inter
    return y.reshape(bsz, s, nh, hp)[:, :s_in], run


def mamba_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, mode: str = "auto",
                return_state: bool = False, rules=None):
    """Full-sequence SSD pass (prefill). x: (b, s, d). With ``return_state``
    also returns the final SSM state (b, nh, n, hp) f32 and the decode conv
    window, the last d_conv - 1 pre-conv inputs (b, d_conv - 1, conv_dim).
    Under ``rules``, nh and d_inner are this rank's (the state's heads; the
    conv window stays whole)."""
    ssm = cfg.ssm
    g, n, hp = ssm.n_groups, ssm.d_state, ssm.head_dim
    di, nh = p["wx"].shape[-1], p["wdt"].shape[-1]  # this rank's under rules
    bsz, s, _ = x.shape

    z = x @ p["wz"]  # (b, s, di)
    xi = x @ p["wx"]
    bc = x @ p["wBC"]  # (b, s, 2gn)
    dt_raw = x @ p["wdt"]  # (b, s, nh)
    if return_state:
        # the window _causal_conv sees: zeros before the first token, so a
        # prompt shorter than d_conv - 1 still leaves d_conv - 1 rows
        xi_all = coll.all_gather(xi, 2, rules.mesh, "model") if rules is not None else xi
        pre = F.pad(torch.cat([xi_all, bc], dim=-1), (0, 0, ssm.d_conv - 1, 0))
        conv_tail = pre[:, s:]

    xi = F.silu(_causal_conv(xi, p["conv_x"], p["conv_bias_x"]))
    bc = F.silu(_causal_conv(bc, p["conv_BC"], p["conv_bias_BC"]))
    b_mat = _local_groups(bc[..., : g * n].reshape(bsz, s, g, n), cfg, rules, nh)
    c_mat = _local_groups(bc[..., g * n:].reshape(bsz, s, g, n), cfg, rules, nh)

    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # (b, s, nh)
    a_log_step = dt * -torch.exp(p["A_log"])  # (b, s, nh), <= 0

    xh = xi.reshape(bsz, s, nh, hp)
    y, final_state = _ssd_chunked(
        xh.float() * dt[..., None], a_log_step, b_mat, c_mat,
        chunk=min(ssm.chunk_size, s), mode=mode,
    )
    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(bsz, s, di).to(x.dtype)

    # gated RMSNorm, then the out projection
    out = _out(_gated_norm(y, z, p["norm_w"], cfg, rules), p["out"], rules)
    if return_state:
        return out, final_state, conv_tail
    return out


def mamba_decode(p: dict, x: torch.Tensor, state: torch.Tensor,
                 conv_state: torch.Tensor, cfg: ModelConfig, rules=None):
    """One-token recurrent step. x: (b, 1, d); state (b, nh, n, hp) f32;
    conv_state (b, d_conv - 1, conv_dim). Returns (out (b, 1, d), new state,
    new conv window). Under ``rules`` nh and the state are this rank's and
    the conv window whole."""
    ssm = cfg.ssm
    g, n, hp = ssm.n_groups, ssm.d_state, ssm.head_dim
    di, nh = p["wx"].shape[-1], p["wdt"].shape[-1]
    bsz = x.shape[0]
    xt = x[:, 0]  # (b, d)

    z = xt @ p["wz"]
    xi = xt @ p["wx"]
    bc = xt @ p["wBC"]
    dt_raw = xt @ p["wdt"]

    # the conv over the cached window (whole on every rank: its x columns
    # arrive from every rank's shard)
    xi_all = coll.all_gather(xi, 1, rules.mesh, "model") if rules is not None else xi
    window = torch.cat([conv_state, torch.cat([xi_all, bc], dim=-1)[:, None, :]], dim=1)
    x0 = rules.mesh.axis_index("model") * di if rules is not None else 0
    di_all = xi_all.shape[-1]
    # this rank's x columns and the B/C columns (b, k, di + 2gn)
    mine = torch.cat([window[..., x0: x0 + di], window[..., di_all:]], dim=-1)
    w_full = torch.cat([p["conv_x"], p["conv_BC"]], dim=1)  # (k, di + 2gn)
    bias_full = torch.cat([p["conv_bias_x"], p["conv_bias_BC"]], dim=0)
    conv_out = (mine.float() * w_full[None].float()).sum(dim=1) + bias_full.float()
    conv_out = F.silu(conv_out)

    xi = conv_out[:, :di]
    bc = conv_out[:, di:]
    b_h = _local_groups(bc[:, : g * n].reshape(bsz, g, n), cfg, rules, nh)
    c_h = _local_groups(bc[:, g * n:].reshape(bsz, g, n), cfg, rules, nh)
    rep = nh // b_h.shape[1]
    b_h = b_h.repeat_interleave(rep, dim=1)  # (b, nh, n)
    c_h = c_h.repeat_interleave(rep, dim=1)

    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # (b, nh)
    decay = torch.exp(dt * -torch.exp(p["A_log"]))

    xh = xi.reshape(bsz, nh, hp).float()
    new_state = state * decay[..., None, None] + (b_h * dt[..., None])[..., None] * xh[:, :, None]
    y = (c_h[:, :, None] @ new_state)[:, :, 0]  # (b, nh, hp)
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(bsz, di).to(x.dtype)
    y = _gated_norm(y, z, p["norm_w"], cfg, rules)
    return _out(y, p["out"], rules)[:, None, :], new_state, window[:, 1:]
