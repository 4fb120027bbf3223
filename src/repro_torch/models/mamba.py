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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import rms_norm


def ssm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """-> (d_inner, n_heads, conv_dim)."""
    ssm = cfg.ssm
    di = ssm.d_inner(cfg.d_model)
    nh = ssm.n_heads(cfg.d_model)
    return di, nh, di + 2 * ssm.n_groups * ssm.d_state


def mamba_param_shapes(cfg: ModelConfig, lead: tuple[int, ...], dtype: torch.dtype) -> dict:
    """One mixer's (shape, init, dtype) leaves (``mamba.py:32-52``), each
    shape prefixed by ``lead`` (the stacked layer axis)."""
    d, ssm = cfg.d_model, cfg.ssm
    di, nh, _ = ssm_dims(cfg)
    gn, ker = ssm.n_groups * ssm.d_state, ssm.d_conv
    f32 = torch.float32
    return {
        "wz": ((*lead, d, di), "normal", dtype),
        "wx": ((*lead, d, di), "normal", dtype),
        "wBC": ((*lead, d, 2 * gn), "normal", dtype),
        "wdt": ((*lead, d, nh), "normal", dtype),
        "conv_x": ((*lead, ker, di), "normal", dtype),
        "conv_BC": ((*lead, ker, 2 * gn), "normal", dtype),
        "conv_bias_x": ((*lead, di), "zeros", dtype),
        "conv_bias_BC": ((*lead, 2 * gn), "zeros", dtype),
        "A_log": ((*lead, nh), "ssm_a", f32),
        "D": ((*lead, nh), "ones", f32),
        "dt_bias": ((*lead, nh), "ssm_dt", f32),
        "norm_w": ((*lead, di), "ones", dtype),
        "out": ((*lead, di, d), "normal", dtype),
    }


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
                return_state: bool = False):
    """Full-sequence SSD pass (prefill). x: (b, s, d). With ``return_state``
    also returns the final SSM state (b, nh, n, hp) f32 and the decode conv
    window, the last d_conv - 1 pre-conv inputs (b, d_conv - 1, conv_dim)."""
    ssm = cfg.ssm
    di, nh, _ = ssm_dims(cfg)
    g, n, hp = ssm.n_groups, ssm.d_state, ssm.head_dim
    bsz, s, _ = x.shape

    z = x @ p["wz"]  # (b, s, di)
    xi = x @ p["wx"]
    bc = x @ p["wBC"]  # (b, s, 2gn)
    dt_raw = x @ p["wdt"]  # (b, s, nh)
    if return_state:
        # the window _causal_conv sees: zeros before the first token, so a
        # prompt shorter than d_conv - 1 still leaves d_conv - 1 rows
        pre = F.pad(torch.cat([xi, bc], dim=-1), (0, 0, ssm.d_conv - 1, 0))
        conv_tail = pre[:, s:]

    xi = F.silu(_causal_conv(xi, p["conv_x"], p["conv_bias_x"]))
    bc = F.silu(_causal_conv(bc, p["conv_BC"], p["conv_bias_BC"]))
    b_mat = bc[..., : g * n].reshape(bsz, s, g, n)
    c_mat = bc[..., g * n:].reshape(bsz, s, g, n)

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
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    out = y @ p["out"]
    if return_state:
        return out, final_state, conv_tail
    return out


def mamba_decode(p: dict, x: torch.Tensor, state: torch.Tensor,
                 conv_state: torch.Tensor, cfg: ModelConfig):
    """One-token recurrent step. x: (b, 1, d); state (b, nh, n, hp) f32;
    conv_state (b, d_conv - 1, conv_dim). Returns (out (b, 1, d), new state,
    new conv window)."""
    ssm = cfg.ssm
    di, nh, _ = ssm_dims(cfg)
    g, n, hp = ssm.n_groups, ssm.d_state, ssm.head_dim
    bsz = x.shape[0]
    xt = x[:, 0]  # (b, d)

    z = xt @ p["wz"]
    xi = xt @ p["wx"]
    bc = xt @ p["wBC"]
    dt_raw = xt @ p["wdt"]

    # the conv over the cached window
    xbc = torch.cat([xi, bc], dim=-1)  # (b, conv_dim)
    window = torch.cat([conv_state, xbc[:, None, :]], dim=1)  # (b, k, conv_dim)
    w_full = torch.cat([p["conv_x"], p["conv_BC"]], dim=1)  # (k, conv_dim)
    bias_full = torch.cat([p["conv_bias_x"], p["conv_bias_BC"]], dim=0)
    conv_out = (window.float() * w_full[None].float()).sum(dim=1) + bias_full.float()
    conv_out = F.silu(conv_out)

    xi = conv_out[:, :di]
    bc = conv_out[:, di:]
    rep = nh // g
    b_h = bc[:, : g * n].reshape(bsz, g, n).repeat_interleave(rep, dim=1)  # (b, nh, n)
    c_h = bc[:, g * n:].reshape(bsz, g, n).repeat_interleave(rep, dim=1)

    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # (b, nh)
    decay = torch.exp(dt * -torch.exp(p["A_log"]))

    xh = xi.reshape(bsz, nh, hp).float()
    new_state = state * decay[..., None, None] + (b_h * dt[..., None])[..., None] * xh[:, :, None]
    y = (c_h[:, :, None] @ new_state)[:, :, 0]  # (b, nh, hp)
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(bsz, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return (y @ p["out"])[:, None, :], new_state, window[:, 1:]
