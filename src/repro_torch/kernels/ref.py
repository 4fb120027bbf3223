"""Plain PyTorch versions of the kernels on the serving and training paths.

Each ``*_ref`` mirrors ``repro.kernels.ref`` (signature and arithmetic) and
is the numerics ground truth: the dispatcher in ``ops.py`` runs it for
tensors that lie on the CPU, the CPU tests hold it against the JAX oracle,
and ``chip_smoke.py`` holds each CUDA kernel against it on the card.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def dequant(kv: torch.Tensor) -> torch.Tensor:
    """An fp8 cache dequantized to bf16 at the attention boundary (JAX's
    ``_dequant``, ``repro/models/attention.py:352-357``); every e4m3 value,
    NaN included, is exact in bf16. Other dtypes pass."""
    if kv.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return kv.to(torch.bfloat16)
    return kv


def flash_attention_ref(
    q: torch.Tensor,  # (b, sq, hq, d)
    k: torch.Tensor,  # (b, skv, hkv, d)
    v: torch.Tensor,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    b, sq, hq, d = q.shape
    p = torch.softmax(_scores(q, k, causal, q_offset), dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, sq, hq, d).to(q.dtype)


def _scores(q, k, causal: bool, q_offset: int = 0) -> torch.Tensor:
    """The scaled, masked f32 scores (b, hkv, g, sq, skv) of the forward."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    qg = q.reshape(b, sq, hkv, hq // hkv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * (1.0 / math.sqrt(d))
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)
        kpos = torch.arange(skv, device=q.device)
        s = s.masked_fill(~(qpos[:, None] >= kpos[None, :]), NEG_INF)
    return s


def flash_attention_lse_ref(q, k, v, causal: bool = True):
    """``flash_attention_ref``'s output and each row's log-sum-exp of the
    scaled, masked scores, (b, hq, sq) f32 in natural log: what the
    forward kernel stores for the backward."""
    b, sq, hq, _ = q.shape
    lse = torch.logsumexp(_scores(q, k, causal), dim=-1)  # (b, hkv, g, sq)
    return flash_attention_ref(q, k, v, causal=causal), lse.reshape(b, hq, sq)


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal: bool = True):
    """The gradients (dq, dk, dv) of ``flash_attention_ref`` at output
    gradient ``do``, as the backward kernels compute them: P recomputed from
    q, k and the forward's ``lse``, D = rowsum(dO * O), dV = P^T dO,
    dS = P * (dO V^T - D), dQ = dS K * scale, dK = dS^T Q * scale, dK and dV
    summed over each GQA group. f32 math, outputs in the input dtype."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    s = _scores(q, k, causal)  # (b, hkv, g, sq, skv)
    p = torch.exp(s - lse.float().reshape(b, hkv, g, sq, 1))
    dog = do.float().reshape(b, sq, hkv, g, d)
    delta = (dog * o.float().reshape(b, sq, hkv, g, d)).sum(-1)  # (b, sq, hkv, g)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, q.float().reshape(b, sq, hkv, g, d)) * scale
    return dq.reshape(b, sq, hq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def kv_gather_write_ref(
    k_cache: torch.Tensor,  # (L, T, hkv, hd) dense per-layer cache
    v_cache: torch.Tensor,
    slot_ids: torch.Tensor,  # (n_blocks,) block-aligned slot index
    block_tokens: int,
) -> torch.Tensor:
    """Returns the pool payload (n_blocks, 2L, block_tokens, hkv, hd)."""
    L, T, hkv, hd = k_cache.shape
    n_slots = T // block_tokens
    kc = k_cache.reshape(L, n_slots, block_tokens, hkv, hd)[:, slot_ids]
    vc = v_cache.reshape(L, n_slots, block_tokens, hkv, hd)[:, slot_ids]
    # (L, n, bt, ...) x2 -> (n, L, 2, bt, ...): fragments [k0, v0, k1, v1, ...]
    kv = torch.stack([kc, vc], dim=2).transpose(0, 1)
    return kv.reshape(len(slot_ids), 2 * L, block_tokens, hkv, hd)


def kv_scatter_read_ref(
    pool_blocks: torch.Tensor,  # (n_blocks, 2L, bt, hkv, hd)
    slot_ids: torch.Tensor,  # (n_blocks,) destination slots
    k_cache: torch.Tensor,  # (L, T, hkv, hd) to scatter into
    v_cache: torch.Tensor,
    block_tokens: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Copies block i into slot ``slot_ids[i]`` of fresh copies of the caches."""
    n_blocks, two_l, bt, hkv, hd = pool_blocks.shape
    L = two_l // 2
    kv = pool_blocks.reshape(n_blocks, L, 2, bt, hkv, hd)
    n_slots = k_cache.shape[1] // block_tokens
    k_out = k_cache.clone().reshape(L, n_slots, bt, hkv, hd)
    v_out = v_cache.clone().reshape(L, n_slots, bt, hkv, hd)
    k_out[:, slot_ids] = kv[:, :, 0].transpose(0, 1).to(k_out.dtype)
    v_out[:, slot_ids] = kv[:, :, 1].transpose(0, 1).to(v_out.dtype)
    return k_out.reshape(k_cache.shape), v_out.reshape(v_cache.shape)


def paged_attention_ref(
    q: torch.Tensor,  # (b, hq, d)
    k_blocks: torch.Tensor,  # (n_blocks, bt, hkv, d)
    v_blocks: torch.Tensor,
    block_table: torch.Tensor,  # (b, max_blocks) int, -1 padded
    context_lens: torch.Tensor,  # (b,) int
    return_lse: bool = False,
):
    """Decode attention through a block table (``ref.py:53-78``).

    The JAX pool ``kv_pool`` (n, 2, bt, hkv, d) is ``k_blocks = kv_pool[:, 0]``,
    ``v_blocks = kv_pool[:, 1]``. Departs from the JAX oracle in one place: a
    row with ``context_lens == 0`` gives zeros, as the Pallas kernel does
    (``paged_attention.py:79-82``); the oracle averages the clamped table's
    rows instead.

    K/V in ``float8_e4m3fn`` (an fp8 cache) follow JAX's decode after
    ``_dequant`` (``repro/models/attention.py:221-245``) for a q of any
    dtype: K and V in bf16, q * scale formed in q's dtype and rounded to
    bf16 once, P rounded to bf16 before P.V; f32 accumulation, the output
    in q's dtype.

    With ``return_lse``, also each head's natural log-sum-exp of its scaled
    scores, (b, hq) f32, and -inf where the context is 0, so that such a
    row weighs exactly 0 in a merge of shards.
    """
    b, hq, d = q.shape
    _, bt, hkv, _ = k_blocks.shape
    max_blocks = block_table.shape[1]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    fp8 = k_blocks.dtype == torch.float8_e4m3fn
    k_blocks, v_blocks = dequant(k_blocks), dequant(v_blocks)
    tbl = block_table.clamp(min=0).long()
    k = k_blocks[tbl].reshape(b, max_blocks * bt, hkv, d)
    v = v_blocks[tbl].reshape(b, max_blocks * bt, hkv, d)
    pos = torch.arange(max_blocks * bt, device=q.device)
    valid = pos[None, :] < context_lens.reshape(-1, 1).to(q.device)
    qg = (q * scale).reshape(b, hkv, g, d)  # rounded to q's dtype, as in JAX
    if fp8:
        qg = qg.to(torch.bfloat16)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k.float())
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    if fp8:
        p = p.to(torch.bfloat16).float()
    o = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    empty = (context_lens.to(q.device) <= 0).reshape(b, 1, 1, 1)
    o = o.masked_fill(empty, 0.0).reshape(b, hq, d).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.logsumexp(s, dim=-1).masked_fill(empty[..., 0], -math.inf)
    return o, lse.reshape(b, hq)


NAN_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def sparse_kv_gather_ref(
    kv: torch.Tensor,  # (N, hkv, hd) token-major pool view
    token_ids,  # (n_sel,) ints
) -> torch.Tensor:
    """Rows ``token_ids`` of ``kv``, as the JAX oracle's ``jnp.take``
    (``ref.py:135``): an id in [-N, 0) wraps to id + N, any other id out of
    [0, N) gives a row of NaN, no ids give ``(0, hkv, hd)``. The Pallas
    kernel clamps out-of-range ids instead; the oracle is the contract."""
    if kv.dtype not in NAN_DTYPES:
        raise TypeError(f"sparse_kv_gather takes {NAN_DTYPES}, got {kv.dtype} (the oracle "
                        "fills an integer dtype's out-of-range rows with INT_MIN)")
    ids = torch.as_tensor(token_ids, device=kv.device).long().reshape(-1)
    n = kv.shape[0]
    valid = (ids >= -n) & (ids < n)
    rows = kv.index_select(0, torch.where(ids < 0, ids + n, ids).clamp(0, max(n - 1, 0)))
    mask = valid.reshape(-1, *[1] * (kv.dim() - 1))
    return torch.where(mask, rows, torch.full((), math.nan, dtype=kv.dtype, device=kv.device))


def ssd_chunk_ref(
    x: torch.Tensor,  # (nb, Lc, nh, hp) dt-scaled inputs
    a_log: torch.Tensor,  # (nb, Lc, nh) per-step log decay
    b_mat: torch.Tensor,  # (nb, Lc, g, n), g dividing nh (g == nh: per head)
    c_mat: torch.Tensor,
    return_cum: bool = False,
):
    """Mamba-2 intra-chunk SSD over nb tiles (``ref.py:147-169``, batched as
    ``ops.py:95`` vmaps it). Head h reads group ``h // (nh // g)`` of B and C.
    Returns (y_intra (nb, Lc, nh, hp) f32, chunk states (nb, nh, n, hp) f32),
    and with ``return_cum`` also cum (nb, Lc, nh) f32, the prefix sums of
    a_log over each chunk.

    Departs from the JAX oracle in its gradient only: the decay takes ``exp``
    of causal pairs alone (the log-decay difference filled with -inf above
    the diagonal), as the CUDA kernels do. The oracle's
    ``where(causal, exp(seg), 0)`` gives the same values, but above the
    diagonal ``seg`` is positive and its ``exp`` overflows to inf once it
    passes about 88 (a 64-step chunk at a = -2 already does), and its
    gradient is 0 * inf = NaN there."""
    nb, lc, nh, _ = x.shape
    rep = nh // b_mat.shape[2]
    bh = b_mat.float().repeat_interleave(rep, dim=2)  # (nb, Lc, nh, n)
    ch = c_mat.float().repeat_interleave(rep, dim=2)
    xf = x.float()
    cum = torch.cumsum(a_log.float(), dim=1)  # (nb, Lc, nh)
    decay = _causal_decay(cum)
    scores = torch.einsum("zlhn,zmhn->zlmh", ch, bh)
    y = torch.einsum("zlmh,zmhp->zlhp", scores * decay, xf)
    decay_to_end = torch.exp(cum[:, -1:, :] - cum)  # (nb, Lc, nh)
    state = torch.einsum("zlhn,zlh,zlhp->zhnp", bh, decay_to_end, xf)
    return (y, state, cum) if return_cum else (y, state)


def _causal_decay(cum: torch.Tensor) -> torch.Tensor:
    """exp(cum_l - cum_m) on causal pairs m <= l, exactly 0 elsewhere, with
    a zero gradient there: (nb, Lc, Lc, nh) from cum (nb, Lc, nh)."""
    lc = cum.shape[1]
    seg = cum[:, :, None, :] - cum[:, None, :, :]  # (nb, Lc, Lc, nh)
    li = torch.arange(lc, device=cum.device)
    causal = (li[:, None] >= li[None, :])[None, :, :, None]
    return torch.exp(seg.masked_fill(~causal, -math.inf))


def ssd_chunk_bwd_ref(x, a_log, b_mat, c_mat, dy, dst, dcum=None):
    """The gradients of ``ssd_chunk_ref(..., return_cum=True)`` at output
    cotangents dy (nb, Lc, nh, hp), dst (nb, nh, n, hp) and dcum (nb, Lc, nh)
    (None: zero), written out as the CUDA backward computes them. With
    L_lm = exp(cum_l - cum_m) and G_lm = C_l . B_m on causal pairs m <= l,
    M = G * L, dM_lm = dy_l . x_m and w_m = exp(cum_last - cum_m):

        dx_m = sum_{l >= m} M_lm dy_l + w_m dst^T B_m
        dC_l = sum_{m <= l} dM_lm L_lm B_m     (over the group's heads)
        dB_m = sum_{l >= m} dM_lm L_lm C_l + w_m dst x_m   (likewise)
        u_m = w_m B_m^T dst x_m
        dcum_j += rowsum_j(dM * M) - colsum_j(dM * M) - u_j + [j = last] sum_m u_m
        da_k = sum_{l >= k} dcum_l

    Arithmetic in float32, or in x's dtype where that is wider (float64);
    -> (dx, da, dB, dC), dB and dC group-shaped (nb, Lc, g, n) in that
    dtype too (the kernel rounds them once to B's dtype)."""
    ct = torch.promote_types(x.dtype, torch.float32)
    nb, lc, nh, hp = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    rep = nh // g
    xf, dyf, dstf = x.to(ct), dy.to(ct), dst.to(ct)
    bg, cg = b_mat.to(ct), c_mat.to(ct)
    bh, ch = bg.repeat_interleave(rep, dim=2), cg.repeat_interleave(rep, dim=2)
    cum = torch.cumsum(a_log.to(ct), dim=1)
    decay = _causal_decay(cum)  # L, (nb, l, m, nh)
    m_ = torch.einsum("zlhn,zmhn->zlmh", ch, bh) * decay
    dm = torch.einsum("zlhp,zmhp->zlmh", dyf, xf)  # used only times L or M
    dg = (dm * decay).reshape(nb, lc, lc, g, rep).sum(-1)  # summed over each group
    w = torch.exp(cum[:, -1:, :] - cum)  # (nb, Lc, nh)
    xs = w[..., None] * torch.einsum("zmhn,zhnp->zmhp", bh, dstf)  # w_m dst^T B_m
    dx = torch.einsum("zlmh,zlhp->zmhp", m_, dyf) + xs
    u = (xf * xs).sum(-1)
    r = dm * m_
    d = r.sum(2) - r.sum(1) - u
    d[:, -1] += u.sum(1)
    if dcum is not None:
        d = d + dcum.to(ct)
    da = d.flip(1).cumsum(1).flip(1)
    dc = torch.einsum("zlmg,zmgn->zlgn", dg, bg)
    bst = torch.einsum("zmh,zhnp,zmhp->zmhn", w, dstf, xf).reshape(nb, lc, g, rep, n).sum(3)
    db = torch.einsum("zlmg,zlgn->zmgn", dg, cg) + bst
    return dx, da, db, dc
