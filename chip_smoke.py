#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each a hard check (any failure exits non-zero):

1. build: compile every ``src/repro_torch/kernels/csrc/*.cu`` with nvcc
   for sm_90a, one nvcc per source, all at once; print ptxas's registers,
   spills and the dynamic shared memory of flash_attention's wgmma kernels,
   and fail unless ``cuobjdump -sass`` of the flash library holds HGMMA
   (tensor cores) and UTMALDG (TMA) instructions; then each paged_attention
   instantiation by name (dtype, head_dim, group) with its registers,
   spills, shared memory and CTAs per SM, failing if the one Llama decode
   runs (bf16, d 128, group 4) spills; then each ssd_chunk instantiation
   (B/C float32, bfloat16) the same way, failing if the bf16 one spills or
   the ssd_chunk library's SASS holds no tensor-core (HMMA) instruction.
2. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the paths give it (Llama-3.1-8B: 32 layers, 8 kv heads,
   head_dim 128; 1024-token prompts = 64 pool blocks; max_len 2048; decode
   at a context of 1040 tokens. Mamba-2 2.7B: chunks of 256, 80 heads of 64,
   d_state 128, prompts of 1024 and 4096 tokens. The sparse gather: the
   16-token reads of phase 6, 8,192 pieces of 256 B from the Llama-3.1-8B
   pool and 16,384 of 160 B from a qwen3-32b pool of 512 blocks, with ids
   -1, -N, N and 2**31 - 1 added, then exp10's top-k read of 4,096 rows of
   1,280 B; the Llama read is also timed replayed from one captured CUDA
   graph, beside the empty kernel on its grid). Gather, scatter and the
   sparse gather (its NaN fill and negative-id wrap included) must be
   bit-exact; flash attention within bf16 2e-2 (tests/test_kernels.py), its wgmma route at
   the main path's shape and at the ragged, GQA and non-causal shapes of
   FLASH_SHAPES, and its CUDA-core route on the main path's inputs;
   paged attention within two bf16 steps at its largest output (also at
   contexts {0, 17, 1040} in one batch, 1 and the full table, with its
   split plan checked: every CTA has work and every cluster is resident,
   and one device kernel per call under torch.profiler), ssd_chunk
   within 1e-4 of its output's scale at 1024 and 4096 tokens (both sides
   get the same inputs, so the limits sit a few times above the readings)
   and its prefix sums within 1e-6 of torch.cumsum's; its bound is the
   larger of its bytes and its operations at the tensor-core peak of their
   type; its human-readable line also prints the same operations over the
   float32 CUDA-core peak, computed, not timed. Each is timed with CUDA events
   against its plain version, its bound and, where one PyTorch call computes
   the same thing, that call (``scaled_dot_product_attention`` for the
   attention kernels, ``index_select`` for the sparse gather; timed only, the
   port never calls them); flash's row also gives the CUDA-core route's time
   on the same inputs and the wgmma route's TFLOP/s.
3. small: a reduced Llama-3.1-8B in float32 served cold and warm on the card
   (kernels) and on the CPU (plain versions) with the same weights, and a
   reduced Mamba-2 2.7B in float32 prefilled and decoded on both; the
   per-step logits must agree within 1e-4; the Llama prefill's flash calls
   (head_dim 16, float32) take the cuda_cores route.
4. main path: full-width Llama-3.1-8B (random weights from a seed, bf16)
   served through ``RealEngine`` (kernels for tensors on the card): two cold
   prompts, two that hit a 512-token shared prefix, two full repeats. Checks
   hit counts, that the cache restored from the pool equals the KV prefill
   wrote bit for bit, that warm logits agree with cold ones and with a
   fresh prefill, and that every kernel of the path was launched during the
   run, paged attention 32 times per decode step and flash attention 32
   times per cold request, all on the wgmma route; then a profiled cold
   request (prefill, writeback, first token) and a profiled window of
   decode steps show where TTFT and a step's time go (the window must hold
   32 paged kernels a step: one launch per layer).
5. Mamba-2 path: full-width mamba2-2.7b (64 layers, bf16, random weights
   from a seed under the JAX init rules): prefill of 1000 and 4095 tokens,
   each followed by 16 greedy decode steps, through ``Model``. Checks finite
   logits, 64 ssd_chunk launches per prefill, the final SSM state against
   the plain path's, and continuity: prefill of 4095 tokens then one decode
   step against a prefill of all 4096, beside the noise floor of the same
   prefill with the plain ssd_chunk, in float32 and in bf16 (see
   CONTINUITY_TOL). Each prefill's wall time is the median of five runs
   after a warm-up, with its spread, outside the counted run and every
   profiler window; then profiled prefills of both prompts and decode.
6. sparse reads: the port's twin of exp10 (Table 6), then of exp09
   (Fig. 14), on the card. exp10: full-width qwen3-32b at depth 1 (layer 0
   is all it reads) selects the top-32 of 256 tokens per query head and
   gathers those rows of K and V in one launch; then 16 sparse tokens per
   (layer, kv head) are read in ONE launch from phase 4's Llama-3.1-8B pool
   (checked against the cold prefill's KV bit for bit) and from a seeded
   qwen3-32b pool of 512 blocks. exp09: one block of each bf16 layout
   written and read back, and the one-launch check. Checks one launch per
   read, bit-exact pieces, finite scores; prints the rows (the fabric rows
   are MODELED by the paper's CXL/RDMA constants, not measured).

Prints the kernel table as one JSON line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Without a GPU it exits non-zero
before doing anything.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.experiments.common import HBM_BYTES_PER_S, cycled_ms, device_ms  # noqa: E402

BF16_FLOP_PER_S = 989e12  # dense tensor-core bf16
FLASH_TOL = 2e-2  # bf16, tests/test_kernels.py:42
# paged attention, bf16: kernel and plain version take the same inputs and
# both accumulate in f32, so they differ only where the two f32 results round
# to neighbouring bf16 values; the limit is two such steps at the largest
# output (about 2e-3 at ctx 1040), far below what a dropped block moves
PAGED_ULPS = 2
# ssd_chunk, relative to the output's scale: the same f32 x and bf16 B/C on
# both sides, f32 accumulation, so only the summation order differs (about
# 1e-5); rounding x to bf16 or to TF32 inside the kernel would read above it
SSD_TOL = 1e-4
F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores
TF32_FLOP_PER_S = 495e12  # dense tensor-core TF32
# ssd_chunk's prefix sums against torch.cumsum of the same a, relative to the
# largest |cum|: a warp's shuffle scan and torch's sum in other orders, 256
# float32 terms at most
CUM_TOL = 1e-6
SMALL_TOL = 1e-4  # float32 reduced model, card vs CPU
# warm vs cold logits at full width, bf16 (logit std about 1.3): the two
# paths round the bf16 residual stream at different points (a 1024-row
# prefill GEMM + flash kernel vs one-token decode over the restored cache)
# through 32 layers, and later steps inherit the difference. Logits of an
# unrelated context differ by about 9 at the max. The run also prints the
# noise floor: the same prefill with the plain attention in place of the
# kernel.
LOGIT_TOL = 0.5
PROMPT, SHARED, MAX_LEN, POOL_BLOCKS, MAX_NEW = 1024, 512, 2048, 512, 16
DECODE_CTX = 1040  # a 1024-token prompt and 16 decode steps
# the wgmma route against the plain version beside the main path's shape:
# (b, sq, skv, hq, hkv, d, causal); d 64 and 128, several K/V tiles, ragged
# lengths, sq != skv under the causal mask, non-causal, b 2, groups 1, 4, 8
FLASH_SHAPES = (
    (1, 2048, 2048, 8, 1, 128, True), (1, 1024, 1024, 8, 8, 64, True),
    (1, 2048, 2048, 16, 2, 64, True), (1, 100, 100, 8, 2, 128, True),
    (2, 200, 200, 16, 2, 64, True), (2, 200, 200, 8, 8, 128, True),
    (1, 37, 80, 4, 1, 128, True), (1, 37, 80, 8, 2, 64, True),
    (1, 64, 300, 8, 2, 64, False), (1, 64, 300, 8, 1, 128, False),
    (2, 1024, 1024, 4, 4, 128, False),
)
# the flash library's SASS must hold tensor-core and TMA instructions
FLASH_SASS = ("HGMMA", "UTMALDG")
# the ssd_chunk library's SASS must hold tensor-core instructions (either)
SSD_SASS = ("HMMA", "HGMMA")
LLAMA_KERNELS = ("kv_gather_write", "kv_scatter_read", "flash_attention", "paged_attention")
MAMBA_PROMPTS, MAMBA_STEPS = (1000, 4095), 16
PREFILL_REPEATS = 5  # timed prefills of each prompt, after one warm-up
# the final SSM state of the kernel path against the plain path's, relative to
# its largest entry: layer 0 sees the same inputs on both paths, so only the
# kernel's f32 summation order differs; deeper layers also inherit bf16
# roundings of the residual stream that flip where the two paths' f32 results
# straddle a rounding boundary
STATE_TOL_L0, STATE_TOL = 1e-4, 5e-2
# continuity, relative to the largest logit (tests/test_models.py:127). In
# float32 the noise floor (the same prefill with the plain ssd_chunk in place
# of the kernel) is about 1e-5, and the limit about ten times that. In bf16
# the 64 layers of random weights amplify any rounding flip, so the floor is
# about 3e-2 already: there continuity is held to twice the floor measured in
# the same run, which a gross bf16-only fault still crosses
CONTINUITY_TOL, CONTINUITY_BF16_FLOORS = 1e-4, 2


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")
    print(f"  ok: {what}", flush=True)


def paged_row(cfg, randn) -> dict:
    """paged_attention as Llama-3.1-8B decode runs it: each layer's dense
    (1, 2048, 8, 128) cache seen as 128 blocks of 16 through the identity
    table, context 1040; then once on one layer of the fused pool layout."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    L, hkv, hd, hq, bt = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads, 16
    n_blk = MAX_LEN // bt
    kc, vc = randn(L, 1, MAX_LEN, hkv, hd), randn(L, 1, MAX_LEN, hkv, hd)
    q = randn(L, 1, hq, hd)
    table = pa.make_block_table([list(range(n_blk))], n_blk, dev)
    ctx = torch.tensor([DECODE_CTX], dtype=torch.int32, device=dev)

    def kernel(i):
        return pa.paged_attention(q[i], pa.dense_blocks(kc[i], bt), pa.dense_blocks(vc[i], bt),
                                  table, ctx)

    def plain(i):
        return ref.paged_attention_ref(q[i], pa.dense_blocks(kc[i], bt),
                                       pa.dense_blocks(vc[i], bt), table, ctx)

    err, tol = bf16_check(torch.stack([kernel(i) for i in range(L)]),
                          torch.stack([plain(i) for i in range(L)]))
    check(err <= tol, f"paged_attention over {L} layers' dense caches, ctx {DECODE_CTX}: "
          f"max |err| {err:.3g} <= {tol:.3g} ({PAGED_ULPS} bf16 steps at the largest output; "
          f"margin {tol / max(err, 1e-30):.3g}x)")
    # layout (ii): one layer of the port's fused pool (n, 2L, bt, hkv, hd),
    # blocks in a shuffled order, read in place
    n_ctx = -(-DECODE_CTX // bt)
    pool = randn(n_ctx, 2 * L, bt, hkv, hd)
    order = torch.randperm(n_ctx, generator=torch.Generator().manual_seed(2)).tolist()
    ptable = pa.make_block_table([order], n_ctx, dev)
    layer = L // 2
    kl, vl = pa.pool_layer(pool, layer)
    perr, ptol = bf16_check(pa.paged_attention(q[0], kl, vl, ptable, ctx),
                            ref.paged_attention_ref(q[0], kl, vl, ptable, ctx))
    check(perr <= ptol, f"paged_attention on layer {layer} of a fused pool "
          f"{tuple(pool.shape)}: max |err| {perr:.3g} <= {ptol:.3g} "
          f"(margin {ptol / max(perr, 1e-30):.3g}x)")
    del pool, kl, vl
    # the split plan's edges on the same caches: a batch of 3 with contexts
    # {0, 17, 1040} (the dense caches of layers 0-2 as three rows), then one
    # row at ctx 1 and at the full table, 2048
    errs = [err, perr]
    rows3 = kc[:3, 0], vc[:3, 0]  # (3, 2048, hkv, hd)
    table3 = pa.make_block_table([[i * n_blk + j for j in range(n_blk)] for i in range(3)],
                                 3 * n_blk, dev)
    for qq, kk, vv, tbl, ctxs in (
            (q[:3, 0], *rows3, table3, [0, 17, DECODE_CTX]),
            (q[0], kc[0], vc[0], table, [1]), (q[0], kc[0], vc[0], table, [MAX_LEN])):
        cl = torch.tensor(ctxs, dtype=torch.int32, device=dev)
        kb, vb = pa.dense_blocks(kk, bt), pa.dense_blocks(vv, bt)
        got = pa.paged_attention(qq, kb, vb, tbl, cl)
        e, t = bf16_check(got, ref.paged_attention_ref(qq, kb, vb, tbl, cl))
        errs.append(e)
        check(e <= t and (ctxs[0] or not got[0].any()),
              f"paged_attention at contexts {ctxs}: max |err| {e:.3g} <= {t:.3g}"
              + (" (the context-0 row all zeros)" if not ctxs[0] else ""))
    del rows3
    splits, per_sm = pa.plan(dev, q.dtype, hd, hq // hkv, 1, hkv, n_blk)
    resident = pa.clusters_resident(dev, q.dtype, hd, hq // hkv, splits)
    idle = splits - len(pa.split_ranges(DECODE_CTX, bt, splits))
    check(resident >= hkv and idle == 0,
          f"paged plan at Llama decode: {splits} splits x {hkv} kv heads = {splits * hkv} CTAs "
          f"in {hkv} clusters ({resident} resident at once), {per_sm} CTAs per SM, {idle} "
          f"without work at ctx {DECODE_CTX}")
    per_call = kernels_per_call(lambda: [kernel(i) for i in range(4)], 4, "paged")
    check(per_call == 1, f"paged_attention is {per_call} device kernel per call "
          "(torch.profiler over 4 calls)")
    moved = (2 * DECODE_CTX * hkv * hd + 2 * hq * hd) * q.element_size()  # K, V rows; q, out
    flops = 4 * hq * DECODE_CTX * hd
    qs = q.unsqueeze(3)  # (L, 1, hq, 1, hd)
    ks, vs = kc[:, :, :DECODE_CTX].transpose(2, 3), vc[:, :, :DECODE_CTX].transpose(2, 3)
    return dict(
        name="paged_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:128", max_abs_err=max(errs),
        splits=splits, ctas_per_sm=per_sm, clusters_resident=resident,
        kernels_per_call=per_call,
        ms=cycled_ms(kernel, range(L)),
        plain_ms=cycled_ms(plain, range(L)),
        bound_ms=max(moved / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S) * 1e3,
        bound_by="bytes" if moved / HBM_BYTES_PER_S >= flops / BF16_FLOP_PER_S else "operations",
        library_ms=cycled_ms(lambda i: F.scaled_dot_product_attention(
            qs[i], ks[i], vs[i], enable_gqa=True), range(L)),
    )


def kernels_per_call(run, calls: int, name: str) -> float:
    """Device kernels per call in a torch.profiler window of ``run`` (which
    makes ``calls`` calls); fails if a kernel without ``name`` in its name
    ran in the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    check(all(name in e.key for e in kernels),
          f"only {name} kernels in the window: {[(e.key[:60], e.count) for e in kernels]}")
    return sum(e.count for e in kernels) / calls


def bf16_check(got, want) -> tuple[float, float]:
    """max |got - want| and the limit: PAGED_ULPS bf16 rounding steps at
    the largest |want| (a step at x is 2**(floor(log2 x) - 7))."""
    import math

    top = want.float().abs().max().item()
    step = 2.0 ** (math.floor(math.log2(top)) - 7)
    return (got.float() - want.float()).abs().max().item(), PAGED_ULPS * step


def ssd_inputs(cfg, seq: int, g):
    """ssd_chunk's inputs as one layer of a seq-token Mamba-2 prefill gives
    them: x and a f32, B and C bf16 slices of one projection, one group."""
    import torch

    ssm = cfg.ssm
    nh, hp, n, lc = ssm.n_heads(cfg.d_model), ssm.head_dim, ssm.d_state, ssm.chunk_size
    nb = seq // lc
    dev = torch.device("cuda")
    x = torch.randn((nb, lc, nh, hp), generator=g, device=dev) * 0.05
    dt = torch.rand((nb, lc, nh), generator=g, device=dev) * 0.1 + 1e-3
    a = -dt * (torch.rand((nh,), generator=g, device=dev) * 15 + 1)  # dt * A
    bc = (torch.randn((nb, lc, 2 * n), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    return x, a, bc[..., :n].reshape(nb, lc, 1, n), bc[..., n:].reshape(nb, lc, 1, n)


def ssd_row(cfg, g) -> dict:
    """ssd_chunk at the full-width Mamba-2 2.7B shapes, prompts of 1024 and
    4096 tokens, called as the model calls it (with the prefix sums); the row
    reports the 1024-token call, with the 4096-token time beside it."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_chunk as ssd

    rows = {}
    for seq in (1024, 4096):
        x, a, b, c = ssd_inputs(cfg, seq, g)
        y, st, cum = ssd.ssd_chunk(x, a, b, c, return_cum=True)
        yr, sr = ref.ssd_chunk_ref(x, a, b, c)
        err = max((y - yr).abs().max().item(), (st - sr).abs().max().item())
        rel = max((y - yr).abs().max().item() / yr.abs().max().item(),
                  (st - sr).abs().max().item() / sr.abs().max().item())
        check(rel <= SSD_TOL, f"ssd_chunk at x {tuple(x.shape)}: max |err| {err:.3g}, "
              f"{rel:.3g} of the output's scale <= {SSD_TOL} "
              f"(margin {SSD_TOL / max(rel, 1e-30):.3g}x)")
        want = torch.cumsum(a, dim=1)
        cum_rel = _rel(cum, want)
        check(cum_rel <= CUM_TOL, f"ssd_chunk's prefix sums at {tuple(a.shape)} against "
              f"torch.cumsum: {cum_rel:.3g} of the largest |cum| <= {CUM_TOL}")
        nb, lc, nh, hp = x.shape
        n = b.shape[-1]
        moved = 4 * (2 * x.numel() + 2 * a.numel() + st.numel()) + 2 * 2 * nb * lc * n
        pairs = lc * (lc + 1) // 2
        flops_g = nb * 2 * pairs * n  # C.B^T, in B/C's type (bf16)
        flops_tf32 = nb * nh * (2 * pairs * hp + 2 * lc * n * hp)  # P.x, B^T.(w x)
        t_bytes = moved / HBM_BYTES_PER_S
        t_ops = flops_g / BF16_FLOP_PER_S + flops_tf32 / TF32_FLOP_PER_S
        rows[seq] = dict(
            name="ssd_chunk", route="cuda", source="src/repro_torch/kernels/csrc/ssd_chunk.cu",
            replaces="src/repro/kernels/ssd_chunk.py:72", max_abs_err=err,
            ms=device_ms(lambda: ssd.ssd_chunk(x, a, b, c, return_cum=True)),
            plain_ms=device_ms(lambda: ref.ssd_chunk_ref(x, a, b, c, return_cum=True), iters=5),
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="operations" if t_ops > t_bytes else "bytes", library_ms=None,
        )
        r = rows[seq]
        # The float32 CUDA-core figure is a computed lower bound, not a timing:
        # it stays on this line, out of the kernels JSON row.
        f32_ops_ms = (flops_g + flops_tf32) / F32_FLOP_PER_S * 1e3
        print(f"  ssd_chunk, {seq} tokens: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f} by {r['bound_by']}: {moved / 1e6:.1f} MB, "
              f"{(flops_g + flops_tf32) / 1e9:.2f} GFLOP on the tensor cores "
              f"{t_ops * 1e3:.4f} ms; computed for f32 CUDA cores {f32_ops_ms:.4f} ms)")
        del x, a, b, c, y, st, cum, yr, sr, want
    row = rows[1024]
    row["ms_4096"], row["plain_ms_4096"] = rows[4096]["ms"], rows[4096]["plain_ms"]
    row["max_abs_err_4096"] = rows[4096]["max_abs_err"]
    return row


def sparse_row(cfg, qwen_cfg, g) -> dict:
    """sparse_kv_gather at phase 6's reads, built by the exp10 twin's own
    helpers: 16 tokens per (layer, kv head) of a 1024-token context in a
    full-width Llama-3.1-8B pool of 512 blocks, and of an 8192-token context
    in a qwen3-32b pool of 512 blocks, each read one launch of
    (-1, 1, head_dim) pieces, timed over exp10's 32 reads cold in L2; then
    exp10's top-k read, 4,096 rows of (8, 80) from one full-width qwen3-32b
    layer's K and V, timed on one id set with its source in L2 as
    exp10.topk_gather times it. The row reports Llama's read, with the
    other two reads' times, the Llama read replayed from one captured CUDA
    graph of its 32 reads (per read) and the launch floor: the kernel's C
    entry with an empty body on the same grid (sparse_probe's ``empty``)."""
    import torch

    from repro_torch.core.pool import KVBlockLayout
    from repro_torch.experiments import exp10_sparse as exp10
    from repro_torch.experiments import sparse_probe
    from repro_torch.experiments.common import graph_ms
    from repro_torch.kernels import kv_transfer as kv
    from repro_torch.kernels import ref

    rows = {}
    for c, ctx_blocks in ((cfg, PROMPT // 16), (qwen_cfg, POOL_BLOCKS)):
        lay = KVBlockLayout.for_model(c, 16)
        pool = exp10.random_pool(lay, POOL_BLOCKS, g)[0]
        view = pool.view(-1, 1, lay.head_dim)
        n = view.shape[0]
        id_sets = exp10.cold_id_sets(lay, POOL_BLOCKS, ctx_blocks, g)
        edge = torch.tensor([-1, -n, n, 2**31 - 1], dtype=torch.int32, device=g.device)
        ids = torch.cat([id_sets[0], edge])
        out, want = kv.sparse_kv_gather(view, ids), ref.sparse_kv_gather_ref(view, ids)
        torch.cuda.synchronize()
        nan_rows = torch.isnan(out).all(dim=(1, 2))
        n_sel = id_sets[0].numel()
        check(torch.equal(out.view(torch.int16), want.view(torch.int16))
              and nan_rows.nonzero().flatten().tolist() == [n_sel + 2, n_sel + 3]
              and torch.equal(out[n_sel], view[n - 1]) and torch.equal(out[n_sel + 1], view[0]),
              f"sparse_kv_gather bit-exact on {c.name}'s pool {tuple(pool.shape)}: {n_sel} "
              f"pieces + ids -1, -N (wrapped), N, 2**31-1 (NaN rows, exactly those)")
        moved = 2 * n_sel * lay.head_dim * pool.element_size()
        rows[c.name] = r = dict(
            name="sparse_kv_gather", route="cuda",
            source="src/repro_torch/kernels/csrc/kv_transfer.cu",
            replaces="src/repro/kernels/kv_transfer.py:172", max_abs_err=0.0,
            ms=cycled_ms(lambda i: kv.sparse_kv_gather(view, i), id_sets),
            plain_ms=cycled_ms(lambda i: ref.sparse_kv_gather_ref(view, i), id_sets),
            bound_ms=moved / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=cycled_ms(lambda i: view.index_select(0, i), id_sets),
        )
        print(f"  sparse_kv_gather, {c.name}: {n_sel} pieces of {lay.head_dim * 2} B: "
              f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, index_select "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.5f} by bytes: {moved / 1e6:.2f} MB)")
        if c is cfg:
            r["graph_ms"] = graph_ms(lambda i: kv.sparse_kv_gather(view, i), id_sets)
            r["floor_ms"] = sparse_probe.floor_ms(view, id_sets)
        del pool, view, id_sets, out, want
    tkv, tids = sparse_probe.topk_read(qwen_cfg, g)
    out = kv.sparse_kv_gather(tkv, tids)
    torch.cuda.synchronize()
    check(torch.equal(out, tkv[tids.long()]),
          f"sparse_kv_gather bit-exact on the top-k read: {tids.numel()} rows of "
          f"{tuple(tkv.shape[1:])} from {qwen_cfg.name}'s K and V of one layer")
    row, qwen = rows[cfg.name], rows[qwen_cfg.name]
    row["ms_qwen3_32b"] = qwen["ms"]
    row["ms_topk"] = device_ms(lambda: kv.sparse_kv_gather(tkv, tids))
    print(f"  sparse_kv_gather, three reads: {cfg.name} {row['ms'] * 1e3:.3f} us (one CUDA "
          f"graph of its 32 reads: {row['graph_ms'] * 1e3:.3f} us a read; empty kernel on its "
          f"grid {row['floor_ms'] * 1e3:.3f}; bound {row['bound_ms'] * 1e3:.3f}), {qwen_cfg.name} "
          f"{qwen['ms'] * 1e3:.3f} (bound {qwen['bound_ms'] * 1e3:.3f}), top-k "
          f"{row['ms_topk'] * 1e3:.3f} (its source and output stay in L2, so no HBM byte "
          f"bound holds)")
    return row


def flash_row(cfg, randn) -> dict:
    """flash_attention at one layer of the 1024-token Llama-3.1-8B prefill
    (bf16, d 128: the wgmma route), timed against the CUDA-core route on the
    same inputs, the plain version and SDPA; then the wgmma route against the
    plain version at the ragged and GQA shapes of FLASH_SHAPES."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    hkv, hd, hq = cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    q, fk, fv = randn(1, PROMPT, hq, hd), randn(1, PROMPT, hkv, hd), randn(1, PROMPT, hkv, hd)
    picked = fa.route(q.dtype, hd)
    before = dict(fa.flash_attention.launches_by_route)
    out = fa.flash_attention(q, fk, fv, causal=True)
    want = ref.flash_attention_ref(q, fk, fv, causal=True)
    err = (out.float() - want.float()).abs().max().item()
    took = fa.flash_attention.launches_by_route["wgmma"] - before["wgmma"]
    check(picked == "wgmma" and took == 1,
          f"flash_attention at q {tuple(q.shape)} bf16 takes the {picked} route")
    check(torch.allclose(out.float(), want.float(), atol=FLASH_TOL, rtol=FLASH_TOL),
          f"flash_attention (wgmma) within {FLASH_TOL} at q {tuple(q.shape)} (max |err| {err:.3g})")
    slow = fa.flash_attention(q, fk, fv, causal=True, force_route="cuda_cores")
    slow_err = (slow.float() - want.float()).abs().max().item()
    check(torch.allclose(slow.float(), want.float(), atol=FLASH_TOL, rtol=FLASH_TOL),
          f"flash_attention (cuda_cores) on the same inputs within {FLASH_TOL} "
          f"(max |err| {slow_err:.3g})")
    pairs = PROMPT * (PROMPT + 1) // 2  # causal (q, k) pairs
    flops = 4 * hq * hd * pairs
    moved = (2 * q.numel() + 2 * fk.numel()) * q.element_size()  # q, k, v in; out
    qt, kt, vt = (t.transpose(1, 2) for t in (q, fk, fv))
    ms = device_ms(lambda: fa.flash_attention(q, fk, fv, causal=True))
    row = dict(
        name="flash_attention", route="cuda", dispatch_route=picked,
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:135", max_abs_err=err,
        ms=ms,
        cuda_cores_ms=device_ms(
            lambda: fa.flash_attention(q, fk, fv, causal=True, force_route="cuda_cores")),
        plain_ms=device_ms(lambda: ref.flash_attention_ref(q, fk, fv, causal=True)),
        bound_ms=max(flops / BF16_FLOP_PER_S, moved / HBM_BYTES_PER_S) * 1e3,
        bound_by="operations" if flops / BF16_FLOP_PER_S > moved / HBM_BYTES_PER_S
        else "bytes",
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        tflops=flops / (ms * 1e-3) / 1e12,
        cuda_cores_max_abs_err=slow_err,
    )
    print(f"  flash_attention, {flops / 1e9:.2f} GFLOP: wgmma {row['ms']:.4f} ms "
          f"({row['tflops']:.1f} TFLOP/s), cuda_cores {row['cuda_cores_ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f}, SDPA {row['library_ms']:.4f}, bound {row['bound_ms']:.4f}")
    del q, fk, fv, out, want, slow, qt, kt, vt
    errs = []
    for b, sq, skv, nq, nkv, d, causal in FLASH_SHAPES:
        q, k, v = randn(b, sq, nq, d), randn(b, skv, nkv, d), randn(b, skv, nkv, d)
        before = fa.flash_attention.launches_by_route["wgmma"]
        out = fa.flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        e = (out.float() - want.float()).abs().max().item()
        errs.append(e)
        check(fa.flash_attention.launches_by_route["wgmma"] == before + 1
              and torch.allclose(out.float(), want.float(), atol=FLASH_TOL, rtol=FLASH_TOL),
              f"flash_attention (wgmma) within {FLASH_TOL} at b {b}, sq {sq}, skv {skv}, heads "
              f"{nq}/{nkv}, d {d}, {'causal' if causal else 'non-causal'} (max |err| {e:.3g})")
    row["max_abs_err_shapes"] = max(errs)
    return row


def phase_kernels(cfg, mamba_cfg) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kv_transfer as kv
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    L, hkv, hd, hq, bt = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads, 16
    n_blocks, n_slots = PROMPT // bt, MAX_LEN // bt
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf16)

    rows = []
    # -- kv_gather_write: the miss path's writeback of one prompt
    k, v = randn(L, MAX_LEN, hkv, hd), randn(L, MAX_LEN, hkv, hd)
    slots = list(range(n_blocks))
    slots_t = torch.tensor(slots, device=dev)
    blocks = kv.kv_gather_write(k, v, slots, bt)
    want = ref.kv_gather_write_ref(k, v, slots_t, bt)
    torch.cuda.synchronize()
    check(torch.equal(blocks, want), f"kv_gather_write bit-exact at {tuple(blocks.shape)}")
    moved = 2 * blocks.numel() * blocks.element_size()
    rows.append(dict(
        name="kv_gather_write", route="cuda",
        source="src/repro_torch/kernels/csrc/kv_transfer.cu",
        replaces="src/repro/kernels/kv_transfer.py:76", max_abs_err=0.0,
        ms=device_ms(lambda: kv.kv_gather_write(k, v, slots, bt)),
        plain_ms=device_ms(lambda: ref.kv_gather_write_ref(k, v, slots_t, bt)),
        bound_ms=moved / HBM_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None,
    ))
    # -- kv_scatter_read: the hit path's fetch of those blocks
    kr, vr = kv.kv_scatter_read(blocks, slots, n_slots)
    zeros = torch.zeros_like(k)
    kw, vw = ref.kv_scatter_read_ref(blocks, slots_t, zeros, zeros, bt)
    torch.cuda.synchronize()
    check(torch.equal(kr, kw) and torch.equal(vr, vw),
          f"kv_scatter_read bit-exact (zero fill included) at {tuple(kr.shape)}")
    moved = blocks.numel() * blocks.element_size() + 2 * kr.numel() * kr.element_size()
    rows.append(dict(
        name="kv_scatter_read", route="cuda",
        source="src/repro_torch/kernels/csrc/kv_transfer.cu",
        replaces="src/repro/kernels/kv_transfer.py:132", max_abs_err=0.0,
        ms=device_ms(lambda: kv.kv_scatter_read(blocks, slots, n_slots)),
        plain_ms=device_ms(
            lambda: ref.kv_scatter_read_ref(blocks, slots_t, zeros, zeros, bt)),
        bound_ms=moved / HBM_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None,
    ))
    del k, v, blocks, want, kr, vr, kw, vw, zeros
    rows.append(flash_row(cfg, randn))
    rows.append(paged_row(cfg, randn))
    rows.append(ssd_row(mamba_cfg, g))
    rows.append(sparse_row(cfg, get_config("qwen3-32b"), g))
    for r in rows:
        print(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
              f"bound {r['bound_ms']:.4f} by {r['bound_by']}, library {r['library_ms']})")
    return rows


def flash_build_proof(build) -> None:
    """The wgmma route's kernels as ptxas built them (registers, spills, the
    CTA's dynamic shared memory), and the flash library's SASS holding the
    tensor-core (HGMMA) and TMA (UTMALDG) instructions."""
    import re

    from repro_torch.kernels import flash_attention as fa

    log = build.build_log("flash_attention")
    for fn, body in re.findall(r"Compiling entry function '(\S*flash_wgmma_kernel\S*)'"
                               r"(.*?)Compile time", log, flags=re.S):
        d = re.search(r"ILi(\d+)E", fn).group(1)
        regs = re.search(r"Used (\d+) registers", body).group(1)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
        smem = build.load("flash_attention", fa.SIGNATURES).flash_attention_wgmma_smem(int(d))
        print(f"  flash wgmma kernel, d {d}: {regs} registers at launch, spill stores "
              f"{spill.group(1)} B / loads {spill.group(2)} B, {smem} B dynamic shared memory")
    sass = build.sass("flash_attention")
    counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in FLASH_SASS}
    check(all(counts.values()), f"flash library SASS holds tensor-core and TMA instructions: "
          f"{counts}")


def paged_build_proof(build) -> None:
    """Each paged_attention instantiation as ptxas built it, by name (dtype,
    head_dim, group): registers, spill stores and loads, static shared
    memory, and its K/V ring (dynamic shared memory); the one that Llama
    decode runs (bf16, d 128, group 4) must not spill."""
    import re

    import torch

    from repro_torch.kernels import paged_attention as pa

    log = build.build_log("paged_attention")
    seen = {}
    for fn, body in re.findall(r"Compiling entry function '(\S*paged_attention_kernel\S*)'"
                               r"(.*?)Compile time", log, flags=re.S):
        m = re.search(r"paged_attention_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", fn)
        dtype = torch.float32 if m.group(1) == "f" else torch.bfloat16
        d, g = int(m.group(2)), int(m.group(3))
        regs = int(re.search(r"Used (\d+) registers", body).group(1))
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
        smem = re.search(r"(\d+) bytes smem", body)
        dev = torch.device("cuda", torch.cuda.current_device())
        seen[(dtype, d, g)] = stores, loads = int(spill.group(1)), int(spill.group(2))
        print(f"  paged kernel {str(dtype)[6:]}, d {d}, group {g}: {regs} registers, spill "
              f"stores {stores} B / loads {loads} B, {smem.group(1) if smem else 0} B static "
              f"+ {pa.ring_bytes(dev, dtype, d, g)} B ring shared memory, "
              f"{pa.ctas_per_sm(dev, dtype, d, g)} CTAs per SM")
    check(len(seen) == 2 * len(pa.HEAD_DIMS) * 4, f"ptxas reported all {len(seen)} paged "
          "instantiations (2 dtypes x 4 head_dims x groups 1, 2, 4, 8)")
    check(seen[(torch.bfloat16, 128, 4)] == (0, 0),
          "the paged instantiation Llama decode runs (bf16, d 128, group 4) does not spill")


def ssd_build_proof(build) -> None:
    """Each ssd_chunk instantiation as ptxas built it, by B/C dtype: registers,
    spill stores and loads, static and dynamic shared memory, CTAs per SM;
    the bf16 one (the served model) must not spill, and the library's SASS
    must hold tensor-core instructions."""
    import re

    import torch

    from repro_torch.kernels import ssd_chunk as ssd

    log = build.build_log("ssd_chunk")
    seen = {}
    for fn, body in re.findall(r"Compiling entry function '(\S*ssd_chunk_kernel\S*)'"
                               r"(.*?)Compile time", log, flags=re.S):
        dtype = torch.bfloat16 if "nv_bfloat16" in fn else torch.float32
        regs = int(re.search(r"Used (\d+) registers", body).group(1))
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
        smem = re.search(r"(\d+) bytes smem", body)
        seen[dtype] = stores, loads = int(spill.group(1)), int(spill.group(2))
        print(f"  ssd_chunk kernel, B/C {str(dtype)[6:]}: {regs} registers, spill stores "
              f"{stores} B / loads {loads} B, {smem.group(1) if smem else 0} B static + "
              f"{ssd.smem_bytes(dtype)} B dynamic shared memory, "
              f"{ssd.ctas_per_sm(dtype)} CTAs per SM")
    check(set(seen) == {torch.float32, torch.bfloat16},
          "ptxas reported both ssd_chunk instantiations (B/C float32, bfloat16)")
    check(seen[torch.bfloat16] == (0, 0),
          "the ssd_chunk instantiation the bf16 model runs does not spill")
    sass = build.sass("ssd_chunk")
    counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in SSD_SASS}
    check(sum(counts.values()) > 0, f"ssd_chunk library SASS holds tensor-core "
          f"instructions: {counts}")


def phase_small() -> None:
    import torch

    from repro_torch.configs.registry import reduced_config
    from repro_torch.models.model import Model, init_params
    from repro_torch.serving.real_runner import RealEngine

    from repro_torch.kernels import ops

    cfg = dataclasses.replace(reduced_config("llama3.1-8b"), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ops.reset_launch_counts()
    engines = {
        "cuda": RealEngine.create(cfg, max_len=128, pool_blocks=64, device="cuda",
                                  params=_to(params, "cuda")),
        "cpu": RealEngine.create(cfg, max_len=128, pool_blocks=64, device="cpu",
                                 params=params),
    }
    prompt = torch.randint(0, cfg.vocab_size, (48,), generator=torch.Generator().manual_seed(3))
    got = {}
    for name, eng in engines.items():
        got[name] = [eng.generate(prompt.tolist(), max_new=8) for _ in range(2)]
    routes = ops.flash_routes()
    check(routes["cuda_cores"] == cfg.n_layers and routes["wgmma"] == 0,
          f"reduced fp32 Llama (head_dim {cfg.head_dim}) prefill took the cuda_cores route: "
          f"{routes}")
    for i, label in enumerate(("cold", "warm")):
        (tg, ig), (tc, ic) = got["cuda"][i], got["cpu"][i]
        diff = (ig["logits"].cpu() - ic["logits"]).abs().max().item()
        check(ig["hit_tokens"] == ic["hit_tokens"] == 48 * i
              and diff <= SMALL_TOL and tg == tc,
              f"reduced fp32 {label}: card vs CPU logits max |diff| {diff:.3g} "
              f"<= {SMALL_TOL}, hits {ig['hit_tokens']}")

    # reduced Mamba-2: prefill (three chunks, the last padded) and decode
    mcfg = dataclasses.replace(reduced_config("mamba2-2.7b"), dtype="float32")
    mparams = init_params(mcfg, torch.Generator().manual_seed(0), "cpu")
    on_card = _to(mparams, "cuda")
    model = Model(mcfg)
    tokens = torch.randint(0, mcfg.vocab_size, (2, 70), generator=torch.Generator().manual_seed(4))
    lg_cpu, cache_cpu = model.prefill_fn(mparams, tokens)
    lg_gpu, cache_gpu = model.prefill_fn(on_card, tokens.cuda())
    diffs = [(lg_gpu.cpu() - lg_cpu).abs().max().item()]
    for step in range(8):
        tok, pos = tokens[:, step], torch.full((2,), 70 + step)
        lc = model.decode_fn(mparams, cache_cpu, tok, pos)
        diffs.append((model.decode_fn(on_card, cache_gpu, tok.cuda(), pos.cuda()).cpu()
                      - lc).abs().max().item())
    check(max(diffs) <= SMALL_TOL, f"reduced fp32 mamba2: card vs CPU prefill and 8 decode "
          f"steps, logits max |diff| {max(diffs):.3g} <= {SMALL_TOL}")


def _to(tree: dict, device) -> dict:
    return _map(tree, lambda t: t.to(device))


def compare_steps(a, b) -> tuple[int, float]:
    """Max |diff| of per-step logits over the steps whose inputs agree:
    step i depends on the tokens emitted before it."""
    (ta, ia), (tb, ib) = a, b
    n = 1
    while n < len(ta) and ta[n - 1] == tb[n - 1]:
        n += 1
    diff = (ia["logits"][:n] - ib["logits"][:n]).abs().max().item()
    return n, diff


def phase_main(cfg) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.serving.real_runner import RealEngine

    t0 = time.perf_counter()
    eng = RealEngine.create(cfg, max_len=MAX_LEN, pool_blocks=POOL_BLOCKS, seed=0)
    torch.cuda.synchronize()
    print(f"  engine up in {time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)")
    rng = np.random.default_rng(0)
    fresh = lambda n: rng.integers(0, cfg.vocab_size, size=n).tolist()  # noqa: E731
    shared = fresh(SHARED)
    p0, p1 = shared + fresh(PROMPT - SHARED), fresh(PROMPT)
    p2, p3 = shared + fresh(PROMPT - SHARED), shared + fresh(PROMPT - SHARED)
    prompts = [p0, p1, p2, p3, p0, p1]
    want_hits = [0, 0, SHARED, SHARED, PROMPT, PROMPT]

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = [eng.generate(p, max_new=MAX_NEW) for p in prompts]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    routes = ops.flash_routes()
    peak = torch.cuda.max_memory_allocated()

    for i, ((toks, info), want) in enumerate(zip(results, want_hits)):
        lg = info["logits"]
        print(f"  req {i}: hit {info['hit_tokens']}/{PROMPT}, ttft "
              f"{info['ttft_s'] * 1e3:.2f} ms, total {info['total_s'] * 1e3:.1f} ms, "
              f"tokens {toks[:6]}...")
        check(info["hit_tokens"] == want, f"req {i} hit_tokens {info['hit_tokens']} == {want}")
        check(len(toks) == MAX_NEW and lg.shape == (MAX_NEW, cfg.padded_vocab)
              and bool(torch.isfinite(lg).all()), f"req {i}: {MAX_NEW} finite logit rows")
    check(all(launches[k] > 0 for k in LLAMA_KERNELS) and launches["ssd_chunk"] == 0,
          f"every kernel of the path launched: {launches}")
    # decode steps: a hit's tail (or its re-fed last token), then MAX_NEW - 1
    steps = sum(
        (len(p) - min(info["hit_tokens"], len(p) - 1) if info["hit_tokens"] else 0)
        + len(toks) - 1
        for p, (toks, info) in zip(prompts, results)
    )
    cold = want_hits.count(0)
    check(launches["flash_attention"] == routes["wgmma"] == cold * cfg.n_layers
          and routes["cuda_cores"] == 0,
          f"all {launches['flash_attention']} flash launches ({cold} cold prefills x "
          f"{cfg.n_layers} layers) took the wgmma route: {routes}")
    check(launches["paged_attention"] == cfg.n_layers * steps,
          f"paged_attention launched {launches['paged_attention']} times = "
          f"{cfg.n_layers} layers x {steps} decode steps")

    # the cache restored from the pool is the KV prefill wrote, bit for bit
    cold_k, cold_v = results[0][1]["kv"]
    hits = eng.index.match_prefix(p0)
    rk, rv = eng.fetch([b for _, b, _ in hits])
    torch.cuda.synchronize()
    check(len(hits) * 16 == PROMPT
          and torch.equal(rk[:, :, :PROMPT], cold_k[:, :, :PROMPT])
          and torch.equal(rv[:, :, :PROMPT], cold_v[:, :, :PROMPT])
          and not rk[:, :, PROMPT:].any() and not rv[:, :, PROMPT:].any(),
          f"pool round trip of {len(hits)} blocks is bit-exact, unmapped slots zero")
    del rk, rv
    for cold, warm in ((0, 4), (1, 5)):
        n, diff = compare_steps(results[cold], results[warm])
        check(diff <= LOGIT_TOL, f"warm req {warm} vs cold req {cold}: max |dlogit| "
              f"{diff:.4g} <= {LOGIT_TOL} over {n} steps (logit std "
              f"{results[cold][1]['logits'].std().item():.3g})")
    plain = Model(cfg, kernel_mode="ref")  # plain attention, same weights
    floor_logits, _ = plain.prefill_fn(eng.params, torch.tensor([p0], device=eng.device),
                                       max_len=PROMPT)
    floor = (floor_logits[0, 0] - results[0][1]["logits"][0]).abs().max().item()
    print(f"  noise floor: cold prefill with plain vs kernel attention, max |dlogit| "
          f"{floor:.4g}")
    for i in (2, 3):  # partial hit (decode over the tail) vs a fresh prefill
        logits, _ = eng.prefill(prompts[i])
        diff = (logits - results[i][1]["logits"][0]).abs().max().item()
        check(diff <= LOGIT_TOL, f"req {i} first-token logits vs prefill: max |dlogit| "
              f"{diff:.4g} <= {LOGIT_TOL}")

    decode_s = sum(info["total_s"] - info["ttft_s"] for _, info in results)
    decode_tok = sum(len(t) - 1 for t, _ in results)
    summary = {
        "wall_s": wall,
        "ttft_ms": [info["ttft_s"] * 1e3 for _, info in results],
        "decode_tok_per_s": decode_tok / decode_s,
        "peak_mem_gib": peak / 2**30,
        "launches": launches,
        "flash_routes": routes,
    }
    print("  main path: " + json.dumps(summary))
    phase_profile(eng, results[0], fresh(PROMPT), results[1][1]["ttft_s"])
    # phase 6 reads this engine's pool: the blocks of p0 and the KV they hold
    return launches, (eng, [b for _, b, _ in hits], cold_k[:, 0], cold_v[:, 0])


def report_profile(label, events, n, wall_ms, top=5) -> None:
    """Wall, device-kernel time, busy share, aten calls and the top kernels
    of a profiled window of n repeats."""
    import torch

    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    ops_n = sum(e.count for e in events if e.key.startswith("aten::")) / n
    print(f"  {label} (profiled): {wall_ms:.2f} ms wall, device kernels {busy_ms:.2f} ms "
          f"({busy_ms / wall_ms:.1%} busy), {ops_n:.0f} aten ops")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"    {e.self_device_time_total / 1e3 / n:.3f} ms  x{e.count // n}  {e.key[:90]}")


def phase_profile(eng, cold, prompt, ttft_s) -> None:
    """Where a cold request's time to first token goes (one profiled cold
    request of a fresh prompt: prefill, pool writeback, first token) and where
    one decode step's time goes (a short profiled window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, info = eng.generate(prompt, max_new=1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    print(f"  cold TTFT, req 1 of the run: {ttft_s * 1e3:.2f} ms; profiled cold request "
          f"(hit {info['hit_tokens']}): ttft {info['ttft_s'] * 1e3:.2f} ms")
    report_profile(f"cold prefill of {len(prompt)} tokens + writeback", prof.key_averages(), 1,
                   wall_ms, top=8)
    toks, info = cold
    cache = info["kv"]
    pos, steps = PROMPT + len(toks), 8
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            eng._decode(cache, toks[-1], pos + i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = prof.key_averages()
    report_profile("decode step", events, steps, wall_ms)
    paged = sum(e.count for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                and "paged" in e.key) / steps
    check(paged == eng.cfg.n_layers, f"profiled decode step: {paged:g} paged kernels a step "
          f"= {eng.cfg.n_layers} layers (one launch per layer, no merge kernel)")


def _rel(a, b) -> float:
    """max |a - b| relative to the largest |b|."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def phase_mamba(cfg) -> dict:
    """Full-width mamba2-2.7b through ``Model``: prefill then greedy decode,
    the port's twin of examples/quickstart.py:46-60."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.model import Model, init_params

    dev = torch.device("cuda")
    # phase 4's engine stays resident for phase 6: memory is counted above it
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = Model(cfg)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"  {cfg.n_layers} layers, {n_params / 1e9:.3f} B parameters up in "
          f"{time.perf_counter() - t0:.1f} s "
          f"({(torch.cuda.memory_allocated() - base) / 2**30:.2f} GiB)")
    rng = np.random.default_rng(5)
    full = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, MAMBA_PROMPTS[1] + 1))).to(dev)
    prompts = [torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, MAMBA_PROMPTS[0])))
               .to(dev), full[:, :-1]]

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    runs = []
    for tokens in prompts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill_fn(params, tokens)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        state = cache["state"].clone()
        steps, out = [logits[:, 0]], [int(logits[0, 0].argmax())]
        t0 = time.perf_counter()
        for i in range(MAMBA_STEPS):
            pos = torch.tensor([tokens.shape[1] + i], device=dev)
            lg = model.decode_fn(params, cache, torch.tensor([out[-1]], device=dev), pos)
            steps.append(lg)
            out.append(int(lg[0].argmax()))
        torch.cuda.synchronize()
        runs.append(dict(prefill_s=prefill_s, decode_s=time.perf_counter() - t0,
                         logits=torch.cat(steps), tokens=out, state=state))
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    # each prefill's wall time: one warm-up, then the median of PREFILL_REPEATS
    # (outside the counted run above and every profiler window)
    for tokens, r in zip(prompts, runs):
        model.prefill_fn(params, tokens)
        times = []
        for _ in range(PREFILL_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.prefill_fn(params, tokens)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        r["prefill_ms"] = sorted(times)
    for tokens, r in zip(prompts, runs):
        t = r["prefill_ms"]
        print(f"  prompt {tokens.shape[1]}: prefill median {t[len(t) // 2]:.1f} ms of "
              f"{len(t)} (spread {t[0]:.1f}-{t[-1]:.1f}; the counted run's "
              f"{r['prefill_s'] * 1e3:.1f}), {MAMBA_STEPS} decode steps "
              f"{r['decode_s'] * 1e3:.1f} ms, tokens {r['tokens'][:6]}...")
        check(r["logits"].shape == (MAMBA_STEPS + 1, cfg.padded_vocab)
              and bool(torch.isfinite(r["logits"]).all()),
              f"prompt {tokens.shape[1]}: {MAMBA_STEPS + 1} finite logit rows")
    check(launches["ssd_chunk"] == cfg.n_layers * len(prompts)
          and all(launches[k] == 0 for k in LLAMA_KERNELS),
          f"ssd_chunk launched {cfg.n_layers} times per prefill: {launches}")

    # the final SSM state of the kernel path against the plain path's
    plain = Model(cfg, kernel_mode="ref")
    _, pcache = plain.prefill_fn(params, prompts[0])
    got, want = runs[0]["state"], pcache["state"]
    rel0, rel = _rel(got[0], want[0]), _rel(got, want)
    check(rel0 <= STATE_TOL_L0 and rel <= STATE_TOL,
          f"final SSM state, kernel vs plain path ({MAMBA_PROMPTS[0]} tokens): layer 0 "
          f"{rel0:.3g} <= {STATE_TOL_L0}, all {cfg.n_layers} layers {rel:.3g} <= {STATE_TOL} "
          "of the largest entry")
    del pcache, got, want

    # continuity, in the model's bf16 (against the floor measured here) and
    # on the same weights in float32 (against CONTINUITY_TOL)
    what = f"prefill {MAMBA_PROMPTS[1]} + decode 1 vs prefill {full.shape[1]}"
    cont_bf16, floor_bf16 = continuity(cfg, params, full)
    lim_bf16 = CONTINUITY_BF16_FLOORS * floor_bf16
    check(cont_bf16 <= lim_bf16, f"bf16 continuity: {what}: {cont_bf16:.3g} of the largest "
          f"logit <= {lim_bf16:.3g} = {CONTINUITY_BF16_FLOORS} x the noise floor (the same "
          f"prefill with plain vs kernel ssd_chunk) {floor_bf16:.3g}")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = _map(params, lambda t: t.float())
    cont, floor = continuity(cfg32, params32, full)
    del params32
    check(cont <= CONTINUITY_TOL, f"float32 continuity: {what}: {cont:.3g} of the largest "
          f"logit <= {CONTINUITY_TOL} (noise floor {floor:.3g}; margin "
          f"{CONTINUITY_TOL / max(cont, 1e-30):.3g}x)")

    decode_s = sum(r["decode_s"] for r in runs)
    summary = {
        "prefill_ms": {str(t.shape[1]): r["prefill_ms"][PREFILL_REPEATS // 2]
                       for t, r in zip(prompts, runs)},
        "prefill_ms_spread": {str(t.shape[1]): [r["prefill_ms"][0], r["prefill_ms"][-1]]
                              for t, r in zip(prompts, runs)},
        "decode_tok_per_s": MAMBA_STEPS * len(runs) / decode_s,
        "peak_mem_gib": (peak - base) / 2**30,
        "launches": launches,
        "continuity_rel": {"bfloat16": cont_bf16, "float32": cont},
        "noise_floor_rel": {"bfloat16": floor_bf16, "float32": floor},
    }
    print("  mamba path: " + json.dumps(summary))
    profile_mamba(model, params, prompts, runs[0]["tokens"])
    return launches


def continuity(cfg, params, full) -> tuple[float, float]:
    """Prefill all but the last token, decode the last at its position, and
    compare with the last logits of a prefill of all of them; the noise
    floor is that prefill with the plain ssd_chunk against the kernel."""
    import torch

    from repro_torch.models.model import Model

    model, plain = Model(cfg), Model(cfg, kernel_mode="ref")
    s = full.shape[1] - 1
    _, cache = model.prefill_fn(params, full[:, :-1])
    stepped = model.decode_fn(params, cache, full[:, -1], torch.tensor([s], device=full.device))
    del cache
    whole, _ = model.prefill_fn(params, full)
    whole_plain, _ = plain.prefill_fn(params, full)
    return _rel(stepped, whole[:, 0]), _rel(whole_plain[:, 0], whole[:, 0])


def _map(tree: dict, fn) -> dict:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _leaves(tree: dict):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def profile_mamba(model, params, prompts, toks) -> None:
    """Where each prefill's (1000 and 4095 tokens) and a decode step's time go."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    caches = []
    for prompt in prompts:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            caches.append(model.prefill_fn(params, prompt)[1])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        report_profile(f"prefill {prompt.shape[1]}", prof.key_averages(), 1, wall_ms, top=6)
    prompt, cache = prompts[0], caches[0]
    del caches[1:]
    steps, dev = 8, prompt.device
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            model.decode_fn(params, cache, torch.tensor([toks[i]], device=dev),
                            torch.tensor([prompt.shape[1] + i], device=dev))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    report_profile("decode step", prof.key_averages(), steps, wall_ms, top=6)


def _fields(derived: str) -> dict:
    """``a=1;b=x`` -> {"a": "1", "b": "x"}: a twin row's derived column."""
    return dict(f.split("=", 1) for f in derived.split(";") if "=" in f)


def phase_sparse(llama_pool) -> dict:
    """The exp10 twin (on phase 4's pool for Llama-3.1-8B) then the exp09
    twin, untimed: their kernels' times are phase 2's, at the same reads."""
    import torch

    from repro_torch.experiments import exp09_dense_transfer as exp09
    from repro_torch.experiments import exp10_sparse as exp10
    from repro_torch.experiments.common import emit
    from repro_torch.kernels import ops

    eng, block_ids, k, v = llama_pool
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rows10 = exp10.run(pools={"llama3.1-8b": (eng.pool.data, block_ids, k, v)}, timed=False)
    rows09 = exp09.run(timed=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    print("  rows (exp10.sparse16.<arch> and exp09.<layout>.write|read without a suffix are "
          "MODELED by the paper's CXL/RDMA fabric, not measured):")
    emit(rows10 + rows09)
    rows = {r[0]: r for r in rows10 + rows09}
    reads = ["exp10.topk_gather", "exp10.sparse16.llama3.1-8b.device",
             "exp10.sparse16.qwen3-32b.device"]
    for name in reads:
        f = _fields(rows[name][2])
        check(f["launches"] == "1" and f["bit_exact"] == "True",
              f"{name}: {f.get('pieces', f.get('ids'))} pieces in one launch, bit-exact"
              + (" against the cold prefill's KV" if "llama" in name else ""))
    check(_fields(rows["exp10.topk_gather"][2])["finite"] == "True"
          and rows["exp10.kernel_allclose"][2] == "ok=True",
          "full-width qwen3-32b layer-0 scores finite; the JAX toy case equal to the plain "
          f"version; non-contiguous fraction {rows['exp10.noncontiguous_fraction'][1]} %")
    check(all(_fields(r[2])["bit_exact"] == "True" for n, r in rows.items()
              if n.startswith("exp09.") and n.endswith(".device"))
          and " in 1 kernel launch" in rows["exp09.kernel_single_launch"][2],
          "exp09: one block of each bf16 layout written and read back bit for bit; "
          "one launch packs every fragment")
    check(launches["sparse_kv_gather"] == len(reads) + 1,
          f"sparse_kv_gather launched once per read ({len(reads)} reads + the toy case): "
          f"{launches}")
    print(f"  sparse path: {wall:.1f} s wall, launches {json.dumps(launches)}")
    return launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the GPU only")
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build

    # float32 matmuls in full float32 (the default, stated): the float32
    # checks compare against the CPU and against float32 references
    torch.backends.cuda.matmul.allow_tf32 = False
    t_all = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    print("[1] build", flush=True)
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"  built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name in libs:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Performance Loss" in line:
                print(f"  {name}: {line.strip()}")
    flash_build_proof(build)
    paged_build_proof(build)
    ssd_build_proof(build)

    cfg, mamba_cfg = get_config("llama3.1-8b"), get_config("mamba2-2.7b")
    print("[2] kernels vs plain versions", flush=True)
    rows = phase_kernels(cfg, mamba_cfg)
    print("[3] reduced models, card vs CPU", flush=True)
    phase_small()
    print("[4] main path: Llama-3.1-8B full width", flush=True)
    launches, llama_pool = phase_main(cfg)
    print("[5] Mamba-2 path: mamba2-2.7b full width", flush=True)
    mamba_launches = phase_mamba(mamba_cfg)
    print("[6] sparse reads: exp10 and exp09 twins, full width", flush=True)
    sparse_launches = phase_sparse(llama_pool)
    del llama_pool
    paths = {"llama": launches, "mamba2": mamba_launches, "sparse": sparse_launches}
    own = {"ssd_chunk": "mamba2", "sparse_kv_gather": "sparse"}
    for r in rows:
        r["launches"] = paths[own.get(r["name"], "llama")][r["name"]]
        r["launches_by_path"] = {p: n[r["name"]] for p, n in paths.items()}
    print(f"done in {time.perf_counter() - t_all:.1f} s", flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
