"""Exp #10 (Table 6) on the port: sparse KV reads of top-k tokens.

Twin of ``benchmarks/exp10_sparse.py``, with its row names:

(a) Contiguity: layer-0 attention scores of the last query against all
    keys, top-32 tokens per query head (H2O-style), sorted; the share of
    neighbouring selections that are not adjacent. The JAX function runs
    the reduced qwen3-32b (``--reduced`` here); on the card the twin runs
    full-width qwen3-32b at depth 1, since only layer 0 is read. The
    selected rows of that layer's K and V are then gathered by
    ``sparse_kv_gather`` in one launch (``exp10.topk_gather``), timed on
    that one read: its source (655 KB at full width) stays in L2, as it
    does right after the layer computed it.
(b) The KV of 16 sparse tokens: the modeled Beluga and RDMA latencies of
    the reference (``core/transfer.py``; MODELED, the paper's CXL fabric)
    and, per layout, the device form of the same read (``.device`` rows):
    16 distinct token positions per (layer, kv head) gathered from the
    pool's payload seen token-major as ``(-1, 1, head_dim)`` pieces, every
    piece of every layer and head in ONE ``sparse_kv_gather`` launch, held
    bit for bit against the KV the pool was written from; timed over 32
    reads of the same size drawn anywhere in the pool, cold in L2
    (``cold_id_sets``).
(c) ``exp10.kernel_allclose``: the JAX toy case through the kernel.

    python -m repro_torch.experiments.exp10_sparse [--device cpu] [--reduced]

Runs on the card unless ``--device cpu``; device times come only from the
card ("not measured" on the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.core import transfer
from repro_torch.core.pool import KVBlockLayout
from repro_torch.experiments.common import (
    NOT_MEASURED, byte_bound_us, cycled_ms, device_ms, device_name, emit,
)
from repro_torch.kernels import kv_transfer as kvk
from repro_torch.kernels import ops, ref
from repro_torch.models.attention import qkv_proj
from repro_torch.models.layers import embed_apply, norm_apply, rope_tables
from repro_torch.models.model import init_params
from repro_torch.models.transformer import layer_params

SEQ, TOP, N_TOKENS, BLOCK_TOKENS = 256, 32, 16, 16
PAPER = [("llama3.1-8b", 2670, 97), ("qwen3-32b", 5260, 211)]  # (arch, rdma us, cxl us)
POOL_BLOCKS = {False: 512, True: 8}  # a seeded random pool's blocks: full, reduced
ID_SETS = 32  # timed reads cycle over 32 reads: 64-84 MB of pieces, above the H100's 50 MB L2


def contiguity_config(reduced: bool) -> ModelConfig:
    """The JAX function's reduced qwen3-32b, or full width at depth 1."""
    if reduced:
        return reduced_config("qwen3-32b")
    return dataclasses.replace(get_config("qwen3-32b"), n_layers=1)


def select_tokens(params: dict, tokens: torch.Tensor, cfg: ModelConfig, top: int = TOP):
    """Layer-0 scores of the last query against all keys -> (sel (hq, top)
    sorted token ids, k, v (s, hkv, hd), scores (hq, s)), as
    ``_contiguity_from_real_model`` (exp10_sparse.py:18) computes them. Ties
    go to the lower index, as ``lax.top_k`` breaks them."""
    s = tokens.shape[1]
    x = embed_apply(params["embed"], tokens)
    positions = torch.arange(s, device=tokens.device)[None]
    lp = layer_params(params["stack"]["pos_0"], 0)
    h = norm_apply(lp["ln1"], x, cfg)
    q, k, v = qkv_proj(lp["attn"], h, cfg, rope_tables(positions, cfg.head_dim, cfg.rope_theta))
    kr = k.repeat_interleave(q.shape[2] // k.shape[2], dim=2)  # GQA broadcast
    scores = torch.einsum("bshd,bthd->bhst", q[:, -1:], kr)[0, :, 0]  # (hq, s)
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :top]
    return torch.sort(order, dim=-1).values, k[0], v[0], scores


def noncontiguous_fraction(sel: torch.Tensor) -> float:
    diffs = sel.diff(dim=-1)
    return int((diffs != 1).sum()) / max(diffs.numel(), 1)


def topk_ids(k: torch.Tensor, v: torch.Tensor, sel: torch.Tensor):
    """One layer's K and V stacked token-major as (2s, hkv, hd), and the ids
    of the selected rows of both: (kv, int32 ids)."""
    flat = sel.reshape(-1)
    return torch.cat([k, v]), torch.cat([flat, flat + k.shape[0]]).to(torch.int32)


def piece_ids(block_ids: torch.Tensor, positions: torch.Tensor, layout: KVBlockLayout):
    """Ids of the (layer, k|v, kv head, token) pieces in the pool payload
    (n_blocks, 2L, bt, hkv, hd) seen as (-1, 1, hd); ``positions`` is
    (L, hkv, n) token positions of the context held, in token order, by
    ``block_ids``. Id = ((blk * 2L + 2l + f) * bt + off) * hkv + h."""
    L, hkv, bt = layout.n_layers_kv, layout.n_kv_heads, layout.block_tokens
    blk = block_ids[positions // bt][:, None]  # (L, 1, hkv, n)
    off = (positions % bt)[:, None]
    frag = (2 * torch.arange(L, device=positions.device)[:, None, None, None]
            + torch.arange(2, device=positions.device)[None, :, None, None])
    h = torch.arange(hkv, device=positions.device)[None, None, :, None]
    return (((blk * 2 * L + frag) * bt + off) * hkv + h).reshape(-1).to(torch.int32)


def read_ids(layout: KVBlockLayout, block_ids: torch.Tensor, gen: torch.Generator):
    """One read: N_TOKENS distinct sorted token positions per (layer, kv
    head) of the context that ``block_ids`` hold in token order -> (piece
    ids, positions (L, hkv, N_TOKENS))."""
    ctx = len(block_ids) * layout.block_tokens
    pos = torch.rand((layout.n_layers_kv, layout.n_kv_heads, ctx), generator=gen,
                     device=block_ids.device).argsort(-1)[..., :N_TOKENS].sort(-1).values
    return piece_ids(block_ids, pos, layout), pos


def cold_id_sets(layout: KVBlockLayout, n_pool_blocks: int, ctx_blocks: int,
                 gen: torch.Generator) -> list[torch.Tensor]:
    """ID_SETS reads, each from a context of ``ctx_blocks`` blocks drawn
    anywhere in a pool of ``n_pool_blocks``: timed in turn (``cycled_ms``),
    they find their pieces cold in L2, as a read of a request's pool blocks
    does."""
    dev = gen.device
    return [read_ids(layout, torch.randperm(n_pool_blocks, generator=gen, device=dev)
                     [:ctx_blocks], gen)[0] for _ in range(ID_SETS)]


def sparse_read(pool_data, block_ids, k_cache, v_cache, gen, timed: bool) -> dict:
    """Read N_TOKENS distinct positions per (layer, kv head) from the pool
    in one launch; check the pieces against the caches the pool holds
    ((L, T, hkv, hd), token t at block ``block_ids[t // bt]``). Timed over
    ``cold_id_sets`` of the same pool and context length."""
    n_blocks, two_l, bt, hkv, hd = pool_data.shape
    layout = KVBlockLayout(bt, two_l // 2, hkv, hd)
    dev = pool_data.device
    ids, positions = read_ids(layout, torch.tensor(block_ids, device=dev), gen)
    view = pool_data.view(-1, 1, hd)
    before = kvk.sparse_kv_gather.launches
    pieces = ops.sparse_kv_gather(view, ids)
    launches = kvk.sparse_kv_gather.launches - before
    # want[l, f, h, t] = (k|v)_cache[l, pos[l, h, t], h]
    li = torch.arange(two_l // 2, device=dev)[:, None, None]
    hi = torch.arange(hkv, device=dev)[None, :, None]
    want = torch.stack([k_cache[li, positions, hi], v_cache[li, positions, hi]], dim=1)
    exact = torch.equal(pieces.reshape(want.shape), want)
    moved = 2 * pieces.numel() * pieces.element_size()
    us = NOT_MEASURED
    if timed and dev.type == "cuda":
        sets = cold_id_sets(layout, n_blocks, len(block_ids), gen)
        us = f"{cycled_ms(lambda i: ops.sparse_kv_gather(view, i), sets) * 1e3:.2f}"
    return dict(us=us, pieces=ids.numel(), piece_bytes=hd * pool_data.element_size(),
                launches=launches, bit_exact=exact, bound_us=byte_bound_us(moved),
                pool=tuple(pool_data.shape))


def random_pool(layout: KVBlockLayout, n_blocks: int, gen: torch.Generator):
    """Seeded bf16 caches of n_blocks * bt tokens, written into a pool by
    ``kv_gather_write`` in a shuffled block order, as a real pool scatters
    a context's blocks -> (pool, block ids in token order, k, v)."""
    L, bt, hkv, hd = layout.n_layers_kv, layout.block_tokens, layout.n_kv_heads, layout.head_dim
    shape, dev = (L, n_blocks * bt, hkv, hd), gen.device
    k = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    slots = torch.randperm(n_blocks, generator=gen, device=dev)
    pool = ops.kv_gather_write(k, v, slots.tolist(), bt)  # block i holds slot slots[i]
    return pool, slots.argsort().tolist(), k, v


def modeled_rows(frac: float) -> list[tuple]:
    """The reference's rows for a non-contiguous fraction ``frac``: the
    fraction itself, then the 16-token read latencies that the port's copy
    of the paper's CXL and RDMA fabric model gives (MODELED, not measured)."""
    rows = [("exp10.noncontiguous_fraction", f"{100*frac:.1f}",
             "paper: >74% of top-256 selections non-contiguous (Qwen-32B)")]
    for arch, paper_rdma, paper_cxl in PAPER:
        layout = KVBlockLayout.for_model(get_config(arch), BLOCK_TOKENS)
        res = {mode: transfer.sparse_read_latency(layout, N_TOKENS, 1 - frac, mode) * 1e6
               for mode in ("beluga", "rdma")}
        cut = 1 - res["beluga"] / res["rdma"]
        rows.append(
            (f"exp10.sparse16.{arch}", f"{res['beluga']:.0f}",
             f"rdma={res['rdma']:.0f}us;cut={100*cut:.1f}% "
             f"(paper: cxl={paper_cxl}us rdma={paper_rdma}us, -95.9%)")
        )
    return rows


def run(device=None, *, reduced: bool = False, pools: dict | None = None, seed: int = 0,
        timed: bool = True) -> list[tuple]:
    """All of exp10's rows, the contiguity on ``contiguity_config(reduced)``.
    ``pools``: arch -> (pool payload, block ids in token order, k cache, v
    cache) to read from; an arch not given gets a seeded random pool of its
    layout (``reduced``: the reduced config's). ``timed``: time each read on
    the card."""
    dev = resolve_device(device)
    cfg = contiguity_config(reduced)
    name = device_name(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    # (a) contiguity of the top-k selection, and its gather
    params = init_params(cfg, gen, dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, SEQ), generator=gen, device=dev)
    sel, k, v, scores = select_tokens(params, tokens, cfg)
    del params
    frac = noncontiguous_fraction(sel)
    kv, ids = topk_ids(k, v, sel)
    before = kvk.sparse_kv_gather.launches
    pieces = ops.sparse_kv_gather(kv, ids)
    launches = kvk.sparse_kv_gather.launches - before
    us = NOT_MEASURED
    if timed and dev.type == "cuda":  # one layer's K and V (655 KB) stay in L2, as after the layer
        us = f"{device_ms(lambda: ops.sparse_kv_gather(kv, ids)) * 1e3:.2f}"
    rows = modeled_rows(frac)
    rows.insert(1, (
        "exp10.topk_gather", us,
        f"model={cfg.name};d_model={cfg.d_model};heads={cfg.n_heads}/{cfg.n_kv_heads};"
        f"layers=1 of {cfg.n_layers};ids={pieces.shape[0]};rows_of={tuple(k.shape)};"
        f"launches={launches};bit_exact={torch.equal(pieces, kv[ids.long()])};"
        f"finite={bool(torch.isfinite(scores).all())};device={name}"))
    del k, v, kv, pieces

    # (b) the device form of the 16-token read, one launch per layout
    for arch, _, _ in PAPER:
        if pools and arch in pools:
            data, block_ids, kc, vc = pools[arch]
        else:
            acfg = reduced_config(arch) if reduced else get_config(arch)
            layout = KVBlockLayout.for_model(acfg, BLOCK_TOKENS)
            data, block_ids, kc, vc = random_pool(layout, POOL_BLOCKS[reduced], gen)
        r = sparse_read(data, block_ids, kc, vc, gen, timed)
        rows.append((
            f"exp10.sparse16.{arch}.device", r["us"],
            f"pieces={r['pieces']}x{r['piece_bytes']}B;pool={r['pool']};"
            f"launches={r['launches']};bit_exact={r['bit_exact']};"
            f"bound={r['bound_us']:.3f}us;device={name}"))
        del data, kc, vc

    # (c) the JAX toy case through the kernel
    kv = torch.arange(64 * 2 * 32, dtype=torch.float32, device=dev).reshape(64, 2, 32)
    ids = torch.tensor([3, 9, 11, 40, 41, 63], dtype=torch.int32, device=dev)
    ok = torch.equal(ops.sparse_kv_gather(kv, ids), ref.sparse_kv_gather_ref(kv, ids))
    rows.append(("exp10.kernel_allclose", "1", f"ok={ok}"))
    return rows


def main(argv: list[str] | None = None) -> list[tuple]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced qwen3-32b and reduced pool layouts")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    rows = run(args.device, reduced=args.reduced, seed=args.seed)
    print("# exp10.sparse16.<arch> (no suffix): MODELED by the paper's CXL/RDMA fabric "
          "(repro_torch/core/fabric.py); every other row: this run")
    emit(rows)
    return rows


if __name__ == "__main__":
    main()
