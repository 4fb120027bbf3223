"""Paged decode attention on the card: wrapper of ``csrc/paged_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py``
``paged_attention`` (pallas_call at :128): one query token per row
attends over keys and values held in blocks of ``bt`` tokens, looked up
through a block table. The bound is bytes: the K and V rows below each
row's context, read once, at 3.35 TB/s. The source's header says what the
design does about it.

K and V come as two block views ``(n_blocks, bt, hkv, d)`` that share one
stride between blocks, each block contiguous inside; so the JAX pool
layout ``(n, 2, bt, hkv, d)``, one layer of the port's fused pool
``(n, 2L, bt, hkv, d)`` and a dense decode cache cut into blocks are all
read in place (``pool_layer``, ``dense_blocks``).

Block tables are checked on the host where they are built
(``make_block_table``): entries in [-1, n_blocks), -1 read as block 0. The
kernel trusts a table that already lies on the card, so a decode loop
builds its table once and never syncs to re-check it.

One call is one kernel launch: ``plan`` picks S CTAs per (row, kv head),
one thread-block cluster, from the SM count, the kernel's resident CTAs per
SM and the clusters that fit at once (read once per device and shape, then
cached); the kernel takes each row's share of blocks from its context on
the card (``split_ranges`` is the same formula) and the cluster merges its
splits through distributed shared memory in the same launch. The call
needs no scratch in device memory: a warm call allocates only its output
(from PyTorch's caching allocator) and never synchronises, so it can be
captured into a CUDA graph after one warm-up call at its shapes (which
builds the kernel and reads the plan) and replayed with new
``context_lens`` written in place.

bfloat16 runs on the tensor cores (mma.sync, the group's up to 8 query
heads as the products' N), float32 on the CUDA cores; a whole group a CTA
in both. An fp8 cache, K and V in ``float8_e4m3fn`` under a float32 or
bfloat16 q, runs the tensor-core kernel with its e4m3 instantiation: a
tile arrives at one byte an element and is widened to bf16 in shared
memory, q * scale is rounded to bf16 once and the output is in q's dtype,
as JAX's decode after ``_dequant`` (``ref.paged_attention_ref``).

Takes (q, K/V) in (float32, float32), (bfloat16, bfloat16), (float32,
float8_e4m3fn) or (bfloat16, float8_e4m3fn), head_dim 16, 32, 64, 80 or
128, at most 8 query heads per kv head; raises on anything else (e5m2
included). Counts its launches in ``paged_attention.launches``, one per
kernel launched, by K/V dtype in ``paged_attention.launches_by_kv``, and
those that stored the log-sum-exp in ``paged_attention.launches_with_lse``.

With ``return_lse`` the kernel also stores each head's log-sum-exp of its
scaled scores, (b, hq) f32 (-inf at context 0): a sequence sharded over
ranks (the pool-interleaved decode, ``models/attention.py``) is attended
shard by shard and the partials merged by it.

On the ``meta`` device it allocates its outputs and launches nothing (a
dry run's shape-only stand-in, ``launch/op_analysis.py``), and counts no
launch. ``paged_attention.cost`` gives a call's (FLOPs, bytes) for the K/V
rows it reads: a dry run has no contexts, so each launch tells
``accounting.kernel`` the cost of its table's whole capacity (a full
cache, which is what a decode cell reads); a measured call's bound passes
its contexts.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import accounting, build

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "paged_attention_fwd": (
        [_P, _P, _P, _LL, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
        ctypes.c_int,
    ),
    "paged_attention_ctas_per_sm": ([_I, _I, _I, ctypes.POINTER(_I)], ctypes.c_int),
    "paged_attention_smem": ([_I, _I, _I, ctypes.POINTER(_I)], ctypes.c_int),
    "paged_attention_max_clusters": ([_I, _I, _I, _I, ctypes.POINTER(_I)], ctypes.c_int),
}
# (q dtype, K/V dtype) -> the C entry's dtype code (csrc/paged_attention.cu)
KINDS = {(torch.float32, torch.float32): 0, (torch.bfloat16, torch.bfloat16): 1,
         (torch.float32, torch.float8_e4m3fn): 2, (torch.bfloat16, torch.float8_e4m3fn): 3}
KV_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
            torch.float8_e4m3fn: "float8_e4m3fn"}
HEAD_DIMS = (16, 32, 64, 80, 128)
MAX_GROUP = 8
MAX_SPLITS = 16  # the CTAs of one (row, kv head) form one thread-block cluster


def cost(b: int, hq: int, hkv: int, d: int, tokens: int, q_bytes: int = 2,
         kv_bytes: int | None = None, lse: bool = False) -> tuple[int, int]:
    """(FLOPs, bytes) of one call reading ``tokens`` K/V rows over its b rows
    (the sum of their contexts): q.K^T and P.V, 4 d a row a q head; each K
    and V row read once at ``kv_bytes`` an element (default q's), q read,
    out (and the f32 log-sum-exp) written."""
    kv_bytes = q_bytes if kv_bytes is None else kv_bytes
    nbytes = 2 * tokens * hkv * d * kv_bytes + 2 * b * hq * d * q_bytes
    return 4 * hq * tokens * d, nbytes + (4 * b * hq if lse else 0)


def plan_splits(n_sms: int, ctas_per_sm: int, b: int, hkv: int, max_blocks: int,
                clusters_resident=None) -> int:
    """S, the CTAs per (row, kv head), one thread-block cluster: enough that
    b * hkv * S fill the card's resident capacity (SMs x CTAs per SM) in one
    wave, at most MAX_SPLITS (a cluster's limit) and the table's blocks, and
    no more than lets all b * hkv clusters be resident at once
    (``clusters_resident(S)``, when given). Llama-3.1-8B decode (b 1, hkv 8)
    on 132 SMs at one CTA per SM takes 16."""
    pairs = max(1, b * hkv)
    splits = max(1, min(max_blocks, MAX_SPLITS, n_sms * ctas_per_sm // pairs))
    while splits > 1 and clusters_resident is not None and clusters_resident(splits) < pairs:
        splits -= 1
    return splits


def split_ranges(ctx: int, bt: int, splits: int) -> list[tuple[int, int]]:
    """The pool blocks [lo, hi) each active split of a row reads, as the
    kernel computes them on the card (``csrc/paged_attention.cu``): nb =
    ceil(ctx / bt) blocks over S_r = min(splits, nb) splits, split s taking
    [s * nb // S_r, (s + 1) * nb // S_r). ``ctx`` is the row's context,
    already clamped to the table; a row of context 0 has no split."""
    if ctx <= 0:
        return []
    nb = -(-ctx // bt)
    active = min(splits, nb)
    return [(s * nb // active, (s + 1) * nb // active) for s in range(active)]


def kind(dtype: torch.dtype, kv_dtype: torch.dtype | None = None) -> int:
    """The kernel's dtype code for a q of ``dtype`` over K/V of ``kv_dtype``
    (default: the same); raises on a pair no kernel takes."""
    pair = (dtype, kv_dtype or dtype)
    if pair not in KINDS:
        raise ValueError(f"paged_attention takes (q, K/V) dtypes {list(KINDS)}, not {pair}")
    return KINDS[pair]


@functools.lru_cache(maxsize=None)
def ctas_per_sm(device: torch.device, dtype: torch.dtype, d: int, g: int,
                kv_dtype: torch.dtype | None = None) -> int:
    """Resident CTAs per SM of the kernel that takes (q dtype, K/V dtype, d,
    group), from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``."""
    return _query(device, "paged_attention_ctas_per_sm", kind(dtype, kv_dtype), d, g)


@functools.lru_cache(maxsize=None)
def clusters_resident(device: torch.device, dtype: torch.dtype, d: int, g: int,
                      splits: int, kv_dtype: torch.dtype | None = None) -> int:
    """Clusters of ``splits`` CTAs of that kernel resident at once, from
    ``cudaOccupancyMaxActiveClusters``."""
    return _query(device, "paged_attention_max_clusters", kind(dtype, kv_dtype), d, g, splits)


def ring_bytes(device: torch.device, dtype: torch.dtype, d: int, g: int,
               kv_dtype: torch.dtype | None = None) -> int:
    """Dynamic shared memory (the K/V stages) of that kernel, in bytes."""
    return _query(device, "paged_attention_smem", kind(dtype, kv_dtype), d, g)


def _query(device, fn: str, code: int, d: int, g: int, *more: int) -> int:
    lib = build.load("paged_attention", SIGNATURES)
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = getattr(lib, fn)(code, d, g, *more, ctypes.byref(out))
    if rc or out.value < 1:
        raise RuntimeError(f"{fn}(dtype code {code}, d {d}, group {g}, {more}) failed: "
                           f"cudaError_t {rc}, got {out.value}")
    return out.value


@functools.lru_cache(maxsize=None)
def plan(device: torch.device, dtype: torch.dtype, d: int, g: int, b: int, hkv: int,
         max_blocks: int, kv_dtype: torch.dtype | None = None) -> tuple[int, int]:
    """(splits, CTAs per SM) of a call on ``device``, sized for the
    instantiation that takes (q dtype, K/V dtype); read once per shape."""
    per_sm = ctas_per_sm(device, dtype, d, g, kv_dtype)
    splits = plan_splits(build.sm_count(device), per_sm, b, hkv, max_blocks,
                         lambda s: clusters_resident(device, dtype, d, g, s, kv_dtype))
    return splits, per_sm


def make_block_table(rows, n_blocks: int, device) -> torch.Tensor:
    """(b, max_blocks) int32 on ``device``; raises on an entry outside [-1, n_blocks)."""
    table = torch.as_tensor(rows, dtype=torch.int32, device="cpu")
    if table.dim() != 2:
        raise ValueError(f"block table must be (b, max_blocks), got {tuple(table.shape)}")
    bad = table[(table < -1) | (table >= n_blocks)]
    if bad.numel():
        raise ValueError(
            f"block table entries {bad.tolist()[:8]} outside [-1, {n_blocks})"
        )
    return table.to(device)


def pool_layer(pool: torch.Tensor, layer: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K and V block views of one layer of a (n, 2L, bt, hkv, d) pool, no copy."""
    return pool[:, 2 * layer], pool[:, 2 * layer + 1]


def dense_blocks(cache: torch.Tensor, bt: int) -> torch.Tensor:
    """A dense (b, max_len, hkv, d) cache as (b * max_len / bt, bt, hkv, d) blocks;
    row i's block j is block i * (max_len / bt) + j."""
    b, max_len, hkv, d = cache.shape
    if max_len % bt:
        raise ValueError(f"max_len {max_len} is not a multiple of the block size {bt}")
    return cache.view(b * (max_len // bt), bt, hkv, d)


def paged_attention(
    q: torch.Tensor,  # (b, hq, d)
    k_blocks: torch.Tensor,  # (n_blocks, bt, hkv, d)
    v_blocks: torch.Tensor,
    block_table: torch.Tensor,  # (b, max_blocks) int32 on the card
    context_lens: torch.Tensor,  # (b,) int32 on the card
    return_lse: bool = False,
):
    """-> out (b, hq, d) in q's dtype; with ``return_lse``, (out, lse (b,
    hq) f32): each head's natural log-sum-exp of its scaled scores, -inf
    where the context is 0. The same launch either way; serving passes no
    lse and the kernel stores none."""
    code = kind(q.dtype, k_blocks.dtype)
    for t in (q, k_blocks, v_blocks, block_table, context_lens):
        if t.device != q.device or t.device.type not in accounting.DEVICES:
            raise ValueError("paged_attention takes tensors on the card, all on one device")
    b, hq, d = q.shape
    n, bt, hkv, _ = k_blocks.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"{hq} query heads over {hkv} kv heads: need a group of <= {MAX_GROUP}")
    if v_blocks.shape != k_blocks.shape or k_blocks.shape[3] != d:
        raise ValueError(f"bad shapes q {q.shape}, k {k_blocks.shape}, v {v_blocks.shape}")
    inner = (hkv * d, d, 1)
    if (v_blocks.dtype != k_blocks.dtype or not q.is_contiguous()
            or k_blocks.stride()[1:] != inner or v_blocks.stride() != k_blocks.stride()):
        raise ValueError("k/v blocks must share one dtype and one block stride, "
                         "each block contiguous; q contiguous")
    if (block_table.dtype != torch.int32 or block_table.dim() != 2
            or block_table.shape[0] != b or not block_table.is_contiguous()):
        raise ValueError(f"block table must be ({b}, max_blocks) int32, contiguous")
    if context_lens.dtype != torch.int32 or tuple(context_lens.shape) != (b,):
        raise ValueError(f"context_lens must be ({b},) int32")
    max_blocks = block_table.shape[1]
    with accounting.kernel("paged_attention", cost(
            b, hq, hkv, d, b * max_blocks * bt, q.element_size(), k_blocks.element_size(),
            return_lse)):
        out = torch.empty_like(q)
        lse = torch.empty((b, hq), dtype=torch.float32, device=q.device) if return_lse else None
        if b and q.device.type != "meta":
            _launch(q, k_blocks, v_blocks, block_table, context_lens, out, lse, code)
    return (out, lse) if return_lse else out


def _launch(q, k_blocks, v_blocks, block_table, context_lens, out, lse, code: int) -> None:
    b, hq, d = q.shape
    _, bt, hkv, _ = k_blocks.shape
    item = k_blocks.element_size()
    if (k_blocks.data_ptr() | v_blocks.data_ptr()) % 16 or k_blocks.stride(0) * item % 16:
        raise ValueError("k/v blocks must be 16-byte aligned, as must the block stride")
    if q.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned")
    max_blocks = block_table.shape[1]
    g = hq // hkv
    splits, _ = plan(q.device, q.dtype, d, g, b, hkv, max_blocks, k_blocks.dtype)
    lib = build.load("paged_attention", SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_attention_fwd(
            q.data_ptr(), k_blocks.data_ptr(), v_blocks.data_ptr(), k_blocks.stride(0),
            block_table.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None, code, b, hq, hkv, d, bt, max_blocks,
            splits, 1.0 / math.sqrt(d), stream,
        )
    if rc:
        raise RuntimeError(f"paged_attention launch failed: cudaError_t {rc}")
    paged_attention.launches += 1
    paged_attention.launches_by_kv[KV_NAMES[k_blocks.dtype]] += 1
    if lse is not None:
        paged_attention.launches_with_lse += 1


def reset_launch_counts() -> None:
    paged_attention.launches = 0
    paged_attention.launches_with_lse = 0
    paged_attention.launches_by_kv = dict.fromkeys(KV_NAMES.values(), 0)


reset_launch_counts()
paged_attention.cost = cost
