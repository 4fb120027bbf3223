"""GQA flash attention on the card: wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
``flash_attention`` (pallas_call at :135): causal or non-causal attention
of q (b, sq, hq, d) against k, v (b, skv, hkv, d), online softmax in f32,
tiles above the diagonal skipped. The bound is operations:
4 * b * hq * sq * skv * d (halved when causal) at 989 TFLOP/s in bf16.
The source's header says what each design does about it.

Two routes, picked from dtype and head_dim alone (``route``), never one
as a fallback for the other:

  * ``"wgmma"``: bfloat16 with head_dim 64, 80 or 128, the tensor cores fed
    by TMA, on a persistent grid of at most one CTA per SM (``cta_items``).
    P is rounded to bf16 for P.V, so it is not bit-equal to the plain
    version (within the bf16 tolerance of tests/test_kernels.py).
  * ``"cuda_cores"``: float32, and bfloat16 at the other multiples of 16 up
    to 128, on the f32 CUDA cores.

Raises on anything else, and on a build or launch failure of either route.
On the ``meta`` device it allocates its outputs and launches nothing (a
dry run's shape-only stand-in, ``launch/op_analysis.py``), and counts no
launch. Counts its launches in ``flash_attention.launches`` and per route in
``flash_attention.launches_by_route``. With ``return_lse`` either route
also stores each row's log-sum-exp (b, hq, sq) f32, natural log, which
``flash_attention_bwd`` reads.

``flash_attention_bwd`` wraps ``csrc/flash_attention_bwd.cu``, the
gradient (dq, dk, dv) the plain ``ref.flash_attention_bwd_ref`` computes,
in three kernels (the rows' statistics D = rowsum(dO * O); dK and dV per kv
tile, the GQA group summed inside a CTA; dQ per q tile), on the same two
routes as the forward, picked by the same ``route``: ``"wgmma"`` (bf16 at
d 64, 80 and 128, the products on the tensor cores fed by TMA) and
``"cuda_cores"`` (float32, and bf16 at the other multiples of 16 up to
128). Neither is a fallback for the other. It replaces no Pallas kernel
(JAX differentiates its jnp chunked flash); ``kernels/ops.py`` runs it
under autograd. Counts its calls in ``flash_attention_bwd.launches``, per
route in ``flash_attention_bwd.launches_by_route`` and each kernel's
launches in ``flash_attention_bwd.launches_by_kernel``; on ``meta`` it
too allocates its outputs and launches nothing.

``flash_attention.cost`` and ``flash_attention_bwd.cost`` give a call's
(FLOPs, bytes): the products on the (query, key) pairs the mask keeps
(``attn_pairs``), each input read once and each output written once. Each
launch tells ``accounting.kernel`` its cost.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import accounting, build

ROUTES = ("wgmma", "cuda_cores")
WGMMA_HEAD_DIMS = (64, 80, 128)
# the wgmma route's tiles (csrc/flash_attention.cu, namespace wgmma_route)
BLOCK_Q = 128  # query rows per work item
BOX_COLS = 64  # 128 B of bf16: the widest box row under the 128-byte swizzle
BOX = (BOX_COLS, 1, BLOCK_Q, 1)  # (d, h, s, b) elements per TMA load, d 64 and 128
# d 80: a 160-byte row exceeds the 128-byte swizzle span, so a tile is five
# boxes of 16 columns (32 B) under the 32-byte swizzle
NARROW_BOX_COLS = 16
# the wgmma route's persistent grid: at most this many CTAs; None, one per SM
# (experiments/flash_probe.py sets it to time other grids)
GRID_CTAS: int | None = None

_P, _I = ctypes.c_void_p, ctypes.c_int
_U64P, _U32P = ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint32)
SIGNATURES = {
    "flash_attention_fwd": (
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
        ctypes.c_int,
    ),
    "flash_attention_wgmma_fwd": (
        [_P, _P, _P, _P, _P, _U64P, _U64P, _U64P, _U64P, _U32P,
         _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P],
        ctypes.c_int,
    ),
    "flash_attention_wgmma_smem": ([_I], ctypes.c_int),
}
BWD_SIGNATURES = {
    "flash_attention_bwd": (
        [_P] * 10 + [_I] * 8 + [ctypes.c_float, _P],
        ctypes.c_int,
    ),
    "flash_attention_bwd_smem": ([_I, _I], ctypes.c_int),
    "flash_attention_bwd_wgmma": (
        [_P] * 10 + [_U64P, _U64P, _U64P, _U64P, _U32P] + [_I] * 8 + [ctypes.c_float, _P],
        ctypes.c_int,
    ),
    "flash_attention_bwd_wgmma_smem": ([_I, _I], ctypes.c_int),
}
# the backward's kernels, in launch order (csrc/flash_attention_bwd.cu); on
# the wgmma route "delta" also packs each row's log-sum-exp beside D
BWD_KERNELS = ("delta", "dkdv", "dq")
# the backward's wgmma route (namespace wgmma_route of the source): a CTA
# owns BWD_BLOCK keys (dK/dV) or query rows (dQ), 64 per consumer
# warpgroup, and streams tiles of 64 query rows or keys past them; every
# TMA box is BWD_BOX_ROWS rows. The rows' (lse log2 e, D) scratch is padded
# to a multiple of BWD_BLOCK rows.
BWD_BLOCK, BWD_BOX_ROWS = 128, 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NO_ENCODER, _ENCODE_FAILED = 9999, 10000


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that takes these inputs: bf16 at d 64, 80 or 128 goes to
    the tensor cores, float32 and the other bf16 widths to the CUDA cores."""
    if dtype not in _DTYPES:
        raise ValueError(f"flash_attention takes float32 or bfloat16, not {dtype}")
    if head_dim % 16 or not 16 <= head_dim <= 128:
        raise ValueError(f"head_dim {head_dim} is not a multiple of 16 in [16, 128]")
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "cuda_cores"


def pick_route(dtype: torch.dtype, head_dim: int, force_route: str | None = None) -> str:
    """``route``'s pick, or ``force_route`` where that route takes these
    inputs (the forward and the backward alike); raises otherwise."""
    picked = route(dtype, head_dim)
    if force_route is None:
        return picked
    if force_route not in ROUTES:
        raise ValueError(f"route {force_route!r} not in {ROUTES}")
    if force_route == "wgmma" and picked != "wgmma":
        raise ValueError(f"the wgmma route takes bf16 at head_dim {WGMMA_HEAD_DIMS}")
    return force_route


def q_tile_order(n_q_tiles: int, heads_x_batch: int) -> list[int]:
    """The q tile of each work item of the wgmma route, by item number: item
    x takes tile n_q_tiles - 1 - x // heads_x_batch, so every head's longest
    causal tile comes first and the short ones last (the kernel's
    decode_item computes the same)."""
    return [n_q_tiles - 1 - x // heads_x_batch for x in range(n_q_tiles * heads_x_batch)]


def cta_items(n_items: int, ctas: int) -> list[list[int]]:
    """The work items each CTA of the persistent grid takes, in order: round
    r gives CTA c item r * ctas + c, reversed in odd rounds (a snake over the
    longest-first numbering), until the items run out (the kernel's
    item_index). The grid is min(n_items, ctas) CTAs."""
    grid = min(n_items, ctas)
    out = [[] for _ in range(grid)]
    for c in range(grid):
        r = 0
        while (x := r * grid + (grid - 1 - c if r % 2 else c)) < n_items:
            out[c].append(x)
            r += 1
    return out


def box_cols(d: int) -> int:
    """Columns of one TMA box at head_dim d: 64 (128 B) for d 64 and 128,
    16 (32 B) for d 80."""
    return BOX_COLS if d % BOX_COLS == 0 else NARROW_BOX_COLS


def tensor_map_args(shape: tuple[int, ...], elem_bytes: int = 2):
    """(dims, byte strides, box) of the rank-4 TMA map over a contiguous
    (b, s, h, d) tensor as it lies: dims innermost first (d, h, s, b), the
    byte strides of h, s and b (d's is the element), and the box of one load:
    ``box_cols(d)`` columns of one head over BLOCK_Q rows."""
    b, s, h, d = shape
    dims = (d, h, s, b)
    strides = (d * elem_bytes, h * d * elem_bytes, s * h * d * elem_bytes)
    return dims, strides, (box_cols(d), 1, BLOCK_Q, 1)


def _u64(vals):
    return (ctypes.c_uint64 * len(vals))(*vals)


def attn_pairs(sq: int, skv: int, causal: bool) -> int:
    """(query, key) pairs attention scores: under the causal mask aligned at
    position 0, row r sees min(r + 1, skv) keys."""
    if not causal:
        return sq * skv
    n = min(sq, skv)
    return n * (n + 1) // 2 + max(sq - skv, 0) * skv


def forward_cost(b: int, sq: int, skv: int, hq: int, hkv: int, d: int, causal: bool = True,
                 elem_bytes: int = 2, lse: bool = False) -> tuple[int, int]:
    """(FLOPs, bytes) of one forward call: Q.K^T and P.V, 4 d a kept pair a
    q head; q, k, v read, out (and the f32 log-sum-exp) written."""
    flops = 4 * b * hq * d * attn_pairs(sq, skv, causal)
    nbytes = (2 * b * sq * hq * d + 2 * b * skv * hkv * d) * elem_bytes
    return flops, nbytes + (4 * b * hq * sq if lse else 0)


def backward_cost(b: int, sq: int, skv: int, hq: int, hkv: int, d: int, causal: bool = True,
                  elem_bytes: int = 2) -> tuple[int, int]:
    """(FLOPs, bytes) of one backward call: 2.5 times the forward's products
    (S and dP recomputed, dV, dK, dQ); q, o, dO, k, v and the f32
    log-sum-exp read, dq, dk, dv written."""
    flops = 10 * b * hq * d * attn_pairs(sq, skv, causal)
    q_n, kv_n = b * sq * hq * d, b * skv * hkv * d
    return flops, (4 * q_n + 4 * kv_n) * elem_bytes + 4 * b * hq * sq


def flash_attention(    q: torch.Tensor,  # (b, sq, hq, d)
    k: torch.Tensor,  # (b, skv, hkv, d)
    v: torch.Tensor,
    causal: bool = True,
    *,
    force_route: str | None = None,
    return_lse: bool = False,
):
    """``force_route`` runs the named route where ``route`` would pick the
    other (chip_smoke.py times both on the same inputs); it raises where
    that route cannot take the inputs. With ``return_lse``, returns
    (out, lse (b, hq, sq) f32)."""
    for t in (q, k, v):
        if t.device.type not in accounting.DEVICES or not t.is_contiguous() or t.dtype != q.dtype:
            raise ValueError("flash_attention takes contiguous q, k, v of one dtype on the card")
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    picked = pick_route(q.dtype, d, force_route)
    if hq % hkv or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"bad shapes q {q.shape}, k {k.shape}, v {v.shape}")
    with accounting.kernel("flash_attention", forward_cost(
            b, sq, skv, hq, hkv, d, causal, q.element_size(), return_lse)):
        out = torch.empty_like(q)
        lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if return_lse \
            else None
        if q.device.type != "meta":
            _launch_forward(q, k, v, out, lse, causal, picked)
    if not return_lse:
        return out
    if skv == 0:  # no keys: the log-sum-exp of an empty row
        lse.fill_(-math.inf)
    return out, lse


def _launch_forward(q, k, v, out, lse, causal: bool, picked: str) -> None:
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    lse_ptr = lse.data_ptr() if lse is not None else None
    lib = build.load("flash_attention", SIGNATURES)
    if picked == "wgmma":
        for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
            if t.data_ptr() % 16:
                raise ValueError(f"the wgmma route's TMA needs 16-byte aligned tensors; "
                                 f"{name} starts at {t.data_ptr():#x}")
        q_dims, q_strides, box = tensor_map_args(tuple(q.shape))
        kv_dims, kv_strides, _ = tensor_map_args(tuple(k.shape))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if picked == "wgmma":
            rc = lib.flash_attention_wgmma_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_ptr,
                _u64(q_dims), _u64(q_strides), _u64(kv_dims), _u64(kv_strides),
                (ctypes.c_uint32 * 4)(*box), b, sq, skv, hq, hkv, d, int(causal),
                1.0 / math.sqrt(d), GRID_CTAS or build.sm_count(q.device), stream,
            )
        else:
            rc = lib.flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_ptr,
                _DTYPES[q.dtype], b, sq, skv, hq, hkv, d, int(causal),
                1.0 / math.sqrt(d), stream,
            )
    if rc == _NO_ENCODER:
        raise RuntimeError("flash_attention (wgmma): libcuda has no cuTensorMapEncodeTiled")
    if rc >= _ENCODE_FAILED:
        raise RuntimeError(f"flash_attention (wgmma): cuTensorMapEncodeTiled refused a map: "
                           f"CUresult {rc - _ENCODE_FAILED}")
    if rc:
        raise RuntimeError(f"flash_attention ({picked}) launch failed: cudaError_t {rc}")
    flash_attention.launches += 1
    flash_attention.launches_by_route[picked] += 1


def bwd_tensor_map_args(shape: tuple[int, ...], elem_bytes: int = 2):
    """``tensor_map_args`` for the backward's wgmma route: the same map over
    the (b, s, h, d) tensor as it lies, with boxes of BWD_BOX_ROWS rows."""
    dims, strides, box = tensor_map_args(shape, elem_bytes)
    return dims, strides, (box[0], 1, BWD_BOX_ROWS, 1)


def bwd_stat_rows(sq: int) -> int:
    """Rows per (batch row, q head) of the wgmma route's statistics scratch:
    sq rounded up to BWD_BLOCK (the padded rows hold (+inf, 0), so their P is
    0)."""
    return -(-sq // BWD_BLOCK) * BWD_BLOCK


def bwd_grids(b: int, sq: int, skv: int, hq: int, hkv: int) -> dict[str, tuple[int, int]]:
    """The wgmma route's CTA grids (x, y): dK/dV one CTA per (batch row, kv
    head) and BWD_BLOCK keys, dQ one per (batch row, q head) and BWD_BLOCK
    query rows."""
    return {"dkdv": (b * hkv, -(-skv // BWD_BLOCK)), "dq": (b * hq, -(-sq // BWD_BLOCK))}


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True, *,
                        force_route: str | None = None):
    """(dq, dk, dv) of ``flash_attention`` at output gradient ``do``, from
    the forward's inputs, its output ``o`` and its ``lse``; the gradients in
    the inputs' dtype. ``force_route`` runs the named route where ``route``
    would pick the other; it raises where that route cannot take the inputs.
    Raises on what the kernels do not take and on a build or launch
    failure."""
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        if t.device.type not in accounting.DEVICES or not t.is_contiguous() or t.dtype != q.dtype:
            raise ValueError(f"flash_attention_bwd takes contiguous tensors of one dtype on "
                             f"the card; {name} is {t.dtype} on {t.device}")
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    picked = pick_route(q.dtype, d, force_route)
    if (hq % hkv or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or o.shape != q.shape or do.shape != q.shape):
        raise ValueError(f"bad shapes q {q.shape}, k {k.shape}, v {v.shape}, o {o.shape}, "
                         f"do {do.shape}")
    if (lse.device != q.device or lse.dtype != torch.float32 or lse.shape != (b, hq, sq)
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous ({b}, {hq}, {sq}) float32 tensor on "
                         f"{q.device}, got {tuple(lse.shape)} {lse.dtype} on {lse.device}")
    with accounting.kernel("flash_attention_bwd", backward_cost(
            b, sq, skv, hq, hkv, d, causal, q.element_size())):
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        f32 = {"dtype": torch.float32, "device": q.device}
        if picked == "wgmma":  # the rows' (lse log2 e, D), padded
            stat = torch.empty((b, hq, bwd_stat_rows(sq), 2), **f32)
        else:  # the rows' D
            stat = torch.empty((b, hq, sq), **f32)
        if q.device.type != "meta":
            _launch_backward(q, k, v, o, lse, do, stat, dq, dk, dv, causal, picked)
    return dq, dk, dv


def _launch_backward(q, k, v, o, lse, do, stat, dq, dk, dv, causal: bool, picked: str) -> None:
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd needs 16-byte aligned tensors; {name} "
                             f"starts at {t.data_ptr():#x}")
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    lib = build.load("flash_attention_bwd", BWD_SIGNATURES)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            do.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if picked == "wgmma":
            q_dims, q_strides, box = bwd_tensor_map_args(tuple(q.shape))
            kv_dims, kv_strides, _ = bwd_tensor_map_args(tuple(k.shape))
            rc = lib.flash_attention_bwd_wgmma(
                *ptrs, stat.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                _u64(q_dims), _u64(q_strides), _u64(kv_dims), _u64(kv_strides),
                (ctypes.c_uint32 * 4)(*box), b, sq, skv, hq, hkv, d, stat.shape[2],
                int(causal), 1.0 / math.sqrt(d), stream,
            )
        else:
            rc = lib.flash_attention_bwd(
                *ptrs, stat.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                _DTYPES[q.dtype], b, sq, skv, hq, hkv, d, int(causal), 1.0 / math.sqrt(d),
                stream,
            )
    if rc == _NO_ENCODER:
        raise RuntimeError("flash_attention_bwd (wgmma): libcuda has no cuTensorMapEncodeTiled")
    if rc >= _ENCODE_FAILED:
        raise RuntimeError(f"flash_attention_bwd (wgmma): cuTensorMapEncodeTiled refused a "
                           f"map: CUresult {rc - _ENCODE_FAILED}")
    if rc:
        raise RuntimeError(f"flash_attention_bwd ({picked}) launch failed: cudaError_t {rc}")
    if b and sq and skv:  # otherwise a memset or nothing ran
        flash_attention_bwd.launches += 1
        flash_attention_bwd.launches_by_route[picked] += 1
        for name in BWD_KERNELS:
            flash_attention_bwd.launches_by_kernel[name] += 1


def reset_launch_counts() -> None:
    flash_attention.launches = 0
    flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
    flash_attention_bwd.launches = 0
    flash_attention_bwd.launches_by_route = dict.fromkeys(ROUTES, 0)
    flash_attention_bwd.launches_by_kernel = dict.fromkeys(BWD_KERNELS, 0)


reset_launch_counts()
flash_attention.cost = forward_cost
flash_attention_bwd.cost = backward_cost
