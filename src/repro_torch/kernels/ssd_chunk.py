"""Mamba-2 intra-chunk SSD on the card: wrapper of ``csrc/ssd_chunk.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_chunk.py`` ``ssd_chunk``
(pallas_call at :72): over (nb, Lc) chunk tiles, the intra-chunk output
y = (C.B^T * causal exp(cum_l - cum_m)).x and the chunk-final state
sum_l exp(cum_last - cum_l) B_l (outer) x_l, both float32, and on request
the prefix sums cum themselves. The products run on the tensor cores as
split (3xTF32) passes that keep float32 accuracy; the bound is bytes; the
source's header says what the design does about it.

B and C come group-shaped, (nb, Lc, g, n) with head h reading group
h // (nh // g), so the model never materialises the broadcast over heads;
a head axis expanded with stride 0 is read as one group. Takes x and a_log
in float32, B and C in float32 or bfloat16; Lc <= 256, n <= 128, hp <= 64.
Raises outside that. Counts its launches in ``ssd_chunk.launches``. On the
``meta`` device it allocates its outputs and launches nothing (a dry run's
shape-only stand-in, ``launch/op_analysis.py``), and counts no launch.

``ssd_chunk_bwd`` wraps ``csrc/ssd_chunk_bwd.cu``, the gradient of the
three outputs (y, the states, the prefix sums), which no Pallas kernel has
(JAX differentiates its jnp chunked SSD): a CTA per (chunk tile, block of a
group's heads, 64-token column tile) with its products on the tensor cores
as split TF32 passes (bf16 C.B^T in one pass), G^T and the head block's dG^T
kept in shared memory, then two small kernels that sum the CTAs' partials
in a fixed order (``bwd_plan`` says which); no atomics, so two calls give
the same bits. It counts its calls in ``ssd_chunk_bwd.launches`` (three
kernels each); on ``meta`` it allocates its outputs and scratch and
launches nothing.

``ssd_chunk.cost`` and ``ssd_chunk_bwd.cost`` give a call's (FLOPs,
bytes): the products on causal pairs, each input read once and each output
written once; ``forward_flops`` and ``backward_flops`` split the FLOPs by
the rate they run at (B/C's type, f32 on the TF32 tensor cores). Each
launch tells ``accounting.kernel`` its cost.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import accounting, build

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "ssd_chunk_fwd": (
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _LL, _LL, _LL, _P],
        ctypes.c_int,
    ),
    "ssd_chunk_info": ([_I, _I, ctypes.POINTER(ctypes.c_int)], ctypes.c_int),
}
BWD_SIGNATURES = {
    "ssd_chunk_bwd": ([_P] * 15 + [_I] * 8 + [_LL, _LL, _LL, _P], ctypes.c_int),
    "ssd_chunk_bwd_info": ([_I, _I, ctypes.POINTER(ctypes.c_int)], ctypes.c_int),
}
_BC_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_LC, MAX_N, MAX_HP = 256, 128, 64
TILE = 64  # rows of a row tile, columns of a column tile


def forward_flops(nb: int, lc: int, nh: int, hp: int, g: int, n: int) -> tuple[int, int]:
    """(FLOPs in B/C's type, f32 FLOPs) of one forward call on causal pairs:
    C.B^T per group; P.x and B^T.(w x) per head."""
    pairs = lc * (lc + 1) // 2
    return nb * g * 2 * pairs * n, nb * nh * (2 * pairs * hp + 2 * lc * n * hp)


def forward_cost(nb: int, lc: int, nh: int, hp: int, g: int, n: int, bc_bytes: int = 2,
                 return_cum: bool = False) -> tuple[int, int]:
    """(FLOPs, bytes) of one forward call: x, a_log, B, C read; y, the
    states (and cum) written, f32 but B and C."""
    nbytes = (4 * (2 * nb * lc * nh * hp + (2 if return_cum else 1) * nb * lc * nh
                   + nb * nh * n * hp) + 2 * bc_bytes * nb * lc * g * n)
    return sum(forward_flops(nb, lc, nh, hp, g, n)), nbytes


def backward_flops(nb: int, lc: int, nh: int, hp: int, g: int, n: int) -> tuple[int, int]:
    """(FLOPs in B/C's type, f32 FLOPs) of one backward call on causal
    pairs: per head dM = dy.x^T, M^T.dy, w dst^T B, w x dst^T; per group
    G = C.B^T (B/C's type), dG^T.C and dG.B after the head sum (f32)."""
    pairs = lc * (lc + 1) // 2
    return (nb * g * 2 * pairs * n,
            nb * nh * (4 * pairs * hp + 4 * lc * n * hp) + nb * g * 4 * pairs * n)


def backward_cost(nb: int, lc: int, nh: int, hp: int, g: int, n: int, bc_bytes: int = 2,
                  with_dcum: bool = False) -> tuple[int, int]:
    """(FLOPs, bytes) of one backward call: x, dy, a_log, dst (and dcum), B,
    C read; dx, da, dB, dC written."""
    nbytes = (4 * (3 * nb * lc * nh * hp + nb * nh * n * hp
                   + (3 if with_dcum else 2) * nb * lc * nh) + 4 * bc_bytes * nb * lc * g * n)
    return sum(backward_flops(nb, lc, nh, hp, g, n)), nbytes


def tile_schedule(lc: int) -> list[list[tuple[int, int]]]:
    """The kernel's (row tile, column tile) steps for one (chunk, head), per
    CTA of its cluster, in the order each CTA walks them: CTA p takes row
    tiles n_lt - 1 - p, then p (once where they coincide), each against its
    column tiles 0 .. row. A CTA adds the chunk state over its diagonal
    steps (row == column)."""
    n_lt = -(-lc // TILE)
    plan = []
    for p in range((n_lt + 1) // 2):
        rows = [n_lt - 1 - p] + ([p] if p != n_lt - 1 - p else [])
        plan.append([(r, c) for r in rows for c in range(r + 1)])
    return plan


MAX_HEAD_BLOCK = 16  # heads of one group per backward CTA


def head_block(nh: int, g: int) -> int:
    """Heads per backward CTA: the largest divisor of a group's nh // g
    heads up to MAX_HEAD_BLOCK. The block's heads share B and C, so their
    dG is summed before it meets B and C, and each block leaves one
    partial of dB and dC per tile for the reduction."""
    rep = nh // g
    return max(d for d in range(1, min(rep, MAX_HEAD_BLOCK) + 1) if rep % d == 0)


def pair_index(c: int, r: int, n_lt: int) -> int:
    """Slot of the tile pair (column tile c, row tile r >= c) in the
    backward's scratch, column tiles in order."""
    return c * n_lt - c * (c - 1) // 2 + (r - c)


def bwd_plan(nb: int, lc: int, nh: int, g: int) -> dict:
    """The backward's plan: head block, tile counts (the main kernel's grid
    is nb * head blocks by column tiles) and its scratch shapes, float32:
    dB's partial per column tile and dC's per tile pair (64 x 128 each, per
    chunk and head block), the row sums of dM * M per column tile (with the
    column sums and u of its own rows folded in), and the sums of u. G per
    tile pair stays in the CTA's shared memory."""
    hblk = head_block(nh, g)
    nhb, n_lt = nh // hblk, -(-lc // TILE)
    npairs = n_lt * (n_lt + 1) // 2
    return {
        "head_block": hblk, "head_blocks": nhb, "n_lt": n_lt, "pairs": npairs,
        "scratch": {
            "dbpart": (nb, nhb, n_lt, TILE, MAX_N),
            "dcpart": (nb, nhb, npairs, TILE, MAX_N),
            "rowpart": (nb, n_lt, n_lt * TILE, nh),
            "usum": (nb, n_lt, nh),
        },
    }


def _info(bc_dtype: torch.dtype, op: int, name: str = "ssd_chunk") -> int:
    lib = build.load(name, SIGNATURES if name == "ssd_chunk" else BWD_SIGNATURES)
    out = ctypes.c_int(0)
    rc = getattr(lib, f"{name}_info")(_BC_DTYPES[bc_dtype], op, ctypes.byref(out))
    if rc:
        raise RuntimeError(f"{name}_info failed: cudaError_t {rc}")
    return out.value


def ctas_per_sm(bc_dtype: torch.dtype, name: str = "ssd_chunk") -> int:
    """Resident CTAs per SM of the instantiation for B/C of ``bc_dtype``
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor); ``name``
    "ssd_chunk_bwd" for the backward's main kernel."""
    return _info(bc_dtype, 1, name)


def smem_bytes(bc_dtype: torch.dtype, name: str = "ssd_chunk") -> int:
    """Dynamic shared memory of that instantiation, in bytes."""
    return _info(bc_dtype, 2, name)


def _check_inputs(name, x, a_log, b_mat, c_mat):
    """(B, C) with a stride-0 head axis read as one group, after the checks
    both kernels make."""
    nb, lc, nh, hp = x.shape
    if b_mat.dim() != 4 or c_mat.shape != b_mat.shape or b_mat.shape[:2] != (nb, lc):
        raise ValueError(f"bad shapes x {x.shape}, b {b_mat.shape}, c {c_mat.shape}")
    if b_mat.stride(2) == 0:  # heads expanded from one group
        b_mat, c_mat = b_mat[:, :, :1], c_mat[:, :, :1]
    g, n = b_mat.shape[2], b_mat.shape[3]
    if not (0 < lc <= MAX_LC and 0 < n <= MAX_N and 0 < hp <= MAX_HP) or nh % g:
        raise ValueError(
            f"{name} takes Lc <= {MAX_LC}, n <= {MAX_N}, hp <= {MAX_HP} and nh a "
            f"multiple of the groups; got Lc {lc}, n {n}, hp {hp}, nh {nh}, groups {g}"
        )
    for t in (x, a_log, b_mat, c_mat):
        if t.device != x.device or t.device.type not in accounting.DEVICES:
            raise ValueError(f"{name} takes tensors on the card, all on one device")
    if x.dtype != torch.float32 or a_log.dtype != torch.float32:
        raise ValueError(f"x and a_log must be float32, got {x.dtype}, {a_log.dtype}")
    if tuple(a_log.shape) != (nb, lc, nh) or not (x.is_contiguous() and a_log.is_contiguous()):
        raise ValueError(f"x and a_log must be contiguous, a_log {(nb, lc, nh)}")
    if b_mat.dtype not in _BC_DTYPES or c_mat.dtype != b_mat.dtype:
        raise ValueError(f"b and c must be one of float32, bfloat16; got {b_mat.dtype}, "
                         f"{c_mat.dtype}")
    if b_mat.stride() != c_mat.stride() or b_mat.stride(3) != 1:
        raise ValueError("b and c must share strides, with a contiguous last axis")
    return b_mat, c_mat


def ssd_chunk(
    x: torch.Tensor,  # (nb, Lc, nh, hp) f32, dt-scaled
    a_log: torch.Tensor,  # (nb, Lc, nh) f32
    b_mat: torch.Tensor,  # (nb, Lc, g, n) f32 or bf16
    c_mat: torch.Tensor,
    return_cum: bool = False,
):
    """-> (y_intra (nb, Lc, nh, hp) f32, states (nb, nh, n, hp) f32), and
    cum (nb, Lc, nh) f32, the prefix sums of a_log over each chunk, with
    ``return_cum``."""
    nb, lc, nh, hp = x.shape
    b_mat, c_mat = _check_inputs("ssd_chunk", x, a_log, b_mat, c_mat)
    g, n = b_mat.shape[2], b_mat.shape[3]
    with accounting.kernel("ssd_chunk", forward_cost(nb, lc, nh, hp, g, n,
                                                     b_mat.element_size(), return_cum)):
        y = torch.empty_like(x)
        states = torch.empty((nb, nh, n, hp), dtype=torch.float32, device=x.device)
        cum = torch.empty_like(a_log) if return_cum else None
        if x.device.type != "meta":
            lib = build.load("ssd_chunk", SIGNATURES)
            with torch.cuda.device(x.device):
                stream = torch.cuda.current_stream(x.device).cuda_stream
                rc = lib.ssd_chunk_fwd(
                    x.data_ptr(), a_log.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
                    y.data_ptr(), states.data_ptr(), cum.data_ptr() if return_cum else None,
                    _BC_DTYPES[b_mat.dtype], nb, lc, nh, hp, n, g, *b_mat.stride()[:3],
                    stream,
                )
            if rc:
                raise RuntimeError(f"ssd_chunk launch failed: cudaError_t {rc}")
            ssd_chunk.launches += 1
    return (y, states, cum) if return_cum else (y, states)


ssd_chunk.launches = 0


def ssd_chunk_bwd(
    x: torch.Tensor,  # (nb, Lc, nh, hp) f32, as the forward took them
    a_log: torch.Tensor,  # (nb, Lc, nh) f32
    b_mat: torch.Tensor,  # (nb, Lc, g, n) f32 or bf16
    c_mat: torch.Tensor,
    dy: torch.Tensor,  # (nb, Lc, nh, hp) f32: cotangent of y_intra
    dst: torch.Tensor,  # (nb, nh, n, hp) f32: of the states
    dcum: torch.Tensor | None = None,  # (nb, Lc, nh) f32: of cum; None is zero
):
    """-> (dx (nb, Lc, nh, hp) f32, da (nb, Lc, nh) f32, dB, dC (nb, Lc, g, n)
    contiguous in B's dtype, each the sum over its group's heads rounded
    once). A head axis expanded with stride 0 is read as one group, and its
    gradient is that group's: (nb, Lc, 1, n)."""
    nb, lc, nh, hp = x.shape
    b_mat, c_mat = _check_inputs("ssd_chunk_bwd", x, a_log, b_mat, c_mat)
    g, n = b_mat.shape[2], b_mat.shape[3]
    want = {"dy": (dy, (nb, lc, nh, hp)), "dst": (dst, (nb, nh, n, hp))}
    if dcum is not None:
        want["dcum"] = (dcum, (nb, lc, nh))
    for name, (t, shape) in want.items():
        if (tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != x.device):
            raise ValueError(f"{name} must be a contiguous float32 {shape} on x's device, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    plan = bwd_plan(nb, lc, nh, g)
    f32 = {"dtype": torch.float32, "device": x.device}
    with accounting.kernel("ssd_chunk_bwd", backward_cost(nb, lc, nh, hp, g, n,
                                                         b_mat.element_size(),
                                                         dcum is not None)):
        scratch = {k: torch.empty(shape, **f32) for k, shape in plan["scratch"].items()}
        dx, da = torch.empty_like(x), torch.empty_like(a_log)
        db = torch.empty((nb, lc, g, n), dtype=b_mat.dtype, device=x.device)
        dc = torch.empty_like(db)
        if x.device.type != "meta":
            lib = build.load("ssd_chunk_bwd", BWD_SIGNATURES)
            with torch.cuda.device(x.device):
                stream = torch.cuda.current_stream(x.device).cuda_stream
                rc = lib.ssd_chunk_bwd(
                    x.data_ptr(), a_log.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
                    dy.data_ptr(), dst.data_ptr(), None if dcum is None else dcum.data_ptr(),
                    dx.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(),
                    *(scratch[k].data_ptr() for k in ("dbpart", "dcpart", "rowpart", "usum")),
                    _BC_DTYPES[b_mat.dtype], nb, lc, nh, hp, n, g, plan["head_block"],
                    *b_mat.stride()[:3], stream,
                )
            if rc:
                raise RuntimeError(f"ssd_chunk_bwd launch failed: cudaError_t {rc}")
            ssd_chunk_bwd.launches += 1
    return dx, da, db, dc


ssd_chunk_bwd.launches = 0
ssd_chunk.cost = forward_cost
ssd_chunk_bwd.cost = backward_cost
