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
Raises outside that. Counts its launches in ``ssd_chunk.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "ssd_chunk_fwd": (
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _LL, _LL, _LL, _P],
        ctypes.c_int,
    ),
    "ssd_chunk_info": ([_I, _I, ctypes.POINTER(ctypes.c_int)], ctypes.c_int),
}
_BC_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_LC, MAX_N, MAX_HP = 256, 128, 64
TILE = 64  # rows of a row tile, columns of a column tile


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


def _info(bc_dtype: torch.dtype, op: int) -> int:
    lib = build.load("ssd_chunk", SIGNATURES)
    out = ctypes.c_int(0)
    rc = lib.ssd_chunk_info(_BC_DTYPES[bc_dtype], op, ctypes.byref(out))
    if rc:
        raise RuntimeError(f"ssd_chunk_info failed: cudaError_t {rc}")
    return out.value


def ctas_per_sm(bc_dtype: torch.dtype) -> int:
    """Resident CTAs per SM of the instantiation for B/C of ``bc_dtype``
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    return _info(bc_dtype, 1)


def smem_bytes(bc_dtype: torch.dtype) -> int:
    """Dynamic shared memory of that instantiation, in bytes."""
    return _info(bc_dtype, 2)


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
    if b_mat.dim() != 4 or c_mat.shape != b_mat.shape or b_mat.shape[:2] != (nb, lc):
        raise ValueError(f"bad shapes x {x.shape}, b {b_mat.shape}, c {c_mat.shape}")
    if b_mat.stride(2) == 0:  # heads expanded from one group
        b_mat, c_mat = b_mat[:, :, :1], c_mat[:, :, :1]
    g, n = b_mat.shape[2], b_mat.shape[3]
    if not (0 < lc <= MAX_LC and 0 < n <= MAX_N and 0 < hp <= MAX_HP) or nh % g:
        raise ValueError(
            f"ssd_chunk takes Lc <= {MAX_LC}, n <= {MAX_N}, hp <= {MAX_HP} and nh a "
            f"multiple of the groups; got Lc {lc}, n {n}, hp {hp}, nh {nh}, groups {g}"
        )
    for t in (x, a_log, b_mat, c_mat):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError("ssd_chunk takes tensors on the card, all on one device")
    if x.dtype != torch.float32 or a_log.dtype != torch.float32:
        raise ValueError(f"x and a_log must be float32, got {x.dtype}, {a_log.dtype}")
    if tuple(a_log.shape) != (nb, lc, nh) or not (x.is_contiguous() and a_log.is_contiguous()):
        raise ValueError(f"x and a_log must be contiguous, a_log {(nb, lc, nh)}")
    if b_mat.dtype not in _BC_DTYPES or c_mat.dtype != b_mat.dtype:
        raise ValueError(f"b and c must be one of float32, bfloat16; got {b_mat.dtype}, "
                         f"{c_mat.dtype}")
    if b_mat.stride() != c_mat.stride() or b_mat.stride(3) != 1:
        raise ValueError("b and c must share strides, with a contiguous last axis")
    y = torch.empty_like(x)
    states = torch.empty((nb, nh, n, hp), dtype=torch.float32, device=x.device)
    cum = torch.empty_like(a_log) if return_cum else None
    lib = build.load("ssd_chunk", SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_chunk_fwd(
            x.data_ptr(), a_log.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
            y.data_ptr(), states.data_ptr(), cum.data_ptr() if return_cum else None,
            _BC_DTYPES[b_mat.dtype], nb, lc, nh, hp, n, g, *b_mat.stride()[:3], stream,
        )
    if rc:
        raise RuntimeError(f"ssd_chunk launch failed: cudaError_t {rc}")
    ssd_chunk.launches += 1
    return (y, states, cum) if return_cum else (y, states)


ssd_chunk.launches = 0
