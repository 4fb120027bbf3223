"""KV gather-write / scatter-read and the sparse token gather on the card:
wrappers of ``csrc/kv_transfer.cu``.

Replaces the Pallas TPU kernels ``repro/kernels/kv_transfer.py``
``kv_gather_write`` (pallas_call at :76), ``kv_scatter_read`` (:132) and
``sparse_kv_gather`` (:172). One launch moves every (block, layer, k|v)
fragment, each a contiguous run of ``bt * hkv * hd`` elements on both
sides, with 16-byte vector copies; one launch gathers every selected token
row. The bound is bytes: (bytes read + bytes written) / 3.35 TB/s on an H100.

Contract, shared with the plain versions in ``ref.py`` (``ops.py`` checks
slot ids for both): slot ids must be distinct and in range, else
``ValueError``. The JAX versions instead let the last duplicate win (the
oracle's scan) and clamp an out-of-range slot (``dynamic_slice``).
``kv_scatter_read`` returns caches whose unmapped slots are zero: the
output is allocated with ``torch.zeros``, as the JAX oracle path does
(``repro/kernels/ops.py:69-74``); the Pallas kernel leaves them unwritten.

``sparse_kv_gather`` follows the JAX oracle (``jnp.take``), as
``ref.sparse_kv_gather_ref`` does: ids in [-N, 0) wrap, any other id out of
range gives a NaN row. The Pallas kernel clamps such ids instead. Its
kernel runs in at most one resident wave, one unit a lane where the read
fits: ``sparse_plan`` is the Python mirror of how it splits the pieces over
CTAs and lanes.

Each wrapper counts its launches in ``<wrapper>.launches``. On the
``meta`` device the gather-write and the scatter-read allocate their
outputs and launch nothing (a dry run's shape-only stand-in,
``launch/op_analysis.py``), and count no launch; ``sparse_kv_gather``,
which no ``Model`` cell reaches, takes no meta tensor past its checks.
``<wrapper>.cost`` gives a call's (FLOPs, bytes), none of them FLOPs:
each byte read once and each written once; each launch tells
``accounting.kernel`` its cost.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.kernels import accounting, build

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _LL, _P]
SIGNATURES = {
    "kv_gather_write": (_ARGS, ctypes.c_int),
    "kv_scatter_read": (_ARGS, ctypes.c_int),
    "sparse_kv_gather": ([_P, _P, _P, _I, _I, _I, _I, ctypes.c_uint, _I, _P], ctypes.c_int),
    "sparse_kv_gather_ctas_per_sm": ([_I, _I, ctypes.POINTER(_I)], ctypes.c_int),
}
# each float dtype's quiet NaN, replicated to fill a 4-byte word
NAN_BITS = {torch.float32: 0x7FC00000, torch.bfloat16: 0x7FC07FC0, torch.float16: 0x7E007E00}
INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1
# the sparse kernel's constants (csrc/kv_transfer.cu): threads per CTA and
# units a lane holds in flight
SPARSE_THREADS, SPARSE_LANE_UNITS = 128, 2


def gather_write_cost(n_blocks: int, layers: int, block_tokens: int, hkv: int, hd: int,
                      elem_bytes: int = 2) -> tuple[int, int]:
    """(FLOPs, bytes) of packing n_blocks blocks of ``layers`` layers' K and
    V: each fragment read from the caches and written into the payload."""
    return 0, 2 * n_blocks * 2 * layers * block_tokens * hkv * hd * elem_bytes


def scatter_read_cost(n_blocks: int, layers: int, n_slots: int, block_tokens: int, hkv: int,
                      hd: int, elem_bytes: int = 2) -> tuple[int, int]:
    """(FLOPs, bytes) of unpacking n_blocks blocks into two (layers, n_slots
    * block_tokens, hkv, hd) caches: the payload read, both caches written
    whole (the unmapped slots' zeros included)."""
    payload = n_blocks * 2 * layers * block_tokens * hkv * hd * elem_bytes
    return 0, payload + 2 * layers * n_slots * block_tokens * hkv * hd * elem_bytes


def sparse_gather_cost(n_sel: int, row_bytes: int) -> tuple[int, int]:
    """(FLOPs, bytes) of gathering n_sel token rows of ``row_bytes``: each
    read once and written once."""
    return 0, 2 * n_sel * row_bytes


def check_slots(slot_ids, n_slots: int) -> list[int]:
    """Slot ids as a list; raises on a duplicate or out-of-range id."""
    ids = torch.as_tensor(slot_ids).tolist()
    bad = [s for s in ids if not 0 <= s < n_slots]
    if bad:
        raise ValueError(f"slot ids {bad} out of range [0, {n_slots})")
    if len(set(ids)) != len(ids):
        raise ValueError(f"duplicate slot ids in {ids}")
    return ids


def _frag_vec(block_tokens: int, hkv: int, hd: int, dtype: torch.dtype) -> int:
    frag_bytes = block_tokens * hkv * hd * dtype.itemsize
    if frag_bytes % 16:
        raise ValueError(f"fragment of {frag_bytes} bytes is not a multiple of 16")
    return frag_bytes // 16


def _check_cuda(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.device.type not in accounting.DEVICES or not t.is_contiguous():
            raise ValueError("the CUDA kernel takes contiguous tensors on the card")
        if t.dtype != ts[0].dtype:
            raise ValueError(f"dtype mismatch: {t.dtype} vs {ts[0].dtype}")


def _launch(fn: str, args: list, device: torch.device) -> None:
    lib = build.load("kv_transfer", SIGNATURES)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc:
        raise RuntimeError(f"{fn} launch failed: cudaError_t {rc}")


def _device_ids(ids, device: torch.device) -> torch.Tensor:
    """int32 ids on ``device``, cast after clamping to int32's range (an id
    past it stays out of range). Ids from the host are staged in pinned
    memory and copied without blocking, so the call never waits for the
    card (a plain ``torch.tensor(..., device="cuda")`` synchronises)."""
    ids = (ids if isinstance(ids, torch.Tensor) else torch.as_tensor(ids)).reshape(-1)
    if ids.dtype != torch.int32:
        ids = ids.clamp(INT32_MIN, INT32_MAX).to(torch.int32)
    if ids.device.type == "cpu" and device.type == "cuda":
        ids = ids.pin_memory()
    return ids.to(device, non_blocking=True).contiguous()


def kv_gather_write(
    k_cache: torch.Tensor,  # (L, T, hkv, hd)
    v_cache: torch.Tensor,
    slot_ids: list[int],  # checked by ``check_slots``
    block_tokens: int,
) -> torch.Tensor:
    """-> pool payload (n_blocks, 2L, block_tokens, hkv, hd)."""
    _check_cuda(k_cache, v_cache)
    L, T, hkv, hd = k_cache.shape
    if v_cache.shape != k_cache.shape or T % block_tokens:
        raise ValueError(f"bad cache shapes {k_cache.shape}, {v_cache.shape}")
    n = len(slot_ids)
    with accounting.kernel("kv_gather_write", gather_write_cost(
            n, L, block_tokens, hkv, hd, k_cache.element_size())):
        out = torch.empty(
            (n, 2 * L, block_tokens, hkv, hd), dtype=k_cache.dtype, device=k_cache.device
        )
        slots = _device_ids(slot_ids, k_cache.device)
        if k_cache.device.type != "meta":
            _launch("kv_gather_write", [
                k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(), slots.data_ptr(),
                n, L, T // block_tokens, _frag_vec(block_tokens, hkv, hd, k_cache.dtype),
            ], k_cache.device)
            kv_gather_write.launches += 1
    return out


kv_gather_write.launches = 0
kv_gather_write.cost = gather_write_cost


def kv_scatter_read(
    pool_blocks: torch.Tensor,  # (n_blocks, 2L, bt, hkv, hd)
    slot_ids: list[int],  # checked by ``check_slots``
    n_slots: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (k_cache, v_cache), each (L, n_slots * bt, hkv, hd), zero where unmapped."""
    _check_cuda(pool_blocks)
    n, two_l, bt, hkv, hd = pool_blocks.shape
    L = two_l // 2
    with accounting.kernel("kv_scatter_read", scatter_read_cost(
            n, L, n_slots, bt, hkv, hd, pool_blocks.element_size())):
        k = torch.zeros((L, n_slots * bt, hkv, hd), dtype=pool_blocks.dtype,
                        device=pool_blocks.device)
        v = torch.zeros_like(k)
        slots = _device_ids(slot_ids, pool_blocks.device)
        if pool_blocks.device.type != "meta":
            _launch("kv_scatter_read", [
                pool_blocks.data_ptr(), k.data_ptr(), v.data_ptr(), slots.data_ptr(),
                n, L, n_slots, _frag_vec(bt, hkv, hd, pool_blocks.dtype),
            ], pool_blocks.device)
            kv_scatter_read.launches += 1
    return k, v


kv_scatter_read.launches = 0
kv_scatter_read.cost = scatter_read_cost


@dataclasses.dataclass(frozen=True)
class SparsePlan:
    grid: int  # CTAs: at most one resident wave and one per piece
    ranges: tuple[tuple[int, int], ...]  # each CTA's pieces [lo, hi)
    units_per_lane: int  # the most units a lane loads before it stores


def sparse_grid(wave: int, n_sel: int, row_units: int) -> int:
    """The kernel's grid: one CTA per SPARSE_THREADS units, so every lane
    copies one unit, but no more CTAs than the card holds at once
    (``wave``) or than pieces."""
    return max(1, min(wave, n_sel, -(-n_sel * row_units // SPARSE_THREADS)))


def sparse_plan(n_sms: int, ctas_per_sm: int, n_sel: int, row_units: int) -> SparsePlan:
    """How the kernel splits n_sel pieces of ``row_units`` units: CTA c takes
    pieces [c*q + min(c, r), (c+1)*q + min(c+1, r)) of q, r = divmod(n_sel,
    grid). A CTA's lanes take its units in turn, SPARSE_THREADS apart, each
    loading up to SPARSE_LANE_UNITS before it stores them."""
    grid = sparse_grid(n_sms * ctas_per_sm, n_sel, row_units)
    q, r = divmod(n_sel, grid)
    ranges = tuple((c * q + min(c, r), (c + 1) * q + min(c + 1, r)) for c in range(grid))
    most = (q + (r > 0)) * row_units
    return SparsePlan(grid, ranges, min(SPARSE_LANE_UNITS, -(-most // SPARSE_THREADS)))


@functools.lru_cache(maxsize=None)
def sparse_wave(device: torch.device, unit: int, row_units: int) -> int:
    """SMs x resident CTAs per SM of the kernel for (unit, row_units), from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; read once."""
    lib = build.load("kv_transfer", SIGNATURES)
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.sparse_kv_gather_ctas_per_sm(unit, row_units, ctypes.byref(per_sm))
    if rc or per_sm.value < 1:
        raise RuntimeError(f"sparse_kv_gather_ctas_per_sm({unit}, {row_units}) failed: "
                           f"cudaError_t {rc}, got {per_sm.value}")
    return build.sm_count(device) * per_sm.value


def sparse_args(kv: torch.Tensor, ids: torch.Tensor, out: torch.Tensor) -> list | None:
    """The C entry's arguments but the stream: the route (16-B units, or
    elements where a row or a base is not 16-byte aligned), the row in
    units and the grid; None when there is nothing to copy. Raises past the
    kernel's 32-bit offsets and for a tensor off the card."""
    row_bytes = math.prod(kv.shape[1:]) * kv.element_size()
    aligned = kv.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    unit = 16 if row_bytes % 16 == 0 and aligned else kv.element_size()
    row_units, n_sel = row_bytes // unit, ids.numel()
    if max(kv.shape[0], n_sel) * row_units > INT32_MAX:  # the kernel's offsets are 32-bit
        raise ValueError(f"{max(kv.shape[0], n_sel)} rows of {row_units} units pass the "
                         f"kernel's 32-bit offsets ({INT32_MAX} units)")
    if kv.device.type != "cuda":  # no meta stand-in: no Model cell reads the pool
        raise ValueError("the CUDA kernel takes contiguous tensors on the card")
    _check_cuda(kv)
    if out.numel() == 0:
        return None
    grid = sparse_grid(sparse_wave(kv.device, unit, row_units), n_sel, row_units)
    return [kv.data_ptr(), out.data_ptr(), ids.data_ptr(), n_sel, kv.shape[0], row_units,
            unit, NAN_BITS[kv.dtype], grid]


def sparse_kv_gather(
    kv: torch.Tensor,  # (N, hkv, hd) token-major, contiguous, on the card
    token_ids,  # (n_sel,) ints: a list or a tensor
) -> torch.Tensor:
    """-> (n_sel, hkv, hd): row ``token_ids[i]`` of ``kv``, NaN where the id
    is out of range (see the module's note). One launch; none for no ids."""
    if kv.dtype not in NAN_BITS:
        raise ValueError(f"sparse_kv_gather takes {tuple(NAN_BITS)}, got {kv.dtype}")
    n_sel = token_ids.numel() if isinstance(token_ids, torch.Tensor) else len(token_ids)
    row_bytes = math.prod(kv.shape[1:]) * kv.element_size()
    with accounting.kernel("sparse_kv_gather", sparse_gather_cost(n_sel, row_bytes)):
        ids = _device_ids(token_ids, kv.device)
        out = torch.empty((ids.numel(), *kv.shape[1:]), dtype=kv.dtype, device=kv.device)
        args = sparse_args(kv, ids, out)
        if args is None:
            return out
        _launch("sparse_kv_gather", args, kv.device)
        sparse_kv_gather.launches += 1
    return out


sparse_kv_gather.launches = 0
sparse_kv_gather.cost = sparse_gather_cost
