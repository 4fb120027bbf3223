"""Dispatcher between the CUDA kernels and their plain PyTorch versions.

``mode`` (twin of ``repro/kernels/ops.py``'s ``kernel_mode``):
  * "auto"   — the kernel for a tensor on the card, the plain version for a
               tensor on the CPU (the only reason the plain version runs);
  * "kernel" — the kernel; raises for a tensor on the CPU;
  * "ref"    — the plain version wherever the tensor lies (tests and
               ``chip_smoke.py`` compare the two with it).

There is no fallback: a kernel that fails to build or launch raises.

A tensor on the ``meta`` device under "auto" or "kernel" takes the kernel
route's structure: the same wrappers, ``FlashAttention`` and ``SsdChunk``
under autograd, each wrapper's shape-only stand-in in place of its launch
(``launch/op_analysis.py``'s dry run), so that a dry run and the card
dispatch the same ops and a backward is recorded as ``flash_attention_bwd``
or ``ssd_chunk_bwd``. It is no fallback either: a tensor on the card still
launches the kernel, and one on the CPU still takes the plain version.

``KERNELS[name].cost(**shapes)`` gives a call's (FLOPs, bytes): what the
kernel must read and write and the products it computes (causal pairs
only); ``chip_smoke.py``'s bounds and ``launch/roofline.py`` read it.

Under autograd (grad enabled and q, k or v requiring grad) the kernel
route of ``flash_attention`` goes through ``FlashAttention``, a
``torch.autograd.Function`` whose forward is the forward kernel with its
log-sum-exp and whose backward is ``flash_attention_bwd``; otherwise it is
one forward launch, as serving runs it. ``ssd_chunk`` likewise: under
autograd its kernel route goes through ``SsdChunk``, whose forward is the
forward kernel and whose backward is ``ssd_chunk_bwd``. The plain versions
train through PyTorch's own autograd.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import accounting
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import kv_transfer as _kv
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd_chunk as _ssd

MODES = ("auto", "kernel", "ref")
KERNELS = {
    "kv_gather_write": _kv.kv_gather_write,
    "kv_scatter_read": _kv.kv_scatter_read,
    "flash_attention": _fa.flash_attention,
    "flash_attention_bwd": _fa.flash_attention_bwd,
    "paged_attention": _pa.paged_attention,
    "ssd_chunk": _ssd.ssd_chunk,
    "ssd_chunk_bwd": _ssd.ssd_chunk_bwd,
    "sparse_kv_gather": _kv.sparse_kv_gather,
}


def use_kernel(t: torch.Tensor, mode: str) -> bool:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if mode == "kernel" and t.device.type not in accounting.DEVICES:
        raise ValueError(f"mode='kernel' needs a tensor on the card, got {t.device}")
    return mode == "kernel" or (mode == "auto" and t.device.type in accounting.DEVICES)


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def flash_routes() -> dict[str, int]:
    """flash_attention's launches per route ("wgmma", "cuda_cores")."""
    return dict(_fa.flash_attention.launches_by_route)


def paged_kv() -> dict[str, int]:
    """paged_attention's launches per K/V dtype ("float32", "bfloat16",
    "float8_e4m3fn": the e4m3 instantiation)."""
    return dict(_pa.paged_attention.launches_by_kv)


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    _fa.reset_launch_counts()
    _pa.reset_launch_counts()


def bwd_kernels() -> dict[str, int]:
    """flash_attention_bwd's launches per kernel ("delta", "dkdv", "dq")."""
    return dict(_fa.flash_attention_bwd.launches_by_kernel)


def bwd_routes() -> dict[str, int]:
    """flash_attention_bwd's calls per route ("wgmma", "cuda_cores")."""
    return dict(_fa.flash_attention_bwd.launches_by_route)


def _differentiated(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class FlashAttention(torch.autograd.Function):
    """The forward kernel, saving its output and log-sum-exp; the backward
    kernels for the gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = _fa.flash_attention(q, k, v, causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _fa.flash_attention_bwd(q, k, v, o, lse, do.contiguous(), ctx.causal)
        return dq, dk, dv, None


class SsdChunk(torch.autograd.Function):
    """The forward kernel, saving its inputs; the backward kernel for the
    gradient of y, the states and (with ``return_cum``) the prefix sums.
    A cotangent that is missing (an output the loss does not read) goes in
    as zeros, or as no dcum."""

    @staticmethod
    def forward(ctx, x, a_log, b_mat, c_mat, return_cum: bool):
        ctx.save_for_backward(x, a_log, b_mat, c_mat)
        ctx.set_materialize_grads(False)
        return _ssd.ssd_chunk(x, a_log, b_mat, c_mat, return_cum=return_cum)

    @staticmethod
    def backward(ctx, dy, dst, dcum=None):
        x, a_log, b_mat, c_mat = ctx.saved_tensors
        nb, _, nh, hp = x.shape
        if dy is None:
            dy = torch.zeros_like(x)
        if dst is None:
            dst = x.new_zeros((nb, nh, b_mat.shape[3], hp))
        dx, da, db, dc = _ssd.ssd_chunk_bwd(
            x, a_log, b_mat, c_mat, dy.contiguous(), dst.contiguous(),
            None if dcum is None else dcum.contiguous())
        return dx, da, db.to(b_mat.dtype), dc.to(c_mat.dtype), None


def flash_attention(q, k, v, *, causal: bool = True, mode: str = "auto"):
    """The kernel takes contiguous q, k, v: a rank's slice of the kv heads
    (``attention.kv_for_heads``) is copied into one first."""
    if use_kernel(q, mode):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if _differentiated(q, k, v):
            return FlashAttention.apply(q, k, v, causal)
        return _fa.flash_attention(q, k, v, causal=causal)
    return _ref.flash_attention_ref(q, k, v, causal=causal)


def kv_gather_write(k_cache, v_cache, slot_ids, block_tokens: int, *, mode: str = "auto"):
    """(L, T, hkv, hd) caches -> pool payload (n_blocks, 2L, bt, hkv, hd)."""
    ids = _kv.check_slots(slot_ids, k_cache.shape[1] // block_tokens)
    if use_kernel(k_cache, mode):
        return _kv.kv_gather_write(k_cache, v_cache, ids, block_tokens)
    slots = torch.tensor(ids, dtype=torch.long, device=k_cache.device)
    return _ref.kv_gather_write_ref(k_cache, v_cache, slots, block_tokens)


def kv_scatter_read(pool_blocks, slot_ids, n_slots: int, *, mode: str = "auto"):
    """Pool payload -> (k, v) caches (L, n_slots * bt, hkv, hd), zero where unmapped."""
    ids = _kv.check_slots(slot_ids, n_slots)
    if len(ids) != pool_blocks.shape[0]:
        raise ValueError(f"{len(ids)} slot ids for {pool_blocks.shape[0]} blocks")
    if use_kernel(pool_blocks, mode):
        return _kv.kv_scatter_read(pool_blocks, ids, n_slots)
    n, two_l, bt, hkv, hd = pool_blocks.shape
    k0 = torch.zeros((two_l // 2, n_slots * bt, hkv, hd), dtype=pool_blocks.dtype,
                     device=pool_blocks.device)
    slots = torch.tensor(ids, dtype=torch.long, device=pool_blocks.device)
    return _ref.kv_scatter_read_ref(pool_blocks, slots, k0, k0, bt)


def sparse_kv_gather(kv, token_ids, *, mode: str = "auto"):
    """Rows ``token_ids`` of a token-major (N, hkv, hd) view -> (n_sel, hkv, hd);
    ids in [-N, 0) wrap, any other out-of-range id gives a NaN row."""
    if use_kernel(kv, mode):
        return _kv.sparse_kv_gather(kv, token_ids)
    return _ref.sparse_kv_gather_ref(kv, token_ids)


def paged_attention(q, k_blocks, v_blocks, block_table, context_lens, *, mode: str = "auto",
                    return_lse: bool = False):
    """q (b, hq, d) over (n_blocks, bt, hkv, d) K/V blocks -> (b, hq, d);
    with ``return_lse`` also each head's log-sum-exp, (b, hq) f32.

    K/V in q's dtype, or in ``float8_e4m3fn`` (an fp8 cache) under a
    float32 or bf16 q: the kernel's e4m3 instantiation on the card, the
    plain version's fp8 contract on the CPU; any other fp8 type raises.
    The table is one built by ``paged_attention.make_block_table`` on q's
    device, which checked its entries once; it is not checked again here.
    """
    _pa.kind(q.dtype, k_blocks.dtype)
    if not (isinstance(block_table, torch.Tensor) and block_table.device == q.device
            and block_table.dtype == torch.int32):
        raise ValueError("block_table must be an int32 tensor on q's device, built by "
                         "paged_attention.make_block_table")
    context_lens = context_lens.to(device=q.device, dtype=torch.int32)
    if use_kernel(q, mode):  # q contiguous: one head a rank gathers as a strided view
        return _pa.paged_attention(q.contiguous(), k_blocks, v_blocks, block_table, context_lens,
                                   return_lse=return_lse)
    return _ref.paged_attention_ref(q, k_blocks, v_blocks, block_table, context_lens,
                                    return_lse=return_lse)


def ssd_chunk(x, a_log, b_mat, c_mat, *, return_cum: bool = False, mode: str = "auto"):
    """Intra-chunk SSD + chunk states over (nb, Lc) tiles; B/C group-shaped.
    With ``return_cum`` also the prefix sums of a_log over each chunk."""
    if use_kernel(x, mode):
        if _differentiated(x, a_log, b_mat, c_mat):
            if b_mat.stride(2) == 0 and b_mat.shape[2] > 1:  # heads expanded from one group
                b_mat, c_mat = b_mat[:, :, :1], c_mat[:, :, :1]
            return SsdChunk.apply(x, a_log, b_mat, c_mat, return_cum)
        return _ssd.ssd_chunk(x, a_log, b_mat, c_mat, return_cum=return_cum)
    return _ref.ssd_chunk_ref(x, a_log, b_mat, c_mat, return_cum=return_cum)
