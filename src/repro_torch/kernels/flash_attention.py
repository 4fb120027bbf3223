"""GQA flash attention on the card: wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
``flash_attention`` (pallas_call at :135): causal or non-causal attention
of q (b, sq, hq, d) against k, v (b, skv, hkv, d), online softmax in f32,
tiles above the diagonal skipped. The bound is operations:
4 * b * hq * sq * skv * d (halved when causal) at 989 TFLOP/s in bf16.
The source's header says what the design does about it.

Takes float32 or bfloat16, head_dim a multiple of 16 up to 128; raises on
anything else. Counts its launches in ``flash_attention.launches``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "flash_attention_fwd": (
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
        ctypes.c_int,
    ),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(
    q: torch.Tensor,  # (b, sq, hq, d)
    k: torch.Tensor,  # (b, skv, hkv, d)
    v: torch.Tensor,
    causal: bool = True,
) -> torch.Tensor:
    for t in (q, k, v):
        if t.device.type != "cuda" or not t.is_contiguous() or t.dtype != q.dtype:
            raise ValueError("flash_attention takes contiguous q, k, v of one dtype on the card")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention takes float32 or bfloat16, not {q.dtype}")
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if d % 16 or not 16 <= d <= 128:
        raise ValueError(f"head_dim {d} is not a multiple of 16 in [16, 128]")
    if hq % hkv or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"bad shapes q {q.shape}, k {k.shape}, v {v.shape}")
    out = torch.empty_like(q)
    lib = build.load("flash_attention", SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, sq, skv, hq, hkv, d, int(causal),
            1.0 / math.sqrt(d), stream,
        )
    if rc:
        raise RuntimeError(f"flash_attention launch failed: cudaError_t {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
