"""The attention backward's plain version against JAX's gradients, on the CPU.

``flash_attention_bwd_ref`` (what the backward kernels compute: P
recomputed from the forward's log-sum-exp, D = rowsum(dO * O), dK and dV
summed over each GQA group) and PyTorch autograd through
``ops.flash_attention(mode="ref")`` are held against ``jax.grad`` of the
JAX oracle ``repro.kernels.ref.flash_attention_ref`` and of the chunked
flash attention JAX trains through, ``repro.models.attention.flash_attention``
with chunks shorter than the sequences, on the same numpy-seeded inputs and
output gradient: GQA groups 1, 2 and 4, head_dim 16, 64 and 80, causal and
not, sq != skv both ways (the causal mask aligned at position 0).

Tolerances, relative to the largest |gradient|: float32 1e-5 (the readings
were under 1e-6: f32 sums in other orders). bfloat16 2e-2, the bf16
tolerance of tests/test_kernels.py: both sides round the gradients to bf16
once, and the backward reads the forward's bf16-rounded output in D where
JAX's softmax VJP uses the unrounded one. The kernels themselves run on the
card only (tests/test_torch_gpu.py, chip_smoke.py).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

# (b, sq, skv, hq, hkv, d, causal)
CASES = [
    (1, 24, 24, 2, 2, 16, True),  # group 1
    (2, 20, 20, 4, 2, 64, True),  # group 2
    (1, 17, 33, 8, 2, 80, True),  # group 4, sq < skv, qwen3-32b's head_dim
    (1, 33, 17, 4, 1, 16, True),  # group 4, sq > skv: rows past skv see every key
    (2, 16, 24, 4, 1, 64, False),  # non-causal
    (1, 24, 24, 4, 2, 80, False),
]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CHUNK = 8  # JAX's chunked flash: chunks shorter than every sequence here


def _inputs(case, dtype: str, seed: int = 0):
    b, sq, skv, hq, hkv, d, _ = case
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d), (b, sq, hq, d))]
    arrs = [np.asarray(jnp.asarray(a).astype(dtype)) for a in arrs]  # rounded once, by JAX
    return arrs, [tensor_from_numpy(a, "cpu") for a in arrs]


def _jax_grads(fn, arrs):
    def grads(q, k, v, do):
        return jax.vjp(fn, q, k, v)[1](do)

    return jax.jit(grads)(*(jnp.asarray(a) for a in arrs))


def _check(got, want, tol: float):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(jnp.asarray(w).astype(jnp.float32))
        top = max(np.abs(w).max(), 1e-30)
        err = np.abs(g.float().numpy() - w).max() / top
        assert err <= tol, f"{name}: {err:.3g} of the largest |grad| > {tol}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_bwd_ref_matches_jax_grad_of_the_oracle(case, dtype):
    causal = case[-1]
    arrs, (q, k, v, do) = _inputs(case, dtype)
    o, lse = ref.flash_attention_lse_ref(q, k, v, causal)
    got = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    assert [g.dtype for g in got] == [q.dtype] * 3
    want = _jax_grads(lambda q_, k_, v_: jref.flash_attention_ref(q_, k_, v_, causal), arrs)
    _check(got, want, TOL[dtype])


@pytest.mark.parametrize("case", CASES)
def test_plain_autograd_matches_jax_grad_of_chunked_flash(case):
    causal = case[-1]
    arrs, (q, k, v, do) = _inputs(case, "float32", seed=1)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ops.flash_attention(*leaves, causal=causal, mode="ref").backward(do)
    want = _jax_grads(lambda q_, k_, v_: jattn.flash_attention(
        q_, k_, v_, causal=causal, chunk_q=CHUNK, chunk_kv=CHUNK), arrs)
    _check([t.grad for t in leaves], want, TOL["float32"])


@pytest.mark.parametrize("case", CASES)
def test_bwd_ref_matches_jax_grad_of_chunked_flash(case):
    causal = case[-1]
    arrs, (q, k, v, do) = _inputs(case, "float32", seed=2)
    o, lse = ref.flash_attention_lse_ref(q, k, v, causal)
    got = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    want = _jax_grads(lambda q_, k_, v_: jattn.flash_attention(
        q_, k_, v_, causal=causal, chunk_q=CHUNK, chunk_kv=CHUNK), arrs)
    _check(got, want, TOL["float32"])


@pytest.mark.parametrize("case", CASES)
def test_lse_ref_is_the_log_sum_exp_of_the_scaled_masked_scores(case):
    b, sq, skv, hq, hkv, d, causal = case
    arrs, (q, k, v, _) = _inputs(case, "float32", seed=3)
    o, lse = ref.flash_attention_lse_ref(q, k, v, causal)
    assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
    assert torch.equal(o, ref.flash_attention_ref(q, k, v, causal))
    qn, kn = arrs[0].astype(np.float64), np.repeat(arrs[1], hq // hkv, axis=2).astype(np.float64)
    s = np.einsum("bqhd,bkhd->bhqk", qn, kn) / math.sqrt(d)
    if causal:
        s = np.where(np.arange(sq)[:, None] >= np.arange(skv)[None, :], s, -np.inf)
    top = s.max(-1, keepdims=True)
    want = (top + np.log(np.exp(s - top).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-5)


def test_autograd_on_the_cpu_runs_the_plain_version_and_launches_nothing():
    _, (q, k, v, do) = _inputs(CASES[1], "float32", seed=4)
    ops.reset_launch_counts()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ops.flash_attention(*leaves).backward(do)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ops.flash_attention(*plain, mode="ref").backward(do)
    assert all(torch.equal(a.grad, b.grad) for a, b in zip(leaves, plain))
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    assert ops.bwd_kernels() == dict.fromkeys(fa.BWD_KERNELS, 0)


def test_backward_wrapper_refuses_cpu_tensors():
    _, (q, k, v, do) = _inputs(CASES[0], "float32")
    o, lse = ref.flash_attention_lse_ref(q, k, v)
    with pytest.raises(ValueError, match="on the card"):
        fa.flash_attention_bwd(q, k, v, o, lse, do)
    with pytest.raises(ValueError, match="on the card"):
        fa.flash_attention(q, k, v, return_lse=True)
