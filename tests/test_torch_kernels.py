"""The port's plain kernel versions against the JAX oracle and the Pallas kernels.

Inputs are made from a seed with numpy and handed to both frameworks (bf16
through the JAX cast, so both sides hold the same bits). Pallas runs as
tests/test_kernels.py runs it on the CPU (``mode="pallas"``, interpret mode).
Tolerances: data movement bit-exact; flash attention f32 2e-5, bf16 2e-2
(tests/test_kernels.py:42). The CUDA kernels themselves are held against
these plain versions on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import kv_transfer as kv
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ssd_chunk as ssd

# tiny shapes: one intra-op thread is as fast, and more threads would only
# spin against the other test workers, which share the CPU's cores
torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, 2e-5), "bfloat16": (jnp.bfloat16, 2e-2)}


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor on the CPU."""
    j = jnp.asarray(rng.standard_normal(shape, dtype=np.float32)).astype(dtype)
    return j, tensor_from_numpy(np.asarray(j), "cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    """Exact bits for comparison (bf16 as uint16)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


def _jnp_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------------------
# gather-write / scatter-read: bit-exact against oracle and Pallas
# ---------------------------------------------------------------------------

KV_SHAPES = [(3, 8, 16, 2, 32), (4, 6, 16, 2, 16), (1, 4, 8, 1, 16)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("L,n_slots,bt,hkv,hd", KV_SHAPES)
def test_gather_write_bit_exact(dtype, L, n_slots, bt, hkv, hd):
    rng = np.random.default_rng(L * 100 + n_slots)
    jk, tk = _pair(rng, (L, n_slots * bt, hkv, hd), DTYPES[dtype][0])
    jv, tv = _pair(rng, (L, n_slots * bt, hkv, hd), DTYPES[dtype][0])
    slots = rng.permutation(n_slots)[:3].tolist()
    got = _np(ops.kv_gather_write(tk, tv, slots, bt))
    js = jnp.asarray(slots, jnp.int32)
    assert np.array_equal(got, _jnp_bits(jref.kv_gather_write_ref(jk, jv, js, bt)))
    assert np.array_equal(got, _jnp_bits(jops.kv_gather_write(jk, jv, js, bt, mode="pallas")))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("L,n_slots,bt,hkv,hd", KV_SHAPES)
def test_scatter_read_bit_exact_with_zero_fill(dtype, L, n_slots, bt, hkv, hd):
    rng = np.random.default_rng(L * 10 + n_slots)
    n = 3
    jb, tb = _pair(rng, (n, 2 * L, bt, hkv, hd), DTYPES[dtype][0])
    slots = rng.permutation(n_slots)[:n].tolist()
    tk, tv = ops.kv_scatter_read(tb, slots, n_slots)
    js = jnp.asarray(slots, jnp.int32)
    # the JAX oracle path zero-fills unmapped slots: equal everywhere
    wk, wv = jops.kv_scatter_read(jb, js, n_slots, mode="jnp")
    assert np.array_equal(_np(tk), _jnp_bits(wk))
    assert np.array_equal(_np(tv), _jnp_bits(wv))
    # the Pallas kernel leaves unmapped slots unwritten: equal on mapped slots,
    # and the port's unmapped slots are zero
    pk, pv = jops.kv_scatter_read(jb, js, n_slots, mode="pallas")
    for got, want in ((tk, pk), (tv, pv)):
        g = _np(got).reshape(L, n_slots, bt, hkv, hd)
        w = _jnp_bits(want).reshape(L, n_slots, bt, hkv, hd)
        assert np.array_equal(g[:, slots], w[:, slots])
        unmapped = [s for s in range(n_slots) if s not in slots]
        assert not g[:, unmapped].any()


def test_slot_ids_checked_unlike_jax():
    """The port raises on duplicate or out-of-range slot ids, in both
    directions. The JAX oracle does not: its scan lets the LAST duplicate
    win, and ``dynamic_slice``/``dynamic_update_slice`` clamp an
    out-of-range slot to the last one."""
    L, n_slots, bt, hkv, hd = 2, 4, 8, 1, 16
    rng = np.random.default_rng(0)
    jb, tb = _pair(rng, (2, 2 * L, bt, hkv, hd), jnp.float32)
    jk, tk = _pair(rng, (L, n_slots * bt, hkv, hd), jnp.float32)
    k0 = jnp.zeros_like(jk)
    wk, _ = jref.kv_scatter_read_ref(jb, jnp.asarray([1, 1], jnp.int32), k0, k0, bt)
    last = np.asarray(jb).reshape(2, L, 2, bt, hkv, hd)[1, :, 0]
    assert np.array_equal(np.asarray(wk)[:, bt:2 * bt], last)  # last duplicate won
    wg = jref.kv_gather_write_ref(jk, jk, jnp.asarray([9], jnp.int32), bt)
    assert np.array_equal(np.asarray(wg)[0, 0], np.asarray(jk)[0, -bt:])  # clamped
    for bad in ([1, 1], [0, n_slots], [-1, 0]):
        with pytest.raises(ValueError, match="slot ids"):
            ops.kv_scatter_read(tb, bad, n_slots)
        with pytest.raises(ValueError, match="slot ids"):
            ops.kv_gather_write(tk, tk, bad, bt)


# ---------------------------------------------------------------------------
# flash attention: oracle and Pallas interpret
# ---------------------------------------------------------------------------

FLASH_SHAPES = [
    # (b, sq, skv, hq, hkv, d)
    (1, 48, 48, 4, 2, 16),  # the reduced configs' head_dim
    (2, 64, 64, 8, 2, 64),  # GQA 4:1
    (1, 100, 100, 4, 1, 128),  # MQA, ragged: 100 is no multiple of the 32-row blocks
]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_plain_matches_oracle_and_pallas(shape, dtype):
    b, sq, skv, hq, hkv, d = shape
    jdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(sum(shape))
    jq, tq = _pair(rng, (b, sq, hq, d), jdt)
    jk, tk = _pair(rng, (b, skv, hkv, d), jdt)
    jv, tv = _pair(rng, (b, skv, hkv, d), jdt)
    got = ops.flash_attention(tq, tk, tv, causal=True).float().numpy()
    want = np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=True), np.float32)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    pallas = jops.flash_attention(jq, jk, jv, causal=True, mode="pallas",
                                  block_q=32, block_kv=32)
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("causal,q_offset", [(False, 0), (True, 0), (True, 24)])
def test_flash_plain_noncausal_and_q_offset(causal, q_offset):
    rng = np.random.default_rng(5)
    jq, tq = _pair(rng, (1, 40, 4, 32), jnp.float32)
    jk, tk = _pair(rng, (1, 64, 2, 32), jnp.float32)
    jv, tv = _pair(rng, (1, 64, 2, 32), jnp.float32)
    got = ref.flash_attention_ref(tq, tk, tv, causal=causal, q_offset=q_offset)
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# dispatcher: the plain version only for CPU tensors, no silent fallback
# ---------------------------------------------------------------------------


def test_dispatch_takes_plain_version_on_cpu_and_counts_nothing():
    ops.reset_launch_counts()
    x = torch.randn(2, 32, 2, 16)
    blocks = ops.kv_gather_write(x, x, [1, 0], 16)
    k, _ = ops.kv_scatter_read(blocks, [0, 1], 2)
    out = ops.flash_attention(x[None, 0], x[None, 0], x[None, 0])
    assert torch.equal(k, x[:, torch.cat([torch.arange(16, 32), torch.arange(16)])])
    assert out.shape == (1, 32, 2, 16)
    q = torch.randn(2, 4, 16)
    table = pa.make_block_table([[0], [1]], 2, "cpu")
    assert ops.paged_attention(q, x, x, table, torch.tensor([5, 9])).shape == q.shape
    a = -torch.rand(1, 32, 2)
    y, st = ops.ssd_chunk(x[None, 0], a, x[None, 0, :, :1], x[None, 0, :, :1])
    assert y.shape == (1, 32, 2, 16) and st.shape == (1, 2, 16, 16)
    assert torch.equal(ops.sparse_kv_gather(x[0], [31, 0]), x[0, [31, 0]])
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0) and len(ops.KERNELS) == 8


def test_no_silent_fallback_for_cpu_tensors():
    x = torch.zeros(2, 32, 2, 16)
    with pytest.raises(ValueError, match="on the card"):
        ops.flash_attention(x, x, x, mode="kernel")
    with pytest.raises(ValueError, match="on the card"):
        ops.kv_gather_write(x, x, [0], 16, mode="kernel")
    with pytest.raises(ValueError, match="not in"):
        ops.flash_attention(x, x, x, mode="pallas")
    # the kernel wrappers themselves take only tensors on the card
    with pytest.raises(ValueError, match="on the card"):
        fa.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="on the card"):
        kv.kv_gather_write(x, x, [0], 16)
    with pytest.raises(ValueError, match="on the card"):
        kv.kv_scatter_read(torch.zeros(1, 4, 16, 2, 16), [0], 2)
    q, ctx = torch.zeros(2, 4, 16), torch.tensor([1, 1])
    with pytest.raises(ValueError, match="on the card"):
        ops.paged_attention(q, x, x, pa.make_block_table([[0], [1]], 2, "cpu"), ctx,
                            mode="kernel")
    with pytest.raises(ValueError, match="on the card"):
        pa.paged_attention(q, x, x, torch.zeros(2, 1, dtype=torch.int32), ctx.int())
    a = torch.zeros(1, 32, 2)
    with pytest.raises(ValueError, match="on the card"):
        ops.ssd_chunk(x[None, 0], a, x[None, 0], x[None, 0], mode="kernel")
    with pytest.raises(ValueError, match="on the card"):
        ssd.ssd_chunk(x[None, 0], a, x[None, 0], x[None, 0])
    with pytest.raises(ValueError, match="on the card"):
        ops.sparse_kv_gather(x[0], [0], mode="kernel")
    with pytest.raises(ValueError, match="on the card"):
        kv.sparse_kv_gather(x[0], [0])
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
