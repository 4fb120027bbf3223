"""The port's plain ``sparse_kv_gather`` against the JAX oracle and the Pallas kernel.

Inputs are made from a seed with numpy and handed to both frameworks (bf16
through the JAX cast, so both sides hold the same bits). Pallas runs as
tests/test_kernels.py runs it on the CPU (``mode="pallas"``, interpret
mode). Tolerance: none, the gather is compared bit for bit (NaN rows by
their bits). The contract is the oracle's ``jnp.take``: ids in [-N, 0)
wrap, any other out-of-range id gives a NaN row, no ids give an empty
result. The Pallas kernel clamps out-of-range ids instead, a divergence
pinned below. The CUDA kernel is held against the plain version on the
card (tests/test_torch_gpu.py, chip_smoke.py).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import kv_transfer as kv
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)  # tiny shapes; keep off the other test workers' cores

DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _pair(rng, shape, dtype):
    j = jnp.asarray(rng.standard_normal(shape, dtype=np.float32)).astype(dtype)
    return j, tensor_from_numpy(np.asarray(j), "cpu")


def _bits(a) -> np.ndarray:
    """Exact bits of a JAX array or torch tensor (bf16 as uint16, f32 as
    uint32, so NaN rows compare by their bits too)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.uint16 if a.dtype == torch.bfloat16 else torch.int32).numpy()
        return a.view(np.uint16 if a.dtype == np.uint16 else np.uint32)
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.name == "bfloat16" else np.uint32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,n_sel", [((64, 2, 32), 17), ((100, 8, 16), 40), ((16, 1, 80), 16)])
def test_sparse_plain_bit_exact_vs_oracle_and_pallas(dtype, shape, n_sel):
    rng = np.random.default_rng(sum(shape) + n_sel)
    jkv, tkv = _pair(rng, shape, DTYPES[dtype])
    ids = rng.choice(shape[0], size=n_sel, replace=shape[0] < n_sel)
    got = _bits(ops.sparse_kv_gather(tkv, torch.from_numpy(ids)))
    jids = jnp.asarray(ids, jnp.int32)
    np.testing.assert_array_equal(got, _bits(jref.sparse_kv_gather_ref(jkv, jids)))
    np.testing.assert_array_equal(got, _bits(jops.sparse_kv_gather(jkv, jids, mode="pallas")))


@settings(max_examples=20, deadline=None)
@given(n_sel=st.integers(1, 16), n_tokens=st.integers(16, 64))
def test_sparse_plain_property(n_sel, n_tokens):
    """tests/test_kernels.py:130 on the port: row i of the output is row
    ids[i] of kv, for any ids in range (repeats included)."""
    kv_t = torch.arange(n_tokens * 2 * 8, dtype=torch.float32).reshape(n_tokens, 2, 8)
    rng = np.random.default_rng(n_sel * 977 + n_tokens)
    ids = rng.integers(0, n_tokens, size=n_sel)
    out = ops.sparse_kv_gather(kv_t, ids.tolist())
    assert out.shape == (n_sel, 2, 8)
    for i, t in enumerate(ids):
        assert torch.equal(out[i], kv_t[t])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sparse_contract_matches_jnp_take(dtype):
    """Wrap for [-N, 0), NaN for any other out-of-range id (int32 extremes
    included), ``(0, hkv, hd)`` for no ids: the oracle's answers, bit for bit."""
    n = 12
    jkv, tkv = _pair(np.random.default_rng(3), (n, 2, 8), DTYPES[dtype])
    ids = [0, 5, n - 1, -1, -n, -n - 1, n, n + 7, 2**31 - 1, -(2**31), 3]
    jids = jnp.asarray(ids, jnp.int32)
    want = jnp.take(jkv, jids, axis=0)
    got = ref.sparse_kv_gather_ref(tkv, ids)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(jref.sparse_kv_gather_ref(jkv, jids)))
    assert torch.equal(got[3], tkv[n - 1]) and torch.equal(got[4], tkv[0])
    nan_rows = torch.isnan(got).all(dim=(1, 2))
    assert nan_rows.tolist() == [False] * 5 + [True] * 5 + [False]
    empty = ref.sparse_kv_gather_ref(tkv, [])
    assert empty.shape == (0, 2, 8) == tuple(jnp.take(jkv, jnp.asarray([], jnp.int32),
                                                      axis=0).shape)


def test_sparse_pallas_clamps_where_oracle_fills_nan():
    """Departs from the Pallas kernel on purpose: it checks no bounds, so an
    id past the end reads the last row and one below -N reads row 0; the
    port follows the oracle, whose rows there are NaN."""
    n = 10
    jkv, tkv = _pair(np.random.default_rng(4), (n, 2, 8), jnp.float32)
    ids = [n, 2**31 - 1, -n - 1, -1]
    pallas = np.asarray(jops.sparse_kv_gather(jkv, jnp.asarray(ids, jnp.int32), mode="pallas"))
    np.testing.assert_array_equal(pallas[:3], np.asarray(jkv)[[n - 1, n - 1, 0]])
    got = ops.sparse_kv_gather(tkv, ids)
    assert torch.isnan(got[:3]).all() and not np.isnan(pallas).any()
    np.testing.assert_array_equal(got[3].numpy(), pallas[3])  # the wrap agrees


def test_sparse_int64_ids_and_dtypes():
    tkv = torch.arange(24, dtype=torch.float16).reshape(4, 2, 3)
    got = ref.sparse_kv_gather_ref(tkv, torch.tensor([1, 2**40, -4], dtype=torch.int64))
    assert torch.equal(got[0], tkv[1]) and torch.isnan(got[1]).all() and torch.equal(got[2], tkv[0])
    assert got.view(torch.int16)[1, 0, 0].item() == 0x7E00  # f16 quiet NaN, as the kernel writes
    with pytest.raises(TypeError, match="INT_MIN"):
        ref.sparse_kv_gather_ref(tkv.to(torch.int32), [0])


def test_sparse_dispatch_on_cpu_counts_nothing_and_kernel_mode_raises():
    ops.reset_launch_counts()
    tkv = torch.randn(8, 2, 16)
    assert torch.equal(ops.sparse_kv_gather(tkv, [7, 0]), tkv[[7, 0]])
    assert torch.equal(ops.sparse_kv_gather(tkv, [7], mode="ref"), tkv[[7]])
    assert ops.sparse_kv_gather(tkv, []).shape == (0, 2, 16)
    with pytest.raises(ValueError, match="on the card"):
        ops.sparse_kv_gather(tkv, [0], mode="kernel")
    with pytest.raises(ValueError, match="on the card"):
        kv.sparse_kv_gather(tkv, [0])
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    assert kv.sparse_kv_gather.launches == 0


def test_kernel_ids_cast_to_int32_keeps_out_of_range_out():
    """The wrapper's int64 -> int32 cast clamps first, so an id past int32's
    range cannot wrap back into [0, N)."""
    ids = kv._device_ids(torch.tensor([2**32, 2**32 + 3, -(2**32), 5]), torch.device("cpu"))
    assert ids.dtype == torch.int32
    assert ids.tolist() == [2**31 - 1, 2**31 - 1, -(2**31), 5]
    assert kv._device_ids([1, -2], torch.device("cpu")).tolist() == [1, -2]
