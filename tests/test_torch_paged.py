"""The port's plain ``paged_attention`` against the JAX oracle and the Pallas kernel.

Inputs are made from a seed with numpy and handed to both frameworks (bf16
through the JAX cast, so both sides hold the same bits). Pallas runs as
tests/test_kernels.py runs it on the CPU (``mode="pallas"``, interpret
mode). The JAX pool ``kv_pool`` (n, 2, bt, hkv, d) reaches the port as the
two block views ``kv_pool[:, 0]``, ``kv_pool[:, 1]``.

Tolerances: f32 2e-5, bf16 3e-2 (tests/test_kernels.py:84). The CUDA kernel
itself is held against this plain version on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.models.attention import decode_attention_replicated

# tiny shapes: one intra-op thread is as fast, and more threads would only
# spin against the other test workers, which share the CPU's cores
torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, 2e-5), "bfloat16": (jnp.bfloat16, 3e-2)}
PAGED_SHAPES = [  # tests/test_kernels.py:63-68
    # (b, hq, hkv, d, bt, max_blocks, n_blocks)
    (3, 8, 2, 64, 16, 6, 32),
    (2, 4, 4, 128, 16, 4, 16),
    (1, 16, 8, 64, 32, 3, 8),
]


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor on the CPU."""
    j = jnp.asarray(rng.standard_normal(shape, dtype=np.float32)).astype(dtype)
    return j, tensor_from_numpy(np.asarray(j), "cpu")


def _case(shape, dtype, seed):
    b, hq, hkv, d, bt, mb, nb = shape
    rng = np.random.default_rng(seed)
    jq, tq = _pair(rng, (b, hq, d), dtype)
    jpool, tpool = _pair(rng, (nb, 2, bt, hkv, d), dtype)
    table = np.stack([rng.choice(nb, size=mb, replace=False) for _ in range(b)])
    ctx = rng.integers(1, mb * bt, size=(b,))
    return jq, tq, jpool, tpool, table.astype(np.int32), ctx.astype(np.int32)


@pytest.mark.parametrize("shape", PAGED_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_paged_plain_matches_oracle_and_pallas(shape, dtype):
    jdt, tol = DTYPES[dtype]
    jq, tq, jpool, tpool, table, ctx = _case(shape, jdt, sum(shape))
    got = ops.paged_attention(tq, tpool[:, 0], tpool[:, 1], torch.from_numpy(table),
                              torch.from_numpy(ctx)).float().numpy()
    jt, jc = jnp.asarray(table), jnp.asarray(ctx)
    want = np.asarray(jref.paged_attention_ref(jq, jpool, jt, jc), np.float32)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    pallas = np.asarray(jops.paged_attention(jq, jpool, jt, jc, mode="pallas"), np.float32)
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)


def test_paged_zero_context_gives_zeros_as_pallas_does():
    """Departs from ``ref.py`` on purpose: the JAX oracle averages the rows of
    the clamped table for ``context_lens == 0`` (ROADMAP §3(b)); the port's
    plain version and its kernel give zeros, as the Pallas kernel does."""
    jq, tq, jpool, tpool, table, ctx = _case(PAGED_SHAPES[0], jnp.float32, 4)
    ctx[1] = 0
    got = ops.paged_attention(tq, tpool[:, 0], tpool[:, 1], torch.from_numpy(table),
                              torch.from_numpy(ctx)).numpy()
    pallas = np.asarray(jops.paged_attention(jq, jpool, jnp.asarray(table), jnp.asarray(ctx),
                                             mode="pallas"))
    assert not got[1].any() and not pallas[1].any()
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=2e-5)
    oracle = np.asarray(jref.paged_attention_ref(jq, jpool, jnp.asarray(table),
                                                 jnp.asarray(ctx)))
    assert np.abs(oracle[1]).max() > 0.01  # the divergence this test pins


def test_paged_minus_one_clamps_to_block_zero():
    jq, tq, jpool, tpool, table, ctx = _case(PAGED_SHAPES[0], jnp.float32, 5)
    ctx[:] = table.shape[1] * 16  # every entry inside the context
    table[0, 2] = -1
    table[2, 0] = -1
    zeroed = np.maximum(table, 0)
    got = ops.paged_attention(tq, tpool[:, 0], tpool[:, 1], torch.from_numpy(table),
                              torch.from_numpy(ctx))
    same = ops.paged_attention(tq, tpool[:, 0], tpool[:, 1], torch.from_numpy(zeroed),
                               torch.from_numpy(ctx))
    assert torch.equal(got, same)
    want = jref.paged_attention_ref(jq, jpool, jnp.asarray(table), jnp.asarray(ctx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("bad", [32, 100, -2])
def test_paged_out_of_range_entry_raises(bad):
    """Tables are checked once, where they are built; the call trusts them."""
    _, tq, _, tpool, table, ctx = _case(PAGED_SHAPES[0], jnp.float32, 6)
    good = pa.make_block_table(table, 32, "cpu")
    ops.paged_attention(tq, tpool[:, 0], tpool[:, 1], good, torch.from_numpy(ctx))
    table[1, 3] = bad
    with pytest.raises(ValueError, match="outside"):
        pa.make_block_table(table, 32, "cpu")
    with pytest.raises(ValueError, match="outside"):
        pa.make_block_table(table.tolist(), 32, "cpu")


def test_paged_takes_only_a_built_table_on_qs_device():
    _, tq, _, tpool, table, ctx = _case(PAGED_SHAPES[0], jnp.float32, 6)
    for raw in (table.tolist(), table, torch.from_numpy(table).long()):
        with pytest.raises(ValueError, match="make_block_table"):
            ops.paged_attention(tq, tpool[:, 0], tpool[:, 1], raw, torch.from_numpy(ctx))


def test_paged_reads_a_layer_of_the_fused_pool_in_place():
    """One layer of the port's (n, 2L, bt, hkv, d) pool, as a view, equals the
    JAX (n, 2, bt, hkv, d) layout of that layer."""
    b, hq, hkv, d, bt, mb, nb = PAGED_SHAPES[0]
    L = 3
    rng = np.random.default_rng(7)
    tq = torch.from_numpy(rng.standard_normal((b, hq, d), dtype=np.float32))
    fused = torch.from_numpy(rng.standard_normal((nb, 2 * L, bt, hkv, d), dtype=np.float32))
    table = pa.make_block_table(np.stack([rng.choice(nb, size=mb, replace=False)
                                          for _ in range(b)]), nb, "cpu")
    ctx = torch.tensor([17, 90, 64])
    for layer in range(L):
        k, v = pa.pool_layer(fused, layer)
        assert k.data_ptr() == fused[:, 2 * layer].data_ptr()  # a view, no copy
        jax_layout = torch.stack([k, v], dim=1).contiguous()
        got = ops.paged_attention(tq, k, v, table, ctx)
        want = ops.paged_attention(tq, jax_layout[:, 0], jax_layout[:, 1], table, ctx)
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 3e-2)])
def test_identity_table_over_dense_cache_equals_decode_attention(dtype, tol):
    """What the decode path runs: the layer's dense cache as blocks of 16
    through an identity table, context pos + 1, against the twin of JAX's
    ``decode_attention_replicated``. bf16 within 3e-2: the replicated form
    rounds p to the cache dtype before P.V, the paged form keeps p in f32."""
    b, hq, hkv, d, max_len, bt = 2, 8, 2, 64, 96, 16
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.standard_normal((b, 1, hq, d), dtype=np.float32)).to(dtype)
    kc = torch.from_numpy(rng.standard_normal((b, max_len, hkv, d), dtype=np.float32)).to(dtype)
    vc = torch.from_numpy(rng.standard_normal((b, max_len, hkv, d), dtype=np.float32)).to(dtype)
    pos = torch.tensor([40, 95])
    nbr = max_len // bt
    ident = pa.make_block_table(np.arange(b * nbr).reshape(b, nbr), b * nbr, "cpu")
    got = ops.paged_attention(q[:, 0], pa.dense_blocks(kc, bt), pa.dense_blocks(vc, bt),
                              ident, pos + 1)
    want = decode_attention_replicated(q, kc, vc, pos + 1)[:, 0]
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=tol, rtol=tol)


def test_dense_blocks_is_a_view_and_checks_the_block_size():
    cache = torch.zeros(2, 48, 2, 16)
    blocks = pa.dense_blocks(cache, 16)
    assert blocks.shape == (6, 16, 2, 16) and blocks.data_ptr() == cache.data_ptr()
    with pytest.raises(ValueError, match="multiple"):
        pa.dense_blocks(torch.zeros(1, 40, 2, 16), 16)
