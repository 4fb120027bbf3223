"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: every test takes the ``cuda`` fixture, which skips when no
card is present (decided at run time, never at import). On a GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: data movement bit-exact; flash attention f32 2e-5, bf16 2e-2
(those of tests/test_kernels.py:42; the wgmma route, bf16 at d 64 and 128,
rounds P to bf16 and is held to the same 2e-2); paged attention f32 2e-5, bf16 3e-2
(tests/test_kernels.py:84); ssd_chunk f32 2e-4, bf16 5e-2
(tests/test_kernels.py:175).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import kv_transfer as kv
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ssd_chunk as ssd

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, dtype)


FLASH_CASES = [
    # (b, sq, skv, hq, hkv, d, causal)
    (1, 64, 64, 4, 4, 64, True),
    (2, 128, 128, 8, 2, 64, True),
    (1, 96, 96, 4, 1, 128, True),
    (2, 128, 128, 16, 16, 128, True),
    (1, 48, 48, 4, 2, 16, True),  # reduced configs' head_dim
    (1, 100, 100, 8, 2, 128, True),  # ragged: not a multiple of any tile
    (1, 37, 80, 4, 2, 32, True),  # sq != skv, causal aligned at position 0
    (1, 64, 90, 4, 2, 48, False),
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, case, dtype):
    b, sq, skv, hq, hkv, d, causal = case
    rng = np.random.default_rng(sum(case[:6]))
    q = _randn(rng, (b, sq, hq, d), dtype, cuda)
    k = _randn(rng, (b, skv, hkv, d), dtype, cuda)
    v = _randn(rng, (b, skv, hkv, d), dtype, cuda)
    expected = "wgmma" if dtype == torch.bfloat16 and d in (64, 128) else "cuda_cores"
    before = dict(fa.flash_attention.launches_by_route)
    out = fa.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
    assert fa.flash_attention.launches_by_route[expected] == before[expected] + 1


WGMMA_CASES = [
    # (b, sq, skv, hq, hkv, d, causal); groups hq/hkv of 1, 4 and 8
    (1, 1024, 1024, 32, 8, 128, True),  # one layer of the Llama-3.1-8B prefill
    (1, 2048, 2048, 8, 1, 128, True),  # 16 K/V tiles through the 2-stage ring
    (1, 1024, 1024, 8, 8, 64, True),
    (1, 2048, 2048, 16, 2, 64, True),
    (1, 100, 100, 8, 2, 128, True),  # ragged: no multiple of 64 or 128
    (2, 200, 200, 16, 2, 64, True),
    (2, 200, 200, 8, 8, 128, True),
    (1, 37, 80, 4, 1, 128, True),  # sq != skv, causal aligned at position 0
    (1, 37, 80, 8, 2, 64, True),
    (1, 64, 300, 8, 2, 64, False),  # non-causal: keys past skv in the last tile
    (1, 64, 300, 8, 1, 128, False),
    (2, 1024, 1024, 4, 4, 128, False),
]


@pytest.mark.parametrize("case", WGMMA_CASES)
def test_flash_wgmma_route_matches_plain(cuda, case):
    b, sq, skv, hq, hkv, d, causal = case
    rng = np.random.default_rng(sum(case[:6]) + 1)
    q = _randn(rng, (b, sq, hq, d), torch.bfloat16, cuda)
    k = _randn(rng, (b, skv, hkv, d), torch.bfloat16, cuda)
    v = _randn(rng, (b, skv, hkv, d), torch.bfloat16, cuda)
    before = dict(fa.flash_attention.launches_by_route)
    out = fa.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches_by_route == {
        "wgmma": before["wgmma"] + 1, "cuda_cores": before["cuda_cores"]}
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[torch.bfloat16],
                               rtol=TOL[torch.bfloat16])


def test_flash_routes_on_the_same_bf16_inputs(cuda):
    """The CUDA-core kernel still takes bf16 at d = 128 when asked (chip_smoke
    times both); the wgmma route refuses float32."""
    rng = np.random.default_rng(3)
    q = _randn(rng, (1, 300, 8, 128), torch.bfloat16, cuda)
    k = _randn(rng, (1, 300, 2, 128), torch.bfloat16, cuda)
    before = dict(fa.flash_attention.launches_by_route)
    slow = fa.flash_attention(q, k, k, force_route="cuda_cores")
    fast = fa.flash_attention(q, k, k)
    want = ref.flash_attention_ref(q, k, k)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches_by_route == {
        "wgmma": before["wgmma"] + 1, "cuda_cores": before["cuda_cores"] + 1}
    for got in (slow, fast):
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    with pytest.raises(ValueError, match="wgmma route takes bf16"):
        fa.flash_attention(q.float(), k.float(), k.float(), force_route="wgmma")


def test_flash_wgmma_route_rejects_unaligned_q(cuda):
    """A contiguous view at an odd offset is no 16-byte TMA base: it raises."""
    shape = (1, 64, 4, 128)
    n = int(np.prod(shape))
    base = torch.randn((n + 8,), device=cuda, dtype=torch.bfloat16)
    q = base[1:1 + n].view(shape)
    k = torch.randn((1, 64, 2, 128), device=cuda, dtype=torch.bfloat16)
    assert q.is_contiguous() and q.data_ptr() % 16
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention(q, k, k)
    assert fa.flash_attention.launches == before


@pytest.mark.parametrize("d", [24, 144, 256])
def test_flash_kernel_rejects_head_dim(cuda, d):
    q = torch.zeros((1, 8, 2, d), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,n_slots,bt,hkv,hd", [(4, 8, 16, 2, 16), (32, 16, 16, 8, 128)])
def test_kv_transfer_kernels_bit_exact(cuda, dtype, L, n_slots, bt, hkv, hd):
    rng = np.random.default_rng(L * n_slots)
    k = _randn(rng, (L, n_slots * bt, hkv, hd), dtype, cuda)
    v = _randn(rng, (L, n_slots * bt, hkv, hd), dtype, cuda)
    slots = rng.permutation(n_slots)[: n_slots // 2].tolist()
    st = torch.tensor(slots, device=cuda)
    blocks = kv.kv_gather_write(k, v, slots, bt)
    assert torch.equal(blocks, ref.kv_gather_write_ref(k, v, st, bt))
    kr, vr = kv.kv_scatter_read(blocks, slots, n_slots)
    zero = torch.zeros_like(k)
    kw, vw = ref.kv_scatter_read_ref(blocks, st, zero, zero, bt)
    torch.cuda.synchronize()
    assert torch.equal(kr, kw) and torch.equal(vr, vw)
    mapped = torch.zeros(n_slots, dtype=torch.bool)
    mapped[slots] = True
    kr5 = kr.reshape(L, n_slots, bt, hkv, hd).cpu()
    assert not kr5[:, ~mapped].any()  # zero fill of unmapped slots


def test_dispatch_counts_launches_on_the_card(cuda):
    ops.reset_launch_counts()
    x = torch.zeros((2, 32, 2, 16), device=cuda)
    blocks = ops.kv_gather_write(x, x, [1, 0], 16)
    ops.kv_scatter_read(blocks, [0, 1], 2)
    ops.flash_attention(x[None, 0], x[None, 0], x[None, 0])
    ops.kv_gather_write(x, x, [1, 0], 16, mode="ref")
    q = torch.zeros((2, 4, 16), device=cuda)
    ops.paged_attention(q, x, x, pa.make_block_table([[0], [1]], 2, cuda),
                        torch.tensor([3, 16]))
    ops.ssd_chunk(x[None, 0], torch.zeros((1, 32, 2), device=cuda), x[None, 0, :, :1],
                  x[None, 0, :, :1])
    ops.ssd_chunk(x[None, 0], torch.zeros((1, 32, 2), device=cuda), x[None, 0, :, :1],
                  x[None, 0, :, :1], mode="ref")
    ops.sparse_kv_gather(x[0], [3, 1])
    ops.sparse_kv_gather(x[0], [3, 1], mode="ref")
    ops.sparse_kv_gather(x[0], [])  # no ids: no launch
    assert ops.launch_counts() == {
        "kv_gather_write": 1, "kv_scatter_read": 1, "flash_attention": 1,
        "paged_attention": 1, "ssd_chunk": 1, "sparse_kv_gather": 1,
    }
    assert ops.flash_routes() == {"wgmma": 0, "cuda_cores": 1}  # float32, d = 16
    ops.reset_launch_counts()
    assert ops.flash_routes() == {"wgmma": 0, "cuda_cores": 0}
    y = torch.zeros((1, 40, 2, 64), device=cuda, dtype=torch.bfloat16)
    ops.flash_attention(y, y, y)
    assert ops.flash_routes() == {"wgmma": 1, "cuda_cores": 0}
    assert ops.launch_counts()["flash_attention"] == 1


SPARSE_CASES = [
    # (N, hkv, hd, n_sel): row bytes in bf16 / f32
    (64, 2, 32, 17),  # tests/test_kernels.py:111; 128 / 256 B: 16-byte copies
    (4096, 1, 128, 8192),  # Llama-3.1-8B pool pieces, 256 B
    (8192, 1, 80, 16384),  # qwen3-32b pool pieces, 160 B
    (256, 8, 80, 4096),  # exp10's top-k rows of one layer's K and V
    (50, 3, 5, 20),  # 30 / 60 B: element by element
    (33, 1, 1, 7),  # one element a row
    # the one-wave kernel's edges: one piece, a warp's worth and either side
    (300, 1, 128, 1), (300, 1, 128, 31), (300, 1, 128, 32), (300, 1, 128, 33),
    (1024, 8, 80, 20000),  # 1,280-B rows past a wave: 9-10 pieces a CTA, 3-4 passes a lane
]


def _sparse_ids(rng, n, n_sel):
    """In-range ids with repeats, every wrapped id, and out-of-range ids."""
    ids = rng.integers(-n, n, size=n_sel)
    ids[:6] = [n, -n - 1, 2**31 - 1, -(2**31), -1, -n][: len(ids[:6])]
    return ids


@pytest.mark.parametrize("case", SPARSE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_sparse_kernel_bit_exact_with_nan_fill(cuda, case, dtype):
    n, hkv, hd, n_sel = case
    rng = np.random.default_rng(n + n_sel)
    src = _randn(rng, (n, hkv, hd), dtype, cuda)
    ids = _sparse_ids(rng, n, n_sel)
    for given in (ids.tolist(), torch.from_numpy(ids), torch.from_numpy(ids).to(cuda).int()):
        out = kv.sparse_kv_gather(src, given)
        want = ref.sparse_kv_gather_ref(src, torch.from_numpy(ids))
        torch.cuda.synchronize()
        bits = torch.int32 if dtype == torch.float32 else torch.int16
        assert torch.equal(out.view(bits), want.view(bits))  # NaN rows by their bits
    bad = torch.from_numpy((ids >= n) | (ids < -n)).to(cuda)
    assert torch.isnan(out).all(dim=(1, 2)).equal(bad)


def test_sparse_kernel_element_path_on_unaligned_rows(cuda):
    """A contiguous view at an odd offset is not 16-byte aligned: the same
    kernel copies element by element, with the same result."""
    base = torch.randn((65 * 2 * 32,), device=cuda, dtype=torch.bfloat16)
    src = base[1:].view(-1)[: 64 * 2 * 32].view(64, 2, 32)
    assert src.data_ptr() % 16 and src.is_contiguous()
    ids = [3, 63, -1, 64, 0]
    out = kv.sparse_kv_gather(src, ids)
    want = ref.sparse_kv_gather_ref(src, ids)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int16), want.view(torch.int16))


def test_sparse_kernel_edges(cuda):
    src = torch.randn((16, 2, 8), device=cuda)
    before = kv.sparse_kv_gather.launches
    empty = kv.sparse_kv_gather(src, [])
    assert empty.shape == (0, 2, 8) and kv.sparse_kv_gather.launches == before
    with pytest.raises(ValueError, match="contiguous"):
        kv.sparse_kv_gather(src.transpose(0, 1), [0])
    with pytest.raises(ValueError, match="takes"):
        kv.sparse_kv_gather(src.to(torch.int32), [0])
    kv.sparse_kv_gather(src, [1])
    assert kv.sparse_kv_gather.launches == before + 1


def _sparse_check(src, ids):
    """The kernel against the plain version on ``ids``, NaN rows by their bits."""
    out = kv.sparse_kv_gather(src, ids)
    want = ref.sparse_kv_gather_ref(src, ids)
    torch.cuda.synchronize()
    bits = torch.int32 if src.dtype == torch.float32 else torch.int16
    assert torch.equal(out.view(bits), want.view(bits))
    return out


@pytest.mark.parametrize("extra", [0, 1])
def test_sparse_kernel_at_a_whole_wave_and_one_past(cuda, extra):
    """256-B pieces that fill the card's whole wave of CTAs at one unit a lane
    (8 pieces a CTA), then one piece more: the grid stays at the wave, the
    first CTA takes 9 pieces and 16 of its lanes a second unit."""
    rng = np.random.default_rng(30 + extra)
    src = _randn(rng, (4096, 1, 128), torch.bfloat16, cuda)
    wave = kv.sparse_wave(cuda, 16, 16)
    n_sel = wave * kv.SPARSE_THREADS // 16 + extra
    assert kv.sparse_grid(wave, n_sel, 16) == wave
    _sparse_check(src, torch.from_numpy(_sparse_ids(rng, 4096, n_sel)).to(cuda))


def test_sparse_kernel_takes_int64_ids_past_int32(cuda):
    """int64 ids beyond int32's range give NaN rows (the wrapper clamps them
    to int32's ends, which stay out of range), from the host or the card."""
    rng = np.random.default_rng(31)
    n = 4096
    src = _randn(rng, (n, 1, 128), torch.bfloat16, cuda)
    ids = torch.from_numpy(rng.integers(-n, n, size=64))
    far = torch.tensor([2**40, -(2**40), 2**31, -(2**31) - 1, 2**63 - 1, n - 1, -n])
    ids = torch.cat([ids, far])
    for given in (ids, ids.to(cuda)):
        out = _sparse_check(src, given)
        assert torch.isnan(out).all(dim=(1, 2)).nonzero().flatten().tolist() == \
            list(range(64, 69))


def test_sparse_kernel_repeats_bit_for_bit(cuda):
    """A read, another read of another width, the first again: equal bit for bit."""
    rng = np.random.default_rng(32)
    a = _randn(rng, (4096, 1, 128), torch.bfloat16, cuda)
    b = _randn(rng, (8192, 1, 80), torch.bfloat16, cuda)
    ids_a = torch.from_numpy(_sparse_ids(rng, 4096, 8192)).to(cuda)
    ids_b = torch.from_numpy(_sparse_ids(rng, 8192, 16384)).to(cuda)
    first = kv.sparse_kv_gather(a, ids_a)
    kv.sparse_kv_gather(b, ids_b)
    third = kv.sparse_kv_gather(a, ids_a)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), third.view(torch.int16))


def test_sparse_kernel_replays_in_a_cuda_graph(cuda):
    """One warm-up call, one call captured in a CUDA graph, new ids copied
    into the captured id buffer, a replay: equal to the plain version on the
    new ids bit for bit, out-of-range ids included."""
    rng = np.random.default_rng(33)
    n = 4096
    src = _randn(rng, (n, 1, 128), torch.bfloat16, cuda)
    ids = torch.from_numpy(_sparse_ids(rng, n, 8192)).to(cuda).int()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kv.sparse_kv_gather(src, ids)  # warm-up: builds the kernel, reads the wave
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kv.sparse_kv_gather(src, ids)
    new = torch.from_numpy(_sparse_ids(np.random.default_rng(34), n, 8192)).int()
    ids.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    want = ref.sparse_kv_gather_ref(src, new)
    assert torch.equal(out.view(torch.int16), want.view(torch.int16))


def test_sparse_kernel_is_one_device_kernel_per_call(cuda):
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(35)
    src = _randn(rng, (4096, 1, 128), torch.bfloat16, cuda)
    ids = torch.from_numpy(_sparse_ids(rng, 4096, 8192)).to(cuda).int()
    kv.sparse_kv_gather(src, ids)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        kv.sparse_kv_gather(src, ids)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert [(e.count, "sparse" in e.key) for e in kernels] == [(1, True)], \
        [(e.key, e.count) for e in kernels]


PAGED_CASES = [
    # (b, hq, hkv, d, bt, max_blocks, n_blocks)
    (3, 8, 2, 64, 16, 6, 32),  # tests/test_kernels.py PAGED_SHAPES
    (2, 4, 4, 128, 16, 4, 16),
    (1, 16, 8, 64, 32, 3, 8),
    (1, 32, 8, 128, 16, 128, 128),  # Llama-3.1-8B decode
    (2, 4, 2, 16, 16, 2, 4),  # the reduced configs
    (2, 64, 8, 32, 8, 5, 12),  # a group of 8
]
PAGED_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


def _table_and_ctx(rng, b, mb, bt, n_blocks):
    table = np.stack([rng.choice(n_blocks, size=mb, replace=mb > n_blocks) for _ in range(b)])
    ctx = rng.integers(1, mb * bt + 1, size=b)
    for i in range(b):  # pad past the context with -1
        table[i, -(-ctx[i] // bt):] = -1
    ctx[0] = min(ctx[0], bt + 1)  # a short row beside long ones
    table[0, 0] = -1  # -1 inside the context reads block 0
    return table, torch.from_numpy(ctx)


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_matches_plain(cuda, case, dtype):
    b, hq, hkv, d, bt, mb, nb = case
    rng = np.random.default_rng(sum(case))
    q = _randn(rng, (b, hq, d), dtype, cuda)
    pool = _randn(rng, (nb, 2, bt, hkv, d), dtype, cuda)  # the JAX pool layout
    table, ctx = _table_and_ctx(rng, b, mb, bt, nb)
    tbl = pa.make_block_table(table, nb, cuda)
    out = pa.paged_attention(q, pool[:, 0], pool[:, 1], tbl, ctx.to(cuda, torch.int32))
    want = ref.paged_attention_ref(q, pool[:, 0], pool[:, 1], tbl, ctx.to(cuda))
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want.float(), atol=PAGED_TOL[dtype],
                               rtol=PAGED_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_reads_three_layouts(cuda, dtype):
    """The JAX pool, one layer of the fused pool and a dense cache give one answer."""
    b, hq, hkv, d, bt, L, nb = 2, 8, 2, 64, 16, 3, 8
    rng = np.random.default_rng(7)
    q = _randn(rng, (b, hq, d), dtype, cuda)
    fused = _randn(rng, (nb, 2 * L, bt, hkv, d), dtype, cuda)  # the port's pool
    ctx = torch.tensor([50, 64], dtype=torch.int32, device=cuda)
    tbl = pa.make_block_table([[5, 2, 7, 0], [1, 3, 6, 4]], nb, cuda)
    k1, v1 = pa.pool_layer(fused, 1)
    got_fused = pa.paged_attention(q, k1, v1, tbl, ctx)
    jax_pool = torch.stack([k1, v1], dim=1).contiguous()  # (n, 2, bt, hkv, d)
    got_jax = pa.paged_attention(q, jax_pool[:, 0], jax_pool[:, 1], tbl, ctx)
    dense_k = k1[tbl.long()].reshape(b, 4 * bt, hkv, d).contiguous()
    dense_v = v1[tbl.long()].reshape(b, 4 * bt, hkv, d).contiguous()
    ident = pa.make_block_table(np.arange(b * 4).reshape(b, 4), b * 4, cuda)
    got_dense = pa.paged_attention(q, pa.dense_blocks(dense_k, bt), pa.dense_blocks(dense_v, bt),
                                   ident, ctx)
    want = ref.paged_attention_ref(q, k1, v1, tbl, ctx)
    torch.cuda.synchronize()
    assert torch.equal(got_fused, got_jax) and torch.equal(got_fused, got_dense)
    torch.testing.assert_close(got_fused.float(), want.float(), atol=PAGED_TOL[dtype],
                               rtol=PAGED_TOL[dtype])
    zero = pa.paged_attention(q, k1, v1, tbl, torch.zeros_like(ctx))
    assert not zero.any()  # context 0 gives zeros, as the Pallas kernel does


def test_paged_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros((1, 4, 48), device=cuda)
    blocks = torch.zeros((2, 16, 1, 48), device=cuda)
    tbl = pa.make_block_table([[0, 1]], 2, cuda)
    ctx = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attention(q, blocks, blocks, tbl, ctx)
    with pytest.raises(ValueError, match="outside"):
        pa.make_block_table([[0, 2]], 2, cuda)
    q16, b16 = torch.zeros((1, 16, 16), device=cuda), torch.zeros((2, 16, 1, 16), device=cuda)
    with pytest.raises(ValueError, match="group"):
        pa.paged_attention(q16, b16, b16, tbl, ctx)



def _paged_rows(rng, dtype, device, ctxs, hq, hkv, d, bt, mb):
    """q, JAX-layout pool, a shuffled table with -1 past each row's context
    and the contexts, for rows of the given contexts."""
    b = len(ctxs)
    nb = b * mb
    q = _randn(rng, (b, hq, d), dtype, device)
    pool = _randn(rng, (nb, 2, bt, hkv, d), dtype, device)
    table = rng.permutation(nb).reshape(b, mb).astype(np.int32)
    for i, c in enumerate(ctxs):
        table[i, -(-c // bt):] = -1
    return (q, pool, pa.make_block_table(table, nb, device),
            torch.tensor(ctxs, dtype=torch.int32, device=device))


def _paged_check(q, pool, tbl, ctx):
    out = pa.paged_attention(q, pool[:, 0], pool[:, 1], tbl, ctx)
    want = ref.paged_attention_ref(q, pool[:, 0], pool[:, 1], tbl, ctx)
    torch.cuda.synchronize()
    tol = PAGED_TOL[q.dtype]
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    return out


@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("d", pa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_at_split_edges(cuda, dtype, d, g):
    """Contexts at the edges of the card's split plan: 1, bt - 1, bt, bt + 1,
    S * bt - 1, S * bt + 1 and the full table, S being the splits the call
    launches; then b = 3 with a row of context 0 beside long rows."""
    hkv, bt, mb = 2, 16, 64
    rng = np.random.default_rng(d + g)
    for b in (7, 3):
        splits, _ = pa.plan(cuda, dtype, d, g, b, hkv, mb)
        full = mb * bt
        if b == 7:
            ctxs = [1, bt - 1, bt, bt + 1, min(splits * bt - 1, full),
                    min(splits * bt + 1, full), full]
        else:
            ctxs = [0, full, min(splits * bt + 1, full)]
        q, pool, tbl, ctx = _paged_rows(rng, dtype, cuda, ctxs, g * hkv, hkv, d, bt, mb)
        out = _paged_check(q, pool, tbl, ctx)
        if b == 3:
            assert not out[0].any()  # context 0 gives zeros


def test_paged_kernel_repeats_bit_for_bit(cuda):
    """Shape A, then another b and context, then A again: the first and third
    outputs are equal bit for bit, so the counters were left at 0 and the
    merge takes the splits in a fixed order."""
    rng = np.random.default_rng(11)
    a = _paged_rows(rng, torch.bfloat16, cuda, [1000], 32, 8, 128, 16, 128)
    other = _paged_rows(rng, torch.bfloat16, cuda, [0, 5, 700, 2048], 32, 8, 128, 16, 128)
    first = _paged_check(*a)
    _paged_check(*other)
    third = _paged_check(*a)
    assert torch.equal(first, third)


def test_paged_kernel_replays_in_a_cuda_graph(cuda):
    """One warm-up call, one call captured in a CUDA graph, new contexts
    written in place, a replay: the replay equals the plain version on the
    new contexts and an eager call on them, bit for bit."""
    rng = np.random.default_rng(12)
    q, pool, tbl, ctx = _paged_rows(rng, torch.bfloat16, cuda, [1040, 300], 32, 8, 128, 16, 128)
    k, v = pool[:, 0], pool[:, 1]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pa.paged_attention(q, k, v, tbl, ctx)  # warm-up: builds the kernel, reads the plan
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pa.paged_attention(q, k, v, tbl, ctx)
    ctx.copy_(torch.tensor([17, 2048], dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    want = ref.paged_attention_ref(q, k, v, tbl, ctx)
    torch.testing.assert_close(out.float(), want.float(), atol=PAGED_TOL[q.dtype],
                               rtol=PAGED_TOL[q.dtype])
    assert torch.equal(out, pa.paged_attention(q, k, v, tbl, ctx))


def test_paged_kernel_is_one_device_kernel_per_call(cuda):
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(13)
    q, pool, tbl, ctx = _paged_rows(rng, torch.bfloat16, cuda, [1040], 32, 8, 128, 16, 128)
    pa.paged_attention(q, pool[:, 0], pool[:, 1], tbl, ctx)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pa.paged_attention(q, pool[:, 0], pool[:, 1], tbl, ctx)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert [(e.count, "paged" in e.key) for e in kernels] == [(1, True)], \
        [(e.key, e.count) for e in kernels]


SSD_CASES = [
    # (nb, Lc, nh, hp, n, groups)
    (2, 32, 8, 16, 8, 8),  # tests/test_kernels.py shapes, B/C per head
    (1, 16, 4, 8, 16, 4),
    (3, 40, 8, 16, 16, 1),  # a chunk that is no multiple of the 64-row tile
    (2, 32, 8, 16, 16, 2),  # two groups
    (1, 256, 80, 64, 128, 1),  # Mamba-2 2.7B
    (2, 256, 12, 64, 128, 1),  # heads no multiple of the 8-head block
]
SSD_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}


def _ssd_inputs(rng, case, dtype, device):
    nb, lc, nh, hp, n, g = case
    x = _randn(rng, (nb, lc, nh, hp), torch.float32, device)
    a = torch.from_numpy(-np.abs(rng.normal(size=(nb, lc, nh))).astype(np.float32) * 0.1)
    b = _randn(rng, (nb, lc, g, n), dtype, device)
    c = _randn(rng, (nb, lc, g, n), dtype, device)
    return x, a.to(device), b, c


def _assert_ssd_matches_plain(cuda, case, dtype, tol):
    x, a, b, c = _ssd_inputs(np.random.default_rng(sum(case)), case, dtype, cuda)
    y, st = ssd.ssd_chunk(x, a, b, c)
    yr, sr = ref.ssd_chunk_ref(x, a, b, c)
    torch.cuda.synchronize()
    # relative to the output's scale: full-width chunks sum 256 x 128 terms
    scale_y, scale_s = yr.abs().max().item(), sr.abs().max().item()
    torch.testing.assert_close(y / scale_y, yr / scale_y, atol=tol, rtol=tol)
    torch.testing.assert_close(st / scale_s, sr / scale_s, atol=tol, rtol=tol)


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain(cuda, case, dtype):
    _assert_ssd_matches_plain(cuda, case, dtype, SSD_TOL[dtype])


def test_ssd_kernel_reads_expanded_and_sliced_b_c(cuda):
    """Group-shaped B/C, the same expanded over heads with stride 0, and B/C
    as slices of one projection (the model's layout) give one answer."""
    nb, lc, nh, hp, n = 2, 64, 16, 16, 32
    rng = np.random.default_rng(11)
    x, a, _, _ = _ssd_inputs(rng, (nb, lc, nh, hp, n, 1), torch.float32, cuda)
    bc = _randn(rng, (nb, lc, 2 * n), torch.bfloat16, cuda)
    b, c = bc[..., :n].reshape(nb, lc, 1, n), bc[..., n:].reshape(nb, lc, 1, n)
    y1, s1 = ssd.ssd_chunk(x, a, b, c)
    y2, s2 = ssd.ssd_chunk(x, a, b.expand(nb, lc, nh, n), c.expand(nb, lc, nh, n))
    y3, s3 = ssd.ssd_chunk(x, a, b.contiguous(), c.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(s1, s2)
    assert torch.equal(y1, y3) and torch.equal(s1, s3)


# The tile-edge cases at float32 level for both B/C dtypes: the kernel and the
# plain version read the same bf16 values and both compute in float32, so a
# lower-precision product (a dropped split pass, single-pass TF32: 3.5e-4 to
# 5.6e-4 of the scale) fails here, where SSD_TOL's bf16 5e-2 would pass it.
SSD_EDGE_TOL = 2e-4
SSD_TC_CASES = [
    # (nb, Lc, nh, hp, n, groups): the tensor-core kernel's tiles and clusters
    (16, 256, 80, 64, 128, 1),  # Mamba-2 2.7B at 4096 tokens
    (2, 100, 8, 64, 128, 1),  # Lc no multiple of the 64-row tile: one CTA a chunk
    (2, 200, 8, 64, 128, 1),  # four row tiles, the last of 8 rows: clusters of two
    (1, 256, 12, 64, 128, 1), (1, 256, 12, 64, 128, 2), (1, 256, 12, 64, 128, 4),
    (1, 256, 80, 64, 128, 2), (1, 256, 80, 64, 128, 4),
    (2, 150, 6, 20, 24, 3),  # odd tile count, hp and n no multiple of the mma tiles
    (1, 64, 4, 6, 10, 2),  # rows not 16-byte aligned: staged element by element
]


@pytest.mark.parametrize("case", SSD_TC_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain_at_tile_edges(cuda, case, dtype):
    _assert_ssd_matches_plain(cuda, case, dtype, SSD_EDGE_TOL)


def test_ssd_kernel_returns_the_prefix_sums(cuda):
    """cum against torch.cumsum of the same a; y and st bit for bit as
    without return_cum."""
    x, a, b, c = _ssd_inputs(np.random.default_rng(21), (4, 256, 80, 64, 128, 1),
                             torch.bfloat16, cuda)
    y, st, cum = ssd.ssd_chunk(x, a, b, c, return_cum=True)
    y0, st0 = ssd.ssd_chunk(x, a, b, c)
    want = torch.cumsum(a, dim=1)
    torch.cuda.synchronize()
    assert cum.shape == a.shape and cum.dtype == torch.float32
    torch.testing.assert_close(cum, want, rtol=1e-6, atol=1e-6 * want.abs().max().item())
    assert torch.equal(y, y0) and torch.equal(st, st0)
    for lc in (40, 100):
        xs, as_, bs, cs = _ssd_inputs(np.random.default_rng(lc), (3, lc, 8, 16, 16, 2),
                                      torch.float32, cuda)
        cum = ssd.ssd_chunk(xs, as_, bs, cs, return_cum=True)[2]
        want = torch.cumsum(as_, dim=1)
        torch.testing.assert_close(cum, want, rtol=1e-6, atol=1e-6 * want.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_repeats_bit_for_bit(cuda, dtype):
    x, a, b, c = _ssd_inputs(np.random.default_rng(22), (4, 256, 80, 64, 128, 1), dtype, cuda)
    first = ssd.ssd_chunk(x, a, b, c, return_cum=True)
    ssd.ssd_chunk(x[:1].contiguous(), a[:1].contiguous(), b[:1], c[:1])
    second = ssd.ssd_chunk(x, a, b, c, return_cum=True)
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(first, second))


def test_ssd_kernel_replays_in_a_cuda_graph(cuda):
    """One warm-up call, one call captured in a CUDA graph, new inputs written
    in place, a replay: equal to an eager call on the new inputs bit for bit."""
    rng = np.random.default_rng(23)
    case = (4, 256, 80, 64, 128, 1)
    x, a, b, c = _ssd_inputs(rng, case, torch.bfloat16, cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ssd.ssd_chunk(x, a, b, c, return_cum=True)  # warm-up: builds the kernel
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ssd.ssd_chunk(x, a, b, c, return_cum=True)
    x2, a2, b2, c2 = _ssd_inputs(rng, case, torch.bfloat16, cuda)
    for dst, src in ((x, x2), (a, a2), (b, b2), (c, c2)):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    eager = ssd.ssd_chunk(x2, a2, b2, c2, return_cum=True)
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(out, eager))
    yr, sr = ref.ssd_chunk_ref(x2, a2, b2, c2)
    assert (out[0] - yr).abs().max() <= 1e-4 * yr.abs().max()
    assert (out[1] - sr).abs().max() <= 1e-4 * sr.abs().max()


def test_ssd_kernel_occupancy(cuda):
    """Two CTAs an SM for bf16 B/C (the served model), one for float32."""
    assert ssd.ctas_per_sm(torch.bfloat16) >= 2
    assert ssd.ctas_per_sm(torch.float32) >= 1


@pytest.mark.parametrize("lc,n,hp", [(512, 16, 16), (32, 256, 16), (32, 16, 128)])
def test_ssd_kernel_rejects_outside_its_domain(cuda, lc, n, hp):
    x = torch.zeros((1, lc, 2, hp), device=cuda)
    a = torch.zeros((1, lc, 2), device=cuda)
    b = torch.zeros((1, lc, 1, n), device=cuda)
    with pytest.raises(ValueError, match="ssd_chunk takes Lc <= 256"):
        ssd.ssd_chunk(x, a, b, b)


@pytest.mark.parametrize("arch", ["llama3.1-8b", "olmo-1b", "qwen1.5-0.5b"])
def test_reduced_model_card_matches_cpu(cuda, arch):
    from repro_torch.configs.registry import reduced_config
    from repro_torch.models.model import Model, init_params

    cfg = dataclasses.replace(reduced_config(arch), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = _tree_to(params, cuda)
    model = Model(cfg)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (1, 40)))
    lg_cpu, cache_cpu = model.prefill_fn(params, tokens, max_len=64)
    lg_gpu, cache_gpu = model.prefill_fn(on_card, tokens.to(cuda), max_len=64)
    torch.testing.assert_close(lg_gpu.cpu(), lg_cpu, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(cache_gpu[0].cpu(), cache_cpu[0], atol=1e-4, rtol=1e-4)


def test_reduced_mamba_card_matches_cpu(cuda):
    from repro_torch.configs.registry import reduced_config
    from repro_torch.models.model import Model, init_params

    cfg = dataclasses.replace(reduced_config("mamba2-2.7b"), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = _tree_to(params, cuda)
    model = Model(cfg)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 70)))
    lg_cpu, cache_cpu = model.prefill_fn(params, tokens)
    ssd.ssd_chunk.launches = 0
    lg_gpu, cache_gpu = model.prefill_fn(on_card, tokens.to(cuda))
    assert ssd.ssd_chunk.launches == cfg.n_layers
    torch.testing.assert_close(lg_gpu.cpu(), lg_cpu, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(cache_gpu["state"].cpu(), cache_cpu["state"], atol=1e-4,
                               rtol=1e-4)
    for step in range(4):
        tok, pos = torch.tensor([3 + step, 9]), torch.tensor([70 + step] * 2)
        lc = model.decode_fn(params, cache_cpu, tok, pos)
        lg = model.decode_fn(on_card, cache_gpu, tok.to(cuda), pos.to(cuda))
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)


def test_reduced_llama_decode_card_matches_cpu(cuda):
    """Decode attention through the paged kernel against the plain version."""
    from repro_torch.configs.registry import reduced_config
    from repro_torch.models.model import Model, init_params

    cfg = dataclasses.replace(reduced_config("llama3.1-8b"), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = _tree_to(params, cuda)
    model = Model(cfg)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 40)))
    _, cache_cpu = model.prefill_fn(params, tokens, max_len=64)
    _, cache_gpu = model.prefill_fn(on_card, tokens.to(cuda), max_len=64)
    pa.paged_attention.launches = 0
    for step in range(4):
        tok, pos = torch.tensor([5 + step, 7]), torch.tensor([40 + step, 40 + step])
        lc = model.decode_fn(params, cache_cpu, tok, pos)
        lg = model.decode_fn(on_card, cache_gpu, tok.to(cuda), pos.to(cuda))
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
    assert pa.paged_attention.launches == 4 * cfg.n_layers


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}
