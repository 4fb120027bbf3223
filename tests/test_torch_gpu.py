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

from repro_torch.experiments.common import rounding_steps
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
        "flash_attention_bwd": 0, "ssd_chunk_bwd": 0,
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


# ---------------------------------------------------------------------------
# the MoE and hybrid paths' shapes: Arctic's GQA group of 7 (56 / 8 heads)
# and Jamba's group of 8 at 64 / 8 heads, d 128, bf16; Jamba's 256 SSD heads
# ---------------------------------------------------------------------------

MOE_FLASH_CASES = [
    # (b, sq, skv, hq, hkv, d, causal)
    (1, 1024, 1024, 56, 8, 128, True),  # one layer of the Arctic prefill
    (1, 1000, 1000, 64, 8, 128, True),  # Jamba's attention layer, 1000 tokens
    (1, 100, 100, 14, 2, 128, True),  # group 7, ragged
    (2, 200, 200, 7, 1, 128, False),
]


@pytest.mark.parametrize("case", MOE_FLASH_CASES)
def test_flash_wgmma_route_at_groups_7_and_8(cuda, case):
    b, sq, skv, hq, hkv, d, causal = case
    rng = np.random.default_rng(sum(case[:6]) + 2)
    q = _randn(rng, (b, sq, hq, d), torch.bfloat16, cuda)
    k = _randn(rng, (b, skv, hkv, d), torch.bfloat16, cuda)
    v = _randn(rng, (b, skv, hkv, d), torch.bfloat16, cuda)
    before = dict(fa.flash_attention.launches_by_route)
    out = fa.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches_by_route["wgmma"] == before["wgmma"] + 1
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[torch.bfloat16],
                               rtol=TOL[torch.bfloat16])


@pytest.mark.parametrize("hq,mb", [(56, 128), (64, 64)])  # Arctic (max_len 2048), Jamba (1024)
def test_paged_kernel_at_groups_7_and_8(cuda, hq, mb):
    """bf16, d 128, 8 kv heads, blocks of 16: the decode contexts of the two
    paths (1040 and 1016) beside the split plan's edges."""
    hkv, d, bt = 8, 128, 16
    rng = np.random.default_rng(hq + mb)
    splits, _ = pa.plan(cuda, torch.bfloat16, d, hq // hkv, 4, hkv, mb)
    ctxs = [1, bt + 1, min(splits * bt + 1, mb * bt), 1040 if mb == 128 else 1016]
    q, pool, tbl, ctx = _paged_rows(rng, torch.bfloat16, cuda, ctxs, hq, hkv, d, bt, mb)
    _paged_check(q, pool, tbl, ctx)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_at_jamba_heads(cuda, dtype):
    """Jamba-1.5-Large's SSD: 256 heads of 64, d_state 128, chunks of 256, one
    group, a 1024-token prompt (4 chunks), at the float32-level limit."""
    _assert_ssd_matches_plain(cuda, (4, 256, 256, 64, 128, 1), dtype, SSD_EDGE_TOL)


@pytest.mark.parametrize("arch", ["arctic-480b", "llama4-maverick-400b-a17b",
                                  "jamba-1.5-large-398b"])
def test_reduced_moe_and_hybrid_card_matches_cpu(cuda, arch):
    from repro_torch.configs.registry import reduced_config
    from repro_torch.models.model import Model, init_params

    cfg = dataclasses.replace(reduced_config(arch), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = _tree_to(params, cuda)
    model = Model(cfg)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 40)))
    lg_cpu, cache_cpu = model.prefill_fn(params, tokens, max_len=64)
    lg_gpu, cache_gpu = model.prefill_fn(on_card, tokens.to(cuda), max_len=64)
    torch.testing.assert_close(lg_gpu.cpu(), lg_cpu, atol=1e-4, rtol=1e-4)
    for step in range(4):
        tok, pos = torch.tensor([3 + step, 9]), torch.tensor([40 + step] * 2)
        lc = model.decode_fn(params, cache_cpu, tok, pos)
        lg = model.decode_fn(on_card, cache_gpu, tok.to(cuda), pos.to(cuda))
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# qwen3-32b's shapes: head_dim 80 at groups 7 and 8 (paged; the bf16
# tensor-core kernel takes a whole group a CTA) and flash's wgmma route at
# head_dim 80 (five 32-byte TMA boxes a tile) and at 56 and 64 heads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hq", [56, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_at_head_dim_80_split_edges(cuda, dtype, hq):
    """Contexts at the plan's edges at d 80, groups 7 and 8 over 8 kv heads:
    1, bt - 1, bt, bt + 1, S * bt +- 1, the full table, a row of context 0."""
    hkv, d, bt, mb = 8, 80, 16, 128
    rng = np.random.default_rng(hq + 80)
    splits, _ = pa.plan(cuda, dtype, d, hq // hkv, 7, hkv, mb)
    full = mb * bt
    ctxs = [0, 1, bt - 1, bt, bt + 1, min(splits * bt - 1, full), min(splits * bt + 1, full),
            full, 1040]
    q, pool, tbl, ctx = _paged_rows(rng, dtype, cuda, ctxs, hq, hkv, d, bt, mb)
    out = _paged_check(q, pool, tbl, ctx)
    assert not out[0].any()  # context 0 gives zeros


def _qwen3_decode(cuda, rng, ctxs):
    return _paged_rows(rng, torch.bfloat16, cuda, ctxs, 64, 8, 80, 16, 128)


def test_paged_kernel_at_head_dim_80_repeats_bit_for_bit(cuda):
    rng = np.random.default_rng(21)
    a = _qwen3_decode(cuda, rng, [1040])
    other = _qwen3_decode(cuda, rng, [0, 5, 700, 2048])
    first = _paged_check(*a)
    _paged_check(*other)
    assert torch.equal(first, _paged_check(*a))


def test_paged_kernel_at_head_dim_80_replays_in_a_cuda_graph(cuda):
    rng = np.random.default_rng(22)
    q, pool, tbl, ctx = _qwen3_decode(cuda, rng, [1040, 300])
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


def test_paged_kernel_at_head_dim_80_is_one_device_kernel_per_call(cuda):
    from torch.profiler import ProfilerActivity, profile

    q, pool, tbl, ctx = _qwen3_decode(cuda, np.random.default_rng(23), [1040])
    pa.paged_attention(q, pool[:, 0], pool[:, 1], tbl, ctx)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pa.paged_attention(q, pool[:, 0], pool[:, 1], tbl, ctx)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert [(e.count, "paged" in e.key) for e in kernels] == [(1, True)], \
        [(e.key, e.count) for e in kernels]


QWEN3_FLASH_CASES = [
    # (b, sq, skv, hq, hkv, d, causal)
    (1, 1024, 1024, 64, 8, 80, True),  # one layer of the qwen3-32b prefill
    (1, 129, 129, 16, 2, 80, True),  # one row past a q tile
    (1, 37, 80, 8, 1, 80, True),  # sq != skv, causal aligned at position 0
    (2, 200, 200, 16, 2, 80, False),
    (1, 64, 300, 7, 1, 80, False),  # keys past skv in the last tile
    (1, 2048, 2048, 56, 8, 128, True),  # Arctic's heads over 16 K/V tiles
    (2, 1024, 1024, 64, 8, 128, True),  # Jamba's heads, two rows: 1024 work items
    (1, 300, 300, 64, 8, 64, True),
]


@pytest.mark.parametrize("case", QWEN3_FLASH_CASES)
def test_flash_wgmma_route_at_head_dim_80_and_56_64_heads(cuda, case):
    b, sq, skv, hq, hkv, d, causal = case
    rng = np.random.default_rng(sum(case[:6]) + 3)
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


def test_flash_wgmma_route_repeats_bit_for_bit_at_head_dim_80(cuda):
    """The persistent grid's items run in a fixed order per CTA and each
    output is written once: two calls give the same bits."""
    rng = np.random.default_rng(24)
    q = _randn(rng, (1, 1024, 64, 80), torch.bfloat16, cuda)
    k = _randn(rng, (1, 1024, 8, 80), torch.bfloat16, cuda)
    first = fa.flash_attention(q, k, k)
    assert torch.equal(first, fa.flash_attention(q, k, k))


# -- the fp8 KV cache: paged_attention's e4m3 instantiation, the cast helper,
# the transfer kernels on e4m3 payloads and reduced models on the card.
# Tolerance 3e-2 for a float32 or bf16 q alike: both sides read bf16 K/V and
# a bf16 q * scale, and round P to bf16 (the plain version the normalised P,
# the kernel the tile's unnormalised one), so they differ by bf16 steps.
FP8_TOL = 3e-2
FP8_CTXS = [0, 17, 1040]  # one batch: an empty row, a partial block, the main path's


def _fp8_rows(rng, dtype, device, ctxs, hq, hkv, d, bt, mb):
    """_paged_rows with the pool cast to e4m3 as the model's cache is."""
    from repro_torch.models.attention import to_e4m3

    q, pool, tbl, ctx = _paged_rows(rng, torch.float32, device, ctxs, hq, hkv, d, bt, mb)
    return q.to(dtype), to_e4m3(pool), tbl, ctx


def _fp8_check(q, pool, tbl, ctx):
    before = dict(pa.paged_attention.launches_by_kv)
    out = pa.paged_attention(q, pool[:, 0], pool[:, 1], tbl, ctx)
    want = ref.paged_attention_ref(q, pool[:, 0], pool[:, 1], tbl, ctx)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype
    assert pa.paged_attention.launches_by_kv["float8_e4m3fn"] == before["float8_e4m3fn"] + 1
    torch.testing.assert_close(out.float(), want.float(), atol=FP8_TOL, rtol=FP8_TOL,
                               equal_nan=True)
    return out


@pytest.mark.parametrize("g", range(1, 9))
@pytest.mark.parametrize("d", pa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_fp8_kernel_matches_plain(cuda, dtype, d, g):
    """K/V e4m3 under a float32 or bf16 q at every head_dim and group 1-8,
    contexts {0, 17, 1040} in one batch (the context-0 row all zeros)."""
    rng = np.random.default_rng(100 * d + g)
    out = _fp8_check(*_fp8_rows(rng, dtype, cuda, FP8_CTXS, g * 2, 2, d, 16, 66))
    assert not out[0].any()


def test_paged_fp8_kernel_propagates_nan_as_the_plain_version(cuda):
    """An e4m3 NaN (a K/V value that rounded past 448) inside a row's
    context: every head of its kv head reads NaN, on both sides; the other
    rows and kv heads stay finite."""
    rng = np.random.default_rng(31)
    q, pool, tbl, ctx = _fp8_rows(rng, torch.bfloat16, cuda, [300, 1040, 64], 16, 2, 128, 16,
                                  66)
    bits = pool.view(torch.uint8)
    bits[int(tbl[1, 3]), 0, 5, 1, 7] = 0x7F  # K of row 1, kv head 1
    bits[int(tbl[2, 0]), 1, 9, 0, 100] = 0xFF  # V of row 2, kv head 0
    out = _fp8_check(q, pool, tbl, ctx)
    nan = torch.isnan(out).reshape(3, 2, 8, 128)
    assert nan[1, 1].all() and nan[2, 0, :, 100].all()
    assert not nan[0].any() and not nan[1, 0].any() and not nan[2, 1].any()


def test_paged_fp8_kernel_repeats_bit_for_bit(cuda):
    rng = np.random.default_rng(32)
    a = _fp8_rows(rng, torch.bfloat16, cuda, [1040], 64, 8, 80, 16, 66)
    other = _fp8_rows(rng, torch.float32, cuda, [0, 5, 700], 32, 8, 128, 16, 66)
    first = _fp8_check(*a)
    _fp8_check(*other)
    assert torch.equal(first, _fp8_check(*a))


def test_paged_fp8_kernel_replays_in_a_cuda_graph(cuda):
    rng = np.random.default_rng(33)
    q, pool, tbl, ctx = _fp8_rows(rng, torch.float32, cuda, [1040, 300], 32, 8, 128, 16, 66)
    k, v = pool[:, 0], pool[:, 1]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pa.paged_attention(q, k, v, tbl, ctx)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pa.paged_attention(q, k, v, tbl, ctx)
    ctx.copy_(torch.tensor([17, 1056], dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    want = ref.paged_attention_ref(q, k, v, tbl, ctx)
    torch.testing.assert_close(out, want, atol=FP8_TOL, rtol=FP8_TOL)
    assert torch.equal(out, pa.paged_attention(q, k, v, tbl, ctx))


def test_paged_fp8_kernel_refuses_other_pairs(cuda):
    q = torch.zeros((1, 8, 64), device=cuda)
    blocks = torch.zeros((2, 16, 1, 64), device=cuda)
    tbl = pa.make_block_table([[0, 1]], 2, cuda)
    ctx = torch.ones(1, dtype=torch.int32, device=cuda)
    for qd, kd in ((torch.float32, torch.float8_e5m2), (torch.bfloat16, torch.float8_e5m2),
                   (torch.float16, torch.float8_e4m3fn), (torch.float32, torch.bfloat16)):
        with pytest.raises(ValueError, match="dtypes"):
            pa.paged_attention(q.to(qd), blocks.to(kd), blocks.to(kd), tbl, ctx)


def test_e4m3_cast_on_the_card_equals_the_cpu_bytes(cuda):
    """to_e4m3 over every bf16 bit pattern and float32 edge cases: the card's
    cast (another code path than the CPU's) gives the CPU's bytes, which
    tests/test_torch_fp8.py holds against jnp.astype."""
    from repro_torch.models.attention import to_e4m3

    bf = torch.arange(-(2**15), 2**15, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    f32 = torch.tensor([464.0, 464.00003, 463.99997, 448.0, 480.0, -464.00003, float("inf"),
                        -float("inf"), float("nan"), 2.0**-10, 3 * 2.0**-11, 2.0**-9, 1e38,
                        -0.0, 1e-30])
    for x in (bf, f32):
        got = to_e4m3(x.to(cuda)).view(torch.uint8).cpu()
        assert torch.equal(got, to_e4m3(x).view(torch.uint8))


@pytest.mark.parametrize("hd", [16, 80, 128])
def test_kv_transfer_kernels_bit_exact_on_e4m3(cuda, hd):
    """gather and scatter move e4m3 payloads as bytes (NaN bytes included)."""
    from repro_torch.models.attention import to_e4m3

    L, n_slots, bt, hkv = 4, 8, 16, 2
    gen = torch.Generator(device=cuda).manual_seed(hd)
    k = to_e4m3(torch.randn((L, n_slots * bt, hkv, hd), generator=gen, device=cuda) * 200)
    v = to_e4m3(torch.randn((L, n_slots * bt, hkv, hd), generator=gen, device=cuda) * 200)
    slots = [5, 1, 6]
    blocks = kv.kv_gather_write(k, v, slots, bt)
    want = ref.kv_gather_write_ref(k, v, torch.tensor(slots, device=cuda), bt)
    assert torch.equal(blocks.view(torch.uint8), want.view(torch.uint8))
    kr, vr = kv.kv_scatter_read(blocks, [0, 3, 7], n_slots)
    k0 = torch.zeros_like(k)
    kw, vw = ref.kv_scatter_read_ref(blocks, torch.tensor([0, 3, 7], device=cuda), k0, k0, bt)
    assert torch.equal(kr.view(torch.uint8), kw.view(torch.uint8))
    assert torch.equal(vr.view(torch.uint8), vw.view(torch.uint8))


# card vs CPU logits of a reduced float32 model decoding from an fp8 cache:
# both decode attentions round P to bf16 (JAX's contract), the kernel a
# tile's unnormalised P and the plain version the normalised one, so the
# logits differ by such roundings (3e-4 to 5e-4 in the first readings, where
# the bf16-cache models stay under 1e-6); prefill runs no fp8 attention
FP8_MODEL_TOL = 2e-3


def _e4m3_neighbours(a: torch.Tensor, b: torch.Tensor) -> int:
    """Bytes of two e4m3 tensors that differ; raises unless each such pair
    is at most one rounding step apart on the e4m3 number line (-0 and +0
    one point: a value near zero rounds to either)."""
    def ordinal(t):
        x = t.view(torch.uint8).cpu().int()
        return torch.where(x >= 0x80, -(x & 0x7F), x)

    assert ((ordinal(a) - ordinal(b)).abs() <= 1).all()
    return int((a.view(torch.uint8).cpu() != b.view(torch.uint8).cpu()).sum())


@pytest.mark.parametrize("arch", ["musicgen-large", "internvl2-26b", "llama3.1-8b"])
def test_reduced_frontend_and_fp8_models_card_match_cpu(cuda, arch):
    """Reduced musicgen-large and internvl2-26b (float32 caches)
    and llama3.1-8b with an fp8 cache, float32: prefill and 6 decode steps
    on the card against the CPU, logits within 1e-4 (fp8: FP8_MODEL_TOL);
    the fp8 prefill caches bit for bit, and the rows decode writes equal or
    one e4m3 step apart (their K/V carry the attention's P roundings)."""
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.configs.registry import reduced_config
    from repro_torch.models.model import Model, init_params

    fp8 = arch == "llama3.1-8b"
    cfg = dataclasses.replace(reduced_config(arch), dtype="float32")
    model = Model(cfg, runtime=RuntimeConfig(use_fp8_kv=fp8))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = _to_device(params, cuda)
    g = torch.Generator().manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 40), generator=g)}
    if cfg.frontend == "audio_stub":
        batch = {"frame_embeds": torch.randn((2, 40, cfg.d_model), generator=g)}
    elif cfg.frontend == "vision_stub":
        batch["patch_embeds"] = torch.randn((2, cfg.n_frontend_tokens, cfg.d_model), generator=g)
    s = 40 + (cfg.n_frontend_tokens if cfg.frontend == "vision_stub" else 0)
    lc, cc = model.prefill_fn(params, batch, max_len=64)
    lg, cg = model.prefill_fn(on_card, {k: v.to(cuda) for k, v in batch.items()}, max_len=64)
    assert (lg.cpu() - lc).abs().max().item() <= 1e-4
    if fp8:
        assert cg[0].dtype == torch.float8_e4m3fn
        for a, b in zip(cc, cg):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8).cpu())
    diffs = []
    for step in range(6):
        tok = torch.full((2,), 3 + step)
        pos = torch.full((2,), s + step)
        a = model.decode_fn(params, cc, tok, pos)
        diffs.append((model.decode_fn(on_card, cg, tok.to(cuda), pos.to(cuda)).cpu() - a)
                     .abs().max().item())
    assert max(diffs) <= (FP8_MODEL_TOL if fp8 else 1e-4), diffs
    if fp8:
        for a, b in zip(cc, cg):
            _e4m3_neighbours(a, b)


def _to_device(tree, device):
    return {k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Training: the flash backward kernels, the forward's log-sum-exp, autograd
# through ops.flash_attention, and a reduced train step card vs CPU.
# Tolerances relative to the largest |gradient|: f32 2e-5, bf16 2e-2 (TOL).
# ---------------------------------------------------------------------------

BWD_CASES = FLASH_CASES + [
    (1, 129, 129, 16, 2, 80, True),  # qwen3-32b's d 80, group 8
    (2, 200, 200, 8, 8, 128, False),
    (1, 300, 64, 4, 4, 16, True),  # sq > skv under the mask
    (1, 64, 300, 8, 1, 128, False),
]


def _rel(a, b) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-30)).item()


# ssd_chunk_bwd against its plain version, relative to each output's scale:
# f32 sums in other orders on both sides (chip_smoke.py's SSD_TOL)
SSD_BWD_TOL = 1e-4


@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_matches_plain(cuda, case, dtype):
    b, sq, skv, hq, hkv, d, causal = case
    rng = np.random.default_rng(7)
    q, do = (_randn(rng, (b, sq, hq, d), dtype, cuda) for _ in range(2))
    k, v = (_randn(rng, (b, skv, hkv, d), dtype, cuda) for _ in range(2))
    o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == w.shape
        assert _rel(a, w) <= TOL[dtype], name


@pytest.mark.parametrize("route", fa.ROUTES)
def test_flash_stores_the_log_sum_exp(cuda, route):
    rng = np.random.default_rng(8)
    for b, sq, skv, hq, hkv, d, causal in [(1, 100, 100, 8, 2, 128, True),
                                           (1, 37, 80, 4, 1, 64, True),
                                           (2, 64, 300, 8, 2, 80, False)]:
        q = _randn(rng, (b, sq, hq, d), torch.bfloat16, cuda)
        k, v = (_randn(rng, (b, skv, hkv, d), torch.bfloat16, cuda) for _ in range(2))
        o, lse = fa.flash_attention(q, k, v, causal=causal, force_route=route, return_lse=True)
        o_ref, lse_ref = ref.flash_attention_lse_ref(q, k, v, causal)
        assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
        assert (lse - lse_ref).abs().max().item() <= 1e-5
        assert torch.equal(o, fa.flash_attention(q, k, v, causal=causal, force_route=route))


def test_flash_bwd_repeats_bit_for_bit(cuda):
    """No atomics: the GQA group's sum is taken inside a CTA."""
    rng = np.random.default_rng(9)
    q, do = (_randn(rng, (2, 200, 16, 128), torch.bfloat16, cuda) for _ in range(2))
    k, v = (_randn(rng, (2, 200, 2, 128), torch.bfloat16, cuda) for _ in range(2))
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    first = fa.flash_attention_bwd(q, k, v, o, lse, do)
    for _ in range(3):
        again = fa.flash_attention_bwd(q, k, v, o, lse, do)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_flash_bwd_rejects_what_it_cannot_take(cuda):
    q = torch.zeros((1, 64, 4, 64), device=cuda)
    k = torch.zeros((1, 64, 2, 64), device=cuda)
    o, lse = fa.flash_attention(q, k, k, return_lse=True)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, k, k, o, lse[:, :, :10], q)
    with pytest.raises(ValueError, match="one dtype"):
        fa.flash_attention_bwd(q, k, k, o, lse, q.to(torch.bfloat16))
    with pytest.raises(ValueError, match="bad shapes"):
        fa.flash_attention_bwd(q, k, k[:, :32], o, lse, q)
    with pytest.raises(ValueError, match="head_dim"):
        x = torch.zeros((1, 8, 2, 24), device=cuda)
        fa.flash_attention_bwd(x, x, x, x, torch.zeros((1, 2, 8), device=cuda), x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_through_the_kernels_matches_plain_autograd(cuda, dtype):
    rng = np.random.default_rng(10)
    base = [_randn(rng, s, dtype, cuda) for s in ((2, 100, 8, 64), (2, 100, 2, 64),
                                                  (2, 100, 2, 64))]
    do = _randn(rng, (2, 100, 8, 64), dtype, cuda)
    ops.reset_launch_counts()
    qkv = [t.clone().requires_grad_(True) for t in base]
    ops.flash_attention(*qkv).backward(do)
    assert ops.launch_counts()["flash_attention"] == 1
    assert ops.launch_counts()["flash_attention_bwd"] == 1
    assert ops.bwd_kernels() == {"delta": 1, "dkdv": 1, "dq": 1}
    plain = [t.clone().requires_grad_(True) for t in base]
    ops.flash_attention(*plain, mode="ref").backward(do)
    assert ops.launch_counts()["flash_attention_bwd"] == 1  # "ref" is plain autograd
    for a, b in zip(qkv, plain):
        assert _rel(a.grad, b.grad) <= TOL[dtype]
    with torch.no_grad():  # serving: one forward launch, no log-sum-exp, no backward
        ops.flash_attention(*qkv)
    assert ops.launch_counts()["flash_attention"] == 2


def test_ssd_chunk_under_autograd_on_the_card_raises(cuda):
    """Under autograd ssd_chunk takes the backward kernel (one forward, one
    backward launch) and matches plain autograd; without grad it is one
    forward launch; a cotangent of the wrong shape is refused."""
    rng = np.random.default_rng(13)
    base = [_randn(rng, (2, 100, 4, 16), torch.float32, cuda),
            -torch.rand((2, 100, 4), device=cuda) * 0.5,
            _randn(rng, (2, 100, 2, 16), torch.float32, cuda),
            _randn(rng, (2, 100, 2, 16), torch.float32, cuda)]
    cots = [_randn(rng, s, torch.float32, cuda) for s in ((2, 100, 4, 16), (2, 4, 16, 16),
                                                          (2, 100, 4))]
    grads = {}
    for mode in ("auto", "ref"):
        leaves = [t.clone().requires_grad_(True) for t in base]
        ops.reset_launch_counts()
        y, st, cum = ops.ssd_chunk(*leaves, return_cum=True, mode=mode)
        sum((o * c).sum() for o, c in zip((y, st, cum), cots)).backward()
        counts = ops.launch_counts()
        assert (counts["ssd_chunk"], counts["ssd_chunk_bwd"]) == ((1, 1) if mode == "auto"
                                                                  else (0, 0))
        grads[mode] = [t.grad for t in leaves]
    for a, b in zip(grads["auto"], grads["ref"]):
        assert _rel(a, b) <= SSD_BWD_TOL
    with torch.no_grad():
        ops.ssd_chunk(*base)
    assert ops.launch_counts()["ssd_chunk_bwd"] == 0
    with pytest.raises(ValueError, match="dst must be"):
        ssd.ssd_chunk_bwd(*base, cots[0], cots[0])


@pytest.mark.parametrize("arch", ["olmo-1b", "llama3.1-8b", "qwen1.5-0.5b"])
def test_reduced_train_step_card_matches_cpu(cuda, arch):
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.configs.registry import reduced_config
    from repro_torch.models.model import Model, init_params
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state, tree_leaves
    from repro_torch.training.train_loop import make_train_step, value_and_grad

    cfg = dataclasses.replace(reduced_config(arch), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = _tree_to(params, cuda)
    model = Model(cfg, runtime=RuntimeConfig(remat="full"))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 48)))
    batch = {"tokens": tokens, "labels": tokens}
    card = {k: v.to(cuda) for k, v in batch.items()}
    loss_c, _, g_c = value_and_grad(model, params, batch)
    loss_g, _, g_g = value_and_grad(model, on_card, card)
    assert abs(float(loss_g) - float(loss_c)) <= 1e-4
    for a, b in zip(tree_leaves(g_g), tree_leaves(g_c)):
        assert _rel(a.cpu(), b) <= 1e-4
    opt = OptimizerConfig()
    p_c, _, m_c = make_train_step(model, opt)(params, init_opt_state(opt, params), batch)
    p_g, _, m_g = make_train_step(model, opt)(on_card, init_opt_state(opt, on_card), card)
    assert abs(float(m_g["grad_norm"]) / float(m_c["grad_norm"]) - 1) <= 1e-4
    for a, b in zip(tree_leaves(p_g), tree_leaves(p_c)):
        assert (a.cpu() - b).abs().max().item() <= 1e-4


def test_remat_policies_on_the_card_give_the_same_gradients(cuda):
    """remat "full" and "dots" recompute each layer's forward kernel in the
    backward (2 launches a layer), "none" keeps it (1); the gradients agree."""
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.configs.registry import reduced_config
    from repro_torch.models.model import Model, init_params
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train_loop import value_and_grad

    cfg = dataclasses.replace(reduced_config("llama3.1-8b"), dtype="float32")
    params = _tree_to(init_params(cfg, torch.Generator().manual_seed(0), "cpu"), cuda)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 48))).to(cuda)
    batch = {"tokens": tokens, "labels": tokens}
    grads = {}
    for remat, per_layer in (("none", 1), ("full", 2), ("dots", 2)):
        ops.reset_launch_counts()
        _, _, grads[remat] = value_and_grad(Model(cfg, runtime=RuntimeConfig(remat=remat)),
                                            params, batch)
        assert ops.launch_counts()["flash_attention"] == per_layer * cfg.n_layers
        assert ops.launch_counts()["flash_attention_bwd"] == cfg.n_layers
    for remat in ("full", "dots"):
        for a, b in zip(tree_leaves(grads[remat]), tree_leaves(grads["none"])):
            assert _rel(a, b) <= 1e-6, remat


# ---------------------------------------------------------------------------
# The backward's wgmma route (bf16, d 64 / 80 / 128): against the plain
# version at ragged, GQA and non-causal shapes, beside the CUDA-core route on
# the same inputs; reruns bit for bit; the route picked and counted.
# ---------------------------------------------------------------------------

BWD_WGMMA_CASES = [
    # (b, sq, skv, hq, hkv, d, causal)
    (1, 37, 80, 4, 1, 128, True),  # sq < skv: keys past every row get dK = dV = 0
    (1, 37, 80, 8, 2, 64, True),
    (1, 37, 80, 8, 1, 80, True),
    (1, 129, 129, 16, 2, 80, True),  # one row past a 128-row block
    (1, 300, 64, 4, 4, 64, True),  # sq > skv under the mask
    (1, 64, 300, 8, 2, 64, False),
    (2, 200, 200, 16, 2, 80, False),
    (2, 200, 200, 8, 8, 128, True),
    (1, 100, 300, 8, 2, 128, True),  # key blocks that no row sees
]


@pytest.mark.parametrize("case", BWD_WGMMA_CASES)
def test_flash_bwd_wgmma_matches_plain_at_ragged_shapes(cuda, case):
    b, sq, skv, hq, hkv, d, causal = case
    rng = np.random.default_rng(11)
    q, do = (_randn(rng, (b, sq, hq, d), torch.bfloat16, cuda) for _ in range(2))
    k, v = (_randn(rng, (b, skv, hkv, d), torch.bfloat16, cuda) for _ in range(2))
    o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    fa.reset_launch_counts()
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    slow = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, force_route="cuda_cores")
    assert fa.flash_attention_bwd.launches_by_route == {"wgmma": 1, "cuda_cores": 1}
    for name, a, s, w in zip(("dq", "dk", "dv"), got, slow, want):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape
        assert torch.isfinite(a).all()
        assert _rel(a, w) <= TOL[torch.bfloat16], name
        assert _rel(s, w) <= TOL[torch.bfloat16], name


def test_flash_bwd_wgmma_repeats_bit_for_bit(cuda):
    """No atomics on the tensor-core route either: dK and dV of a GQA group
    are summed inside one CTA, dQ inside another."""
    rng = np.random.default_rng(12)
    for b, sq, skv, hq, hkv, d in ((2, 300, 300, 16, 2, 128), (1, 129, 129, 16, 2, 80)):
        q, do = (_randn(rng, (b, sq, hq, d), torch.bfloat16, cuda) for _ in range(2))
        k, v = (_randn(rng, (b, skv, hkv, d), torch.bfloat16, cuda) for _ in range(2))
        o, lse = fa.flash_attention(q, k, v, return_lse=True)
        first = fa.flash_attention_bwd(q, k, v, o, lse, do, force_route="wgmma")
        for _ in range(3):
            again = fa.flash_attention_bwd(q, k, v, o, lse, do, force_route="wgmma")
            assert all(torch.equal(a, x) for a, x in zip(first, again))


def test_flash_bwd_force_route_refuses_what_the_route_cannot_take(cuda):
    q = torch.zeros((1, 64, 4, 64), device=cuda)
    k = torch.zeros((1, 64, 2, 64), device=cuda)
    o, lse = fa.flash_attention(q, k, k, return_lse=True)
    with pytest.raises(ValueError, match="wgmma route takes bf16"):
        fa.flash_attention_bwd(q, k, k, o, lse, q, force_route="wgmma")
    with pytest.raises(ValueError, match="not in"):
        fa.flash_attention_bwd(q, k, k, o, lse, q, force_route="tensor_cores")


def test_training_step_backward_takes_the_wgmma_route(cuda):
    """A bf16 attention stack at head_dim 64 trains through the wgmma
    backward: one call (three kernels) a layer, all on that route."""
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model, init_params
    from repro_torch.training.train_loop import value_and_grad

    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"), n_layers=2, d_model=256, n_heads=4,
                              n_kv_heads=4, d_ff=512, vocab_size=512)
    assert cfg.head_dim == 64
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 512, (2, 200))).to(cuda)
    ops.reset_launch_counts()
    loss, _, grads = value_and_grad(Model(cfg, runtime=RuntimeConfig(remat="full")), params,
                                    {"tokens": tokens, "labels": tokens})
    assert torch.isfinite(loss)
    assert ops.bwd_routes() == {"wgmma": cfg.n_layers, "cuda_cores": 0}
    assert ops.bwd_kernels() == dict.fromkeys(fa.BWD_KERNELS, cfg.n_layers)


# ---------------------------------------------------------------------------
# ssd_chunk_bwd: against ssd_chunk_bwd_ref at the shapes chip_smoke.py's
# phase 2 takes (smaller batches), bit for bit on a rerun; the Mamba-2 and
# Jamba training steps on the card against the CPU; the in-place loop; the
# launcher.
# ---------------------------------------------------------------------------

SSD_BWD_CASES = [
    # (nb, lc, nh, hp, g, n, bc dtype, with dcum, decay per step up to)
    (4, 256, 80, 64, 1, 128, torch.bfloat16, True, 1.6),  # mamba2-2.7b, strong decays
    (2, 256, 256, 64, 1, 128, torch.bfloat16, True, 1.6),  # Jamba's 256 heads
    (3, 100, 8, 64, 1, 128, torch.bfloat16, False, 0.5),  # ragged chunk
    (2, 256, 8, 64, 2, 128, torch.bfloat16, True, 0.5),  # two groups
    (2, 256, 8, 64, 1, 128, torch.float32, True, 0.5),  # float32 B/C
    (2, 40, 4, 16, 4, 16, torch.float32, False, 0.5),  # reduced widths, a group per head
]


def ssd_bwd_inputs(rng, nb, lc, nh, hp, g, n, bc_dtype, with_dcum, decay, device):
    x = _randn(rng, (nb, lc, nh, hp), torch.float32, device) * 0.05
    a = -torch.from_numpy(rng.random((nb, lc, nh), dtype=np.float32)).to(device) * decay
    b, c = (_randn(rng, (nb, lc, g, n), torch.float32, device).mul(0.5).to(bc_dtype)
            for _ in range(2))
    dy = _randn(rng, (nb, lc, nh, hp), torch.float32, device)
    dst = _randn(rng, (nb, nh, n, hp), torch.float32, device)
    dcum = _randn(rng, (nb, lc, nh), torch.float32, device) if with_dcum else None
    return x, a, b, c, dy, dst, dcum


@pytest.mark.parametrize("case", SSD_BWD_CASES)
def test_ssd_bwd_matches_plain_and_repeats(cuda, case):
    rng = np.random.default_rng(14)
    x, a, b, c, dy, dst, dcum = ssd_bwd_inputs(rng, *case, cuda)
    got = ssd.ssd_chunk_bwd(x, a, b, c, dy, dst, dcum)
    want = ref.ssd_chunk_bwd_ref(x, a, b, c, dy, dst, dcum)
    assert got[2].dtype == got[3].dtype == b.dtype and got[2].shape == want[2].shape
    for name, gv, wv in zip(("dx", "da"), got, want):
        assert torch.isfinite(gv).all() and _rel(gv, wv) <= SSD_BWD_TOL, name
    for name, gv, wv in zip(("dB", "dC"), got[2:], want[2:]):
        assert torch.isfinite(gv).all() and rounding_steps(gv, wv) <= 1.0, name
    again = ssd.ssd_chunk_bwd(x, a, b, c, dy, dst, dcum)
    assert all(torch.equal(p, q) for p, q in zip(got, again))


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-1.5-large-398b"])
def test_reduced_ssm_train_step_card_matches_cpu(cuda, arch):
    """float32 at chunk 256 over 256 tokens: one SSD call a layer on the
    card (forward twice under remat "full", backward once), against the
    plain path on the CPU."""
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.configs.registry import reduced_config
    from repro_torch.models.model import Model, init_params
    from repro_torch.models.transformer import layer_kinds, n_periods
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state, tree_leaves
    from repro_torch.training.train_loop import make_train_step, value_and_grad

    base = reduced_config(arch)
    cfg = dataclasses.replace(base, dtype="float32",
                              ssm=dataclasses.replace(base.ssm, chunk_size=256))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = _tree_to(params, cuda)
    model = Model(cfg, runtime=RuntimeConfig(remat="full"))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 256)))
    batch = {"tokens": tokens, "labels": tokens}
    card = {k: v.to(cuda) for k, v in batch.items()}
    loss_c, _, g_c = value_and_grad(model, params, batch)
    ops.reset_launch_counts()
    loss_g, _, g_g = value_and_grad(model, on_card, card)
    n_ssm = sum(kind.mixer != "attn" for kind in layer_kinds(cfg)) * n_periods(cfg)
    counts = ops.launch_counts()
    assert (counts["ssd_chunk"], counts["ssd_chunk_bwd"]) == (2 * n_ssm, n_ssm)
    assert abs(float(loss_g) - float(loss_c)) <= 1e-4
    for a, b in zip(tree_leaves(g_g), tree_leaves(g_c)):
        assert torch.isfinite(a).all() and _rel(a.cpu(), b) <= 1e-4
    opt = OptimizerConfig()
    _, _, m_c = make_train_step(model, opt)(params, init_opt_state(opt, params), batch)
    _, _, m_g = make_train_step(model, opt)(on_card, init_opt_state(opt, on_card), card)
    assert abs(float(m_g["grad_norm"]) / float(m_c["grad_norm"]) - 1) <= 1e-4


def test_ssm_train_loop_in_place_equals_the_pure_step(cuda):
    """run_train_loop (in place) against make_train_step's pure steps on a
    reduced mamba2-2.7b in bf16 on the card: weights and moments bit for bit
    after three steps."""
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.configs.registry import reduced_config
    from repro_torch.models.model import Model, init_params
    from repro_torch.training.optimizer import (OptimizerConfig, init_opt_state, tree_leaves,
                                                tree_map)
    from repro_torch.training.train_loop import TrainLoopConfig, make_train_step, run_train_loop

    cfg = reduced_config("mamba2-2.7b")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    model = Model(cfg, runtime=RuntimeConfig(remat="full"))
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(3):
        t = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 96))).to(cuda)
        batches.append({"tokens": t, "labels": t})
    opt = OptimizerConfig()
    ops.reset_launch_counts()
    loop_p, loop_s, _ = run_train_loop(model, opt, TrainLoopConfig(steps=3), iter(batches),
                                       params=tree_map(torch.clone, params))
    assert ops.launch_counts()["ssd_chunk_bwd"] == 3 * cfg.n_layers
    p, s, step = params, init_opt_state(opt, params), make_train_step(model, opt)
    for b_ in batches:
        p, s, _ = step(p, s, b_)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(loop_p), tree_leaves(p)))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(loop_s), tree_leaves(s)))


def test_train_launcher_trains_mamba2_on_the_card(cuda):
    from repro_torch.launch import train

    ops.reset_launch_counts()
    history = train.main(["--arch", "mamba2-2.7b", "--smoke", "--steps", "6", "--batch", "2",
                          "--seq-len", "64"])
    assert [h["step"] for h in history] == [1, 5]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in history)
    assert ops.launch_counts()["ssd_chunk_bwd"] == 6 * 4  # 4 layers a step


def test_reduced_resume_on_the_card_is_bit_for_bit(cuda, tmp_path):
    """Reduced olmo-1b in bf16 on the card: 3 steps of run_train_loop saving
    a checkpoint, a restore into fresh tensors on the card, then an async
    save of the restored state (its pinned snapshot) while 3 more steps
    change the same tensors in place: weights, moments, step and metrics
    equal an unbroken 6 under torch.equal, and the async files equal the
    unbroken run's step-3 files."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.configs.registry import reduced_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import Model, init_params
    from repro_torch.training.optimizer import (OptimizerConfig, init_opt_state, tree_leaves,
                                                tree_map)
    from repro_torch.training.train_loop import TrainLoopConfig, run_train_loop

    cfg = reduced_config("olmo-1b")
    model = Model(cfg, runtime=RuntimeConfig(remat="full"))
    opt = OptimizerConfig(warmup_steps=2, total_steps=6)
    data_cfg = DataConfig(seq_len=64, global_batch=2, vocab_size=cfg.vocab_size)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)

    def loop(steps, ckdir=None):
        return TrainLoopConfig(steps=steps, log_every=1, checkpoint_every=3,
                               checkpoint_dir=ckdir and str(tmp_path / ckdir))

    p6, s6, h6 = run_train_loop(model, opt, loop(6, "unbroken"), SyntheticLM(data_cfg),
                                params=tree_map(torch.clone, params))
    _, _, h3 = run_train_loop(model, opt, loop(3, "killed"), SyntheticLM(data_cfg),
                              params=params)
    del params
    ck = Checkpointer(str(tmp_path / "killed"))
    fresh = init_params(cfg, torch.Generator(device=cuda).manual_seed(1), cuda)
    tree = ck.restore(3, {"params": fresh, "opt_state": init_opt_state(opt, fresh)})
    assert all(t.device.type == cuda.type for t in tree_leaves(tree))
    data = SyntheticLM(data_cfg)
    data.load_state_dict(ck.load_extra(3)["data_state"])
    ack = Checkpointer(str(tmp_path / "async"), async_save=True)
    ack.save(3, tree, extra={"data_state": data.state_dict()})
    p, s, h = run_train_loop(model, opt, loop(6), data, params=tree["params"],
                             opt_state=tree["opt_state"], start_step=3)
    ack.wait()
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p), tree_leaves(p6)))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(s), tree_leaves(s6)))
    assert h3 + h == h6
    unbroken = Checkpointer(str(tmp_path / "unbroken"))
    with np.load(f"{unbroken.step_dir(3)}/proc_0.npz") as want, \
            np.load(f"{ack.step_dir(3)}/proc_0.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        assert all(np.array_equal(got[k], want[k]) for k in want.files)


# ---------------------------------------------------------------------------
# The paged kernel's log-sum-exp output, and a world of ranks on the card
# ---------------------------------------------------------------------------

# the kernel's lse against the plain version's, absolute on values of order
# 1-10: f32 sums in other orders (the kernel in log2 units, merged over its
# warps and splits); a bf16 or e4m3 q is rounded alike on both sides
PAGED_LSE_TOL = 1e-4


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "e4m3"])
def test_paged_kernel_lse_matches_plain(cuda, case, kind):
    from repro_torch.models.attention import to_e4m3

    b, hq, hkv, d, bt, mb, nb = case
    rng = np.random.default_rng(sum(case) + 1)
    dtype = torch.float32 if kind == "float32" else torch.bfloat16
    q = _randn(rng, (b, hq, d), dtype, cuda)
    pool = _randn(rng, (nb, 2, bt, hkv, d), dtype, cuda)
    if kind == "e4m3":
        pool = to_e4m3(pool)
    table, ctx = _table_and_ctx(rng, b, mb, bt, nb)
    ctx[-1] = 0  # an empty shard: zeros and -inf
    tbl = pa.make_block_table(table, nb, cuda)
    ctx = ctx.to(cuda, torch.int32)
    before = pa.paged_attention.launches_with_lse
    out, lse = pa.paged_attention(q, pool[:, 0], pool[:, 1], tbl, ctx, return_lse=True)
    plain_out = pa.paged_attention(q, pool[:, 0], pool[:, 1], tbl, ctx)
    want, want_lse = ref.paged_attention_ref(q, pool[:, 0], pool[:, 1], tbl, ctx,
                                             return_lse=True)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches_with_lse == before + 1
    assert torch.equal(out, plain_out)  # the lse store changes nothing else
    assert bool((out[-1] == 0).all()) and bool(torch.isneginf(lse[-1]).all())
    torch.testing.assert_close(lse[:-1], want_lse[:-1], atol=PAGED_LSE_TOL, rtol=0)
    tol = PAGED_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


def _two_rank_program(rank: int, n: int) -> dict:
    """A 1x2 mesh on the card: reduced command-r-35b in float32 through the
    kernels and through the plain versions on the same shards; the paged
    kernel's lse on this rank's sequence shard against the plain one."""
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.configs.registry import reduced_config
    from repro_torch.distributed.sharding import AxisRules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model

    dev = torch.device("cuda")
    cfg = dataclasses.replace(reduced_config("command-r-35b"), dtype="float32")
    rules = AxisRules.create(make_mesh((1, 2), ("data", "model"), device=dev))
    tokens = torch.randint(0, cfg.vocab_size, (2, 30), generator=torch.Generator()
                           .manual_seed(4)).to(dev)
    out = {}
    for mode in ("kernel", "ref"):
        model = Model(cfg, runtime=RuntimeConfig(kernel_mode=mode), rules=rules)
        params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
        ops.reset_launch_counts()
        logits, cache = model.prefill_fn(params, tokens[:, :24], max_len=64)
        steps = [logits[:, 0]]
        for t in range(6):
            pos = torch.full((2,), 24 + t, device=dev)
            steps.append(model.decode_fn(params, cache, tokens[:, 24 + t], pos))
        out[mode] = {"logits": torch.stack(steps), "launches": ops.launch_counts(),
                     "with_lse": pa.paged_attention.launches_with_lse}
    return out


def test_two_ranks_on_the_card_kernels_match_plain(cuda, tmp_path):
    from repro_torch.distributed.world import run_world

    got = run_world(_two_rank_program, 2, (), timeout_s=600, workdir=str(tmp_path))
    k, p = got["kernel"], got["ref"]
    layers = reduced_config_layers("command-r-35b")
    assert k["launches"]["flash_attention"] == layers
    assert k["launches"]["paged_attention"] == k["with_lse"] == 6 * layers
    assert p["launches"]["paged_attention"] == 0
    torch.testing.assert_close(k["logits"], p["logits"], atol=1e-4, rtol=1e-4)


def reduced_config_layers(arch: str) -> int:
    from repro_torch.configs.registry import reduced_config

    return reduced_config(arch).n_layers


def _mesh_train_program(rank: int, n: int) -> dict:
    """A 1x2 mesh on the card: reduced olmo-1b in float32, the gradient of
    loss_fn (remat "full") through the kernels and through the plain
    versions on the same shards."""
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.configs.registry import reduced_config
    from repro_torch.distributed.sharding import AxisRules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model
    from repro_torch.training.train_loop import value_and_grad

    dev = torch.device("cuda")
    cfg = dataclasses.replace(reduced_config("olmo-1b"), dtype="float32")
    rules = AxisRules.create(make_mesh((1, 2), ("data", "model"), device=dev))
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator()
                           .manual_seed(4)).to(dev)
    out = {}
    for mode in ("kernel", "ref"):
        model = Model(cfg, runtime=RuntimeConfig(kernel_mode=mode, remat="full"), rules=rules)
        params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
        ops.reset_launch_counts()
        loss, _, grads = value_and_grad(model, params, {"tokens": tokens, "labels": tokens})
        out[mode] = {"loss": float(loss), "grads": grads, "launches": ops.launch_counts()}
    return out


def test_two_ranks_train_on_the_card_kernels_match_plain(cuda, tmp_path):
    from repro_torch.distributed.world import run_world
    from repro_torch.training.optimizer import tree_leaves

    got = run_world(_mesh_train_program, 2, (), timeout_s=600, workdir=str(tmp_path))
    k, p = got["kernel"], got["ref"]
    layers = reduced_config_layers("olmo-1b")
    assert k["launches"]["flash_attention"] == 2 * layers  # and the recompute
    assert k["launches"]["flash_attention_bwd"] == layers
    assert p["launches"]["flash_attention"] == p["launches"]["flash_attention_bwd"] == 0
    assert abs(k["loss"] - p["loss"]) <= 1e-5
    for a, b in zip(tree_leaves(k["grads"]), tree_leaves(p["grads"])):
        assert float((a - b).abs().max() / b.abs().max().clamp(min=1e-30)) <= 1e-4


def _collectives_program(rank: int, n: int) -> dict:
    from repro_torch.experiments.mesh_train_probe import check_collectives
    from repro_torch.launch.mesh import make_mesh

    return {shape: check_collectives(make_mesh(shape, ("data", "model"),
                                               device=torch.device("cuda")))
            for shape in ((1, 4), (2, 2))}


def test_collective_backwards_on_the_card_equal_cpu(cuda, tmp_path):
    from repro_torch.distributed.world import run_world

    got = run_world(_collectives_program, 4, (), timeout_s=600, workdir=str(tmp_path))
    assert got == {(1, 4): [], (2, 2): []}
