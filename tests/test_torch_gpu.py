"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: every test takes the ``cuda`` fixture, which skips when no
card is present (decided at run time, never at import). On a GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: data movement bit-exact; flash attention f32 2e-5, bf16 2e-2
(those of tests/test_kernels.py:42).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import kv_transfer as kv
from repro_torch.kernels import ops, ref

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
    out = fa.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])


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
    assert ops.launch_counts() == {
        "kv_gather_write": 1, "kv_scatter_read": 1, "flash_attention": 1,
    }


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


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}
