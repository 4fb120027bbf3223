"""flash_attention's wrapper on the CPU: the route it picks, the q-tile order
of the wgmma route and the TMA tensor-map arguments it hands the kernel.

The kernels themselves run only on the card (tests/test_torch_gpu.py,
chip_smoke.py); what surrounds them is plain Python and is tested here.
"""

from __future__ import annotations

import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

torch.set_num_threads(1)


@pytest.mark.parametrize("d", [64, 128])
def test_bf16_at_64_and_128_takes_the_tensor_cores(d):
    assert fa.route(torch.bfloat16, d) == "wgmma"


@pytest.mark.parametrize("dtype,d", [
    (torch.float32, 128), (torch.float32, 64), (torch.float32, 16),
    (torch.bfloat16, 16), (torch.bfloat16, 32), (torch.bfloat16, 48),
    (torch.float32, 80), (torch.bfloat16, 96), (torch.bfloat16, 112),
])
def test_float32_and_other_widths_take_the_cuda_cores(dtype, d):
    assert fa.route(dtype, d) == "cuda_cores"


@pytest.mark.parametrize("dtype,d,match", [
    (torch.float16, 128, "float32 or bfloat16"),
    (torch.bfloat16, 24, "head_dim"),
    (torch.bfloat16, 144, "head_dim"),
    (torch.float32, 0, "head_dim"),
])
def test_route_refuses_what_no_kernel_takes(dtype, d, match):
    with pytest.raises(ValueError, match=match):
        fa.route(dtype, d)


@pytest.mark.parametrize("arch,want", [
    ("llama3.1-8b", "wgmma"),  # head_dim 128: the main path
    ("qwen1.5-0.5b", "wgmma"),  # head_dim 64
    ("qwen3-32b", "wgmma"),  # head_dim 80: five 32-byte TMA boxes a tile
])
def test_full_width_configs_route_by_their_head_dim(arch, want):
    assert fa.route(torch.bfloat16, get_config(arch).head_dim) == want


@pytest.mark.parametrize("n_q_tiles,rows", [(8, 32), (16, 8), (1, 4), (3, 2 * 16), (5, 1)])
def test_q_tile_order_is_a_permutation_longest_first(n_q_tiles, rows):
    """At the main path's (8, 32) the 132 SMs start all 32 heads' longest
    causal tiles first, and the one-tile q blocks fill the second wave's tail."""
    order = fa.q_tile_order(n_q_tiles, rows)
    assert sorted(order) == sorted(list(range(n_q_tiles)) * rows)
    assert order == sorted(order, reverse=True)  # never a longer tile after a shorter one
    assert order[:rows] == [n_q_tiles - 1] * rows  # every head's longest tile starts first


@pytest.mark.parametrize("shape", [
    (1, 1024, 32, 128),  # Llama-3.1-8B q
    (1, 1024, 8, 128),  # its k and v
    (2, 200, 16, 64),  # qwen1.5-0.5b-like width, ragged
    (1, 37, 1, 128),
    (3, 80, 2, 64),
])
def test_tensor_map_args_walk_the_layout_as_it_lies(shape):
    b, s, h, d = shape
    dims, strides, box = fa.tensor_map_args(shape)
    assert dims == (d, h, s, b)
    t = torch.empty(shape, dtype=torch.bfloat16)
    # byte strides of h, s and b are the tensor's own: no transposed copy
    assert strides == tuple(st * t.element_size() for st in reversed(t.stride()[:3]))
    assert all(st % 16 == 0 for st in strides)  # TMA's rule for global strides
    assert strides[1] == h * d * 2  # row stride: 8,192 B for Llama's q, 2,048 for k, v
    assert box == (64, 1, fa.BLOCK_Q, 1)
    assert box[0] * 2 == 128  # a box row fills the 128-byte swizzle exactly
    assert d % box[0] == 0 and d // box[0] in (1, 2)  # d = 128 is two boxes per tile


def test_llama_prefill_row_strides():
    cfg = get_config("llama3.1-8b")
    _, q_strides, _ = fa.tensor_map_args((1, 1024, cfg.n_heads, cfg.head_dim))
    _, kv_strides, _ = fa.tensor_map_args((1, 1024, cfg.n_kv_heads, cfg.head_dim))
    assert q_strides[1] == 8192 and kv_strides[1] == 2048


def test_wrapper_takes_only_tensors_on_the_card_and_counts_nothing_here():
    fa.reset_launch_counts()
    x = torch.zeros((1, 40, 2, 64), dtype=torch.bfloat16)
    for force in (None, "wgmma", "cuda_cores"):
        with pytest.raises(ValueError, match="on the card"):
            fa.flash_attention(x, x, x, force_route=force)
    out = ops.flash_attention(x, x, x)  # CPU tensor: the plain version
    assert out.shape == x.shape
    assert fa.flash_attention.launches == 0
    assert ops.flash_routes() == {"wgmma": 0, "cuda_cores": 0}
