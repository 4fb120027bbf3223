"""The attention backward's wgmma route on the CPU: the route it picks
(``pick_route``, shared with the forward), the host-side grids, statistics
padding and TMA maps it hands its kernels, and the float64 backward the
training probe and ``chip_smoke.py`` phase 13 hold it against, with the
probe's emulated backwards: the float64 one with P and dS rounded to bf16
before their products, and the planted faults the per-layer check must
refuse.

The kernels (``csrc/flash_attention_bwd.cu``, namespace ``wgmma_route``)
run only on the card (tests/test_torch_gpu.py, chip_smoke.py phase 2).
"""

from __future__ import annotations

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.experiments import flash_probe
from repro_torch.experiments import train_bwd_probe as probe
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

torch.set_num_threads(1)

SOURCE = Path(fa.__file__).resolve().parent / "csrc" / "flash_attention_bwd.cu"
WG_ROWS = fa.BWD_BLOCK // 2  # rows (or keys) one consumer warpgroup owns


@pytest.mark.parametrize("d", [64, 80, 128])
def test_bf16_at_64_80_128_takes_the_tensor_cores(d):
    assert fa.pick_route(torch.bfloat16, d) == "wgmma"
    assert fa.pick_route(torch.bfloat16, d, "cuda_cores") == "cuda_cores"


@pytest.mark.parametrize("dtype,d", [
    (torch.float32, 128), (torch.float32, 80), (torch.float32, 64), (torch.float32, 16),
    (torch.bfloat16, 16), (torch.bfloat16, 32), (torch.bfloat16, 48), (torch.bfloat16, 96),
    (torch.bfloat16, 112),
])
def test_float32_and_other_widths_take_the_cuda_cores(dtype, d):
    assert fa.pick_route(dtype, d) == "cuda_cores"
    with pytest.raises(ValueError, match="wgmma route takes bf16"):
        fa.pick_route(dtype, d, "wgmma")


@pytest.mark.parametrize("name", ["tensor_cores", "WGMMA", "", "plain"])
def test_force_route_rejects_a_bad_name(name):
    with pytest.raises(ValueError, match="not in"):
        fa.pick_route(torch.bfloat16, 128, name)


def test_python_plan_follows_the_kernel_constants():
    src = SOURCE.read_text()
    consts = {name: int(val) for name, val in
              re.findall(r"constexpr int (k\w+) = (\d+);", src.split("namespace wgmma_route {")[1])}
    assert consts["kM"] == WG_ROWS and consts["kStream"] == 64
    assert consts["kBoxRows"] == fa.BWD_BOX_ROWS and consts["kThreads"] == 256
    assert "constexpr int kBlk = 2 * kM;" in src and "constexpr int kStatPad = kBlk;" in src


@pytest.mark.parametrize("shape", [(4, 2048, 16, 128), (1, 1024, 64, 80), (2, 37, 8, 64)])
def test_bwd_tensor_maps_have_boxes_of_64_rows(shape):
    dims, strides, box = fa.bwd_tensor_map_args(shape)
    b, s, h, d = shape
    assert dims == (d, h, s, b)
    assert strides == (2 * d, 2 * h * d, 2 * s * h * d)
    assert box == (16 if d == 80 else 64, 1, fa.BWD_BOX_ROWS, 1)
    assert d % box[0] == 0 and box[0] * 2 <= 128  # a box row within the swizzle span


@pytest.mark.parametrize("sq,want", [(1, 128), (37, 128), (128, 128), (129, 256), (2048, 2048)])
def test_stat_rows_pad_to_whole_blocks(sq, want):
    assert fa.bwd_stat_rows(sq) == want


def test_grids_at_the_training_shapes():
    assert fa.bwd_grids(4, 2048, 2048, 16, 16) == {"dkdv": (64, 16), "dq": (64, 16)}
    assert fa.bwd_grids(1, 1024, 1024, 64, 8) == {"dkdv": (8, 8), "dq": (64, 8)}
    assert fa.bwd_grids(1, 37, 80, 8, 2) == {"dkdv": (2, 1), "dq": (8, 1)}


# (b, sq, skv, hq, hkv, d, causal)
F64_CASES = [
    (1, 24, 24, 2, 2, 16, True), (2, 20, 20, 4, 2, 64, True), (1, 17, 33, 8, 2, 80, True),
    (1, 33, 17, 4, 1, 16, True), (2, 16, 24, 4, 1, 64, False),
]


def _inputs(case, seed):
    b, sq, skv, hq, hkv, d, _ = case
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
            for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d), (b, sq, hq, d))]


@pytest.mark.parametrize("case", F64_CASES)
def test_f64_backward_matches_the_plain_version(case):
    """The float64 backward against ``flash_attention_bwd_ref`` in f32 on the
    same inputs, relative to the largest |gradient|: f32 sums in another
    order, readings under 1e-6."""
    q, k, v, do = _inputs(case, seed=11)
    causal = case[-1]
    o, lse = ref.flash_attention_lse_ref(q, k, v, causal)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    got = probe.flash_attention_bwd_f64(q, k, v, o, lse, do, causal)
    by_row = probe.f64_by_row(q, k, v, o, lse, do, causal)
    for g, r, w in zip(got, by_row, want):
        assert g.dtype == torch.float64 and g.shape == w.shape
        assert torch.equal(g, r)
        assert (g - w.double()).abs().max().item() <= 1e-5 * w.abs().max().item()
    rounded = probe.f64_rounded(q.bfloat16(), k.bfloat16(), v.bfloat16(), o.bfloat16(),
                                lse, do.bfloat16(), causal)
    assert all(t.dtype == torch.bfloat16 for t in rounded)


@pytest.mark.parametrize("case", F64_CASES[:3])
def test_layer_stats_put_the_plain_version_at_the_rounding_floor(case):
    """``layer_stats``: the f32 plain version's RMS error against float64 is
    far under bf16 rounding's, and rounding the float64 result to bf16 gives
    an RMS relative error near 2^-9 / sqrt(3) with a bias near 0."""
    q, k, v, do = _inputs(case, seed=12)
    causal = case[-1]
    o, lse = ref.flash_attention_lse_ref(q, k, v, causal)
    stats = probe.layer_stats({0: (q, k, v, o, lse, do, causal)},
                              {"plain": ref.flash_attention_bwd_ref, "f64_rounded": None})
    for g in probe.GRADS:
        rms, bias = stats[0, "plain", g]
        assert rms <= 1e-6 and abs(bias) <= 1e-6
    q, k, v, do, o = (t.bfloat16() for t in (q, k, v, do, o))
    stats = probe.layer_stats({0: (q, k, v, o, lse, do, causal)}, {"f64_rounded": None})
    for g in probe.GRADS:
        rms, bias = stats[0, "f64_rounded", g]
        assert 0.5 * 2**-9 / math.sqrt(3) <= rms <= 2 * 2**-9 / math.sqrt(3)
        assert abs(bias) <= 1e-3


def _bf16_layer(case, seed):
    """One layer's backward inputs in bf16 (lse in f32), as the probe
    captures them."""
    q, k, v, do = _inputs(case, seed)
    causal = case[-1]
    o, lse = ref.flash_attention_lse_ref(q, k, v, causal)
    q, k, v, o, do = (t.bfloat16() for t in (q, k, v, o, do))
    return {0: (q, k, v, o, lse, do, causal)}


def _ratios(stats, name):
    return {g: stats[0, name, g][0] / stats[0, "f64_rounded", g][0] for g in probe.GRADS}


# (b, sq, skv, hq, hkv, d, causal), a few tiles long
EMULATED_CASES = [(1, 192, 192, 4, 2, 64, True), (2, 160, 160, 4, 1, 80, True),
                  (1, 128, 256, 2, 2, 128, False)]


@pytest.mark.parametrize("case", EMULATED_CASES)
def test_rounding_p_and_ds_to_bf16_reads_above_the_floor_and_under_twice_it(case):
    """The wgmma route's rounding, emulated: P and dS in bf16 before their
    products add about as much error as rounding the outputs, so the RMS
    error lands between the floor and twice it, unbiased."""
    stats = probe.layer_stats(_bf16_layer(case, seed=21),
                              {"pds": probe.emulated("pds_bf16"), "f64_rounded": None})
    for g, ratio in _ratios(stats, "pds").items():
        assert 1.05 < ratio < 2.0, (g, ratio)
        assert abs(stats[0, "pds", g][1]) <= 1e-3


@pytest.mark.parametrize("change", ["drop_tile", "mask_shift"])
def test_planted_faults_read_many_times_the_floor(change):
    stats = probe.layer_stats(_bf16_layer(EMULATED_CASES[0], seed=22),
                              {change: probe.emulated(change), "f64_rounded": None})
    assert min(_ratios(stats, change).values()) > 10


def test_summing_in_bf16_over_one_tile_is_the_rounded_result():
    """acc_bf16 rounds its running sums after each tile of 64: over one
    tile that is the float64 result rounded once."""
    layer = _bf16_layer((1, 64, 64, 2, 1, 16, True), seed=23)[0]
    want = probe.f64_rounded(*layer)
    for g, w in zip(probe.emulated("acc_bf16")(*layer), want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", sorted(flash_probe.VARIANTS))
def test_flash_probe_edits_apply_to_the_current_source(name):
    edits, _ = flash_probe.VARIANTS[name]
    patched = build.patched_source("flash_attention", edits)
    assert all(new in patched for _, new, _ in edits)


def test_the_hopper_helpers_live_in_one_header():
    """flash_attention.cu and flash_attention_bwd.cu include
    hopper_common.cuh and define none of its functions themselves."""
    header = (build.CSRC / "hopper_common.cuh").read_text()
    names = set(re.findall(r"^(?:__device__ __forceinline__ |inline )[\w:<>]+ (\w+)\(",
                           header, re.M))
    assert {"mbar_wait", "tma_load", "smem_desc", "wgmma_fence", "encoder", "encode"} <= names
    for source in ("flash_attention", "flash_attention_bwd"):
        src = (build.CSRC / f"{source}.cu").read_text()
        assert '#include "hopper_common.cuh"' in src
        for name in names:
            assert not re.search(rf"^\S.* {name}\(.*\{{$", src, re.M), (source, name)


def test_the_build_hash_covers_included_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "common.cuh").write_text("// one\n")
    src = '#include <cstdint>\n#include "common.cuh"\nint f();\n'
    before = build.digest(src)
    assert build.digest(src.replace('#include "common.cuh"\n', "")) != before
    (tmp_path / "common.cuh").write_text("// two\n")
    assert build.digest(src) != before
