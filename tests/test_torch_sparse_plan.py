"""The sparse gather's launch plan and its limits, in plain Python on the CPU.

``csrc/kv_transfer.cu`` splits the pieces over one wave of CTAs and each
CTA's units over its lanes; ``kv_transfer.sparse_plan`` mirrors the split,
and ``cta_units`` here the kernel's loops inside one CTA. The kernel itself
runs only on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

from __future__ import annotations

import re

import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.kernels import build
from repro_torch.kernels import kv_transfer as kv

H100_SMS = 132
# phase 6's reads: (pieces, units of 16 B a piece)
LLAMA, QWEN, TOPK = (8192, 16), (16384, 10), (4096, 80)


def cta_units(count: int, row_units: int) -> torch.Tensor:
    """The units one CTA of ``count`` pieces copies, as the kernel's loops
    visit them: (passes, SPARSE_LANE_UNITS, SPARSE_THREADS) offsets into the
    CTA's output (piece * row_units + column), -1 where a lane is idle. In
    a pass every lane loads its units, then stores them."""
    units, lanes = count * row_units, torch.arange(kv.SPARSE_THREADS)
    k = torch.arange(kv.SPARSE_LANE_UNITS)[:, None] * kv.SPARSE_THREADS
    step = kv.SPARSE_THREADS * kv.SPARSE_LANE_UNITS
    passes = [u0 + k + lanes for u0 in range(0, units, step)]
    if not passes:
        return torch.empty((0, kv.SPARSE_LANE_UNITS, kv.SPARSE_THREADS), dtype=torch.long)
    u = torch.stack(passes)
    return torch.where(u < units, u, -1)


def _covers_once(count: int, row_units: int) -> torch.Tensor:
    """cta_units for a CTA of ``count`` pieces; asserts every unit of its
    output is copied exactly once and returns the schedule."""
    sched = cta_units(count, row_units)
    got = sched[sched >= 0]
    assert got.numel() == count * row_units
    assert torch.equal(got.sort().values, torch.arange(count * row_units))
    return sched


@settings(max_examples=60, deadline=None)
@given(n_sel=st.integers(1, 40_000), row_units=st.integers(1, 300),
       per_sm=st.integers(1, 16))
def test_plan_covers_every_piece_and_unit_once_in_one_balanced_wave(n_sel, row_units, per_sm):
    plan = kv.sparse_plan(H100_SMS, per_sm, n_sel, row_units)
    # a CTA for every SPARSE_THREADS units, within one wave and one CTA a piece
    want = min(H100_SMS * per_sm, n_sel, -(-n_sel * row_units // kv.SPARSE_THREADS))
    assert plan.grid == want
    assert [lo for lo, _ in plan.ranges] == [0] + [hi for _, hi in plan.ranges[:-1]]
    assert plan.ranges[-1][1] == n_sel  # the ranges tile [0, n_sel) in order
    counts = {hi - lo for lo, hi in plan.ranges}
    assert min(counts) >= 1 and max(counts) - min(counts) <= 1  # no CTA idle
    for count in counts:
        per_lane = (_covers_once(count, row_units) >= 0).sum(dim=1)
        assert int(per_lane.max()) <= kv.SPARSE_LANE_UNITS
    busiest = (cta_units(max(counts), row_units) >= 0).sum(dim=1)
    assert plan.units_per_lane == int(busiest.max())
    if plan.grid < H100_SMS * per_sm:  # the read fits the wave: a unit a lane,
        assert max(counts) * row_units < kv.SPARSE_THREADS + row_units  # up to a piece


@pytest.mark.parametrize("per_sm", [8, 16])
@pytest.mark.parametrize("read", [LLAMA, QWEN, TOPK], ids=["llama", "qwen3_32b", "topk"])
def test_phase6_reads_fit_one_wave(read, per_sm):
    """Each read is one launch of at most one wave: about one unit a lane
    where the read fits the wave (Llama, and qwen3-32b at the 16 CTAs of 128
    an SM that an H100 holds, whose CTAs of 13 pieces hold 130 units), and
    every lane issues all its loads before any store (one pass) except for
    the top-k rows on half that wave."""
    n_sel, row_units = read
    plan = kv.sparse_plan(H100_SMS, per_sm, n_sel, row_units)
    assert plan.grid <= H100_SMS * per_sm
    passes = len(cta_units(max(hi - lo for lo, hi in plan.ranges), row_units))
    want = {(LLAMA, 16): (1024, 1, 1), (QWEN, 16): (1280, 2, 1), (TOPK, 16): (2112, 2, 1),
            (LLAMA, 8): (1024, 1, 1), (QWEN, 8): (1056, 2, 1), (TOPK, 8): (1056, 2, 2)}
    assert (plan.grid, plan.units_per_lane, passes) == want[read, per_sm]


def test_fewer_pieces_than_a_wave_take_one_cta_each_up_to_the_lanes():
    plan = kv.sparse_plan(H100_SMS, 16, 33, 16)
    assert plan.grid == 5 and plan.units_per_lane == 1  # 528 units over 5 CTAs of 128
    plan = kv.sparse_plan(H100_SMS, 16, 33, 1280)
    assert plan.grid == 33 and plan.ranges == tuple((i, i + 1) for i in range(33))
    assert plan.units_per_lane == kv.SPARSE_LANE_UNITS and len(cta_units(1, 1280)) == 5


def test_python_constants_match_the_kernel_source():
    src = (build.CSRC / "kv_transfer.cu").read_text()
    consts = dict(re.findall(r"constexpr int (kSparse\w+) = (\w+);", src))
    assert int(consts["kSparseThreads"]) == kv.SPARSE_THREADS
    assert int(consts["kSparseUnits"]) == kv.SPARSE_LANE_UNITS


@pytest.mark.parametrize("shape,n_sel,units", [
    ((2**27 + 1, 1, 128), 4, 2**31 + 16),  # a 4 GiB bf16 view: 16-B units past 2**31
    ((2**31, 1, 1), 4, 2**31),  # one 2-B element a row
    ((16, 2**30), 17, 17 * 2**27),  # the output's units pass it
])
def test_wrapper_raises_past_32_bit_unit_offsets(shape, n_sel, units):
    """Checked before anything touches the card (a meta tensor has no data)."""
    view = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    assert max(shape[0], n_sel) * view[0].numel() * 2 // (16 if shape[-1] % 8 == 0 else 2) \
        == units
    with pytest.raises(ValueError, match="32-bit offsets"):
        kv.sparse_kv_gather(view, torch.zeros(n_sel, dtype=torch.int32))


def test_wrapper_takes_views_up_to_the_limit_to_the_card_check():
    """2**31 - 1 units passes the offset check and stops at the device check."""
    view = torch.empty((2**31 - 1, 1, 1), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="on the card"):
        kv.sparse_kv_gather(view, torch.zeros(3, dtype=torch.int32))


def test_probe_topk_read_is_exp10s_read_at_full_width():
    """The top-k read chip_smoke and sparse_probe time: one full-width
    qwen3-32b layer's K and V stacked, the top-32 of 256 tokens of each of
    the 64 query heads, sorted, in both halves."""
    from repro_torch.configs.registry import get_config
    from repro_torch.experiments import exp10_sparse as exp10
    from repro_torch.experiments import sparse_probe

    kv_rows, ids = sparse_probe.topk_read(get_config("qwen3-32b"), torch.Generator().manual_seed(0))
    assert kv_rows.shape == (2 * exp10.SEQ, 8, 80) and kv_rows.dtype == torch.bfloat16
    assert ids.dtype == torch.int32 and ids.numel() == 2 * 64 * exp10.TOP
    k_ids = ids[: ids.numel() // 2].reshape(64, exp10.TOP)
    assert bool((k_ids.diff(dim=-1) > 0).all()) and int(k_ids.max()) < exp10.SEQ
    assert torch.equal(ids[ids.numel() // 2:], ids[: ids.numel() // 2] + exp10.SEQ)
