"""The paged kernel's launch plan and workspace, in plain Python on the CPU.

``csrc/paged_attention.cu`` computes each CTA's blocks on the card with the
formula of ``paged_attention.split_ranges``; the wrapper picks the splits,
one thread-block cluster per (row, kv head), with ``plan_splits``. The
kernel itself runs only on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""

from __future__ import annotations

import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.kernels import paged_attention as pa

H100_SMS = 132
LLAMA = dict(b=1, hkv=8, max_blocks=2048 // 16)  # Llama-3.1-8B decode, max_len 2048
LLAMA_CTX, BT = 1040, 16


@settings(max_examples=300, deadline=None)
@given(ctx=st.integers(0, 5000), bt=st.sampled_from([1, 8, 16, 32, 48]),
       splits=st.integers(1, 200))
def test_split_ranges_cover_the_context_once_and_evenly(ctx, bt, splits):
    ranges = pa.split_ranges(ctx, bt, splits)
    nb = -(-ctx // bt)
    assert len(ranges) == min(splits, nb)
    flat = [blk for lo, hi in ranges for blk in range(lo, hi)]
    assert flat == list(range(nb))  # every block once, in order
    sizes = [hi - lo for lo, hi in ranges]
    assert all(n >= 1 for n in sizes)  # no active split is empty
    assert not sizes or max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("per_sm", [1, 2, 3])
def test_every_cta_of_llama_decode_has_work(per_sm):
    """At Llama's decode shape, ctx 1040 (65 blocks of 16), every CTA of the
    grid gets blocks, whatever the resident CTAs per SM up to 3."""
    splits = pa.plan_splits(H100_SMS, per_sm, **LLAMA)
    assert splits == min(pa.MAX_SPLITS, H100_SMS * per_sm // 8) == 16
    ranges = pa.split_ranges(LLAMA_CTX, BT, splits)
    assert len(ranges) == splits  # no CTA exits without work
    assert {hi - lo for lo, hi in ranges} <= {65 // splits, 65 // splits + 1}


def test_one_cta_per_sm_gives_sixteen_splits_of_four_or_five_blocks():
    splits = pa.plan_splits(H100_SMS, 1, **LLAMA)
    sizes = [hi - lo for lo, hi in pa.split_ranges(LLAMA_CTX, BT, splits)]
    assert splits == 16 and sorted(set(sizes)) == [4, 5] and sum(sizes) == 65


@pytest.mark.parametrize("b,hkv,max_blocks,want", [
    (1, 8, 128, 16),  # capped by a cluster's 16 CTAs
    (4, 8, 128, 12),  # one wave at 3 CTAs per SM: 396 // 32
    (1, 8, 4, 4),  # capped by the table's blocks
    (64, 8, 128, 1),  # more (row, kv head) pairs than resident CTAs: one split
    (8, 4, 128, 12),  # b * hkv is what counts
])
def test_plan_splits_fills_one_wave(b, hkv, max_blocks, want):
    assert pa.plan_splits(H100_SMS, 3, b, hkv, max_blocks) == want


def test_splits_do_not_depend_on_the_context():
    """The grid is fixed by shapes alone, so a captured call replays with any
    context written in place."""
    import inspect

    assert "ctx" not in inspect.signature(pa.plan_splits).parameters
    assert "ctx" not in inspect.signature(pa.plan).parameters


def test_plan_splits_keeps_every_cluster_resident():
    """S shrinks until all b * hkv clusters of S CTAs fit on the card at once."""
    fits = {16: 6, 15: 7, 14: 8}  # clusters resident at each size
    assert pa.plan_splits(H100_SMS, 2, 1, 8, 128, lambda s: fits.get(s, 99)) == 14
    assert pa.plan_splits(H100_SMS, 2, 1, 8, 128, lambda s: 0) == 1
    assert pa.plan_splits(H100_SMS, 2, 1, 8, 128, lambda s: 8) == 16


def test_the_call_needs_no_scratch_in_device_memory():
    """The splits merge in the cluster's shared memory: the wrapper holds no
    workspace and passes the kernel no scratch pointer."""
    argtypes, _ = pa.SIGNATURES["paged_attention_fwd"]
    pointers = [t for t in argtypes if t is pa._P]
    # q, k, v, table, context, out, the optional lse output and the stream
    assert len(pointers) == 8
    assert not hasattr(pa, "workspace")
