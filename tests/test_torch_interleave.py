"""The non-interleaved pool (the paper's §5.3 bottleneck, the ablation of its
O9) and the transfer's read into a destination, against the JAX package:

* ``KVBlockPool(interleave=False)`` fills shard 0 first (the twin of
  ``tests/test_core.py:42-46``) and hands out JAX's ``BelugaPool`` ids,
  occupancy and epochs on a seeded churn; a ``TieredPool`` gives the flag
  to every tier;
* ``Cluster(interleave=False)``: flat, tiered, and over the shared data
  plane with one engine worker process, each ``run()`` dict equal to JAX's
  key by key (integers exactly, times within 1e-12 relative), its
  ``shard_occupancy_max`` other than the interleaved run's;
* ``PoolTransfer.scatter_read(out=)`` returns ``out`` itself, bit for bit
  the fresh read, on a flat pool and across a tier chain, and zeroes
  ``out`` on a payload-free pool as the reference does.

Every cluster number is MODELED by the simulator; nothing runs on a device.
"""

from __future__ import annotations

import signal

import numpy as np
import pytest
import torch

from repro.core.pool import BelugaPool, PoolLayout
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import Cluster as JCluster
from repro.serving.scheduler import ClusterConfig as JClusterConfig
from repro.tiering import TieredPool as JTieredPool
from repro.tiering import TieringConfig as JTieringConfig
from repro_torch.core.pool import KVBlockLayout, KVBlockPool, PoolExhausted
from repro_torch.core.transfer import PoolTransfer, StaleBlockError
from repro_torch.experiments.cluster_common import mismatches
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import Cluster, ClusterConfig
from repro_torch.tiering import TieredPool, TieringConfig

torch.set_num_threads(1)

LAYOUT = KVBlockLayout(block_tokens=8, n_layers_kv=2, n_kv_heads=2, head_dim=8)
JLAYOUT = PoolLayout(block_tokens=8, n_layers_kv=2, n_kv_heads=2, head_dim=8)
LIMIT_S = 120  # the worker test's own limit


@pytest.fixture
def time_limit():
    """Fail a test that runs past ``LIMIT_S`` by raising in it."""
    def expired(signum, frame):
        raise TimeoutError(f"ran past its {LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.setitimer(signal.ITIMER_REAL, LIMIT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------


def test_no_interleave_fills_first_shard():
    p = KVBlockPool(LAYOUT, 64, "meta", n_shards=8, interleave=False)
    assert p.interleave is False
    assert p.allocate(8) == list(range(8))
    occ = p.shard_occupancy()
    assert occ[0] == 8 and sum(occ[1:]) == 0, occ
    q = KVBlockPool(LAYOUT, 64, "meta", n_shards=8)
    q.allocate(8)
    assert q.shard_occupancy() == [1] * 8  # O9: balanced across shards


@pytest.mark.parametrize("seed_val", [0, 1])
def test_no_interleave_churn_equals_jax(seed_val):
    rng = np.random.default_rng(seed_val)
    p = KVBlockPool(LAYOUT, 256, "meta", n_shards=8, interleave=False)
    j = BelugaPool(JLAYOUT, 256, 8, backing="meta", interleave=False)
    live = []
    for _ in range(300):
        if live and (rng.random() < 0.45 or p.free_blocks() < 24):
            i = int(rng.integers(len(live)))
            ids = live.pop(i)
            p.release(ids)
            j.release(ids)
        else:
            n = int(rng.integers(1, 24))
            got = p.allocate(n)
            assert got == j.allocate(n)
            live.append(got)
        assert p.shard_occupancy() == j.shard_occupancy()
        assert p.free_blocks() == j.free_blocks()
    assert p.epochs.tolist() == j.epochs.tolist()
    with pytest.raises(PoolExhausted):
        p.allocate(p.free_blocks() + 1)


def test_tiered_pool_passes_the_flag_to_every_tier():
    cfg = TieringConfig(enabled=True, extra_tiers=((64, "ssd"),))
    p = TieredPool(LAYOUT, 64, 64, "meta", n_shards=8, interleave=False, cfg=cfg)
    j = JTieredPool(JLAYOUT, 64, 64, n_shards=8, backing="meta", interleave=False,
                    cfg=JTieringConfig(enabled=True, extra_tiers=((64, "ssd"),)))
    assert p.interleave is False and [t.interleave for t in p.tiers] == [False] * 3
    got = p.allocate(8)
    assert got == j.allocate(8) == list(range(8))
    assert p.shard_occupancy() == j.shard_occupancy()
    assert TieredPool(LAYOUT, 64, 64, "meta", n_shards=8).interleave is True


# ---------------------------------------------------------------------------
# the cluster
# ---------------------------------------------------------------------------


def _work(n: int = 16, seed: int = 3):
    """Odd requests share a 64-token prefix, even ones do not."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 1000, 64).tolist()
    out = []
    for i in range(n):
        toks = (base + rng.integers(0, 1000, 24).tolist() if i % 2
                else rng.integers(0, 1000, 80).tolist())
        out.append((f"r{i}", [int(t) for t in toks], 8, i * 0.03))
    return out


def _serve(side: str, *, tiered: bool = False, **kw) -> dict:
    common = dict(n_engines=2, policy="round_robin", pool_blocks=512, pool_shards=4,
                  hbm_slots_per_engine=64, block_tokens=8)
    common.update(kw)
    if side == "port":
        if tiered:
            common["tiering"] = TieringConfig(enabled=True, spill_blocks=256)
        c = Cluster(ClusterConfig(**common), LAYOUT,
                    device="cpu" if kw.get("data_plane") == "shared" else "meta")
        R = Request
    else:
        if tiered:
            common["tiering"] = JTieringConfig(enabled=True, spill_blocks=256)
        c = JCluster(JClusterConfig(**common), JLAYOUT,
                     backing="numpy" if kw.get("data_plane") == "shared" else "meta")
        R = JRequest
    with c:  # each prompt twice, the repeats two seconds on
        for rid, toks, nout, arr in _work():
            c.dispatch(R(rid, toks, nout, arrival=arr))
        for rid, toks, nout, arr in _work():
            c.dispatch(R("h" + rid, toks, nout, arrival=2.0 + arr))
        return c.run()


@pytest.mark.parametrize("tiered", [False, True], ids=["flat", "tiered"])
def test_cluster_without_interleave_equals_jax(tiered):
    got = _serve("port", tiered=tiered, interleave=False)
    want = _serve("jax", tiered=tiered, interleave=False)
    assert set(got) == set(want)
    assert mismatches(got, want) == []
    assert got["n_done"] == 32 and got["hit_tokens"] > 0
    interleaved = _serve("port", tiered=tiered)
    assert got["shard_occupancy_max"] != interleaved["shard_occupancy_max"]
    assert got["shard_occupancy_max"] > interleaved["shard_occupancy_max"]


def test_one_worker_shared_plane_without_interleave_equals_jax(time_limit):
    """Only the owner's pool places blocks (the allocator ring serves the
    worker), so the flag reaches the worker's run through it."""
    kw = dict(n_engines=1, index_rpc=True, index_transport="process", index_shards=2,
              data_plane="shared", interleave=False)
    got = _serve("port", engine_processes=1, **kw)
    want = _serve("jax", engine_processes=1, **kw)
    assert set(got) == set(want)
    assert mismatches(got, want) == []
    assert got["n_done"] == 32 and got["hit_tokens"] > 0
    in_process = _serve("port", **kw)
    assert mismatches(got, in_process) == []
    interleaved = _serve("port", **{**kw, "interleave": True})
    assert got["shard_occupancy_max"] > interleaved["shard_occupancy_max"]


# ---------------------------------------------------------------------------
# scatter_read(out=)
# ---------------------------------------------------------------------------


def _written(pool, n: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    kv = torch.randn((n, *LAYOUT.block_shape), generator=g).to(torch.bfloat16)
    xfer = PoolTransfer(pool)
    ids = pool.allocate(n)
    return xfer, ids, xfer.gather_write(ids, kv), kv


def test_scatter_read_into_out_returns_out_bit_equal():
    pool = KVBlockPool(LAYOUT, 64, "cpu", n_shards=8)
    xfer, ids, eps, kv = _written(pool, 6, 0)
    order = ids[::-1]
    fresh = xfer.scatter_read(order, eps[::-1])
    dst = torch.full((6, *LAYOUT.block_shape), float("nan"), dtype=torch.bfloat16)
    ptr = dst.data_ptr()
    got = xfer.scatter_read(order, eps[::-1], out=dst)
    assert got is dst and dst.data_ptr() == ptr
    assert torch.equal(dst.view(torch.uint8), fresh.view(torch.uint8))
    assert torch.equal(dst, kv.flip(0))
    assert xfer.stats.reads == 12 and xfer.stats.bytes_read == 12 * LAYOUT.block_bytes
    pool.release(ids[:1])
    with pytest.raises(StaleBlockError):
        xfer.scatter_read(ids[:2], eps[:2], out=dst[:2])
    with pytest.raises(ValueError):
        xfer.scatter_read(ids[1:3], eps[1:3], out=dst[:3])
    with pytest.raises(ValueError):
        xfer.scatter_read(ids[1:3], eps[1:3], out=dst[:2].float())


def test_scatter_read_into_out_across_tiers():
    pool = TieredPool(LAYOUT, 8, 16, "cpu", n_shards=4)
    xfer, ids, eps, kv = _written(pool, 14, 1)  # 8 in the fast tier, 6 below it
    assert min(ids) < 8 <= max(ids)
    fresh = xfer.scatter_read(ids, eps)
    dst = torch.zeros((14, *LAYOUT.block_shape), dtype=torch.bfloat16)
    assert xfer.scatter_read(ids, eps, out=dst) is dst
    assert torch.equal(dst.view(torch.uint8), fresh.view(torch.uint8))
    assert torch.equal(dst, kv)
    below = [b for b in ids if b >= 8]
    part = dst[: len(below)]
    assert xfer.scatter_read(below, [eps[ids.index(b)] for b in below], out=part) is part
    assert torch.equal(part, kv[[ids.index(b) for b in below]])


def test_scatter_read_into_out_on_a_payload_free_pool_zeroes_it():
    pool = KVBlockPool(LAYOUT, 64, "meta", n_shards=8)
    xfer = PoolTransfer(pool)
    ids = pool.allocate(2)
    eps = xfer.gather_write(ids, None)
    dst = torch.ones((2, *LAYOUT.block_shape), dtype=torch.bfloat16)
    assert xfer.scatter_read(ids, eps, out=dst) is dst and not dst.any()
    pool.release(ids[:1])
    with pytest.raises(StaleBlockError):
        xfer.scatter_read(ids, eps, out=dst)
