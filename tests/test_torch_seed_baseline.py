"""The port's frozen seed (``repro_torch/core/seed_baseline.py``) against the
JAX package's (``repro/core/seed_baseline.py``), and the port's pool held
to it:

* ``SeedAllocator`` against JAX's ``SeedPool`` on recorded allocate /
  release traces (the traces of ``tests/test_pool_allocator.py``, seeds
  1-3, interleaved and not): the same ids in the same order, free counts,
  shard occupancy, out-of-memory points and per-block epochs; and on the
  skewed free state that trips the seed's round-robin fallback;
* ``KVBlockPool`` against the port's seed on the same traces and the same
  fallback (the port's twin of ``test_pool_allocator.py:159-210``);
* the seed's str-hash chain keys byte for byte JAX's;
* ``seed_scatter_read`` byte for byte JAX's on the same seeded payloads
  (the port's 2-byte payload is bfloat16, JAX's float16: bytes are
  compared), and raising on a moved epoch as JAX's does.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import seed_baseline as jseed
from repro.core.coherence import CoherenceError
from repro.core.pool import BelugaPool, OutOfPoolMemory, PoolLayout
from repro_torch.core import seed_baseline as seed
from repro_torch.core.index import chain_keys
from repro_torch.core.pool import KVBlockLayout, KVBlockPool, PoolExhausted
from repro_torch.core.transfer import StaleBlockError

LAYOUT = KVBlockLayout(block_tokens=16, n_layers_kv=4, n_kv_heads=2, head_dim=8)
JLAYOUT = PoolLayout(block_tokens=16, n_layers_kv=4, n_kv_heads=2, head_dim=8)


def _trace(seed_val: int, n_ops: int = 120, max_alloc: int = 12):
    """``tests/test_pool_allocator.py``'s recorded trace: a deterministic
    allocate / release stream."""
    rng = np.random.default_rng(seed_val)
    ops, live = [], 0
    for _ in range(n_ops):
        if live and rng.random() < 0.45:
            ops.append(("release", int(rng.integers(0, 1 << 30))))
            live -= 1
        else:
            ops.append(("allocate", int(rng.integers(1, max_alloc))))
            live += 1
    return ops


def _replay(a, a_oom, b, b_oom, ops) -> int:
    """Replay ``ops`` through allocators ``a`` and ``b`` (raising ``a_oom`` /
    ``b_oom`` when exhausted), asserting the same ids, free counts and
    occupancy after every op; returns the out-of-memory points met."""
    live_a, live_b, ooms = [], [], 0
    for op, arg in ops:
        if op == "allocate":
            try:
                got_a = a.allocate(arg)
            except a_oom:
                with pytest.raises(b_oom):
                    b.allocate(arg)
                ooms += 1
                continue
            got_b = b.allocate(arg)
            assert got_b == got_a  # the same ids in the same order
            live_a.append(got_a)
            live_b.append(got_b)
        else:
            if not live_a:
                continue
            i = arg % len(live_a)
            a.release(live_a.pop(i))
            b.release(live_b.pop(i))
        assert a.free_blocks() == b.free_blocks()
        assert a.shard_occupancy() == b.shard_occupancy()
    return ooms


def _epochs(pool) -> list[int]:
    if hasattr(pool, "meta"):
        return [m.epoch for m in pool.meta]
    return pool.epochs.tolist()


@pytest.mark.parametrize("seed_val", [1, 2, 3])
@pytest.mark.parametrize("interleave", [True, False])
def test_seed_allocator_equals_jax_seed_pool_on_traces(seed_val, interleave):
    jax_seed = jseed.SeedPool(JLAYOUT, 128, 8, interleave=interleave)
    port_seed = seed.SeedAllocator(LAYOUT, 128, 8, interleave=interleave)
    ooms = _replay(jax_seed, OutOfPoolMemory, port_seed, PoolExhausted, _trace(seed_val))
    assert _epochs(port_seed) == _epochs(jax_seed)
    assert port_seed.alloc_count == jax_seed.alloc_count
    assert [m.refcount for m in port_seed.meta] == [m.refcount for m in jax_seed.meta]
    assert [m.committed for m in port_seed.meta] == [m.committed for m in jax_seed.meta]
    assert ooms == _replay(jseed.SeedPool(JLAYOUT, 128, 8, interleave=interleave),
                           OutOfPoolMemory,
                           seed.SeedAllocator(LAYOUT, 128, 8, interleave=interleave),
                           PoolExhausted, _trace(seed_val))


@pytest.mark.parametrize("seed_val", [1, 2, 3])
@pytest.mark.parametrize("interleave", [True, False])
def test_pool_equals_port_seed_on_traces(seed_val, interleave):
    """The port's twin of ``test_allocator_equivalence_with_seed_impl``."""
    old = seed.SeedAllocator(LAYOUT, 128, 8, interleave=interleave)
    new = KVBlockPool(LAYOUT, 128, "meta", 8, interleave=interleave)
    _replay(old, PoolExhausted, new, PoolExhausted, _trace(seed_val))
    assert _epochs(old) == _epochs(new)  # the same recycle history


def test_traces_reach_the_pool_s_limit():
    """The traces are not trivial: interleaved and not, some reach an
    out-of-memory point, as the reference's test relies on."""
    ooms = [_replay(seed.SeedAllocator(LAYOUT, 128, 8, interleave=i), PoolExhausted,
                    KVBlockPool(LAYOUT, 128, "meta", 8, interleave=i), PoolExhausted,
                    _trace(s)) for s in (1, 2, 3) for i in (True, False)]
    assert any(ooms), ooms


def _skew(pool) -> None:
    """One fat shard and crumbs: trips the seed's round-robin cap."""
    pool.allocate(128)
    pool.release([b for b in range(128) if b % 8 == 0] + [1, 10, 19, 28, 37, 46, 55])


@pytest.mark.parametrize("n_alloc", [17, 20, 23])
def test_degenerate_fallback_equals_jax_and_the_pool(n_alloc):
    jax_seed = jseed.SeedPool(JLAYOUT, 128, 8)
    port_seed = seed.SeedAllocator(LAYOUT, 128, 8)
    pool = KVBlockPool(LAYOUT, 128, "meta", 8)
    jpool = BelugaPool(JLAYOUT, 128, 8, backing="meta")
    for p in (jax_seed, port_seed, pool, jpool):
        _skew(p)
    want = jax_seed.allocate(n_alloc)
    assert port_seed.allocate(n_alloc) == want
    assert pool.allocate(n_alloc) == want
    assert jpool.allocate(n_alloc) == want
    occ = jax_seed.shard_occupancy()
    assert port_seed.shard_occupancy() == pool.shard_occupancy() == occ


def test_seed_allocator_refusals_and_exact_exhaustion():
    p = seed.SeedAllocator(LAYOUT, 64, 8)
    p.allocate(60)
    with pytest.raises(PoolExhausted):
        p.allocate(5)
    assert p.free_blocks() == 4  # a refused call takes nothing
    assert len(p.allocate(4)) == 4
    q = seed.SeedAllocator(LAYOUT, 64, 8)
    a = q.allocate(2)
    q.release(a)
    with pytest.raises(ValueError):
        q.release(a[:1])
    with pytest.raises(ValueError):
        q.retain(a[1:])
    with pytest.raises(ValueError):
        seed.SeedAllocator(LAYOUT, 60, 8)
    with pytest.raises(ValueError):
        seed.SeedAllocator(LAYOUT, 64, 8, device="cuda")


@pytest.mark.parametrize("bt", [1, 4, 16])
@pytest.mark.parametrize("n_tokens", [0, 15, 16, 37, 256])
def test_seed_keys_byte_equal_to_jax(bt, n_tokens):
    tokens = np.random.default_rng(n_tokens * 31 + bt).integers(0, 152000, n_tokens).tolist()
    keys = seed.seed_keys_for(tokens, bt)
    assert keys == jseed.seed_keys_for(tokens, bt)
    assert len(keys) == n_tokens // bt
    assert seed.seed_block_key(seed.SEED_ROOT, tuple(tokens[:bt])) == jseed.seed_block_key(
        jseed.SEED_ROOT, tuple(tokens[:bt]))
    if keys:  # the seed's chain is not the port's (bytes, not str() encodings)
        assert not set(keys) & set(chain_keys(tokens, bt))


def _written_pair(seed_val: int, n_blocks: int = 32, n_write: int = 12):
    """JAX's and the port's seed with the same seeded bytes written into
    the same blocks: (jax pool, port pool, ids, jax epochs, port epochs,
    payloads)."""
    rng = np.random.default_rng(seed_val)
    payloads = rng.integers(0, 256, (n_write, LAYOUT.block_bytes), dtype=np.uint8)
    jp = jseed.SeedPool(JLAYOUT, n_blocks, 8, backing="numpy")
    tp = seed.SeedAllocator(LAYOUT, n_blocks, 8, device="cpu")
    ids = jp.allocate(n_write)
    assert tp.allocate(n_write) == ids
    jeps = [jp.write_block(b, payloads[i]) for i, b in enumerate(ids)]
    teps = [tp.write_block(b, torch.from_numpy(payloads[i])) for i, b in enumerate(ids)]
    assert teps == jeps
    return jp, tp, ids, jeps, teps, payloads


@pytest.mark.parametrize("seed_val", [0, 1, 2])
def test_seed_scatter_read_byte_equal_to_jax(seed_val):
    jp, tp, ids, jeps, teps, payloads = _written_pair(seed_val)
    order = np.random.default_rng(seed_val + 7).permutation(ids).tolist()
    pos = [ids.index(b) for b in order]
    want = jseed.seed_scatter_read(jp, order, [jeps[i] for i in pos])
    got = seed.seed_scatter_read(tp, order, [teps[i] for i in pos])
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == want.shape == (len(order), *LAYOUT.block_shape)
    assert np.array_equal(got.view(torch.uint8).numpy().reshape(len(order), -1),
                          want.view(np.uint8).reshape(len(order), -1))
    assert np.array_equal(got.view(torch.uint8).numpy().reshape(len(order), -1), payloads[pos])
    for b in ids[:3]:
        (jb, je), (tb, te) = jp.read_block(b), tp.read_block(b)
        assert te == je and np.array_equal(tb.numpy(), jb)
        assert tp.validate_epoch(b, te) == jp.validate_epoch(b, je) is True


def test_seed_scatter_read_raises_on_a_moved_epoch():
    jp, tp, ids, jeps, teps, payloads = _written_pair(5, n_write=4)
    for p in (jp, tp):
        p.write_block(ids[2], None)  # rewritten: its epoch moves on
    with pytest.raises(CoherenceError):
        jseed.seed_scatter_read(jp, ids, jeps)
    with pytest.raises(StaleBlockError, match=f"block {ids[2]} "):
        seed.seed_scatter_read(tp, ids, teps)
    for p in (jp, tp):  # recycled: released to the free list, epoch bumped
        p.release([ids[0]])
    assert not tp.validate_epoch(ids[0], teps[0]) and not jp.validate_epoch(ids[0], jeps[0])
    with pytest.raises(StaleBlockError, match=f"block {ids[0]} "):
        seed.seed_scatter_read(tp, ids[:1], teps[:1])


def test_payload_free_seed_reads_zeros():
    p = seed.SeedAllocator(LAYOUT, 16, 8)
    [b] = p.allocate(1)
    e = p.write_block(b, torch.ones(LAYOUT.block_bytes, dtype=torch.uint8))
    assert p.data is None
    got, ge = p.read_block(b)
    assert ge == e and got.dtype == torch.uint8 and not got.any()
    out = seed.seed_scatter_read(p, [b], [e])
    assert tuple(out.shape) == (1, *LAYOUT.block_shape) and not out.view(torch.uint8).any()
