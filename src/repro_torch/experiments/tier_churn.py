"""The tiered pool's churn protocol (``tests/test_tiering.py:266-306``) at
the Qwen3-32B layout, for ``chip_smoke.py`` phase 19 (ii).

A seeded mix of writebacks, planned fetches, LRU evictions and targeted
evictions over documents whose chains share prefixes, with the migrator
stepped after each operation. At this size (``PINS``) it makes demotions
into spill and on into the SSD tier and promotions back to fast, each a
copy of real payload rows on a ``cuda`` chain. It makes no bottom-tier
eviction and no ghost admission (both 0 in ``PINS``), and no remap loses a
race within a step, so no rollback runs: the CPU tests' smaller chains
reach those. ``churn`` takes the manager, index, migrator and
pool it drives by their method names alone, so the same protocol runs the
reference's objects (a CPU test takes ``PINS`` from the JAX package's
payload-free pool) and the port's, payload-free on ``meta`` or with real
payload rows on the card. Placement does not depend on the payload's
bytes, so every run of one seed places the same block ids.

``record`` lines (one per operation, then the index's final entries) are
plain Python numbers; ``digest`` hashes them.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

# the chain: fast 512, spill 512 (RDMA DRAM), a deep SSD tier of 2048, all
# at the Qwen3-32B layout (2.5 MiB a block: 7.5 GiB on the card)
FAST_BLOCKS = 512
SPILL_BLOCKS = 512
N_SHARDS = 32
TIERING = dict(
    enabled=True, spill_media="rdma_dram", extra_tiers=((2048, "ssd"),),
    migrate_interval_s=0.01, migrate_batch_blocks=128, high_watermark=0.8,
    demote_target=0.5, promote_min_heat=2.0,
)
SEED = 0
N_OPS = 400
N_DOCS = 24
MAX_CHAIN = 96  # blocks: a document's chain is 1 .. MAX_CHAIN - 1 of them
EVICT_MAX = 96


def doc_tokens(doc: int, n_blocks: int, block_tokens: int = 16) -> list[int]:
    return [doc * 100000 + i for i in range(n_blocks * block_tokens)]


def churn(mgr, index, migrator, pool, seed: int = SEED, n_ops: int = N_OPS,
          n_docs: int = N_DOCS, max_chain: int = MAX_CHAIN, evict_max: int = EVICT_MAX,
          payload=None, after_op=None) -> list:
    """Drive the protocol; returns its record. ``payload(keys)`` gives the
    KV of a writeback's unpublished keys (None: a payload-free pool).
    ``after_op(i)`` runs after each operation and its migrator steps."""
    rng = np.random.default_rng(seed)
    record = []
    now = 0.0
    for step in range(n_ops):
        now += float(rng.uniform(0.0, 0.06))
        op = int(rng.integers(0, 10))
        doc = int(rng.integers(0, n_docs))
        nb = int(rng.integers(1, max_chain))
        tokens = doc_tokens(doc, nb)
        if op < 4:  # publish (chains share per-document prefixes)
            kv = None
            if payload is not None:
                keys = index.keys_for(tokens)
                kv = payload([keys[i] for i in index.filter_unpublished(keys)])
            got = mgr.writeback(f"w{step}", tokens, kv_payload=kv, now=now)
            placed = [int(b) for _, b, _ in _entries(index, index.keys_for(tokens))]
        elif op < 7:  # demand: heat and the promotion signal
            got = len(mgr.plan_fetch(tokens, now=now).hit_blocks)
            placed = []
        elif op < 8:  # foreground pool pressure
            placed = [int(b) for b in index.evict_lru(int(rng.integers(1, evict_max)))]
            got = len(placed)
        else:  # targeted eviction of arbitrary ids (unindexed ones skip)
            ids = rng.integers(0, pool.n_blocks, size=4).tolist()
            placed = [int(b) for b in index.evict_blocks(ids)]
            got = len(placed)
        migrator.run_until(now)
        record.append((step, op, int(got), placed, int(pool.free_blocks()),
                       [int(t.n_blocks - t.free_blocks()) for t in pool.tiers],
                       list(pool.tier_writes), int(migrator.steps)))
        if after_op is not None:
            after_op(step)
    return record


def _entries(index, keys) -> list:
    """(key, block, epoch) of the chain's keys the index holds, in order."""
    keys = list(keys)
    if hasattr(index, "lookup_many"):  # the reference's index
        got = index.lookup_many(keys)
        return [(k, e.block_id, e.epoch) for k, e in zip(keys, got) if e is not None]
    out = []
    for k in keys:
        e = index.lookup(k)
        if e is not None:
            out.append((k, e.block_id, e.epoch))
    return out


def final_entries(index, keys) -> list:
    """The index's (block, epoch) for every key of ``keys`` it holds."""
    return [(int(b), int(e)) for _, b, e in _entries(index, keys)]


def all_keys(index, n_docs: int = N_DOCS, max_chain: int = MAX_CHAIN) -> list[bytes]:
    """Every key the protocol can publish: each document's longest chain."""
    return [k for d in range(n_docs) for k in index.keys_for(doc_tokens(d, max_chain - 1))]


def summary(record: list, pool, migrator, index) -> dict:
    """What ``PINS`` holds of a run: the digest of its record and of the
    index's final entries, its ``TierStats`` and counts."""
    ents = final_entries(index, all_keys(index))
    return {
        "digest": hashlib.sha1(repr(record + [ents]).encode()).hexdigest(),
        "tier_stats": pool.tier_stats.as_dict(),
        "tier_writes": [int(w) for w in pool.tier_writes],
        "migrator_steps": int(migrator.steps),
        "entries": len(ents),
        "free_blocks": int(pool.free_blocks()),
    }


def key_payload(keys, layout, device) -> torch.Tensor:
    """Each key's block of KV: distinct bytes from a generator seeded by the
    key, (n, *block_shape) in the pool's 2-byte payload type."""
    out = torch.empty((len(keys), *layout.block_shape), dtype=torch.int16, device=device)
    g = torch.Generator(device=device)
    for i, k in enumerate(keys):
        g.manual_seed(int.from_bytes(k[:8], "little") & (2**63 - 1))
        torch.randint(-(2**15), 2**15, layout.block_shape, generator=g, dtype=torch.int16,
                      device=device, out=out[i])
    return out.view(torch.bfloat16)


def verify_payloads(index, transfer, batch: int = 64) -> tuple[int, int]:
    """Read every indexed block back through ``transfer.scatter_read`` (its
    epoch checked) and hold its bytes to its key's. Returns (blocks read,
    blocks whose bytes differ)."""
    items = index.items()
    layout = transfer.pool.layout
    bad = 0
    for i in range(0, len(items), batch):
        part = items[i:i + batch]
        got = transfer.scatter_read([e.block_id for _, e in part], [e.epoch for _, e in part])
        want = key_payload([k for k, _ in part], layout, got.device)
        same = (got.view(torch.int16) == want.view(torch.int16)).flatten(1).all(1)
        bad += int((~same).sum())
    return len(items), bad


def books_balance(pool, index) -> list[str]:
    """The port's chain and index agree: every pool block is free or owned
    by exactly one entry, whose block maps back to its key; an owned block
    is committed with refcount 1 (nothing else holds a reference here).
    Returns what is wrong."""
    items = index.items()
    keys = [k for k, _ in items]
    ids = [e.block_id for _, e in items]
    bad = []
    if index.owners_of(ids)[0] != keys:
        bad.append("the reverse map is out of step with the entries")
    if len(set(ids)) != len(ids):
        bad.append("a block owned by two entries")
    if pool.free_blocks() != pool.n_blocks - len(ids):
        bad.append(f"{pool.free_blocks()} blocks free, {pool.n_blocks - len(ids)} unowned")
    if ids:
        a = np.asarray(ids, np.intp)
        if not (np.asarray(pool.committed[a], bool).all() and (pool.refcounts[a] == 1).all()):
            bad.append("an owned block uncommitted or with refcount != 1")
    return bad


# the reference's run of the protocol at SEED on a payload-free chain
# (tests/test_torch_tiering.py takes them from the JAX package)
PINS: dict = {
    "digest": "946e14032758ef57c44be1f820d2998ffac71d0e",
    "tier_stats": {
        "fast_hit_blocks": 0, "spill_hit_blocks": 0, "fast_writes": 3319, "spill_writes": 0,
        "ghost_admits": 0, "demotions": 5115, "promotions": 665, "spill_evictions": 0,
        "migrated_bytes": 15151923200, "migration_busy_s": 1.6577073211241893,
    },
    "tier_writes": [3319, 0, 0],
    "migrator_steps": 1252,
    "entries": 1204,
    "free_blocks": 1868,
}
