"""The port's ``RealEngine``, pool and index against the JAX package's.

* The engines: the JAX ``RealEngine(kernel_mode="jnp")`` (the oracle path;
  its Pallas scatter leaves unmapped slots unwritten) and the port's, with
  the JAX weights carried across, serve the same prompts cold, warm (full
  prefix hit) and with a partial hit. Hit counts and pool block ids must be
  equal; per-step logits, the prefill cache and the pool payload agree
  within 1e-2 (reduced llama3.1-8b in bf16: one or two bf16 ulps at 1, see
  tests/test_torch_model.py). The C1 claim holds on the port: the cache
  restored from the pool equals the cold cache bit for bit.
* The control plane: the port's ``chain_keys`` are byte-identical to
  ``repro.core.index.PrefixHasher``'s, and ``KVBlockPool`` + ``PrefixIndex``
  give the same answers as ``BelugaPool`` + ``GlobalIndex`` on one seeded
  stream of allocate / publish / match / evict / release operations.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.core.index import GlobalIndex, PrefixHasher
from repro.core.pool import BelugaPool, PoolLayout
from repro.serving.real_runner import RealEngine as JaxRealEngine
from repro_torch.configs.registry import reduced_config
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.core.index import PrefixIndex, chain_keys
from repro_torch.core.pool import KVBlockLayout, KVBlockPool
from repro_torch.serving.real_runner import RealEngine

# tiny shapes: one intra-op thread is as fast, and more threads would only
# spin against the other test workers, which share the CPU's cores
torch.set_num_threads(1)

TOL = 1e-2
MAX_NEW = 8


def _recording_jax_engine():
    """A JAX engine whose prefill and decode calls record their logits and caches."""
    eng = JaxRealEngine.create("llama3.1-8b", max_len=96, pool_blocks=64, kernel_mode="jnp")
    log = {"logits": [], "prefill_cache": []}
    prefill, decode = eng._prefill, eng._decode

    def rec_prefill(batch):
        logits, cache = prefill(batch)
        log["logits"].append(np.asarray(logits[0, 0], np.float32))
        log["prefill_cache"].append(cache)
        return logits, cache

    def rec_decode(cache, tokens, pos):
        logits, cache = decode(cache, tokens, pos)
        log["logits"].append(np.asarray(logits[0], np.float32))
        return logits, cache

    eng.__dict__["_prefill"] = rec_prefill  # shadows the cached_property
    eng.__dict__["_decode"] = rec_decode
    return eng, log


def _steps_to_compare(a: list[int], b: list[int]) -> int:
    """Step i's logits depend on the tokens emitted before it."""
    n = 1
    while n < len(a) and a[n - 1] == b[n - 1]:
        n += 1
    return n


@pytest.fixture(scope="module")
def engines():
    jeng, log = _recording_jax_engine()
    tree = jax.tree.map(np.asarray, jeng.params)
    cfg = reduced_config("llama3.1-8b")
    teng = RealEngine.create(cfg, max_len=96, pool_blocks=64, device="cpu",
                             params=params_from_numpy(tree, cfg, "cpu"))
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, size=48).tolist()
    partial = prompt[:32] + rng.integers(0, cfg.vocab_size, size=20).tolist()
    runs = []
    for p in (prompt, prompt, partial):  # cold, full hit, 32-token hit
        n_before = len(log["logits"])
        jt, ji = jeng.generate(p, max_new=MAX_NEW)
        tt, ti = teng.generate(p, max_new=MAX_NEW)
        jlog = np.stack(log["logits"][n_before:][-len(jt):])
        runs.append(dict(jtok=jt, jinfo=ji, jlogits=jlog, ttok=tt, tinfo=ti))
    return jeng, teng, log, prompt, runs


def test_hits_and_per_step_logits_match_jax(engines):
    _, _, _, _, runs = engines
    for run, want_hit in zip(runs, (0, 48, 32)):
        assert run["jinfo"]["hit_tokens"] == run["tinfo"]["hit_tokens"] == want_hit
        n = _steps_to_compare(run["jtok"], run["ttok"])
        np.testing.assert_allclose(
            run["tinfo"]["logits"][:n].numpy(), run["jlogits"][:n], atol=TOL, rtol=TOL
        )


def test_prefill_cache_and_pool_payload_match_jax(engines):
    jeng, teng, log, prompt, runs = engines
    jk = log["prefill_cache"][0]["pos_0"]["k"]
    tk = runs[0]["tinfo"]["kv"][0]
    np.testing.assert_allclose(
        tk[:, :, :48].float().numpy(), np.asarray(jk[:, :, :48], np.float32),
        atol=TOL, rtol=TOL,
    )
    jhits, thits = jeng.index.match_prefix(prompt), teng.index.match_prefix(prompt)
    ids = [b for _, b, _ in thits]
    assert ids == [b for _, b, _ in jhits] and len(ids) == 3
    np.testing.assert_allclose(
        teng.pool.data[ids].float().numpy(),
        np.asarray(jeng.pool.data[np.asarray(ids)], np.float32), atol=TOL, rtol=TOL,
    )


def test_warm_restored_cache_is_bit_equal_to_cold(engines):
    """C1 on the port: pool round trip preserves the KV exactly."""
    _, teng, _, prompt, runs = engines
    cold_k, cold_v = runs[0]["tinfo"]["kv"]
    hits = teng.index.match_prefix(prompt)
    rk, rv = teng.fetch([b for _, b, _ in hits])
    assert torch.equal(rk[:, :, :48], cold_k[:, :, :48])
    assert torch.equal(rv[:, :, :48], cold_v[:, :, :48])
    assert not rk[:, :, 48:].any() and not rv[:, :, 48:].any()
    assert runs[1]["ttok"] == runs[0]["ttok"]


def test_engine_refuses_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RealEngine.create(reduced_config("llama3.1-8b"))


# ---------------------------------------------------------------------------
# control plane parity
# ---------------------------------------------------------------------------


def test_chain_hasher_keys_are_byte_identical():
    rng = np.random.default_rng(3)
    jh = PrefixHasher(16)
    for n in (0, 5, 16, 33, 48, 200):
        toks = rng.integers(0, 128256, size=n).tolist()
        assert chain_keys(toks, 16) == jh.keys_for(toks)


def test_pool_and_index_answer_like_repro_on_one_op_stream():
    bt, n_blocks = 4, 32
    jpool = BelugaPool(PoolLayout(bt, 1, 1, 8), n_blocks=n_blocks, n_shards=8, backing="meta")
    tpool = KVBlockPool(KVBlockLayout(bt, 1, 1, 8), n_blocks=n_blocks, device="cpu")
    assert tpool.n_shards == jpool.n_shards
    jidx, tidx = GlobalIndex(jpool), PrefixIndex(tpool)
    rng = np.random.default_rng(7)
    stems = [rng.integers(0, 50, size=8).tolist() for _ in range(3)]
    prompts = [
        stems[i % 3] + rng.integers(0, 50, size=int(rng.integers(0, 17))).tolist()
        for i in range(9)
    ]
    seen_keys = set()
    for step in range(300):
        op = rng.choice(["publish", "publish", "match", "match", "evict", "release"])
        p = prompts[int(rng.integers(len(prompts)))]
        if op == "publish":
            keys = list(jidx.keys_for(p))
            assert tuple(keys) == tidx.keys_for(p)
            if rng.random() < 0.2 and keys:
                keys.append(keys[0])  # a key twice in one batch: the last wins
            if not keys or jpool.free_blocks() < len(keys):
                continue
            ids = jpool.allocate(len(keys))
            assert tpool.allocate(len(keys)) == ids
            eps = jpool.write_blocks(ids)
            assert tpool.write_blocks(ids) == eps
            jidx.publish_many(keys, ids, eps, bt)
            tidx.publish_many(keys, ids, eps, bt)
            seen_keys.update(keys)
        elif op == "match":
            assert tidx.match_prefix(p) == jidx.match_prefix(p)
        elif op == "evict":
            k = int(rng.integers(1, 5))
            assert tidx.evict_lru(k) == jidx.evict_lru(k)
        else:
            live = np.flatnonzero(jpool.refcounts > 0)
            if len(live):
                b = [int(live[rng.integers(len(live))])]
                jpool.release(b)
                tpool.release(b)
        assert tidx.stats() == jidx.stats(), step
        assert tpool.free_blocks() == jpool.free_blocks()
        assert tpool.shard_occupancy() == jpool.shard_occupancy()
        assert np.array_equal(tpool.epochs, jpool.epochs)
        assert np.array_equal(tpool.refcounts, jpool.refcounts)
    for key in sorted(seen_keys):
        je, te = jidx.lookup(key), tidx.lookup(key)
        assert (je is None) == (te is None)
        if je is not None:
            assert (te.block_id, te.epoch, te.n_tokens) == (je.block_id, je.epoch, je.n_tokens)


def test_tensor_from_numpy_keeps_bf16_bits():
    a = np.asarray(jax.numpy.asarray([1.0, -2.5, 3e-3], jax.numpy.bfloat16))
    t = tensor_from_numpy(a, "cpu")
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.uint16).numpy(), a.view(np.uint16))
