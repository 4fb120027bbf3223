"""qwen3-32b's shapes in the port against the JAX package, on the CPU.

The registry's ``qwen3-32b`` sets no ``d_head``, so its head_dim is 5120 /
64 = 80 and its GQA group 64 / 8 = 8: the one served config whose decode
attention runs at head_dim 80. ``reduced_config`` forces head_dim 16, so
this file builds a narrow config of its own, the same way on both sides:
head_dim 80, 8 query heads over 1 kv head (group 8), d_model 640, 2 layers,
d_ff 256, vocabulary 256, float32.

* ``Model`` (prefill and every decode step) and ``RealEngine`` (cold, full
  hit, partial hit) against the JAX ``Model`` and the JAX ``RealEngine``
  (``kernel_mode="jnp"``, its oracle path) with the JAX weights carried
  across: logits at every step within 1e-4 (float32; the two frameworks
  sum in other orders).
* The plain ``paged_attention`` at head_dim 80 and group 8 against the JAX
  oracle and the Pallas kernel in interpret mode, as tests/test_torch_paged.py
  does at the kernel tests' shapes (f32 2e-5, bf16 3e-2).
* ``RealEngine.generate`` fed a given continuation scores it as prefills do.
* The card's launch plans at qwen3-32b's shapes, computed here: the paged
  split plan at groups 4, 7 and 8, and flash's route, TMA boxes and work
  schedule at head_dim 80.
"""

from __future__ import annotations

import dataclasses
import heapq

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RuntimeConfig
from repro.configs.registry import get_config as jax_get_config
from repro.core.index import GlobalIndex
from repro.core.pool import BelugaPool, PoolLayout
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import Model as JaxModel
from repro.serving.real_runner import RealEngine as JaxRealEngine
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.models.model import Model
from repro_torch.serving.real_runner import RealEngine

# narrow shapes: one intra-op thread is as fast, and more threads would only
# spin against the other test workers, which share the CPU's cores
torch.set_num_threads(1)

NARROW = dict(name="qwen3-32b-narrow", n_layers=2, d_model=640, n_heads=8, n_kv_heads=1,
              d_ff=256, vocab_size=256, dtype="float32")
TOL = 1e-4
RT = RuntimeConfig(remat="none", attn_chunk_q=16, attn_chunk_kv=16, decode_kv="replicated")
PROMPT, MAX_LEN, STEPS = 40, 64, 8
H100_SMS = 132


def _configs():
    jcfg = dataclasses.replace(jax_get_config("qwen3-32b"), **NARROW)
    tcfg = dataclasses.replace(get_config("qwen3-32b"), **NARROW)
    assert jcfg.head_dim == tcfg.head_dim == 80
    assert tcfg.n_heads // tcfg.n_kv_heads == 8
    return jcfg, tcfg


def _close(got: torch.Tensor, want, what: str):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL, err_msg=what)


def test_narrow_config_keeps_qwen3_32bs_head_dim_and_group():
    jcfg, tcfg = _configs()
    full = get_config("qwen3-32b")
    assert (full.head_dim, full.n_heads // full.n_kv_heads) == (80, 8)
    assert jcfg.d_head == tcfg.d_head == 0  # head_dim comes from d_model / n_heads


def test_model_prefill_and_every_decode_step_match_jax():
    jcfg, tcfg = _configs()
    jmodel = JaxModel(jcfg, RT)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0)))
    jparams = jax.tree.map(jnp.asarray, tree)
    tmodel, tparams = Model(tcfg), params_from_numpy(tree, tcfg, "cpu")
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 256, size=(1, PROMPT))
    feed = rng.integers(0, 256, size=STEPS)

    prefill = jax.jit(jmodel.prefill_fn, static_argnames="max_len")
    decode = jax.jit(jmodel.decode_fn)
    jlogits, jcache = prefill(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
                              max_len=MAX_LEN)
    tlogits, tcache = tmodel.prefill_fn(tparams, torch.from_numpy(tokens), max_len=MAX_LEN)
    _close(tlogits, jlogits, "prefill logits")
    _close(tcache[0], jcache["pos_0"]["k"], "prefill k cache")
    _close(tcache[1], jcache["pos_0"]["v"], "prefill v cache")
    # each side decodes from its own cache: the port's paged decode at head
    # dim 80 and group 8 over the port's prefill
    for i, tok in enumerate(feed):
        pos = PROMPT + i
        jl, jcache = decode(jparams, jcache, jnp.asarray([tok], jnp.int32),
                            jnp.asarray([pos], jnp.int32))
        tl = tmodel.decode_fn(tparams, tcache, torch.tensor([int(tok)]), torch.tensor([pos]))
        _close(tl, jl, f"decode step {i} logits")


def _jax_engine(jcfg, max_len: int, pool_blocks: int):
    """The JAX RealEngine as its ``create`` builds one, on the narrow config
    (``create`` takes only a registry name and reduces it)."""
    model = JaxModel(jcfg, RuntimeConfig(remat="none", attn_chunk_q=32, attn_chunk_kv=32,
                                         decode_kv="replicated"))
    layout = PoolLayout(block_tokens=16, n_layers_kv=jcfg.n_layers,
                        n_kv_heads=jcfg.n_kv_heads, head_dim=jcfg.head_dim)
    pool = BelugaPool(layout, n_blocks=pool_blocks, n_shards=8, backing="jax")
    eng = JaxRealEngine(cfg=jcfg, model=model, pool=pool, index=GlobalIndex(pool),
                        params=model.init(jax.random.key(0)), max_len=max_len,
                        kernel_mode="jnp")
    log = []
    prefill, decode = eng._prefill, eng._decode

    def rec_prefill(batch):
        logits, cache = prefill(batch)
        log.append(np.asarray(logits[0, 0], np.float32))
        return logits, cache

    def rec_decode(cache, tokens, pos):
        logits, cache = decode(cache, tokens, pos)
        log.append(np.asarray(logits[0], np.float32))
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


def test_real_engine_cold_full_and_partial_hits_match_jax():
    jcfg, tcfg = _configs()
    jeng, log = _jax_engine(jcfg, max_len=96, pool_blocks=32)
    tree = jax.tree.map(np.asarray, jeng.params)
    teng = RealEngine.create(tcfg, max_len=96, pool_blocks=32, device="cpu",
                             params=params_from_numpy(tree, tcfg, "cpu"))
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 256, size=48).tolist()
    partial = prompt[:32] + rng.integers(0, 256, size=20).tolist()
    for p, want_hit in ((prompt, 0), (prompt, 48), (partial, 32)):
        n_before = len(log)
        jt, ji = jeng.generate(p, max_new=STEPS)
        tt, ti = teng.generate(p, max_new=STEPS)
        jlogits = np.stack(log[n_before:][-len(jt):])
        assert ji["hit_tokens"] == ti["hit_tokens"] == want_hit
        n = _steps_to_compare(jt, tt)
        assert n == STEPS, (jt, tt)
        np.testing.assert_allclose(ti["logits"][:n].numpy(), jlogits[:n], atol=TOL, rtol=TOL)
    assert [b for _, b, _ in teng.index.match_prefix(prompt)] == \
        [b for _, b, _ in jeng.index.match_prefix(prompt)]


def test_generate_fed_a_continuation_scores_it_as_prefills_do():
    """``RealEngine.generate(feed=...)``, which chip_smoke.py uses to hold
    the kernel path against the plain one on the same tokens. Cold, step
    i's logits equal the last logits of a prefill of the prompt and
    feed[:i]. After a full hit (the KV read back from the pool), a run fed
    the greedy run's own tokens repeats its logits bit for bit. The tokens
    are each step's argmax."""
    _, tcfg = _configs()
    eng = RealEngine.create(tcfg, max_len=64, pool_blocks=16, device="cpu", seed=0)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, 256, size=32).tolist()
    feed = rng.integers(0, 256, size=4).tolist()
    toks, info = eng.generate(prompt, max_new=4, feed=feed)
    assert info["hit_tokens"] == 0
    for i in range(4):
        want, _ = eng.prefill(prompt + feed[:i])
        _close(info["logits"][i], want, f"cold step {i}")
        assert toks[i] == int(info["logits"][i].argmax())
    greedy, ginfo = eng.generate(prompt, max_new=4)
    fed, finfo = eng.generate(prompt, max_new=4, feed=greedy)
    assert ginfo["hit_tokens"] == finfo["hit_tokens"] == 32
    assert fed == greedy and torch.equal(finfo["logits"], ginfo["logits"])


PAGED_D80 = [
    # (b, hq, hkv, d, bt, max_blocks, n_blocks): group 8 at head_dim 80
    (2, 8, 1, 80, 16, 4, 16),
    (1, 64, 8, 80, 16, 5, 8),  # qwen3-32b's heads
]


@pytest.mark.parametrize("shape", PAGED_D80)
@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 2e-5), (jnp.bfloat16, 3e-2)])
def test_paged_plain_at_head_dim_80_group_8_matches_oracle_and_pallas(shape, dtype, tol):
    b, hq, hkv, d, bt, mb, nb = shape
    rng = np.random.default_rng(sum(shape))
    jq = jnp.asarray(rng.standard_normal((b, hq, d), dtype=np.float32)).astype(dtype)
    jpool = jnp.asarray(rng.standard_normal((nb, 2, bt, hkv, d), dtype=np.float32)).astype(dtype)
    tq, tpool = tensor_from_numpy(np.asarray(jq), "cpu"), tensor_from_numpy(np.asarray(jpool), "cpu")
    table = np.stack([rng.choice(nb, size=mb, replace=False) for _ in range(b)]).astype(np.int32)
    ctx = rng.integers(1, mb * bt, size=(b,)).astype(np.int32)
    got = ops.paged_attention(tq, tpool[:, 0], tpool[:, 1], torch.from_numpy(table),
                              torch.from_numpy(ctx)).float().numpy()
    jt, jc = jnp.asarray(table), jnp.asarray(ctx)
    want = np.asarray(jref.paged_attention_ref(jq, jpool, jt, jc), np.float32)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    pallas = np.asarray(jops.paged_attention(jq, jpool, jt, jc, mode="pallas"), np.float32)
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)


def test_paged_takes_head_dim_80():
    assert 80 in pa.HEAD_DIMS and pa.MAX_GROUP >= 8


@pytest.mark.parametrize("g", [4, 7, 8])
def test_paged_plan_fills_the_card_in_one_wave_at_groups_4_7_8(g):
    """At qwen3-32b's decode (b 1, 8 kv heads, a 2048-token table) with 2
    CTAs per SM, the plan's CTAs all fit at once, and a further split would
    either pass a cluster's 16 CTAs or the card's 264 resident CTAs. The
    bf16 kernel takes a whole group a CTA, so the group does not change the
    plan: 16 splits of 8 kv heads."""
    per_sm, hkv, max_blocks = 2, 8, 128
    splits = pa.plan_splits(H100_SMS, per_sm, 1, hkv, max_blocks)
    ctas = splits * hkv
    assert ctas <= H100_SMS * per_sm
    assert splits == pa.MAX_SPLITS or (splits + 1) * hkv > H100_SMS * per_sm
    assert len(pa.split_ranges(1040, 16, splits)) == splits  # every CTA has blocks
    assert ctas == 128


def test_flash_routes_bf16_head_dim_80_to_the_tensor_cores():
    assert fa.route(torch.bfloat16, get_config("qwen3-32b").head_dim) == "wgmma"
    assert fa.route(torch.float32, 80) == "cuda_cores"


def test_flash_tma_box_at_head_dim_80_is_five_32_byte_columns():
    """A 160-byte row is wider than the 128-byte swizzle span and no multiple
    of it: a tile is five boxes of 16 columns (32 B) under the 32-byte
    swizzle, one k16 step of Q.K^T each."""
    shape = (1, 1024, 64, 80)
    dims, strides, box = fa.tensor_map_args(shape)
    assert dims == (80, 64, 1024, 1)
    assert strides == (160, 64 * 160, 1024 * 64 * 160) and all(s % 16 == 0 for s in strides)
    assert box == (16, 1, fa.BLOCK_Q, 1) and box[0] * 2 == 32 and 80 // box[0] == 5
    assert fa.box_cols(64) == fa.box_cols(128) == 64


def _greedy_max(lengths: list[int], ctas: int) -> int:
    loads = [0] * ctas
    for n in sorted(lengths, reverse=True):
        heapq.heapreplace(loads, loads[0] + n)
    return max(loads)


@pytest.mark.parametrize("label,sq,hq", [
    ("llama", 1024, 32), ("arctic", 1024, 56), ("jamba", 1000, 64), ("qwen3-32b", 1024, 64),
])
def test_flash_cta_schedule_covers_every_item_once_and_balances(label, sq, hq):
    """The persistent grid's snake over the longest-first items: each item
    once, at most one CTA per SM, and no CTA's causal kv tiles above a greedy
    longest-first schedule's largest load."""
    n_q_tiles = -(-sq // fa.BLOCK_Q)
    n_items = n_q_tiles * hq
    order = fa.q_tile_order(n_q_tiles, hq)
    per_cta = fa.cta_items(n_items, H100_SMS)
    assert len(per_cta) == min(n_items, H100_SMS)
    assert sorted(x for items in per_cta for x in items) == list(range(n_items))
    kv_tiles = [order[x] + 1 for x in range(n_items)]  # causal: tiles up to the diagonal
    load = max(sum(kv_tiles[x] for x in items) for items in per_cta)
    assert load <= _greedy_max(kv_tiles, H100_SMS)
    assert load <= -(-sum(kv_tiles) // H100_SMS) + 1


def test_flash_cta_schedule_with_fewer_items_than_sms():
    """The grid is never larger than the items; a partial odd round runs
    backwards, so its items go to the last CTAs."""
    assert fa.cta_items(5, H100_SMS) == [[0], [1], [2], [3], [4]]
    assert fa.cta_items(6, 4) == [[0], [1], [2, 5], [3, 4]]
