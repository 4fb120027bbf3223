"""The fp8 KV cache (``RuntimeConfig.use_fp8_kv``) in the port against JAX.

JAX casts K and V to ``float8_e4m3fn`` with ``astype`` as they enter the
cache (prefill's ``_mixer_full``, decode's ``update_kv_cache``) and
dequantizes the cache to bf16 at the decode attention (``_dequant``). The
port's cast (``models.attention.to_e4m3``) must give the same bytes:
``Tensor.to(torch.float8_e4m3fn)`` saturates a value that rounds past 448
to +-448, where ``astype`` gives NaN. Checked here:

- the cast over all 65,536 bf16 bit patterns and float32 edge cases,
  against ``jnp.astype``, byte for byte;
- ``convert.tensor_from_numpy`` moving e4m3 arrays bit for bit;
- reduced olmo-1b and command-r-35b (JAX's own fp8 tests), llama3.1-8b and
  jamba with an fp8 cache, weights from JAX ``Model.init``: the caches
  after prefill and after each of 8 decode steps byte for byte (uint8
  views; SSM states within the float32 tolerance), the logits at every
  step within 1e-4 (float32, where the two frameworks' K and V differ in
  the last f32 bits at most, too little to move an e4m3 rounding);
- ``paged_attention_ref`` with e4m3 K/V against JAX's
  ``decode_attention_replicated`` on the same cache, a float32 and a bf16 q
  (1e-5: the same bf16 operands, f32 sums in other orders; 3e-2 for bf16,
  as ``tests/test_torch_paged.py`` holds the bf16 decode: JAX forms a bf16
  q * scale with the scale itself rounded to bf16, a weakly typed constant,
  where the port multiplies by the f32 scale and rounds once; at d 80 and
  128 the two scales differ by 1.2e-4 and 1e-4, which moves roundings of
  q * scale);
- gather and scatter on e4m3 caches against the Pallas kernels in
  interpret mode, byte for byte;
- the cache layout (e4m3 K/V, SSM state and conv in their dtypes) and the
  refusals: another fp8 type, and ``RealEngine`` with ``use_fp8_kv``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import RuntimeConfig as JaxRuntimeConfig
from repro.configs.registry import reduced_config as jax_reduced_config
from repro.kernels import ops as jops
from repro.models import Model as JaxModel
from repro.models import attention as jattn
from repro_torch.configs.base import RuntimeConfig
from repro_torch.configs.registry import reduced_config
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import transformer as stack_lib
from repro_torch.models.attention import to_e4m3
from repro_torch.models.model import Model
from repro_torch.serving.real_runner import RealEngine

torch.set_num_threads(1)

E4M3 = torch.float8_e4m3fn
ARCHS = ["olmo-1b", "command-r-35b", "llama3.1-8b", "jamba-1.5-large-398b"]
TOL = 1e-4  # float32 logits and SSM states
JRT = JaxRuntimeConfig(remat="none", attn_chunk_q=16, attn_chunk_kv=16, decode_kv="replicated",
                       use_fp8_kv=True)
PROMPT, MAX_LEN, STEPS = 24, 32, 8


def _bytes(a) -> np.ndarray:
    """An e4m3 array or tensor as its bytes."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _jax_e4m3(x: np.ndarray) -> np.ndarray:
    return _bytes(jnp.asarray(x).astype(jnp.float8_e4m3fn))


def test_cast_matches_jnp_astype_on_every_bf16_pattern():
    bits = np.arange(2**16, dtype=np.uint32).astype(np.uint16)
    x = tensor_from_numpy(bits.view(ml_dtypes.bfloat16), "cpu")
    want = _jax_e4m3(bits.view(ml_dtypes.bfloat16))
    got = _bytes(to_e4m3(x))
    assert np.array_equal(got, want)
    # the cases where a plain .to() differs: every |x| past 464, inf included
    plain = _bytes(x.to(E4M3))
    differ = np.nonzero(plain != want)[0]
    f = bits.view(ml_dtypes.bfloat16).astype(np.float32)
    assert len(differ) == 30512 and (np.abs(f[differ]) > 464).all()
    assert set(want[differ].tolist()) == {0x7F, 0xFF}


def test_cast_matches_jnp_astype_on_float32_edges():
    e = np.float32
    x = np.array([0.0, -0.0, 448.0, -448.0, 464.0, np.nextafter(e(464), e(0)),
                  np.nextafter(e(464), e(1e9)), -np.nextafter(e(464), e(1e9)), 479.99, 480.0,
                  1e38, np.inf, -np.inf, np.nan, 2.0**-6, 2.0**-7, 2.0**-9, 2.0**-10,
                  np.nextafter(e(2.0**-10), e(1)), 3 * 2.0**-11, 1e-30, -1e-30, 0.1, -17.3],
                 dtype=np.float32)
    assert np.array_equal(_bytes(to_e4m3(torch.from_numpy(x))), _jax_e4m3(x))
    rng = np.random.default_rng(0)
    wide = (rng.standard_normal(20000) * 10.0 ** rng.uniform(-4, 3, 20000)).astype(np.float32)
    assert np.array_equal(_bytes(to_e4m3(torch.from_numpy(wide))), _jax_e4m3(wide))


def test_convert_moves_e4m3_bit_for_bit():
    rng = np.random.default_rng(1)
    arr = np.asarray(jnp.asarray(rng.standard_normal((4, 8), dtype=np.float32) * 100)
                     .astype(jnp.float8_e4m3fn))
    t = tensor_from_numpy(arr, "cpu")
    assert t.dtype == E4M3 and np.array_equal(_bytes(t), arr.view(np.uint8))


def _setup(arch):
    jcfg = dataclasses.replace(jax_reduced_config(arch), dtype="float32")
    tcfg = dataclasses.replace(reduced_config(arch), dtype="float32")
    jmodel = JaxModel(jcfg, JRT)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0)))
    return (jmodel, jax.tree.map(jnp.asarray, tree),
            Model(tcfg, runtime=RuntimeConfig(use_fp8_kv=True)),
            params_from_numpy(tree, tcfg, "cpu"))


def _check_caches(tcache, jcache, kinds, what):
    for j, (got, kind) in enumerate(zip(stack_lib.position_caches(tcache, kinds), kinds)):
        want = jcache[f"pos_{j}"]
        if kind.mixer == "attn":
            for n in "kv":
                assert got[n].dtype == E4M3
                g, w = _bytes(got[n]), _bytes(want[n])
                assert np.array_equal(g, w), (what, j, n, int((g != w).sum()))
        else:
            for n in ("state", "conv"):
                w = np.asarray(want[n], np.float32)
                err = np.abs(got[n].float().numpy() - w).max() / max(np.abs(w).max(), 1e-30)
                assert err <= TOL, (what, j, n, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_fp8_caches_and_logits_match_jax(arch):
    jmodel, jparams, tmodel, tparams = _setup(arch)
    cfg = tmodel.cfg
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, PROMPT)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, size=(STEPS, 2)).astype(np.int32)

    jlogits, jcache = jax.jit(jmodel.prefill_fn, static_argnames="max_len")(
        jparams, {"tokens": jnp.asarray(tokens)}, max_len=MAX_LEN)
    tlogits, tcache = tmodel.prefill_fn(tparams, torch.from_numpy(tokens), max_len=MAX_LEN)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=TOL, rtol=TOL)
    _check_caches(tcache, jcache, tmodel.kinds, "prefill")

    decode = jax.jit(jmodel.decode_fn)
    for i in range(STEPS):
        pos = np.full(2, PROMPT + i, np.int32)
        jl, jcache = decode(jparams, jcache, jnp.asarray(feed[i]), jnp.asarray(pos))
        tl = tmodel.decode_fn(tparams, tcache, torch.from_numpy(feed[i]), torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL,
                                   err_msg=f"decode step {i}")
        _check_caches(tcache, jcache, tmodel.kinds, f"decode step {i}")


def test_fp8_cache_layout():
    """Every attention position's K and V in e4m3, in a hybrid too; the SSM
    state stays float32 and the conv window in the model dtype."""
    cfg = reduced_config("jamba-1.5-large-398b")
    cache = Model(cfg, runtime=RuntimeConfig(use_fp8_kv=True)).init_cache(2, 32, "cpu")
    kinds = stack_lib.layer_kinds(cfg)
    for c, kind in zip(stack_lib.position_caches(cache, kinds), kinds):
        if kind.mixer == "attn":
            assert c["k"].dtype == c["v"].dtype == E4M3
        else:
            assert c["state"].dtype == torch.float32 and c["conv"].dtype == torch.bfloat16
    plain = Model(cfg).init_cache(2, 32, "cpu")
    attn = [j for j, k in enumerate(kinds) if k.mixer == "attn"][0]
    assert plain[f"pos_{attn}"]["k"].dtype == torch.bfloat16


@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,d", [(8, 2, 16), (64, 8, 80), (32, 8, 128)])
def test_paged_ref_on_e4m3_matches_decode_attention_replicated(qdtype, hq, hkv, d):
    """The plain version on an e4m3 cache read through the identity table of
    a dense cache, against JAX's decode attention after ``_dequant``, with
    the q dtype's own rounding of q * scale before the bf16 cast."""
    b, max_len, bt = 3, 64, 16
    rng = np.random.default_rng(hq + d)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[qdtype]
    jq = jnp.asarray(rng.standard_normal((b, 1, hq, d), dtype=np.float32)).astype(jdt)
    kc = jnp.asarray(rng.standard_normal((b, max_len, hkv, d), dtype=np.float32) * 3) \
        .astype(jnp.float8_e4m3fn)
    vc = jnp.asarray(rng.standard_normal((b, max_len, hkv, d), dtype=np.float32) * 3) \
        .astype(jnp.float8_e4m3fn)
    ctx = np.array([1, 37, 64], np.int32)
    want = jattn.decode_attention_replicated(jq, kc, vc, jnp.asarray(ctx))[:, 0]
    q = tensor_from_numpy(np.asarray(jq)[:, 0], "cpu")
    k, v = (tensor_from_numpy(np.asarray(a), "cpu") for a in (kc, vc))
    nb = max_len // bt
    table = pa.make_block_table(np.arange(b * nb).reshape(b, nb), b * nb, "cpu")
    got = ops.paged_attention(q, pa.dense_blocks(k, bt), pa.dense_blocks(v, bt), table,
                              torch.from_numpy(ctx))
    assert got.dtype == q.dtype
    tol = {"float32": 1e-5, "bfloat16": 3e-2}[qdtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_paged_refuses_other_fp8_types():
    q = torch.zeros((1, 4, 16))
    blocks = torch.zeros((2, 16, 1, 16)).to(torch.float8_e5m2)
    tbl = pa.make_block_table([[0, 1]], 2, "cpu")
    with pytest.raises(ValueError, match="dtypes"):
        ops.paged_attention(q, blocks, blocks, tbl, torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="e4m3fn"):
        from repro_torch.models.attention import to_cache_dtype

        to_cache_dtype(q, torch.float8_e5m2)


@pytest.mark.parametrize("L,n_slots,bt,hkv,hd", [(3, 8, 16, 2, 32), (2, 4, 16, 8, 80)])
def test_gather_and_scatter_on_e4m3_match_pallas(L, n_slots, bt, hkv, hd):
    """e4m3 payloads (values past 448 cast to NaN included) move byte for
    byte, as the Pallas kernels in interpret mode move them."""
    rng = np.random.default_rng(L + hd)

    def pair(shape):
        j = jnp.asarray(rng.standard_normal(shape, dtype=np.float32) * 200).astype(
            jnp.float8_e4m3fn)
        return j, tensor_from_numpy(np.asarray(j), "cpu")

    jk, tk = pair((L, n_slots * bt, hkv, hd))
    jv, tv = pair((L, n_slots * bt, hkv, hd))
    assert (_bytes(tk) & 0x7F == 0x7F).any()  # NaN bytes travel too
    slots = rng.permutation(n_slots)[:3].tolist()
    js = jnp.asarray(slots, jnp.int32)
    blocks = ops.kv_gather_write(tk, tv, slots, bt)
    assert blocks.dtype == E4M3
    assert np.array_equal(_bytes(blocks),
                          _bytes(jops.kv_gather_write(jk, jv, js, bt, mode="pallas")))
    back_k, back_v = ops.kv_scatter_read(blocks, slots, n_slots)
    pk, pv = jops.kv_scatter_read(jnp.asarray(np.asarray(
        jops.kv_gather_write(jk, jv, js, bt, mode="pallas"))), js, n_slots, mode="pallas")
    for got, want, src in ((back_k, pk, tk), (back_v, pv, tv)):
        g = _bytes(got).reshape(L, n_slots, bt, hkv, hd)
        w = _bytes(want).reshape(L, n_slots, bt, hkv, hd)
        s = _bytes(src).reshape(L, n_slots, bt, hkv, hd)
        assert np.array_equal(g[:, slots], w[:, slots])
        assert np.array_equal(g[:, slots], s[:, slots])
        unmapped = [i for i in range(n_slots) if i not in slots]
        assert not g[:, unmapped].any()  # zero-filled, as the port's contract says


def test_real_engine_refuses_an_fp8_cache():
    with pytest.raises(ValueError, match="use_fp8_kv"):
        RealEngine.create(reduced_config("llama3.1-8b"), max_len=64, pool_blocks=8,
                          device="cpu", runtime=RuntimeConfig(use_fp8_kv=True))


def test_exp09_twin_moves_the_fp8_layout():
    """The qwen3-32b-fp8 layout gets its .device rows: blocks of e4m3 caches
    written and read back bit for bit, half the bytes of the bf16 layout."""
    from repro_torch.experiments import exp09_dense_transfer as exp09

    rows = {r[0]: r for r in exp09.run("cpu", reduced=True)}
    for what in ("write", "read"):
        fp8 = dict(f.split("=") for f in rows[f"exp09.qwen3-32b-fp8.{what}.device"][2].split(";"))
        bf16 = dict(f.split("=") for f in rows[f"exp09.qwen3-32b.{what}.device"][2].split(";"))
        assert fp8["bit_exact"] == "True" and 2 * int(fp8["bytes"]) == int(bf16["bytes"])


def test_runtime_and_shape_configs_copy_the_reference():
    """The port's RuntimeConfig keeps the reference's defaults for the
    fields it reads; its ShapeConfig has the reference's fields and reads
    every shape cell alike."""
    from repro.configs.base import SHAPES
    from repro.configs.base import ShapeConfig as JaxShapeConfig
    from repro_torch.configs.base import ShapeConfig

    port, jax_rt = RuntimeConfig(), JaxRuntimeConfig()
    assert [f.name for f in dataclasses.fields(port)] == ["kernel_mode", "remat", "decode_kv",
                                                          "moe_dispatch", "rowp_bf16_psum",
                                                          "use_fp8_kv"]
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(jax_rt, f.name), f.name
    assert ([f.name for f in dataclasses.fields(ShapeConfig)]
            == [f.name for f in dataclasses.fields(JaxShapeConfig)])
    for cell in SHAPES.values():
        mine = ShapeConfig(cell.name, cell.seq_len, cell.global_batch, cell.kind)
        assert dataclasses.astuple(mine) == dataclasses.astuple(cell)
        assert mine.is_decode == cell.is_decode


def test_model_takes_the_runtime_and_keywords_replace_its_fields():
    cfg = reduced_config("llama3.1-8b")
    m = Model(cfg, kernel_mode="ref", runtime=RuntimeConfig(use_fp8_kv=True))
    assert m.runtime == RuntimeConfig(kernel_mode="ref", use_fp8_kv=True)
    assert (m.kernel_mode, m.moe_dispatch) == ("ref", "einsum")
    assert Model(cfg, "auto", "ragged").runtime == RuntimeConfig(moe_dispatch="ragged")
    with pytest.raises(ValueError, match="moe_dispatch"):
        Model(cfg, runtime=RuntimeConfig(moe_dispatch="bogus"))
