"""The port's Mamba-2 path against the JAX package on the same inputs.

* ``ssd_chunk``: the port's plain version against ``repro.kernels.ref``'s
  oracle and the Pallas kernel in interpret mode, at the shapes and
  tolerances of tests/test_kernels.py:166-177 (f32 2e-4, bf16 5e-2), with B
  and C given per head, group-shaped, and expanded over heads with stride 0.
* ``_ssd_chunked`` against JAX's over several chunks with a padded tail.
* Reduced mamba2-2.7b with the JAX ``Model.init`` weights carried across by
  ``convert.params_from_numpy`` (norms, conv biases and ``D`` first set to
  seeded random values, so that their paths are tested): prefill logits,
  the ``state`` and ``conv`` caches, and 8 decode steps fed the same inputs
  on both sides. float32 within 1e-4 (the largest difference seen was
  2.4e-7). bf16 within 2e-2 (the largest seen was 6.8e-3 on logits up to
  0.46, three bf16 ulps there): the two frameworks round bf16
  intermediates at different points (XLA rounds silu's sigmoid and product
  apart, PyTorch once; matmul outputs after differently ordered f32 sums).
  The f32 SSM state, whose entries are of order 1e-2, is compared relative
  to its largest entry.
* Prefill then decode equals a full forward (tests/test_models.py:101).
* The parameter tree carries across bit for bit, float32 leaves included;
  ``RealEngine`` refuses an SSM stack; the stack layout matches JAX's.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RuntimeConfig
from repro.configs.registry import REGISTRY as JAX_REGISTRY
from repro.configs.registry import reduced_config as jax_reduced_config
from repro.kernels import ops as jops
from repro.models import Model as JaxModel
from repro.models import transformer as jstack
from repro.models.mamba import _ssd_chunked as jax_ssd_chunked
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import transformer as tstack
from repro_torch.models.mamba import _ssd_chunked
from repro_torch.models.model import Model, init_params
from repro_torch.serving.real_runner import RealEngine

# tiny shapes: one intra-op thread is as fast, and more threads would only
# spin against the other test workers, which share the CPU's cores
torch.set_num_threads(1)

ARCH = "mamba2-2.7b"
RT = RuntimeConfig(remat="none", attn_chunk_q=16, attn_chunk_kv=16, decode_kv="replicated")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
PROMPT, STEPS = 70, 8  # 70 tokens: chunks of 32, the last one padded


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor on the CPU."""
    j = jnp.asarray(rng.standard_normal(shape, dtype=np.float32)).astype(dtype)
    return j, tensor_from_numpy(np.asarray(j), "cpu")


# ---------------------------------------------------------------------------
# ssd_chunk: plain version against the oracle and Pallas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nb,lc,nh,hp,n,tile", [(2, 32, 8, 16, 8, 4), (1, 16, 4, 8, 16, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_plain_matches_oracle_and_pallas(nb, lc, nh, hp, n, tile, dtype):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tol = 5e-2 if dtype == "bfloat16" else 2e-4
    rng = np.random.default_rng(nb * 100 + lc)
    jx, tx = _pair(rng, (nb, lc, nh, hp), jdt)
    a = (-np.abs(rng.normal(size=(nb, lc, nh))) * 0.1).astype(np.float32)
    jb, tb = _pair(rng, (nb, lc, nh, n), jdt)
    jc, tc = _pair(rng, (nb, lc, nh, n), jdt)
    ja, ta = jnp.asarray(a), torch.from_numpy(a)
    y, st = ops.ssd_chunk(tx.float(), ta, tb, tc)
    for mode in ("jnp", "pallas"):
        yw, sw = jops.ssd_chunk(jx, ja, jb, jc, nh_tile=tile, mode=mode)
        np.testing.assert_allclose(y.numpy(), np.asarray(yw), atol=tol, rtol=tol)
        np.testing.assert_allclose(st.numpy(), np.asarray(sw), atol=tol, rtol=tol)


def test_ssd_plain_takes_group_shaped_and_stride0_b_c():
    """One group of B/C, as (nb, Lc, 1, n) and expanded over heads with stride
    0, against the oracle fed the materialised per-head broadcast."""
    nb, lc, nh, hp, n = 2, 32, 8, 16, 8
    rng = np.random.default_rng(9)
    jx, tx = _pair(rng, (nb, lc, nh, hp), jnp.float32)
    a = (-np.abs(rng.normal(size=(nb, lc, nh))) * 0.1).astype(np.float32)
    jb, tb = _pair(rng, (nb, lc, 1, n), jnp.float32)
    jc, tc = _pair(rng, (nb, lc, 1, n), jnp.float32)
    wants = jops.ssd_chunk(jx, jnp.asarray(a), jnp.broadcast_to(jb, (nb, lc, nh, n)),
                           jnp.broadcast_to(jc, (nb, lc, nh, n)), nh_tile=4, mode="pallas")
    expanded = (tb.expand(nb, lc, nh, n), tc.expand(nb, lc, nh, n))
    assert expanded[0].stride(2) == 0
    for b, c in ((tb, tc), expanded):
        for got, want in zip(ops.ssd_chunk(tx, torch.from_numpy(a), b, c), wants):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("s,chunk,g", [(100, 32, 1), (64, 16, 2), (33, 32, 1)])
def test_ssd_chunked_matches_jax_with_padded_tail(s, chunk, g):
    b, nh, hp, n = 2, 4, 8, 8
    rng = np.random.default_rng(s + chunk)
    jx, tx = _pair(rng, (b, s, nh, hp), jnp.float32)
    a = (-np.abs(rng.normal(size=(b, s, nh))) * 0.1).astype(np.float32)
    jb, tb = _pair(rng, (b, s, g, n), jnp.float32)
    jc, tc = _pair(rng, (b, s, g, n), jnp.float32)
    yw, sw = jax_ssd_chunked(jx, jnp.asarray(a), jb, jc, chunk=chunk)
    y, st = _ssd_chunked(tx, torch.from_numpy(a), tb, tc, chunk=chunk)
    assert y.shape == (b, s, nh, hp) and st.shape == (b, nh, n, hp)
    np.testing.assert_allclose(y.numpy(), np.asarray(yw), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(sw), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# reduced mamba2-2.7b against the JAX model
# ---------------------------------------------------------------------------

_RANDOMIZED = ("w", "norm_w", "conv_bias_x", "conv_bias_BC", "D")


def _randomize(tree, rng):
    """Norm weights, conv biases and D (init ones/zeros) to seeded values."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k in _RANDOMIZED:
            base = 0.0 if k.startswith("conv_bias") else 1.0
            noise = rng.normal(scale=0.1, size=v.shape).astype(np.float32)
            out[k] = np.asarray(jnp.asarray(base + noise).astype(v.dtype))
        else:
            out[k] = v
    return out


def _setup(dtype):
    jcfg = dataclasses.replace(jax_reduced_config(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(reduced_config(ARCH), dtype=dtype)
    jmodel = JaxModel(jcfg, RT)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0)))
    tree = _randomize(tree, np.random.default_rng(1))
    return jmodel, jax.tree.map(jnp.asarray, tree), tcfg, tree


def _close(got: torch.Tensor, want, tol: float, what: str):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol, err_msg=what
    )


def _close_state(got: torch.Tensor, want, tol: float, what: str):
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max()
    _close(got / scale, want / scale, tol, what)


def _to_port_cache(jcache) -> dict:
    return {k: tensor_from_numpy(np.asarray(jcache["pos_0"][k]), "cpu") for k in ("state", "conv")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_mamba_prefill_caches_and_decode_match_jax(dtype):
    jmodel, jparams, tcfg, tree = _setup(dtype)
    tmodel, tparams = Model(tcfg), params_from_numpy(tree, tcfg, "cpu")
    tol = TOL[dtype]
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 256, size=(2, PROMPT))
    feed = rng.integers(0, 256, size=(STEPS, 2))

    jlogits, jcache = jax.jit(jmodel.prefill_fn)(jparams, {"tokens": jnp.asarray(tokens)})
    tlogits, tcache = tmodel.prefill_fn(tparams, torch.from_numpy(tokens))
    _close(tlogits, jlogits, tol, "prefill logits")
    _close_state(tcache["state"], jcache["pos_0"]["state"], tol, "prefill state")
    _close(tcache["conv"], jcache["pos_0"]["conv"], tol, "prefill conv window")

    # decode continues from the JAX cache on both sides, so each step
    # compares one step's arithmetic on identical inputs
    decode = jax.jit(jmodel.decode_fn)
    for i, tok in enumerate(feed):
        pos = np.full(2, PROMPT + i)
        tcache = _to_port_cache(jcache)
        jl, jcache = decode(jparams, jcache, jnp.asarray(tok, jnp.int32),
                            jnp.asarray(pos, jnp.int32))
        tl = tmodel.decode_fn(tparams, tcache, torch.from_numpy(tok), torch.from_numpy(pos))
        _close(tl, jl, tol, f"decode step {i} logits")
        _close_state(tcache["state"], jcache["pos_0"]["state"], tol, f"decode step {i} state")
        _close(tcache["conv"], jcache["pos_0"]["conv"], tol, f"decode step {i} conv")


def test_reduced_mamba_prefill_then_decode_equals_full_forward():
    """As tests/test_models.py:101 checks JAX: the last logits of a prefill
    of s tokens equal a prefill of s - 1 tokens then one decode step."""
    cfg = reduced_config(ARCH)
    model = Model(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 256, size=(2, 40)))
    want, _ = model.prefill_fn(params, tokens)
    _, cache = model.prefill_fn(params, tokens[:, :-1])
    got = model.decode_fn(params, cache, tokens[:, -1], torch.full((2,), 39))
    rel = (want[:, 0] - got).abs().max() / want.abs().max()
    assert rel < 2e-2, rel


def test_mamba_tree_carries_across_bit_for_bit():
    _, jparams, tcfg, tree = _setup("bfloat16")
    tparams = params_from_numpy(tree, tcfg, "cpu")
    n_f32 = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        t = tparams
        for key in path:
            t = t[key.key]
        arr = np.asarray(leaf)
        if arr.dtype == np.float32:
            n_f32 += 1
            assert t.dtype == torch.float32 and np.array_equal(t.numpy(), arr)
        else:
            assert t.dtype == torch.bfloat16
            assert np.array_equal(t.view(torch.uint16).numpy(), arr.view(np.uint16))
    assert n_f32 == 3  # A_log, D, dt_bias
    # a float32 leaf where bf16 belongs (and the reverse) is refused
    bad = jax.tree.map(lambda a: a, tree)
    bad["stack"]["pos_0"]["ssm"]["A_log"] = bad["stack"]["pos_0"]["ssm"]["A_log"].astype(
        jnp.bfloat16)
    with pytest.raises(ValueError, match="A_log"):
        params_from_numpy(bad, tcfg, "cpu")


def test_init_params_follow_the_ssm_init_rules():
    cfg = reduced_config(ARCH)
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")["stack"]["pos_0"]
    assert set(p) == {"ln1", "ssm"}  # ffn "none": no ln2, no mlp
    ssm = p["ssm"]
    a = torch.exp(ssm["A_log"])
    dt = torch.nn.functional.softplus(ssm["dt_bias"])
    assert ssm["A_log"].dtype == ssm["D"].dtype == ssm["dt_bias"].dtype == torch.float32
    assert ssm["wx"].dtype == torch.bfloat16
    assert a.min() >= 1.0 and a.max() <= 16.0 and a.std() > 1.0
    assert dt.min() >= 1e-3 * 0.999 and dt.max() <= 1e-1 * 1.001
    assert torch.equal(ssm["D"], torch.ones_like(ssm["D"]))


def test_real_engine_refuses_an_ssm_stack():
    with pytest.raises(ValueError, match="period-1 attention stacks only"):
        RealEngine.create(ARCH, device="cpu")


@pytest.mark.parametrize("arch", sorted(JAX_REGISTRY))
def test_stack_layout_matches_jax(arch):
    jcfg, tcfg = JAX_REGISTRY[arch], get_config(arch)
    assert tstack.period_length(tcfg) == jstack.period_length(jcfg)
    assert [(k.mixer, k.ffn) for k in tstack.layer_kinds(tcfg)] == [
        (k.mixer, k.ffn) for k in jstack.layer_kinds(jcfg)
    ]


def test_generate_launcher_runs_reduced_mamba_on_cpu(capsys):
    from repro_torch.launch.generate import main

    out = main(["--reduced", "--device", "cpu", "--prompt-len", "40", "--gen", "4"])
    assert len(out) == 4 and all(0 <= t < 256 for t in out)
    assert "mamba2-2.7b-smoke on cpu" in capsys.readouterr().out
