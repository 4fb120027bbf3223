"""The port's model against the JAX ``Model`` with the same weights.

The JAX ``Model.init`` tree is carried across bit for bit with
``repro_torch.convert.params_from_numpy``; norms and biases are first set
to seeded random values (their init is ones/zeros, which would leave the
qkv-bias and norm-weight paths untested). Prefill logits, the collected
KV cache and the logits of 8 decode steps (fed the same tokens on both
sides) are compared on reduced configs: llama3.1-8b (GQA), olmo-1b
(non-parametric norm, tied embeddings) and qwen1.5-0.5b (qkv bias).

Tolerances: float32 configs 1e-4 (the largest difference seen was 2.1e-7).
bf16 configs 1e-2 on values of order 1 (the largest seen was 3.9e-3, one
bf16 ulp at 1): the two frameworks round bf16 intermediates at different
points (JAX's chunked prefill attention rounds p and q*scale to bf16, the
port's plain flash attention does not; XLA and PyTorch CPU matmuls round
their bf16 outputs after differently ordered f32 sums).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RuntimeConfig
from repro.configs.registry import reduced_config as jax_reduced_config
from repro.models import Model as JaxModel
from repro_torch.configs.registry import reduced_config
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models.model import Model

# tiny shapes: one intra-op thread is as fast, and more threads would only
# spin against the other test workers, which share the CPU's cores
torch.set_num_threads(1)

ARCHS = ["llama3.1-8b", "olmo-1b", "qwen1.5-0.5b"]
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
RT = RuntimeConfig(remat="none", attn_chunk_q=16, attn_chunk_kv=16, decode_kv="replicated")
PROMPT, MAX_LEN, STEPS = 24, 32, 8


def _randomize_norms_and_biases(tree, rng, path=""):
    out = {}
    for k, v in tree.items():
        p = f"{path}/{k}"
        if isinstance(v, dict):
            out[k] = _randomize_norms_and_biases(v, rng, p)
        elif "ln" in p or k.startswith("b"):
            noise = rng.normal(scale=0.1, size=v.shape).astype(np.float32)
            base = 1.0 if "ln" in p else 0.0
            out[k] = np.asarray(jnp.asarray(base + noise).astype(v.dtype))
        else:
            out[k] = v
    return out


def _setup(arch, dtype):
    jcfg = dataclasses.replace(jax_reduced_config(arch), dtype=dtype)
    tcfg = dataclasses.replace(reduced_config(arch), dtype=dtype)
    jmodel = JaxModel(jcfg, RT)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0)))
    tree = _randomize_norms_and_biases(tree, np.random.default_rng(1))
    jparams = jax.tree.map(jnp.asarray, tree)
    return jmodel, jparams, Model(tcfg, kernel_mode="auto"), params_from_numpy(tree, tcfg, "cpu")


def _close(got: torch.Tensor, want, tol: float, what: str):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol, err_msg=what
    )


def test_params_carry_across_bit_for_bit():
    _, jparams, _, tparams = _setup("qwen1.5-0.5b", "bfloat16")
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        t = tparams
        for key in path:
            t = t[key.key]
        assert t.dtype == torch.bfloat16
        assert np.array_equal(t.view(torch.uint16).numpy(), np.asarray(leaf).view(np.uint16))


def test_convert_rejects_a_wrong_tree():
    cfg = reduced_config("llama3.1-8b")
    jtree = jax.tree.map(np.asarray, JaxModel(jax_reduced_config("llama3.1-8b"), RT).init(
        jax.random.key(0)))
    bad = dict(jtree, final_ln={})
    with pytest.raises(ValueError, match="final_ln"):
        params_from_numpy(bad, cfg, "cpu")
    with pytest.raises(ValueError, match="want"):
        params_from_numpy(jtree, dataclasses.replace(cfg, dtype="float32"), "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_and_decode_match_jax(arch, dtype):
    jmodel, jparams, tmodel, tparams = _setup(arch, dtype)
    tol = TOL[dtype]
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 256, size=(1, PROMPT))
    feed = rng.integers(0, 256, size=STEPS)

    prefill = jax.jit(jmodel.prefill_fn, static_argnames="max_len")
    decode = jax.jit(jmodel.decode_fn)
    jlogits, jcache = prefill(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
                              max_len=MAX_LEN)
    tlogits, tcache = tmodel.prefill_fn(tparams, torch.from_numpy(tokens), max_len=MAX_LEN)
    _close(tlogits, jlogits, tol, "prefill logits")
    _close(tcache[0], jcache["pos_0"]["k"], tol, "prefill k cache")
    _close(tcache[1], jcache["pos_0"]["v"], tol, "prefill v cache")

    # decode continues from the JAX cache on both sides, so each step
    # compares one step's arithmetic on identical inputs
    tcache = tuple(tensor_from_numpy(np.asarray(jcache["pos_0"][n]), "cpu") for n in "kv")
    for i, tok in enumerate(feed):
        pos = PROMPT + i
        jl, jcache = decode(
            jparams, jcache, jnp.asarray([tok], jnp.int32), jnp.asarray([pos], jnp.int32)
        )
        tl = tmodel.decode_fn(
            tparams, tcache, torch.tensor([int(tok)]), torch.tensor([pos])
        )
        _close(tl, jl, tol, f"decode step {i} logits")
        tcache = tuple(tensor_from_numpy(np.asarray(jcache["pos_0"][n]), "cpu") for n in "kv")
