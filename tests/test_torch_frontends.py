"""The stub frontends in the port's ``Model`` against the JAX ``Model``.

musicgen-large (audio: EnCodec frame embeddings replace the token
embeddings) and internvl2-26b (vision: 8 patch embeddings, in the reduced
config, before the text tokens), reduced, with the JAX ``Model.init`` tree
carried across bit for bit (``params_from_numpy``; norms and biases first
set to seeded values) and the embeddings drawn in bf16 from a numpy seed, as
``tests/test_models.py:23-41`` batches them. The prefill logits, the
collected cache and the logits of 8 decode steps (decode embeds tokens for
both frontends; each step starts from the JAX cache on both sides) are
compared in float32 and bf16, and ``input_specs`` against JAX's shapes and
dtypes for the train, prefill and decode kinds.

Tolerances, as ``tests/test_torch_model.py`` states them: float32 1e-4;
bf16 1e-2 on values of order 1 (the frameworks round bf16 intermediates at
different points).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES
from repro.configs.base import RuntimeConfig as JaxRuntimeConfig
from repro.configs.registry import reduced_config as jax_reduced_config
from repro.models import Model as JaxModel
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import reduced_config
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models.model import Model

torch.set_num_threads(1)

ARCHS = ["musicgen-large", "internvl2-26b"]
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
RT = JaxRuntimeConfig(remat="none", attn_chunk_q=16, attn_chunk_kv=16, decode_kv="replicated")
TEXT, STEPS = 24, 8


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
    return (jmodel, jax.tree.map(jnp.asarray, tree), Model(tcfg),
            params_from_numpy(tree, tcfg, "cpu"))


def _batch(cfg, rng):
    """numpy batch (embeddings bf16 as ``ml_dtypes``) and its sequence length."""
    def embeds(n):
        return rng.standard_normal((1, n, cfg.d_model), dtype=np.float32).astype(
            ml_dtypes.bfloat16)

    if cfg.frontend == "audio_stub":
        return {"frame_embeds": embeds(TEXT)}, TEXT
    npat = cfg.n_frontend_tokens
    return ({"tokens": rng.integers(0, cfg.vocab_size, size=(1, TEXT)).astype(np.int32),
             "patch_embeds": embeds(npat)}, npat + TEXT)


def _close(got: torch.Tensor, want, tol: float, what: str):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol, err_msg=what
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_prefill_and_decode_match_jax(arch, dtype):
    jmodel, jparams, tmodel, tparams = _setup(arch, dtype)
    cfg, tol = tmodel.cfg, TOL[dtype]
    rng = np.random.default_rng(2)
    batch, s = _batch(cfg, rng)
    max_len = -(-(s + STEPS) // 16) * 16
    feed = rng.integers(0, cfg.vocab_size, size=STEPS)

    prefill = jax.jit(jmodel.prefill_fn, static_argnames="max_len")
    decode = jax.jit(jmodel.decode_fn)
    jlogits, jcache = prefill(jparams, {k: jnp.asarray(v) for k, v in batch.items()},
                              max_len=max_len)
    tlogits, tcache = tmodel.prefill_fn(
        tparams, {k: tensor_from_numpy(v, "cpu") for k, v in batch.items()}, max_len=max_len)
    assert tlogits.shape == (1, 1, cfg.padded_vocab)
    _close(tlogits, jlogits, tol, "prefill logits")
    _close(tcache[0], jcache["pos_0"]["k"], tol, "prefill k cache")
    _close(tcache[1], jcache["pos_0"]["v"], tol, "prefill v cache")

    # decode positions count the patches too: a vision decode at TEXT + i
    # would read an empty slot and write over a text token's K/V
    for i, tok in enumerate(feed):
        tcache = tuple(tensor_from_numpy(np.asarray(jcache["pos_0"][n]), "cpu") for n in "kv")
        pos = s + i
        jl, jcache = decode(jparams, jcache, jnp.asarray([tok], jnp.int32),
                            jnp.asarray([pos], jnp.int32))
        tl = tmodel.decode_fn(tparams, tcache, torch.tensor([int(tok)]), torch.tensor([pos]))
        _close(tl, jl, tol, f"decode step {i} logits")
        _close(tcache[0], jcache["pos_0"]["k"], tol, f"decode step {i} k cache")


@pytest.mark.parametrize("arch", ARCHS)
def test_embed_follows_the_frontend(arch):
    """Audio takes the frame embeddings as they are (cast to the model
    dtype); vision puts the patches first, then the text tokens' embeddings;
    positions run over the whole sequence."""
    cfg = dataclasses.replace(reduced_config(arch), dtype="float32")
    model = Model(cfg)
    params = {"embed": {"table": torch.randn(cfg.padded_vocab, cfg.d_model)}}
    tokens = torch.tensor([[3, 1, 4]])
    embeds = torch.randn(1, max(cfg.n_frontend_tokens, 3), cfg.d_model).to(torch.bfloat16)
    if cfg.frontend == "audio_stub":
        x, pos = model.embed(params, {"frame_embeds": embeds})
        assert torch.equal(x, embeds.float())
    else:
        x, pos = model.embed(params, {"tokens": tokens, "patch_embeds": embeds})
        n = cfg.n_frontend_tokens
        assert torch.equal(x[:, :n], embeds.float())
        assert torch.equal(x[:, n:], params["embed"]["table"][tokens])
    assert x.dtype == torch.float32
    assert torch.equal(pos, torch.arange(x.shape[1])[None])


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS + ["llama3.1-8b"])
def test_input_specs_match_jax(arch, shape):
    jcell = SHAPES[shape]
    cell = ShapeConfig(jcell.name, jcell.seq_len, jcell.global_batch, jcell.kind)
    want = JaxModel(jax_reduced_config(arch), RT).input_specs(jcell)
    got = Model(reduced_config(arch)).input_specs(cell)
    assert set(got) == set(want)
    for name, (shp, dt) in got.items():
        assert shp == want[name].shape, name
        assert str(dt).removeprefix("torch.") == str(want[name].dtype), name
    assert cell.is_decode == jcell.is_decode


def test_vision_decode_position_counts_the_patches():
    """A decode step at TEXT (forgetting the patches) gives other logits than
    at patches + TEXT, which the JAX side takes."""
    jmodel, jparams, tmodel, tparams = _setup("internvl2-26b", "float32")
    batch, s = _batch(tmodel.cfg, np.random.default_rng(4))
    _, cache = tmodel.prefill_fn(
        tparams, {k: tensor_from_numpy(v, "cpu") for k, v in batch.items()}, max_len=48)
    _, jcache = jax.jit(jmodel.prefill_fn, static_argnames="max_len")(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, max_len=48)
    jl, _ = jax.jit(jmodel.decode_fn)(jparams, jcache, jnp.asarray([5], jnp.int32),
                                      jnp.asarray([s], jnp.int32))
    right = tmodel.decode_fn(tparams, tuple(t.clone() for t in cache), torch.tensor([5]),
                             torch.tensor([s]))
    wrong = tmodel.decode_fn(tparams, tuple(t.clone() for t in cache), torch.tensor([5]),
                             torch.tensor([TEXT]))
    _close(right, jl, 1e-4, "decode at patches + text")
    assert (wrong - right).abs().max().item() > 1e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_real_engine_refuses_a_frontend(arch):
    """The engine's prompts are tokens; JAX's engine fails at its first
    prefill (``KeyError``), the port's at ``create``."""
    from repro_torch.serving.real_runner import RealEngine

    with pytest.raises(ValueError, match="frontend"):
        RealEngine.create(reduced_config(arch), max_len=64, pool_blocks=8, device="cpu")
