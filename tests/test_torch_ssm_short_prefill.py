"""An SSM prefill shorter than the conv window, then decode, on the CPU.

``mamba_apply`` hands decode the last d_conv - 1 pre-conv inputs as the
conv window. A prompt of 1 or 2 tokens has fewer than d_conv - 1 = 3, and
the window must then be the one ``_causal_conv`` itself saw: zeros before
the first token. (JAX cannot decode after such a prefill at all: its
window keeps s rows and ``mamba_decode`` fails to broadcast it.) The
reference is JAX's full forward, which runs at any length: on reduced
Mamba-2 and Jamba built by the JAX ``Model.init`` and carried across by
``convert.params_from_numpy``, the port's logits after a prefill of s
tokens and one decode step equal the last logits of JAX's prefill of the
s + 1 tokens, for s of 1, 2 and 3, in float32 within 1e-4 (as
tests/test_torch_hybrid.py holds the two frameworks). The port is also held
against itself the same way (its own prefill of s + 1 tokens), at 1e-4 of
the largest logit. Jamba's MoE capacity factor is 8.0 on both sides so that
no (token, expert) pair drops in either call. The generate launcher reaches
the same path with ``--prompt-len 1``.
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
from repro_torch.convert import params_from_numpy
from repro_torch.models.model import Model, init_params

# tiny shapes: one intra-op thread is as fast, and more threads would only
# spin against the other test workers, which share the CPU's cores
torch.set_num_threads(1)

ARCHS = ["mamba2-2.7b", "jamba-1.5-large-398b"]


def _no_drops(cfg):
    """``cfg`` in float32 with the MoE capacity factor at 8.0 (no drops)."""
    cfg = dataclasses.replace(cfg, dtype="float32")
    if cfg.moe.enabled:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    return cfg


def _model(arch: str):
    cfg = _no_drops(reduced_config(arch))
    return cfg, Model(cfg), init_params(cfg, torch.Generator().manual_seed(1), "cpu")


@pytest.mark.parametrize("s", [1, 2, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_a_short_prefill_matches_jax_full_forward(arch, s):
    jcfg = _no_drops(jax_reduced_config(arch))
    jmodel = JaxModel(jcfg, RuntimeConfig(remat="none", attn_chunk_q=16, attn_chunk_kv=16,
                                          decode_kv="replicated"))
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0)))
    tcfg = _no_drops(reduced_config(arch))
    params = params_from_numpy(tree, tcfg, "cpu")
    tokens = np.random.default_rng(3).integers(0, 256, size=(2, s + 1))
    want, _ = jmodel.prefill_fn(jax.tree.map(jnp.asarray, tree),
                                {"tokens": jnp.asarray(tokens, jnp.int32)}, max_len=16)
    model = Model(tcfg)
    _, cache = model.prefill_fn(params, torch.from_numpy(tokens[:, :-1]), max_len=16)
    got = model.decode_fn(params, cache, torch.from_numpy(tokens[:, -1]), torch.full((2,), s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32)[:, 0],
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("s", [1, 2, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_a_short_prefill_equals_the_full_forward(arch, s):
    """The port against its own prefill of s + 1 tokens."""
    cfg, model, params = _model(arch)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 256, size=(2, s + 1)))
    want, _ = model.prefill_fn(params, tokens, max_len=16)
    _, cache = model.prefill_fn(params, tokens[:, :-1], max_len=16)
    got = model.decode_fn(params, cache, tokens[:, -1], torch.full((2,), s))
    rel = ((want[:, 0] - got).abs().max() / want.abs().max()).item()
    assert rel < 1e-4, rel


@pytest.mark.parametrize("arch", ARCHS)
def test_short_prefill_leaves_a_full_zero_padded_conv_window(arch):
    """After one token, the window holds zeros for the two positions before
    the prompt and the token's own pre-conv input last: nothing repeated."""
    cfg, model, params = _model(arch)
    _, cache = model.prefill_fn(params, torch.tensor([[7]]), max_len=16)
    convs = [c["conv"] for c in (cache if isinstance(cache, list) else [cache])
             if isinstance(c, dict) and "conv" in c]
    if not convs:  # the hybrid's per-position tree
        convs = [pos["conv"] for pos in cache.values() if "conv" in pos]
    assert convs
    for conv in convs:
        conv = conv.reshape(-1, *conv.shape[-2:])[0]  # (d_conv - 1, conv_dim) of the row
        assert conv.shape[0] == cfg.ssm.d_conv - 1
        assert not conv[:-1].any() and conv[-1].abs().sum() > 0


def test_generate_launcher_with_a_one_token_prompt_decodes_as_full_prefills():
    """``launch/generate.py --prompt-len 1`` greedy-decodes from the short
    prefill's state; each of its tokens equals the argmax of a full prefill
    of the prompt and the tokens before it (the launcher's weights and
    prompt, rebuilt from its seeds)."""
    from repro_torch.launch.generate import main

    arch = "mamba2-2.7b"
    out = main(["--arch", arch, "--reduced", "--device", "cpu", "--prompt-len", "1",
                "--gen", "4"])
    cfg = reduced_config(arch)
    model = Model(cfg)
    params = init_params(cfg, torch.Generator(device="cpu").manual_seed(0), "cpu")
    seq = torch.randint(0, cfg.vocab_size, (1, 1), generator=torch.Generator().manual_seed(1))
    want = []
    for _ in range(4):
        logits, _ = model.prefill_fn(params, seq, max_len=16)
        want.append(int(logits[0, 0].argmax()))
        seq = torch.cat([seq, torch.tensor([[want[-1]]])], dim=1)
    assert out == want
