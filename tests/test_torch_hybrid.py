"""MoE stacks and Jamba's hybrid period in the port, against the JAX package.

* ``Model`` on reduced jamba-1.5-large-398b (one 8-layer period: Mamba-2 at
  positions 0-6, attention at 7, MoE FFNs at the odd positions), arctic-480b
  (MoE with the dense residual) and llama4-maverick-400b-a17b (top-1 MoE),
  with the JAX ``Model.init`` tree carried across by
  ``convert.params_from_numpy`` (norms and biases first set to seeded random
  values): prefill logits, the collected cache position by position, and 8
  decode steps fed the same inputs on both sides, through the einsum
  dispatch in both dtypes and the ragged one in float32. float32 within
  1e-4; bf16 within the TOL of the file each mirrors: 1e-2 for the attention
  stacks (tests/test_torch_model.py), 2e-2 for Jamba, whose Mamba-2 layers
  round bf16 as tests/test_torch_mamba.py says. SSM states are compared
  relative to their largest entry. The bf16 runs print the smallest top-k
  margin of the router that the port's prefill met: a routing flip between
  the frameworks below that margin would show as a logit difference here,
  and none does at these seeds.
* ``RealEngine`` on reduced Arctic and Maverick against the JAX
  ``RealEngine(kernel_mode="jnp")``: cold, full-hit and partial-hit
  requests give the same hit counts and per-step logits within 1e-2
  (tests/test_torch_engine.py); it still refuses Jamba, as JAX asserts.
* The MoE and Jamba trees carry across bit for bit (the float32 router and
  SSM leaves included); ``init_params`` draws an expert leaf one (layer,
  expert) at a time.
* Jamba's prefill then decode equals a prefill of one more token at a
  capacity factor of 8.0, as tests/test_models.py:104-108 runs it: at the
  default factor the prefill may drop the last token's expert pair, which
  a one-token decode (capacity 4) never drops.
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
from repro.models import moe as jmoe
from repro.serving.real_runner import RealEngine as JaxRealEngine
from repro_torch.configs.registry import reduced_config
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models import transformer as tstack
from repro_torch.models.model import Model, init_params, param_shapes
from repro_torch.serving.real_runner import RealEngine

# tiny shapes: one intra-op thread is as fast, and more threads would only
# spin against the other test workers, which share the CPU's cores
torch.set_num_threads(1)

JAMBA, ARCTIC, MAVERICK = "jamba-1.5-large-398b", "arctic-480b", "llama4-maverick-400b-a17b"
TOL = {
    JAMBA: {"float32": 1e-4, "bfloat16": 2e-2},
    ARCTIC: {"float32": 1e-4, "bfloat16": 1e-2},
    MAVERICK: {"float32": 1e-4, "bfloat16": 1e-2},
}
ENGINE_TOL, MAX_NEW = 1e-2, 8
PROMPT, MAX_LEN, STEPS = 24, 32, 8


def _randomize_norms_and_biases(tree, rng, path=""):
    """Norm weights, biases, conv biases and D (init ones/zeros) to seeded values."""
    out = {}
    for k, v in tree.items():
        p = f"{path}/{k}"
        if isinstance(v, dict):
            out[k] = _randomize_norms_and_biases(v, rng, p)
        elif "ln" in p or k.startswith(("b", "conv_bias")) or k in ("norm_w", "D"):
            noise = rng.normal(scale=0.1, size=v.shape).astype(np.float32)
            base = 0.0 if k.startswith(("b", "conv_bias")) else 1.0
            out[k] = np.asarray(jnp.asarray(base + noise).astype(v.dtype))
        else:
            out[k] = v
    return out


def _setup(arch: str, dtype: str, dispatch: str = "einsum"):
    jcfg = dataclasses.replace(jax_reduced_config(arch), dtype=dtype)
    tcfg = dataclasses.replace(reduced_config(arch), dtype=dtype)
    rt = RuntimeConfig(remat="none", attn_chunk_q=16, attn_chunk_kv=16,
                       decode_kv="replicated", moe_dispatch=dispatch)
    jmodel = JaxModel(jcfg, rt)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0)))
    tree = _randomize_norms_and_biases(tree, np.random.default_rng(1))
    return (jmodel, jax.tree.map(jnp.asarray, tree), tree,
            Model(tcfg, moe_dispatch=dispatch), params_from_numpy(tree, tcfg, "cpu"))


def _close(got: torch.Tensor, want, tol: float, what: str):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol, err_msg=what
    )


def _close_position(got: dict, want: dict, tol: float, what: str):
    for name, t in got.items():
        w = np.asarray(want[name], np.float32)
        if name == "state":  # entries of order 1e-2: relative to the largest
            err = np.abs(t.float().numpy() - w).max() / np.abs(w).max()
            assert err <= tol, (what, name, err)
        else:
            _close(t, w, tol, f"{what} {name}")


def _port_cache(jcache: dict, kinds):
    """The JAX cache tree as the port's cache of the same stack."""
    tree = {p: {n: tensor_from_numpy(np.asarray(a), "cpu") for n, a in c.items()}
            for p, c in jcache.items()}
    if len(kinds) > 1:
        return tree
    only = tree["pos_0"]
    return (only["k"], only["v"]) if kinds[0].mixer == "attn" else only


def _recording_jax_moe(monkeypatch) -> list:
    """JAX's MoE layers, each also recording its router probabilities and
    choices (``moe.py:70-72``) in layer order, as the port's aux holds them."""
    log = []
    apply = jmoe.moe_apply

    def recording(p, x, cfg, runtime, rules):
        xt = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
        probs = jax.nn.softmax((xt @ p["router"]).astype(jnp.float32), axis=-1)
        jax.debug.callback(lambda pr, te: log.append((np.asarray(pr), np.asarray(te))),
                           probs, jax.lax.top_k(probs, cfg.moe.top_k)[1], ordered=True)
        return apply(p, x, cfg, runtime, rules)

    monkeypatch.setattr(jmoe, "moe_apply", recording)
    return log


def _flips(jlog: list, aux: list, dtype: str, tol: float, what: str) -> list:
    """Tokens whose sets of chosen experts differ between the frameworks,
    per MoE layer. Each must be a flip below the noise: the two top-k candidates'
    order turned on a gap (the port's margin there) no larger than twice the
    difference of the two frameworks' probabilities, which stays within
    the file's tolerance; and only in bf16."""
    jax.effects_barrier()
    assert len(jlog) == len(aux), what
    flips = []
    for layer, ((jprobs, jtop), a) in enumerate(zip(jlog, aux)):
        # the chosen sets: an order swapped within a token's k routes alike
        rows = np.flatnonzero((np.sort(a["top_e"].numpy(), -1) != np.sort(jtop, -1)).any(-1))
        if not len(rows):
            continue
        k = jtop.shape[-1]
        ranked = a["probs"].sort(-1, descending=True).values.numpy()[rows]
        margin = (ranked[:, k - 1] - ranked[:, k]).max()
        noise = np.abs(a["probs"].numpy()[rows] - jprobs[rows]).max()
        print(f"{what}: routing flip in MoE layer {layer}, tokens {rows.tolist()}: port "
              f"{a['top_e'].numpy()[rows].tolist()}, JAX {jtop[rows].tolist()}, gap "
              f"{margin:.3g} <= 2 x probability noise {noise:.3g}")
        assert dtype == "bfloat16" and margin <= 2 * noise <= 2 * tol, what
        flips.append((layer, rows.tolist()))
    return flips


def _check_against_jax(monkeypatch, arch: str, dtype: str, dispatch: str):
    """Prefill and 8 decode steps on both sides; a point where a routing
    choice flipped below the noise (``_flips``) is reported, its outputs
    not compared, and at most one of the nine points may flip."""
    jlog = _recording_jax_moe(monkeypatch)
    jmodel, jparams, _, tmodel, tparams = _setup(arch, dtype, dispatch)
    tol = TOL[arch][dtype]
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 256, size=(1, PROMPT))
    feed = rng.integers(0, 256, size=STEPS)

    prefill = jax.jit(jmodel.prefill_fn, static_argnames="max_len")
    decode = jax.jit(jmodel.decode_fn)
    jlogits, jcache = prefill(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
                              max_len=MAX_LEN)
    aux = []
    tlogits, tcache = tmodel.prefill_fn(tparams, torch.from_numpy(tokens), max_len=MAX_LEN,
                                        aux=aux)
    kinds = tstack.layer_kinds(tmodel.cfg)
    n_moe = sum(k.ffn == "moe" for k in kinds) * tstack.n_periods(tmodel.cfg)
    assert len(aux) == n_moe and all(float(a["margin"]) >= 0 for a in aux)
    print(f"{arch} {dtype} {dispatch}: smallest top-k router margin in prefill "
          f"{min(float(a['margin']) for a in aux):.3g}, dropped pairs per MoE layer "
          f"{[int(a['dropped']) for a in aux]}")
    flipped = []
    if _flips(jlog, aux, dtype, tol, "prefill"):
        flipped.append("prefill")
    else:
        _close(tlogits, jlogits, tol, "prefill logits")
        for j, c in enumerate(tstack.position_caches(tcache, kinds)):
            _close_position(c, jcache[f"pos_{j}"], tol, f"prefill cache pos_{j}")

    # decode continues from the JAX cache on both sides, so each step
    # compares one step's arithmetic on identical inputs
    for i, tok in enumerate(feed):
        pos = PROMPT + i
        tcache = _port_cache(jcache, kinds)
        jlog.clear()
        jl, jcache = decode(jparams, jcache, jnp.asarray([tok], jnp.int32),
                            jnp.asarray([pos], jnp.int32))
        aux = []
        tl = tmodel.decode_fn(tparams, tcache, torch.tensor([int(tok)]), torch.tensor([pos]),
                              aux=aux)
        if _flips(jlog, aux, dtype, tol, f"decode step {i}"):
            flipped.append(f"decode step {i}")
            continue
        _close(tl, jl, tol, f"decode step {i} logits")
        for j, c in enumerate(tstack.position_caches(tcache, kinds)):
            _close_position(c, jcache[f"pos_{j}"], tol, f"decode step {i} cache pos_{j}")
    assert len(flipped) <= 1, flipped


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [JAMBA, ARCTIC, MAVERICK])
def test_prefill_cache_and_decode_match_jax(monkeypatch, arch, dtype):
    _check_against_jax(monkeypatch, arch, dtype, "einsum")


@pytest.mark.parametrize("arch", [JAMBA, ARCTIC, MAVERICK])
def test_ragged_dispatch_model_matches_jax(monkeypatch, arch):
    _check_against_jax(monkeypatch, arch, "float32", "ragged")


@pytest.mark.parametrize("arch", [JAMBA, ARCTIC])
def test_moe_and_hybrid_trees_carry_across_bit_for_bit(arch):
    _, jparams, _, _, tparams = _setup(arch, "bfloat16")
    dtypes = set()
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        t = tparams
        for key in path:
            t = t[key.key]
        want = np.asarray(leaf)
        if want.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            assert np.array_equal(t.view(torch.uint16).numpy(), want.view(np.uint16))
        else:
            assert t.dtype == torch.float32 and np.array_equal(t.numpy(), want)
        dtypes.add((path[-1].key, str(t.dtype)))
    assert ("router", "torch.float32") in dtypes and ("wi_gate", "torch.bfloat16") in dtypes
    if arch == JAMBA:
        assert {("A_log", "torch.float32"), ("wq", "torch.bfloat16")} <= dtypes


def test_param_shapes_cover_every_position_of_jamba():
    _, _, tree, _, _ = _setup(JAMBA, "bfloat16")
    shapes = param_shapes(reduced_config(JAMBA))
    assert sorted(shapes["stack"]) == sorted(tree["stack"]) == [f"pos_{i}" for i in range(8)]
    assert set(shapes["stack"]["pos_1"]) == {"ln1", "ssm", "ln2", "moe"}
    assert set(shapes["stack"]["pos_6"]) == {"ln1", "ssm", "ln2", "mlp"}
    assert set(shapes["stack"]["pos_7"]) == {"ln1", "attn", "ln2", "moe"}
    with pytest.raises(ValueError, match="router"):
        bad = dict(tree, stack=dict(tree["stack"], pos_1=dict(
            tree["stack"]["pos_1"], moe=dict(tree["stack"]["pos_1"]["moe"],
                                             router=tree["stack"]["pos_1"]["moe"]["router"]
                                             .astype(jnp.bfloat16)))))
        params_from_numpy(bad, reduced_config(JAMBA), "cpu")


def test_init_draws_one_layer_expert_at_a_time(monkeypatch):
    cfg = reduced_config(ARCTIC)
    drawn = []
    randn = torch.randn

    def recording_randn(shape, **kw):
        drawn.append(tuple(shape))
        return randn(shape, **kw)

    monkeypatch.setattr(torch, "randn", recording_randn)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    d, f, e, L = cfg.d_model, cfg.d_ff, cfg.moe.n_experts, cfg.n_layers
    moe_p = params["stack"]["pos_0"]["moe"]
    assert moe_p["router"].dtype == torch.float32 and moe_p["wi_gate"].dtype == torch.bfloat16
    assert drawn.count((d, f)) == 2 * L * e  # wi_gate and wi_up, per (layer, expert)
    assert drawn.count((f, d)) == L * e
    assert drawn.count((d, e)) == L  # the router, per layer
    assert (e, d, f) not in drawn and (L, e, d, f) not in drawn
    assert not torch.equal(moe_p["wi_gate"][0, 0], moe_p["wi_gate"][0, 1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jamba_prefill_then_decode_equals_full_forward(dtype):
    cfg = dataclasses.replace(reduced_config(JAMBA), dtype=dtype)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    model = Model(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 256, size=(2, 40)))
    want, _ = model.prefill_fn(params, tokens, max_len=48)
    _, cache = model.prefill_fn(params, tokens[:, :-1], max_len=48)
    got = model.decode_fn(params, cache, tokens[:, -1], torch.full((2,), 39))
    rel = ((want[:, 0] - got).abs().max() / want.abs().max()).item()
    assert rel < {"float32": 1e-4, "bfloat16": 2e-2}[dtype], rel


def test_real_engine_refuses_the_hybrid():
    with pytest.raises(AssertionError, match="homogeneous"):
        JaxRealEngine.create(JAMBA)
    with pytest.raises(ValueError, match="period-1 attention stacks only"):
        RealEngine.create(reduced_config(JAMBA), device="cpu")


def test_launchers_run_reduced_arctic_and_jamba_on_cpu(capsys):
    from repro_torch.launch.generate import main as generate
    from repro_torch.launch.serve import main as serve

    out = generate(["--arch", JAMBA, "--reduced", "--device", "cpu", "--prompt-len", "40",
                    "--gen", "4"])
    assert len(out) == 4 and all(0 <= t < 256 for t in out)
    serve(["--arch", ARCTIC, "--reduced", "--device", "cpu", "--prompt-len", "32", "--gen", "4",
           "--requests", "2"])
    text = capsys.readouterr().out
    assert "jamba-1.5-large-398b-smoke on cpu" in text
    assert "req 1: hit 16/32" in text and "req 2: hit 32/32" in text


# ---------------------------------------------------------------------------
# RealEngine on MoE stacks
# ---------------------------------------------------------------------------


def _recording_jax_engine(arch: str):
    """A JAX engine whose prefill and decode calls record their logits."""
    eng = JaxRealEngine.create(arch, max_len=96, pool_blocks=64, kernel_mode="jnp")
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


@pytest.mark.parametrize("arch", [ARCTIC, MAVERICK])
def test_real_engine_serves_moe_like_jax(arch):
    jeng, log = _recording_jax_engine(arch)
    cfg = reduced_config(arch)
    teng = RealEngine.create(cfg, max_len=96, pool_blocks=64, device="cpu",
                             params=params_from_numpy(jax.tree.map(np.asarray, jeng.params),
                                                      cfg, "cpu"))
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, size=48).tolist()
    partial = prompt[:32] + rng.integers(0, cfg.vocab_size, size=20).tolist()
    for p, want_hit in ((prompt, 0), (prompt, 48), (partial, 32)):
        n_before = len(log)
        jt, ji = jeng.generate(p, max_new=MAX_NEW)
        tt, ti = teng.generate(p, max_new=MAX_NEW)
        assert ji["hit_tokens"] == ti["hit_tokens"] == want_hit
        jlog = np.stack(log[n_before:][-len(jt):])
        n = _steps_to_compare(jt, tt)
        np.testing.assert_allclose(ti["logits"][:n].numpy(), jlog[:n],
                                   atol=ENGINE_TOL, rtol=ENGINE_TOL)
    assert [b for _, b, _ in teng.index.match_prefix(prompt)] == [
        b for _, b, _ in jeng.index.match_prefix(prompt)]
