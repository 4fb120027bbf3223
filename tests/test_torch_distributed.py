"""The port under a device mesh: gloo worlds of 2-4 ranks on the CPU.

One world of 4 ranks is spawned per module (``distributed.world.run_world``:
the ``spawn`` start method, a ``file://`` rendezvous under ``tmp_path``,
one thread a rank, a time limit on the whole world). It builds the 1x4 mesh
and then the 2x2 mesh over the same ranks and runs every check of each;
the references are computed meanwhile, and the tests then read both. Weights are JAX's
``Model.init`` tree with seeded norms and biases (as in
``test_torch_model.py``), converted to each rank's shards by
``convert.params_from_numpy``.

* ``row_parallel_matmul`` with and without ``rowp_bf16`` against a local
  emulation of each summation order;
* the pool-interleaved decode attention (the paged plain version with its
  log-sum-exp per shard, merged) equal to the replicated one over 4
  shards, rows whose context leaves shards empty included;
* whole models: reduced command-r-35b (meshes 1x4 and 2x2: the gathered
  and the sharded kv-head branches), jamba-1.5-large-398b (2x2) and
  mamba2-2.7b (1x4): ``loss_fn``'s value, the prefill logits and 6 decode
  steps' logits against JAX's single-device ``Model`` on the same weights,
  within ``test_torch_model.py``'s TOL, and against the port's single
  device; command-r's replicated decode layout beside the interleaved one;
* ``chip_smoke.py`` phase 15's runs (``experiments/mesh_probe.py``) at
  the reduced configs: every collective on both meshes, the forced decode,
  arctic's a2a outputs at the tokens routed alike, within the phase's
  limits;
* the all-to-all MoE dispatch on reduced llama4-maverick-400b-a17b at
  capacity factor 8.0 against JAX's single-device einsum dispatch, as
  ``tests/test_sharded.py:96-113`` holds JAX's: the total loss within
  5e-3 (the load-balance term is averaged per shard), the LM loss and the
  logits within TOL.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import RuntimeConfig
from repro_torch.configs.registry import reduced_config
from repro_torch.distributed.world import run_world

torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 1e-2}
PROMPT, STEPS, BATCH, MAX_LEN = 24, 6, 4, 64  # max_len: whole blocks of 16 on 4 shards
WORLD_S = 240.0  # a hung collective fails the world on this clock
# (label, arch, dtype, runtime overrides, capacity factor)
RUNS = {
    "1x4": [("command-r", "command-r-35b", "float32", {}, None),
            ("command-r-bf16", "command-r-35b", "bfloat16", {}, None),
            ("command-r-replicated", "command-r-35b", "float32",
             {"decode_kv": "replicated"}, None),
            ("mamba2", "mamba2-2.7b", "float32", {}, None),
            ("maverick-a2a", "llama4-maverick-400b-a17b", "float32",
             {"moe_dispatch": "a2a"}, 8.0)],
    "2x2": [("command-r", "command-r-35b", "float32", {}, None),
            ("command-r-bf16", "command-r-35b", "bfloat16", {}, None),
            ("jamba", "jamba-1.5-large-398b", "float32", {}, None)],
}
MODELS = [(mesh, r[0]) for mesh, runs in RUNS.items() for r in runs]


def _cfg(arch, dtype, cap):
    from repro.configs.registry import reduced_config as jax_reduced

    out = []
    for c in (jax_reduced(arch), reduced_config(arch)):
        c = dataclasses.replace(c, dtype=dtype)
        if cap is not None:
            c = dataclasses.replace(c, moe=dataclasses.replace(c.moe, capacity_factor=cap))
        out.append(c)
    return out


def _weights(jcfg):
    """JAX's init tree as numpy, norms and biases seeded away from 1 / 0."""
    import jax

    from repro.configs.base import RuntimeConfig as JaxRuntime
    from repro.models import Model as JaxModel

    tree = jax.tree.map(np.asarray, JaxModel(jcfg, JaxRuntime()).init(jax.random.key(0)))
    rng = np.random.default_rng(1)

    def walk(t, path=""):
        out = {}
        for k, v in t.items():
            p = f"{path}/{k}"
            if isinstance(v, dict):
                out[k] = walk(v, p)
            elif "ln" in p or k.startswith("b"):
                base = 1.0 if "ln" in p else 0.0
                noise = rng.normal(scale=0.1, size=v.shape).astype(np.float32)
                out[k] = (base + noise).astype(v.dtype)
            else:
                out[k] = v
        return out

    return walk(tree)


def _tokens():
    return torch.randint(0, 256, (BATCH, PROMPT + STEPS), generator=torch.Generator()
                         .manual_seed(3))


def _drive(model, params, tokens) -> dict:
    """loss_fn, prefill_fn of the prompt, STEPS decode steps fed the
    following tokens: every logit returned, (STEPS + 1, b, V) f32."""
    loss, aux = model.loss_fn(params, {"tokens": tokens, "labels": tokens})
    logits, cache = model.prefill_fn(params, tokens[:, :PROMPT], max_len=MAX_LEN)
    out = [logits[:, 0]]
    for t in range(STEPS):
        pos = torch.full((tokens.shape[0],), PROMPT + t, dtype=torch.int32)
        out.append(model.decode_fn(params, cache, tokens[:, PROMPT + t], pos))
    return {"loss": float(loss), "lm_loss": float(aux["lm_loss"]),
            "logits": torch.stack(out).float()}


# ---------------------------------------------------------------------------
# The ranks' programs (module level: spawned ranks import them by name)
# ---------------------------------------------------------------------------


def _rank_program(rank: int, n: int, meshes: dict) -> dict:
    """Every mesh's checks in turn, over the same 4 ranks."""
    return {label: _mesh_program(tuple(int(x) for x in label.split("x")), *args)
            for label, args in meshes.items()}


def _mesh_program(mesh_shape, runs, trees) -> dict:
    from repro_torch.convert import params_from_numpy
    from repro_torch.distributed.sharding import AxisRules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model

    mesh = make_mesh(mesh_shape, ("data", "model"), timeout_s=WORLD_S)
    out = {"models": {}}
    for (label, arch, dtype, overrides, cap), tree in zip(runs, trees):
        cfg = dataclasses.replace(reduced_config(arch), dtype=dtype)
        if cap is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cap))
        rules = AxisRules.create(mesh)
        model = Model(cfg, runtime=RuntimeConfig(remat="none", **overrides), rules=rules)
        out["models"][label] = _drive(model, params_from_numpy(tree, cfg, "cpu", rules),
                                      _tokens())
    if mesh_shape == (1, 4):
        out["row_parallel"] = _row_parallel(mesh)
        out["interleaved"] = _interleaved(mesh)
    return out


def _row_parallel_inputs():
    g = torch.Generator().manual_seed(11)
    x = torch.randn(2, 5, 64, generator=g).to(torch.bfloat16)
    w = (torch.randn(64, 24, generator=g) * 0.5).to(torch.bfloat16)
    return x, w


def _row_parallel(mesh):
    from repro_torch.distributed.collectives import row_parallel_matmul
    from repro_torch.distributed.sharding import AxisRules

    x, w = _row_parallel_inputs()
    n = x.shape[-1] // mesh.shape["model"]
    r = mesh.axis_index("model")
    xl, wl = x[..., r * n:(r + 1) * n], w[r * n:(r + 1) * n]
    return {flag: row_parallel_matmul(xl, wl, AxisRules.create(mesh, rowp_bf16=flag))
            for flag in (False, True)}


def _interleaved_inputs(dtype):
    g = torch.Generator().manual_seed(12)
    b, s, hq, hkv, d = 4, 64, 8, 2, 32
    q = torch.randn(b, hq, d, generator=g).to(dtype)
    k = torch.randn(b, s, hkv, d, generator=g).to(dtype)
    v = torch.randn(b, s, hkv, d, generator=g).to(dtype)
    # contexts: inside shard 0 only, at a shard's edge, ragged, the whole cache
    ctx = torch.tensor([5, 16, 37, 64], dtype=torch.int32)
    return q, k, v, ctx


def _interleaved(mesh):
    from repro_torch.models.attention import decode_attention_interleaved
    from repro_torch.models.transformer import identity_block_table

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, ctx = _interleaved_inputs(dtype)
        s_loc = k.shape[1] // mesh.shape["model"]
        lo = mesh.axis_index("model") * s_loc
        ks, vs = k[:, lo:lo + s_loc].contiguous(), v[:, lo:lo + s_loc].contiguous()
        table = identity_block_table(q.shape[0], s_loc, "cpu")
        out[str(dtype)] = decode_attention_interleaved(q, ks, vs, ctx, mesh, ("model",),
                                                       table, 16, mode="ref")
    return out


# ---------------------------------------------------------------------------
# The worlds and the references
# ---------------------------------------------------------------------------


def _references(trees: dict) -> dict:
    """JAX's single-device Model (the einsum dispatch where the world runs
    a2a, as JAX's own test compares them) and the port's on the same weights."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import RuntimeConfig as JaxRuntime
    from repro.models import Model as JaxModel
    from repro_torch.convert import params_from_numpy
    from repro_torch.models.model import Model

    out = {}
    tokens = _tokens()
    jt = jnp.asarray(tokens.numpy())
    for mesh, runs in RUNS.items():
        for (label, arch, dtype, overrides, cap), tree in zip(runs, trees[mesh]):
            jcfg, tcfg = _cfg(arch, dtype, cap)
            jm = JaxModel(jcfg, JaxRuntime(remat="none", attn_chunk_q=16, attn_chunk_kv=16,
                                           decode_kv="replicated"))
            jp = jax.tree.map(jnp.asarray, tree)
            loss, aux = jax.jit(jm.loss_fn)(jp, {"tokens": jt, "labels": jt})
            logits, cache = jax.jit(jm.prefill_fn, static_argnames="max_len")(
                jp, {"tokens": jt[:, :PROMPT]}, max_len=MAX_LEN)
            decode = jax.jit(jm.decode_fn)
            steps = [np.asarray(logits[:, 0], np.float32)]
            for t in range(STEPS):
                lg, cache = decode(jp, cache, jt[:, PROMPT + t],
                                   jnp.full((BATCH,), PROMPT + t, jnp.int32))
                steps.append(np.asarray(lg, np.float32))
            jax_ref = {"loss": float(loss), "lm_loss": float(aux["lm_loss"]),
                       "logits": torch.from_numpy(np.stack(steps))}
            port = Model(tcfg, runtime=RuntimeConfig(remat="none", **overrides))
            out[(mesh, label)] = (jax_ref, _drive(port, params_from_numpy(tree, tcfg, "cpu"),
                                                  tokens))
    return out


@pytest.fixture(scope="module")
def world_and_references(tmp_path_factory):
    """The world's results and the references, computed side by side: the
    world runs in its own processes while this one computes the references."""
    from concurrent.futures import ThreadPoolExecutor

    trees = {mesh: [_weights(_cfg(arch, dtype, cap)[0]) for _, arch, dtype, _, cap in runs]
             for mesh, runs in RUNS.items()}
    meshes = {mesh: (RUNS[mesh], trees[mesh]) for mesh in RUNS}
    with ThreadPoolExecutor(1) as pool:
        world = pool.submit(run_world, _rank_program, 4, (meshes,), timeout_s=WORLD_S,
                            workdir=str(tmp_path_factory.mktemp("world")))
        refs = _references(trees)
        got = world.result()
    return {mesh: (RUNS[mesh], trees[mesh], got[mesh]) for mesh in RUNS}, refs


@pytest.fixture(scope="module")
def worlds(world_and_references):
    return world_and_references[0]


@pytest.fixture(scope="module")
def references(world_and_references):
    return world_and_references[1]


def _run(worlds, mesh, label):
    runs, _, got = worlds[mesh]
    dtype = next(r[2] for r in runs if r[0] == label)
    return got["models"][label], TOL[dtype]


@pytest.mark.parametrize("mesh,label", MODELS)
def test_logits_match_jax_single_device(worlds, references, mesh, label):
    got, tol = _run(worlds, mesh, label)
    want = references[(mesh, label)][0]
    np.testing.assert_allclose(got["logits"].numpy(), want["logits"].numpy(), atol=tol,
                               rtol=tol, err_msg=f"{mesh} {label}")


@pytest.mark.parametrize("mesh,label", MODELS)
def test_loss_matches_jax_single_device(worlds, references, mesh, label):
    got, tol = _run(worlds, mesh, label)
    want = references[(mesh, label)][0]
    assert abs(got["lm_loss"] - want["lm_loss"]) <= tol, (got["lm_loss"], want["lm_loss"])
    if "a2a" in label:  # JAX's own bound between its a2a and einsum losses
        assert abs(got["loss"] - want["loss"]) < 5e-3, (got["loss"], want["loss"])
    else:
        assert abs(got["loss"] - want["loss"]) <= tol, (got["loss"], want["loss"])


@pytest.mark.parametrize("mesh,label", MODELS)
def test_matches_port_single_device(worlds, references, mesh, label):
    got, tol = _run(worlds, mesh, label)
    want = references[(mesh, label)][1]
    np.testing.assert_allclose(got["logits"].numpy(), want["logits"].numpy(), atol=tol,
                               rtol=tol, err_msg=f"{mesh} {label}")
    assert abs(got["lm_loss"] - want["lm_loss"]) <= tol


def test_interleaved_decode_layout_equals_replicated(worlds):
    runs, _, got = worlds["1x4"]
    a = got["models"]["command-r"]["logits"]
    b = got["models"]["command-r-replicated"]["logits"]
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_interleaved_attention_equals_replicated(worlds, dtype):
    from repro_torch.models.attention import decode_attention_replicated

    q, k, v, ctx = _interleaved_inputs(dtype)
    want = decode_attention_replicated(q[:, None], k, v, ctx)[:, 0]
    got = worlds["1x4"][2]["interleaved"][str(dtype)]
    assert got.dtype == dtype
    # each shard's partial is rounded to the output dtype before the merge
    tol = 1e-6 if dtype == torch.float32 else 1.6e-2
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=tol, rtol=tol)


def test_row_parallel_matmul_summation_orders(worlds):
    got = worlds["1x4"][2]["row_parallel"]
    x, w = _row_parallel_inputs()
    parts = [x[..., i * 16:(i + 1) * 16].float() @ w[i * 16:(i + 1) * 16].float()
             for i in range(4)]
    exact = sum(parts)
    # f32 partials summed, then one cast (the partitioner's order)
    assert got[False].dtype == torch.bfloat16
    np.testing.assert_allclose(got[False].float().numpy(), exact.to(torch.bfloat16).float()
                               .numpy(), rtol=2 ** -8, atol=1e-6)
    # each partial cast to bf16 before the sum
    rounded = sum(p.to(torch.bfloat16).float() for p in parts)
    np.testing.assert_allclose(got[True].float().numpy(), rounded.numpy(), rtol=2 ** -7,
                               atol=1e-2)
    err_f32 = (got[False].float() - exact).abs().max()
    err_bf16 = (got[True].float() - exact).abs().max()
    assert err_bf16 > err_f32


def test_mesh_probe_runs_phase_15_reduced():
    """Phase 15's plumbing at the reduced configs on the CPU: the same
    references, world, forced decode and readings as on the card."""
    from repro_torch.experiments import mesh_probe

    got = mesh_probe.run(seeds=(0,), cpu=True)[0]
    assert got["collectives_1x4"] == got["collectives_2x2"] == []
    for name in mesh_probe.RUNS:
        r = got[name]
        assert max(r["max_dlogit_per_step"]) <= TOL["bfloat16"], (name, r)
        assert r.get("tokens_equal", True) and r.get("flips", 0) == 0, (name, r)
    assert got["arctic_1x4"]["dropped"] == [0.0] * 4
    assert got["arctic_1x4"]["max_dhidden_alike"] <= TOL["bfloat16"]
