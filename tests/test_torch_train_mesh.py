"""Training under a device mesh against one device: a gloo world of 4 ranks on the CPU.

One world of 4 ranks is spawned per module (``distributed.world.run_world``)
and builds the 1x4 mesh and then the 2x2 mesh over the same ranks; the
references are computed meanwhile in this process. Weights are JAX's
``Model.init`` tree with seeded norms and biases, float32, carried to each
rank's shards by ``convert.params_from_numpy``. Every rank's result is
reassembled here from the ranks' shards (a leaf replicated over some axes
must come back the same from every replica, bit for bit).

* (b) ``loss_fn``'s gradient on every leaf under ``Model(rules=...)``
  (``train_loop.value_and_grad``: the collectives' backwards, a 1 / world
  seed, the replicated leaves summed) for reduced olmo-1b (tied, vocab-
  sharded embedding reached through the embedding's and the head's
  collectives), command-r-35b (norm weights; GQA, whose kv heads are
  gathered at 1x4 and sharded at 2x2) and mamba2-2.7b (the SSM's
  replicated and sharded leaves), ``remat="full"``, on 1x4 and 2x2: against
  JAX's single-device ``jax.value_and_grad(loss_fn)`` and against the
  port's one device; no c10d autograd warning on the way;
* (c) ``make_train_step`` under each mesh for AdamW with gradient
  compression none and bf16 and ``accum_steps`` 1 and 2, 3 steps, against
  JAX's one-device step on loss, grad norm, lr, the weights and moments;
  and for command-r-35b and mamba2-2.7b, whose replicated leaves take both
  stages of the gradient sum (over ``model`` in f32, then over ``data``):
  bf16 compression at 1x4; at 2x2 none, and bf16 (the sum over ``data`` in
  bf16, a rounding JAX's one device does not make) for one step within
  ``TOL["bfloat16"]``;
* (e) the checkpoint: the 1x4 world trains 2 steps of ``run_train_loop``
  saving step 2 (one ``proc_<rank>.npz`` of shards each); JAX's
  ``Checkpointer`` and the port's one device restore it equal to the ranks'
  shards bit for bit; the 2x2 world resumes it (its shards cut from the
  1x4 world's) and trains on to step 4, ending equal to an unbroken
  one-device run;
* (f) ``launch/train.py --mesh 2x2 --smoke --device cpu`` against 1x1.

Tolerances are ``test_torch_training.py``'s: the loss within 1e-5, each
gradient leaf within 1e-4 of its largest entry, the step's metrics within
1e-5 relative, the weights within 1e-6 but where a near-zero gradient of
another sign moves a weight by up to 2 lr a step (those are counted, at most
0.1 % of the weights), the moments within 1e-4 of each leaf's largest entry
or, with bf16 compression, one bf16 step (2**-8); the bf16 launcher run
within ``TOL["bfloat16"]`` = 1e-2.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RuntimeConfig as JaxRuntime
from repro.configs.registry import reduced_config as jax_reduced_config
from repro.data import pipeline as jpipe
from repro.models import Model as JaxModel
from repro.training import optimizer as jopt
from repro.training import train_loop as jloop
from repro_torch.configs.base import RuntimeConfig
from repro_torch.configs.registry import reduced_config
from repro_torch.convert import params_from_numpy
from repro_torch.distributed.world import run_world
from repro_torch.models.model import Model
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as tloop

torch.set_num_threads(1)

WORLD_S = 240.0
MESHES = ("1x4", "2x2")
ARCHS = ["olmo-1b", "command-r-35b", "mamba2-2.7b"]
B, S, STEPS = 4, 32, 3
STEP_CASES = [(c, a) for c in ("none", "bf16") for a in (1, 2)]
# configs with leaves replicated over `model` (norm weights, biases, the SSM's
# A_log, D, dt_bias): their gradient is summed over `model` in f32 and over
# `data` in bf16, as JAX rounds it once before its DP sum
REPLICATED_ARCHS = ["command-r-35b", "mamba2-2.7b"]
# (arch, compression, accum_steps, steps)
STEP_RUNS = [("olmo-1b", c, a, STEPS) for c, a in STEP_CASES] + [
    run for arch in REPLICATED_ARCHS
    for run in ((arch, "bf16", 1, STEPS), (arch, "none", 1, STEPS), (arch, "bf16", 1, 1))]
JAX_RT = JaxRuntime(remat="none", attn_chunk_q=16, attn_chunk_kv=16)
LOSS_TOL, GRAD_TOL, STEP_TOL, PARAM_TOL = 1e-5, 1e-4, 1e-5, 1e-6
BF16_STEP = 2.0**-8
FLIP_SHARE = 1e-3
BF16_TOL = 1e-2
OPT = dict(name="adamw", warmup_steps=2, total_steps=50)


def _shape(label: str) -> tuple[int, int]:
    return tuple(int(x) for x in label.split("x"))


def _tree(arch: str) -> dict:
    """JAX's float32 init tree as numpy, norms and biases seeded away from 1 / 0."""
    jcfg = dataclasses.replace(jax_reduced_config(arch), dtype="float32")
    tree = jax.tree.map(np.asarray, JaxModel(jcfg, JAX_RT).init(jax.random.key(0)))
    rng = np.random.default_rng(1)

    def walk(t, path=""):
        out = {}
        for k, v in t.items():
            p = f"{path}/{k}"
            if isinstance(v, dict):
                out[k] = walk(v, p)
            elif "ln" in p or k.startswith("b"):
                noise = rng.normal(scale=0.1, size=v.shape).astype(np.float32)
                out[k] = ((1.0 if "ln" in p else 0.0) + noise).astype(v.dtype)
            else:
                out[k] = v
        return out

    return walk(tree)


def _tcfg(arch: str):
    return dataclasses.replace(reduced_config(arch), dtype="float32")


def _batch(cfg, seed: int = 2) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


def _data_cfg(cfg) -> dict:
    return dict(seq_len=S, global_batch=B, vocab_size=cfg.vocab_size, seed=3)


# ---------------------------------------------------------------------------
# The ranks' program (module level: spawned ranks import it by name)
# ---------------------------------------------------------------------------


def _steps(rules, trees: dict, arch: str, compression: str, accum: int, steps: int) -> tuple:
    """``steps`` AdamW steps of ``make_train_step`` under ``rules``:
    (history, params, state)."""
    cfg = _tcfg(arch)
    model = Model(cfg, runtime=RuntimeConfig(remat="full"), rules=rules)
    opt = topt.OptimizerConfig(grad_compression=compression, **OPT)
    params = params_from_numpy(trees[arch], cfg, "cpu", rules)
    state = topt.init_opt_state(opt, params)
    step = tloop.make_train_step(model, opt, accum)
    history = []
    for i in range(steps):
        params, state, metrics = step(params, state,
                                      tloop.to_device(_batch(cfg, seed=10 + i), "cpu"))
        history.append({k: float(v) for k, v in metrics.items()})
    return history, params, state


def _rank_program(rank: int, n: int, trees: dict, ckpt_dir: str) -> dict:
    """Every mesh's runs in turn over the same 4 ranks; rank 0 returns every
    rank's results."""
    import warnings

    import torch.distributed as dist

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.distributed.sharding import AxisRules
    from repro_torch.launch.mesh import make_mesh

    out = {}
    for label in MESHES:
        mesh = make_mesh(_shape(label), ("data", "model"), timeout_s=WORLD_S)
        rules = AxisRules.create(mesh)
        mine = {"coords": mesh.coords, "grads": {}, "steps": {}}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for arch in ARCHS:
                cfg = _tcfg(arch)
                model = Model(cfg, runtime=RuntimeConfig(remat="full"), rules=rules)
                params = params_from_numpy(trees[arch], cfg, "cpu", rules)
                loss, aux, grads = tloop.value_and_grad(
                    model, params, tloop.to_device(_batch(cfg), "cpu"))
                mine["grads"][arch] = (float(loss), float(aux["lm_loss"]), grads)
        mine["warnings"] = [str(w.message) for w in caught]
        for run in STEP_RUNS:
            mine["steps"][run] = _steps(rules, trees, *run)
        cfg = _tcfg("olmo-1b")
        model = Model(cfg, runtime=RuntimeConfig(remat="full"), rules=rules)
        # the checkpoint: 1x4 trains and saves step 2, 2x2 resumes it to step 4
        opt = topt.OptimizerConfig(**OPT)
        data = SyntheticLM(DataConfig(**_data_cfg(cfg)))
        params = params_from_numpy(trees["olmo-1b"], cfg, "cpu", rules)
        state = topt.init_opt_state(opt, params)
        if label == "1x4":
            params, state, history = tloop.run_train_loop(
                model, opt, tloop.TrainLoopConfig(steps=2, log_every=1, checkpoint_every=2,
                                                  checkpoint_dir=ckpt_dir), data,
                params=params, opt_state=state)
        else:
            ck = Checkpointer(ckpt_dir, rules=rules)
            ck.restore(2, {"params": params, "opt_state": state}, in_place=True,
                       specs=tloop.state_specs(model, opt))
            data.load_state_dict(ck.load_extra(2)["data_state"])
            params, state, history = tloop.run_train_loop(
                model, opt, tloop.TrainLoopConfig(steps=4, log_every=1), data,
                params=params, opt_state=state, start_step=2)
        mine["ckpt"] = (history, {"params": params, "opt_state": state})
        every = [None] * n
        dist.all_gather_object(every, mine)
        out[label] = every
    return out


# ---------------------------------------------------------------------------
# Reassembly and the references
# ---------------------------------------------------------------------------


def _reassemble(label: str, specs: dict, pick) -> dict:
    """The whole tree from every rank's shards (``pick(rank_result)`` gives
    a rank's tree), by ``specs`` (ParamSpec leaves): each rank's shard
    written into its box; replicas must agree bit for bit."""
    from repro_torch.distributed.sharding import AxisRules, shard_box
    from repro_torch.launch.mesh import Mesh

    def build(ranks):
        def leaf(path_specs, idx):
            spec = path_specs
            whole = torch.full(spec.shape, float("nan"), dtype=torch.float64)
            for r in ranks:
                mesh = Mesh(_shape(label), ("data", "model"), coords=r["coords"])
                pspec = AxisRules.create(mesh).spec(spec.logical_axes)
                box = shard_box(spec.shape, pspec, mesh)
                got = topt.tree_leaves(pick(r))[idx].double()
                seen = whole[box]
                assert torch.isnan(seen).all() or torch.equal(seen, got), (label, idx)
                whole[box] = got
            assert not torch.isnan(whole).any(), (label, idx)
            return whole

        leaves = [leaf(s, i) for i, s in enumerate(topt.tree_leaves(specs))]
        return topt.tree_unflatten(specs, leaves)

    return build


def _jax_grads(arch: str, tree: dict) -> tuple:
    jcfg = dataclasses.replace(jax_reduced_config(arch), dtype="float32")
    jmodel = JaxModel(jcfg, JAX_RT)
    batch = {k: jnp.asarray(v) for k, v in _batch(_tcfg(arch)).items()}
    (loss, aux), grads = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, tree), batch)
    return float(loss), float(aux["lm_loss"]), jax.tree.map(np.asarray, grads)


def _jax_steps(tree: dict, arch: str, compression: str, accum: int, steps: int) -> tuple:
    jcfg = dataclasses.replace(jax_reduced_config(arch), dtype="float32")
    jmodel = JaxModel(jcfg, JAX_RT)
    opt = jopt.OptimizerConfig(grad_compression=compression, **OPT)
    params = jax.tree.map(jnp.asarray, tree)
    state = jopt.init_opt_state(opt, params)
    step = jax.jit(jloop.make_train_step(jmodel, opt, accum))
    history = []
    for i in range(steps):
        batch = {k: jnp.asarray(v) for k, v in _batch(_tcfg(arch), 10 + i).items()}
        params, state, metrics = step(params, state, batch)
        history.append({k: float(v) for k, v in metrics.items()})
    return history, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)


def _references(trees: dict, ckpt_dir: str) -> dict:
    """JAX's gradients and steps, the port's one-device gradients and the
    unbroken 4-step run the resumed world is held against."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    out = {"jax_grads": {a: _jax_grads(a, trees[a]) for a in ARCHS},
           "jax_steps": {run: _jax_steps(trees[run[0]], *run) for run in STEP_RUNS},
           "port_grads": {}}
    for arch in ARCHS:
        cfg = _tcfg(arch)
        model = Model(cfg, runtime=RuntimeConfig(remat="full"))
        loss, aux, grads = tloop.value_and_grad(
            model, params_from_numpy(trees[arch], cfg, "cpu"),
            tloop.to_device(_batch(cfg), "cpu"))
        out["port_grads"][arch] = (float(loss), float(aux["lm_loss"]), grads)
    cfg = _tcfg("olmo-1b")
    model = Model(cfg, runtime=RuntimeConfig(remat="full"))
    out["unbroken"] = tloop.run_train_loop(
        model, topt.OptimizerConfig(**OPT), tloop.TrainLoopConfig(steps=4, log_every=1),
        SyntheticLM(DataConfig(**_data_cfg(cfg))),
        params=params_from_numpy(trees["olmo-1b"], cfg, "cpu"))
    return out


@pytest.fixture(scope="module")
def world_and_references(tmp_path_factory):
    from concurrent.futures import ThreadPoolExecutor

    trees = {a: _tree(a) for a in ARCHS}
    ckpt_dir = str(tmp_path_factory.mktemp("ckpt"))
    with ThreadPoolExecutor(1) as pool:
        world = pool.submit(run_world, _rank_program, 4, (trees, ckpt_dir), timeout_s=WORLD_S,
                            workdir=str(tmp_path_factory.mktemp("world")))
        refs = _references(trees, ckpt_dir)
        got = world.result()
    return trees, ckpt_dir, got, refs


def _leaf_gap(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _specs(arch: str) -> dict:
    return Model(_tcfg(arch)).param_specs()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_loss_gradient_matches_jax_and_one_device(world_and_references, mesh, arch):
    _, _, got, refs = world_and_references
    ranks = got[mesh]
    grads = _reassemble(mesh, _specs(arch), lambda r: r["grads"][arch][2])(ranks)
    losses = {(r["grads"][arch][0], r["grads"][arch][1]) for r in ranks}
    assert len(losses) == 1, losses  # every rank reports the same loss
    (loss, lm_loss), = losses
    for name, (want_loss, want_lm, want) in (("jax", refs["jax_grads"][arch]),
                                              ("port", refs["port_grads"][arch])):
        assert abs(loss - want_loss) <= LOSS_TOL and abs(lm_loss - want_lm) <= LOSS_TOL, name
        wl = jax.tree.leaves(want) if name == "jax" else topt.tree_leaves(want)
        gl = topt.tree_leaves(grads)
        assert len(gl) == len(wl)
        gaps = [_leaf_gap(a.numpy(), np.asarray(b, np.float32)) for a, b in zip(gl, wl)]
        assert max(gaps) <= GRAD_TOL, (name, max(gaps))


@pytest.mark.parametrize("mesh", MESHES)
def test_no_c10d_autograd_warning_under_rules(world_and_references, mesh):
    _, _, got, _ = world_and_references
    said = [w for r in got[mesh] for w in r["warnings"]
            if "autograd" in w or "c10d" in w or "no_grad" in w]
    assert said == []


def _check_steps(label: str, ranks: list, want: tuple, run: tuple,
                 bf16_tol: float | None = None) -> None:
    """The ranks' steps of ``run`` against JAX's one device: the f32 rules
    (module docstring), or with ``bf16_tol`` (one step) the metrics and m
    within that share of their scale (m's leaf's largest entry): after one
    step m is 0.1 g and v 0.001 g**2, so m holds the gradient."""
    arch, compression, accum, steps = run
    want_hist, want_params, want_state = want
    hist = ranks[0]["steps"][run][0]
    assert all(r["steps"][run][0] == hist for r in ranks)
    lrs = 0.0
    for h, w in zip(hist, want_hist):
        assert set(h) == set(w)
        for k in w:
            tol = bf16_tol or STEP_TOL
            assert abs(h[k] - w[k]) <= tol * max(abs(w[k]), 1.0), (k, h[k], w[k])
        lrs += w["lr"]
    specs = _specs(arch)
    params = _reassemble(label, specs, lambda r: r["steps"][run][1])(ranks)
    flips = total = 0
    for a, b in zip(topt.tree_leaves(params), jax.tree.leaves(want_params)):
        gap = np.abs(a.numpy() - np.asarray(b, np.float64))
        assert gap.max() <= 2 * lrs + PARAM_TOL
        flips += int((gap > PARAM_TOL).sum())
        total += gap.size
    print(f"{label}, {arch}, compression {compression}, accum {accum}: {flips} of {total} "
          f"weights moved apart by a near-zero gradient of another sign")
    assert flips <= FLIP_SHARE * total
    moment_tol = bf16_tol or (BF16_STEP if compression == "bf16" else GRAD_TOL)
    state_specs = topt.opt_state_specs(topt.OptimizerConfig(), specs)
    state = _reassemble(label, state_specs, lambda r: r["steps"][run][2])(ranks)
    assert int(state["step"]) == int(want_state["step"]) == steps
    for key in ("m",) if bf16_tol else ("m", "v"):
        gaps = [_leaf_gap(a.numpy(), b) for a, b in zip(topt.tree_leaves(state[key]),
                                                         jax.tree.leaves(want_state[key]))]
        assert max(gaps) <= moment_tol, (key, max(gaps))


@pytest.mark.parametrize("compression,accum", STEP_CASES)
@pytest.mark.parametrize("mesh", MESHES)
def test_train_step_matches_jax(world_and_references, mesh, compression, accum):
    _, _, got, refs = world_and_references
    run = ("olmo-1b", compression, accum, STEPS)
    _check_steps(mesh, got[mesh], refs["jax_steps"][run], run)


@pytest.mark.parametrize("arch", REPLICATED_ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_train_step_of_replicated_leaves_matches_jax(world_and_references, mesh, arch):
    """Leaves replicated over `model` have their gradient summed over it in
    f32 and then compressed, rounded once as JAX rounds its gradient, so at
    1x4 the f32 rules hold over 3 bf16 steps. At 2x2 the leaves replicated
    over `data` are then summed over it: without compression the f32 rules
    hold over 3 steps; with bf16 the sum is in bf16 (JAX's DP reduction), a
    rounding JAX's one device does not make, which cancelling partials
    magnify relative to their sum and later steps carry into every leaf, so
    one step is held to the bf16 tolerance."""
    _, _, got, refs = world_and_references
    runs = ([((arch, "bf16", 1, STEPS), None)] if _shape(mesh)[0] == 1 else
            [((arch, "none", 1, STEPS), None), ((arch, "bf16", 1, 1), BF16_TOL)])
    for run, tol in runs:
        _check_steps(mesh, got[mesh], refs["jax_steps"][run], run, tol)


def test_world_checkpoint_restores_in_jax_and_on_one_device(world_and_references):
    """The 1x4 world's step-2 checkpoint: JAX format, 4 processes' files,
    restored by JAX's Checkpointer and by the port's one device equal to the
    ranks' shards bit for bit."""
    import json

    from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
    from repro_torch.checkpoint.checkpointer import Checkpointer

    _, ckpt_dir, got, _ = world_and_references
    step_dir = os.path.join(ckpt_dir, "step_000000002")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        assert json.load(f)["nprocs"] == 4
    assert sorted(n for n in os.listdir(step_dir) if n.endswith(".npz")) == [
        f"proc_{k}.npz" for k in range(4)]
    specs = tloop.state_specs(Model(_tcfg("olmo-1b")), topt.OptimizerConfig(**OPT))
    want = _reassemble("1x4", specs, lambda r: r["ckpt"][1])(got["1x4"])
    target = topt.tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype), specs)
    port = Checkpointer(ckpt_dir).restore(2, target)
    jtarget = jax.tree.map(lambda t: np.zeros(t.shape, dtype=np.float32 if t.dtype ==
                                              torch.float32 else np.int32), target)
    jax_tree = JaxCheckpointer(ckpt_dir).restore(2, jtarget)
    for a, b, w in zip(topt.tree_leaves(port), jax.tree.leaves(jax_tree),
                       topt.tree_leaves(want)):
        assert torch.equal(a.double(), w)
        assert np.array_equal(np.asarray(b, np.float64), w.numpy())


def test_2x2_resumes_a_1x4_checkpoint_and_ends_as_an_unbroken_run(world_and_references):
    _, _, got, refs = world_and_references
    params, _, unbroken = refs["unbroken"]
    hist = got["2x2"][0]["ckpt"][0]
    assert [h["step"] for h in hist] == [3, 4]
    for h, w in zip(hist, unbroken[2:]):
        assert abs(h["loss"] - w["loss"]) <= LOSS_TOL
        assert abs(h["grad_norm"] / w["grad_norm"] - 1) <= STEP_TOL
    specs = tloop.state_specs(Model(_tcfg("olmo-1b")), topt.OptimizerConfig(**OPT))
    resumed = _reassemble("2x2", specs, lambda r: r["ckpt"][1])(got["2x2"])
    lrs = sum(h["lr"] for h in unbroken)
    flips = total = 0
    for a, b in zip(topt.tree_leaves(resumed["params"]), topt.tree_leaves(params)):
        gap = (a - b.double()).abs()
        assert float(gap.max()) <= 2 * lrs + PARAM_TOL
        flips += int((gap > PARAM_TOL).sum())
        total += gap.numel()
    assert flips <= FLIP_SHARE * total
    assert int(resumed["opt_state"]["step"]) == 4


def test_launcher_trains_under_a_mesh_as_on_one_device():
    """--mesh 2x2 spawns 4 ranks; rank 0's history is 1x1's within the bf16
    tolerance (the reduced olmo-1b is bf16)."""
    from repro_torch.launch import train

    argv = ["--smoke", "--device", "cpu", "--steps", "2", "--batch", "4", "--seq-len", "32"]
    one = train.main(argv)
    mesh = train.main([*argv, "--mesh", "2x2", "--timeout", str(WORLD_S)])
    assert [h["step"] for h in mesh] == [h["step"] for h in one] == [1]
    for k in ("loss", "grad_norm", "lr"):
        assert abs(mesh[0][k] - one[0][k]) <= BF16_TOL * max(abs(one[0][k]), 1.0), k
