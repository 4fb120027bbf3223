"""The collectives' backwards under a device mesh: a gloo world of 4 ranks on the CPU.

One world of 4 ranks is spawned per module (``distributed.world.run_world``)
and builds the 1x4 mesh and then the 2x2 mesh over the same ranks:

* the adjoint of every collective Function (``distributed/collectives.py``)
  on both meshes, over each tuple of axes, in float32 and bfloat16: with x
  and y drawn per rank, the sum over the ranks of <f(x), y> equals the sum
  of <x, f^T(y)>, f^T(y) being the backward autograd runs. This is the
  transpose under the convention the train step relies on (a rank's
  cotangent is its partial of the true one); ``all_reduce`` max has no
  gradient at all;
* ``torch.autograd.gradcheck`` in float64 of three world functions
  (``all_gather_flat``, ``all_to_all`` and the row-parallel product, each
  closed by a psum): every rank holds the same input and the same
  replicated output, and a test-only entry op sums the ranks' partial
  input cotangents and divides by the world size, so each rank's
  gradcheck sees the world's true Jacobian;
* reduced llama4-maverick-400b-a17b with the all-to-all dispatch at
  capacity factor 8.0 (1x4): the gradient of ``lm_loss`` (the load-balance
  term is averaged per shard) on every leaf, reassembled from the ranks,
  against one device's on the same weights, within 1e-4 of each leaf's
  largest entry (the router's is rounding on both sides: with top-1 routing
  lm_loss does not depend on it); the loss within 1e-5;
* ``experiments/mesh_train_probe.py`` at its ``small()`` runs (chip_smoke
  phase 16's plumbing on the CPU) within phase 16's limits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.distributed.world import run_world

torch.set_num_threads(1)

WORLD_S = 240.0
MESHES = ((1, 4), (2, 2))
AXES = ("model", "data", ("data", "model"))
# the collectives whose adjoints are checked: name -> f(x) on a rank
CASES = ("all_reduce_sum", "all_gather_0", "all_gather_2", "all_gather_stacked",
         "all_gather_flat", "all_to_all", "row_parallel_f32", "row_parallel_bf16")
ADJOINT_TOL = {"float32": 1e-5, "bfloat16": 1e-2}  # relative to |<f(x), y>| + |<x, f^T y>|
GRADCHECKS = ("all_gather_flat", "all_to_all", "row_parallel")
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


def _apply(name: str, x: torch.Tensor, mesh, axes):
    """f(x) for a case; x (8, 6, 4) on each rank."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.sharding import AxisRules

    if name == "all_reduce_sum":
        return coll.all_reduce(x, mesh, axes)
    if name == "all_gather_0":
        return coll.all_gather(x, 0, mesh, axes)
    if name == "all_gather_2":
        return coll.all_gather(x, 2, mesh, axes)
    if name == "all_gather_stacked":
        return coll.all_gather_stacked(x, mesh, axes)
    if name == "all_gather_flat":
        a, b = coll.all_gather_flat([x, x[:, 1:] * 3], [0, 1], mesh, axes)
        return torch.cat([a.reshape(-1), b.reshape(-1)])
    if name == "all_to_all":
        return coll.all_to_all(x, mesh, axes)
    # row-parallel over model: x (8, 6, 4) as 48 rows of 4 columns, w (4, 5)
    w = torch.linspace(-1, 1, 20, dtype=torch.float64).reshape(4, 5).to(x.dtype) + mesh.rank
    rules = AxisRules.create(mesh, rowp_bf16=name == "row_parallel_bf16")
    return coll.row_parallel_matmul(x.reshape(48, 4), w, rules)


def _adjoints(mesh) -> dict:
    """(sum over ranks of <f(x), y>, of <x, f^T y>) per (case, axes, dtype)."""
    from repro_torch.distributed import collectives as coll

    out = {}
    g = torch.Generator().manual_seed(10 + mesh.rank)
    for dtype in (torch.float32, torch.bfloat16):
        for name in CASES:
            for axes in (AXES if not name.startswith("row_parallel") else ("model",)):
                x = torch.randn(8, 6, 4, generator=g).to(dtype).requires_grad_(True)
                y = _apply(name, x, mesh, axes)
                v = torch.randn(y.shape, generator=g).to(dtype)
                (xt,) = torch.autograd.grad(y, x, grad_outputs=v)
                lhs = (y.detach().double() * v.double()).sum()
                rhs = (x.detach().double() * xt.double()).sum()
                both = coll.all_reduce(torch.stack([lhs, rhs, lhs.abs() + rhs.abs()]), mesh,
                                       ("data", "model"))
                out[(name, str(axes), str(dtype))] = both.tolist()
        # pmax: a value, and no gradient
        x = torch.randn(8, 6, 4, generator=g).to(dtype).requires_grad_(True)
        m = coll.all_reduce(x, mesh, ("data", "model"), op="max")
        (xt,) = torch.autograd.grad((m * 2).sum(), x, allow_unused=True, materialize_grads=True)
        out[("all_reduce_max", "", str(dtype))] = [float(xt.abs().max())]
    return out


class _Enter(torch.autograd.Function):
    """Identity forward; backward: the mean over the world of the ranks'
    cotangents (test only: it makes each rank's gradcheck see the world's
    Jacobian of a replicated input)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        from repro_torch.distributed import collectives as coll

        return coll._psum(g, ctx.mesh, ("data", "model")) / ctx.mesh.size, None


def _gradchecks(mesh) -> dict:
    """gradcheck in float64 of a world function per case: a replicated input
    (6, 4), a rank-dependent local op, the collective, a psum over the world
    of a rank-weighted output: a replicated output."""
    from repro_torch.distributed import collectives as coll

    weight = 1.0 + 0.5 * mesh.rank

    def world_fn(name):
        def f(x):
            u = _Enter.apply(x, mesh) * weight  # each rank its own input
            if name == "all_gather_flat":
                a, b = coll.all_gather_flat([u, u[:, 1:] ** 2], [0, 1], mesh, ("data",))
                y = torch.cat([a.reshape(-1), b.reshape(-1)])
            elif name == "all_to_all":
                y = coll.all_to_all(torch.cat([u, u * u]), mesh, ("data", "model")).reshape(-1)
            else:
                # rowp_bf16: the partial kept in the input's dtype, here float64
                y = _apply("row_parallel_bf16", u.repeat(8, 1, 1)[:8], mesh, "model").reshape(-1)
            lin = torch.linspace(-1, 1, y.numel(), dtype=y.dtype) * (mesh.rank + 1)
            return coll.all_reduce(y * lin, mesh, ("data", "model"))[:6]
        return f

    x = torch.linspace(-1, 1, 24, dtype=torch.float64).reshape(6, 4).requires_grad_(True)
    return {name: bool(torch.autograd.gradcheck(world_fn(name), (x,), eps=1e-6, atol=1e-7,
                                                rtol=1e-5))
            for name in GRADCHECKS}


def _maverick(mesh, tree, cfg) -> dict:
    """Reduced maverick, the a2a dispatch: loss, lm_loss and the gradient
    shards of lm_loss, taken as ``train_loop.value_and_grad`` takes the
    loss's (a 1 / world seed, then the psum of the replicated leaves)."""
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.convert import params_from_numpy
    from repro_torch.distributed.sharding import AxisRules, reduce_replicated
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import tree_leaves, tree_map, tree_unflatten

    rules = AxisRules.create(mesh)
    model = Model(cfg, runtime=RuntimeConfig(remat="full", moe_dispatch="a2a"), rules=rules)
    params = tree_map(lambda p: p.requires_grad_(True), params_from_numpy(tree, cfg, "cpu",
                                                                           rules))
    tokens = _maverick_tokens(cfg)
    loss, aux = model.loss_fn(params, {"tokens": tokens, "labels": tokens})
    grads = torch.autograd.grad(aux["lm_loss"], tree_leaves(params),
                                grad_outputs=torch.full_like(loss, 1.0 / mesh.size),
                                allow_unused=True, materialize_grads=True)
    grads = reduce_replicated(tree_unflatten(params, grads), model.partition_specs(), mesh)
    return {"lm_loss": float(aux["lm_loss"].detach()), "grads": grads}


def _maverick_tokens(cfg):
    return torch.randint(0, cfg.vocab_size, (2, 32), generator=torch.Generator().manual_seed(4))


def _rank_program(rank: int, n: int, maverick) -> dict:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    out = {}
    for shape in MESHES:
        mesh = make_mesh(shape, ("data", "model"), timeout_s=WORLD_S)
        label = f"{shape[0]}x{shape[1]}"
        out[f"adjoint_{label}"] = _adjoints(mesh)
        if shape == (2, 2):
            out["gradcheck"] = _gradchecks(mesh)
        else:
            got = _maverick(mesh, *maverick)
            every = [None] * n
            dist.all_gather_object(every, got)
            out["maverick"] = every
    return out


def _maverick_setup():
    import jax

    from repro.configs.base import RuntimeConfig as JaxRuntime
    from repro.configs.registry import reduced_config as jax_reduced
    from repro.models import Model as JaxModel
    from repro_torch.configs.registry import reduced_config

    def cap(c):
        return dataclasses.replace(c, dtype="float32", moe=dataclasses.replace(
            c.moe, capacity_factor=8.0))

    arch = "llama4-maverick-400b-a17b"
    jcfg, tcfg = cap(jax_reduced(arch)), cap(reduced_config(arch))
    tree = jax.tree.map(np.asarray, JaxModel(jcfg, JaxRuntime()).init(jax.random.key(0)))
    return tree, tcfg


def _maverick_reference(tree, cfg) -> dict:
    """One device, the same weights: lm_loss and its gradient."""
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.convert import params_from_numpy
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import tree_leaves, tree_map, tree_unflatten

    model = Model(cfg, runtime=RuntimeConfig(remat="full", moe_dispatch="einsum"))
    params = tree_map(lambda p: p.requires_grad_(True), params_from_numpy(tree, cfg, "cpu"))
    tokens = _maverick_tokens(cfg)
    _, aux = model.loss_fn(params, {"tokens": tokens, "labels": tokens})
    grads = torch.autograd.grad(aux["lm_loss"], tree_leaves(params), allow_unused=True,
                                materialize_grads=True)
    return {"lm_loss": float(aux["lm_loss"].detach()), "grads": tree_unflatten(params, grads),
            "specs": Model(cfg).param_specs()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from concurrent.futures import ThreadPoolExecutor

    tree, cfg = _maverick_setup()
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(run_world, _rank_program, 4, ((tree, cfg),), timeout_s=WORLD_S,
                          workdir=str(tmp_path_factory.mktemp("world")))
        ref = _maverick_reference(tree, cfg)
        got = fut.result()
    got["maverick_ref"] = ref
    return got


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_collective_backward_is_its_adjoint(world, mesh, case, dtype):
    got = {k: v for k, v in world[f"adjoint_{mesh}"].items() if k[0] == case and k[2] == dtype}
    assert got, (mesh, case, dtype)
    tol = ADJOINT_TOL[dtype.removeprefix("torch.")]
    for (_, axes, _), (lhs, rhs, scale) in got.items():
        assert abs(lhs - rhs) <= tol * scale, (mesh, case, axes, dtype, lhs, rhs)


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_pmax_has_no_gradient(world, mesh):
    got = {k: v for k, v in world[f"adjoint_{mesh}"].items() if k[0] == "all_reduce_max"}
    assert len(got) == 2
    for key, (grad,) in got.items():
        assert grad == 0.0, key


@pytest.mark.parametrize("name", GRADCHECKS)
def test_gradcheck_float64_of_a_world_function(world, name):
    assert world["gradcheck"][name] is True


def test_maverick_a2a_lm_loss_gradient_matches_one_device(world):
    """Every leaf of the gradient of lm_loss, reassembled from the ranks'
    shards, against one device's (the einsum dispatch, as JAX's own test
    holds its a2a against it; capacity 8.0 drops no pair)."""
    from repro_torch.distributed.sharding import AxisRules, shard_box
    from repro_torch.launch.mesh import Mesh
    from repro_torch.training.optimizer import tree_leaves

    ref = world["maverick_ref"]
    ranks = world["maverick"]
    assert all(abs(r["lm_loss"] - ref["lm_loss"]) <= LOSS_TOL for r in ranks)
    specs = tree_leaves(ref["specs"])
    want = tree_leaves(ref["grads"])
    shards = [tree_leaves(r["grads"]) for r in ranks]
    # under top-1 routing the kept weight is p / p = 1, so lm_loss does not
    # depend on the router: its gradient is rounding on both sides, held to
    # a floor of 1e-6 of the tree's largest entry instead of its own
    floor = 1e-6 * max(float(w.abs().max()) for w in want)
    worst = 0.0
    for i, (spec, w) in enumerate(zip(specs, want)):
        whole = torch.full(spec.shape, float("nan"))
        for rank, leaves in enumerate(shards):
            mesh = Mesh((1, 4), ("data", "model"), coords=Mesh((1, 4), ("data", "model"))
                        .coords_of(rank))
            pspec = AxisRules.create(mesh).spec(spec.logical_axes)
            whole[shard_box(spec.shape, pspec, mesh)] = leaves[i].float()
        assert not torch.isnan(whole).any(), i
        scale = float(w.abs().max())
        if scale < floor:
            assert float(whole.abs().max()) < floor, (i, float(whole.abs().max()), floor)
            continue
        worst = max(worst, float((whole - w.float()).abs().max()) / scale)
    assert worst <= GRAD_TOL, worst


def test_mesh_train_probe_runs_phase_16_reduced():
    """Phase 16's plumbing at the reduced configs on the CPU: the same
    references, world, checkpoint and readings as on the card, within the
    phase's limits."""
    import importlib.util
    import os

    from repro_torch.experiments import mesh_train_probe as probe

    got = probe.run(seeds=(0,), cpu=True)[0]
    assert got["collectives_1x4"] == got["collectives_2x2"] == []
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for name in probe.RUNS:
        r = got[name]
        assert r["ranks_agree"], name
        assert max(r["loss_rel"]) <= smoke.MESH_TRAIN_LOSS_TOL[name], (name, r["loss_rel"])
        assert max(r["grad_norm_rel"]) <= smoke.MESH_TRAIN_NORM_TOL[name], (
            name, r["grad_norm_rel"])
        assert max(r["moment_gap"].values()) <= smoke.MESH_TRAIN_MOMENT_TOL[name], (
            name, r["moment_gap"])
    ck = got["checkpoint"]
    assert ck["shards_differ"] == [] and ck["nprocs"] == 4 and ck["step"] == 4
