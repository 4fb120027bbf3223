"""The port's sharding rules and shard arithmetic against the JAX package's.

No process world here: ``AxisRules.spec`` and the shard arithmetic read only
a mesh's axis names, shape and this rank's coordinates, so an abstract
``launch.mesh.Mesh`` (and, for JAX, a stub with ``axis_names`` and
``shape``) stands for every rank of a production mesh.

* ``AxisRules.spec`` equals JAX's for every leaf of the parameter, cache
  (both kv layouts) and optimizer-state specs of all twelve registry
  configs, on meshes (2, 4), (16, 16) and (2, 16, 16), with the same shapes
  (the tp-padded heads and vocab), logical axes and dtypes;
* four ranks' ``init_tree`` shards, put back together, are the single
  device's ``init_params`` bit for bit, and so are four ranks'
  ``shard_tree`` of JAX's converted tree;
* a dim its mesh axes do not divide raises, naming the leaf and the axes;
* the paged plain version's log-sum-exp against a float64 one, and a row of
  context 0 (zeros and -inf).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import types

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import REGISTRY, get_config, reduced_config
from repro_torch.distributed.sharding import (AxisRules, ParamSpec, init_tree, local_shape,
                                              local_slice, shard_tree)
from repro_torch.launch.mesh import Mesh
from repro_torch.models.model import Model, init_params, param_specs

torch.set_num_threads(1)

MESHES = {(2, 4): ("data", "model"), (16, 16): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model")}


def _jax_rules(shape, names):
    from repro.distributed.sharding import AxisRules as JaxRules

    mesh = types.SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)))
    return JaxRules.create(mesh)


def _leaves(tree, path=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{path}/{k}")
        else:
            yield f"{path}/{k}", tree[k]


def _jax_leaves(tree):
    import jax

    from repro.distributed.sharding import is_param_spec

    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree, is_leaf=is_param_spec):
        out["/" + "/".join(str(getattr(p, "key", p)) for p in path)] = leaf
    return out


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) else str(np.dtype(dt))


def _same_specs(port_tree, jax_tree, port_rules, jax_rules, what):
    mine = dict(_leaves(port_tree))
    theirs = _jax_leaves(jax_tree)
    assert sorted(mine) == sorted(theirs), what
    for path, p in mine.items():
        j = theirs[path]
        assert p.shape == tuple(j.shape), (what, path, p.shape, j.shape)
        assert p.logical_axes == tuple(j.logical_axes), (what, path)
        assert _dtype_name(p.dtype) == _dtype_name(j.dtype), (what, path, p.dtype, j.dtype)
        assert p.init == j.init, (what, path)
        got, want = port_rules.spec(p.logical_axes), tuple(jax_rules.spec(j.logical_axes))
        assert got == want, (what, path, got, want)


@pytest.mark.parametrize("shape", list(MESHES), ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_specs_equal_jax_on_every_leaf(arch, shape):
    from repro.configs.base import RuntimeConfig as JaxRuntime
    from repro.configs.registry import get_config as jax_config
    from repro.models import Model as JaxModel
    from repro.training.optimizer import OptimizerConfig as JaxOpt
    from repro.training.optimizer import opt_state_specs as jax_opt_specs
    from repro_torch.training.optimizer import OptimizerConfig, opt_state_specs

    names = MESHES[shape]
    jr = _jax_rules(shape, names)
    pr = AxisRules.create(Mesh(shape, names))
    jm = JaxModel(jax_config(arch), JaxRuntime(), jr)
    pm = Model(get_config(arch), rules=pr)
    _same_specs(pm.param_specs(), jm.param_specs(), pr, jr, "params")
    for kv_axes in (("batch", "kv_seq"), ("batch", None)):
        _same_specs(pm.cache_specs(256, 4096, kv_axes), jm.cache_specs(256, 4096, kv_axes),
                    pr, jr, f"cache {kv_axes}")
    _same_specs(opt_state_specs(OptimizerConfig(), pm.param_specs()),
                jax_opt_specs(JaxOpt(), jm.param_specs()), pr, jr, "opt state")
    assert (pr.tp, pr.dp) == (jr.tp, jr.dp)


@pytest.mark.parametrize("tp", [1, 2, 4, 16])
def test_padded_heads_and_vocab_equal_jax(tp):
    from repro.configs.registry import get_config as jax_config

    for arch in REGISTRY:
        mine, theirs = get_config(arch), jax_config(arch)
        assert mine.padded_heads(tp) == theirs.padded_heads(tp), arch
        assert mine.padded_vocab_tp(tp) == theirs.padded_vocab(tp), arch
    assert get_config("mamba2-2.7b").padded_vocab_tp(4) == 50304
    assert get_config("mamba2-2.7b").padded_vocab == 50280


def _ranks(shape, names):
    """An abstract mesh for every rank of ``shape``."""
    for coords in itertools.product(*(range(n) for n in shape)):
        yield Mesh(shape, names, coords=dict(zip(names, coords)))


def _assemble(shards: list, specs, meshes, full_specs):
    """Rank shards put back together: each written into its slice of a
    zero tree of the full shapes, and every slice written exactly once."""

    def leaf(path, spec):
        full = torch.zeros(spec.shape, dtype=spec.dtype)
        seen = torch.zeros(spec.shape, dtype=torch.int32)
        for shard, mesh in zip(shards, meshes):
            rules = AxisRules.create(mesh)
            pspec = rules.spec(spec.logical_axes)
            got = dict(_leaves(shard))[path]
            assert tuple(got.shape) == local_shape(spec.shape, pspec, mesh, path)
            local_slice(full, pspec, mesh).copy_(got)
            local_slice(seen, pspec, mesh).add_(1)
        return full, seen

    return {path: leaf(path, spec) for path, spec in _leaves(full_specs)}


@pytest.mark.parametrize("arch,shape", [("jamba-1.5-large-398b", (2, 2)),
                                        ("mamba2-2.7b", (1, 4)), ("arctic-480b", (1, 4))])
def test_init_tree_shards_reassemble_to_init_params(arch, shape):
    cfg = reduced_config(arch)
    names = ("data", "model")
    meshes = list(_ranks(shape, names))
    specs = param_specs(cfg, shape[1])
    shards = [init_tree(specs, torch.Generator().manual_seed(7), "cpu", AxisRules.create(m))
              for m in meshes]
    whole = dict(_leaves(init_params(cfg, torch.Generator().manual_seed(7), "cpu",
                                     tp=shape[1])))
    replicas = math.prod(shape)
    for path, (full, seen) in _assemble(shards, specs, meshes, specs).items():
        # each element is held by as many ranks as the leaf is replicated over
        n = seen.flatten()[0].item()
        assert bool((seen == n).all()) and replicas % n == 0, path
        assert torch.equal(full, whole[path]), path


def test_single_device_init_is_unchanged_at_tp1():
    """Model.init without rules draws init_params' values, tp 1 and tp 4
    alike where no leaf is padded (reduced configs)."""
    cfg = reduced_config("jamba-1.5-large-398b")
    a = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = Model(cfg).init(torch.Generator().manual_seed(3), "cpu")
    c = init_params(cfg, torch.Generator().manual_seed(3), "cpu", tp=4)
    for (p, x), (_, y), (_, z) in zip(_leaves(a), _leaves(b), _leaves(c)):
        assert torch.equal(x, y) and torch.equal(x, z), p


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_shard_tree_of_jax_tree_reassembles(shape):
    import jax

    from repro.configs.base import RuntimeConfig as JaxRuntime
    from repro.configs.registry import reduced_config as jax_reduced
    from repro.models import Model as JaxModel
    from repro_torch.convert import params_from_numpy

    arch = "jamba-1.5-large-398b"
    cfg = reduced_config(arch)
    tree = jax.tree.map(np.asarray, JaxModel(jax_reduced(arch), JaxRuntime()).init(
        jax.random.key(0)))
    whole = params_from_numpy(tree, cfg, "cpu")
    names = ("data", "model")
    meshes = list(_ranks(shape, names))
    specs = param_specs(cfg, shape[1])
    shards = [shard_tree(whole, specs, AxisRules.create(m)) for m in meshes]
    converted = [params_from_numpy(tree, cfg, "cpu", rules=AxisRules.create(m)) for m in meshes]
    for a, b in zip(shards, converted):
        for (p, x), (_, y) in zip(_leaves(a), _leaves(b)):
            assert torch.equal(x, y), p
    flat = dict(_leaves(whole))
    for path, (full, _) in _assemble(shards, specs, meshes, specs).items():
        assert torch.equal(full, flat[path]), path


def test_undivided_dim_raises_naming_leaf_and_axes():
    cfg = dataclasses.replace(reduced_config("command-r-35b"), n_kv_heads=3, d_head=6)
    mesh = Mesh((1, 4), ("data", "model"))
    with pytest.raises(ValueError, match=r"wk.*\('model',\)"):
        init_tree(param_specs(cfg, 4), torch.Generator().manual_seed(0), "cpu",
                  AxisRules.create(mesh))
    spec = {"w": ParamSpec((6, 8), torch.float32, ("heads", "embed"))}
    with pytest.raises(ValueError, match=r"/w: dim 0 of 6 does not divide over mesh axes"):
        shard_tree({"w": torch.zeros(6, 8)}, spec, AxisRules.create(mesh))


def test_spec_drops_a_mesh_axis_an_earlier_dim_used():
    rules = AxisRules.create(Mesh((2, 16, 16), ("pod", "data", "model")))
    jr = _jax_rules((2, 16, 16), ("pod", "data", "model"))
    for axes in [("kv_seq_long", "batch"), ("batch", "kv_seq_long"), ("heads", "vocab"),
                 ("embed", "batch", "act_heads"), (None, "experts", "mlp")]:
        assert rules.spec(axes) == tuple(jr.spec(axes)), axes
    assert rules.spec(("batch", "kv_seq_long")) == (("pod", "data"), "model")
    assert rules.spec(("embed", "vocab")) == (("pod", "data"), "model")
    assert AxisRules.create(Mesh((2, 4), ("data", "model"))).spec(("embed",)) == ("data",)
    with pytest.raises(KeyError):
        rules.spec(("nope",))


def test_paged_plain_lse_against_float64():
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import make_block_table

    g = torch.Generator().manual_seed(5)
    b, hq, hkv, d, bt, nb = 3, 8, 2, 32, 16, 4
    q = torch.randn(b, hq, d, generator=g)
    k = torch.randn(b * nb, bt, hkv, d, generator=g)
    v = torch.randn(b * nb, bt, hkv, d, generator=g)
    table = make_block_table([[i * nb + j for j in range(nb)] for i in range(b)], b * nb, "cpu")
    ctx = torch.tensor([0, 17, 64], dtype=torch.int32)
    out, lse = ref.paged_attention_ref(q, k, v, table, ctx, return_lse=True)
    assert torch.equal(out, ref.paged_attention_ref(q, k, v, table, ctx))
    assert lse.shape == (b, hq) and lse.dtype == torch.float32
    kk = k.reshape(b, nb * bt, hkv, d).double()
    for i in range(b):
        n = int(ctx[i])
        if n == 0:
            assert bool((out[i] == 0).all()) and bool(torch.isneginf(lse[i]).all())
            continue
        s = torch.einsum("hgd,khd->hgk", q[i].double().reshape(hkv, hq // hkv, d),
                         kk[i, :n]) / math.sqrt(d)
        want = torch.logsumexp(s, -1).reshape(hq)
        np.testing.assert_allclose(lse[i].numpy(), want.numpy(), rtol=0, atol=1e-5)
