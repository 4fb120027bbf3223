"""The port's Mixture-of-Experts layer against ``repro.models.moe``.

Both frameworks get the same inputs: the parameters of JAX's ``moe_params``
drawn by ``init_tree`` and carried across bit for bit, and the same x. On
the reduced llama4-maverick (top-1), arctic (top-2 with the dense residual
MLP) and jamba (top-2) configs, through the einsum and the ragged dispatch
and ``"a2a"`` without a mesh (which JAX runs as ragged, ``moe.py:56-78``):

* the top-k choices are equal, ties included (``jax.lax.top_k`` puts the
  lower index first; the port takes a stable sort's first k);
* the output and the load-balance aux value agree: float32 within 1e-4 of
  the output's largest entry (the largest difference seen was about 1e-7
  of it), bf16 within 1e-2 of it, the bf16 TOL of tests/test_torch_model.py
  (the two frameworks round the experts' bf16 SwiGLU at different points);
* at a capacity factor of 0.5 tokens are dropped, and both dispatches still
  agree with JAX's; ``capacity`` equals ``_capacity`` over a grid of token
  counts and factors.
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
from repro.distributed.sharding import init_tree
from repro.models import moe as jmoe
from repro_torch.configs.registry import reduced_config
from repro_torch.convert import tensor_from_numpy
from repro_torch.models import moe

# tiny shapes: one intra-op thread is as fast, and more threads would only
# spin against the other test workers, which share the CPU's cores
torch.set_num_threads(1)

ARCHS = ["llama4-maverick-400b-a17b", "arctic-480b", "jamba-1.5-large-398b"]
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
B, S = 2, 24


def _setup(arch: str, dtype: str, **moe_changes):
    jcfg = jax_reduced_config(arch)
    jcfg = dataclasses.replace(jcfg, dtype=dtype, moe=dataclasses.replace(jcfg.moe, **moe_changes))
    tcfg = reduced_config(arch)
    tcfg = dataclasses.replace(tcfg, dtype=dtype, moe=dataclasses.replace(tcfg.moe, **moe_changes))
    tree = jax.tree.map(np.asarray, init_tree(jmoe.moe_params(jcfg, 1), jax.random.key(0)))
    x = jnp.asarray(np.random.default_rng(1).normal(size=(B, S, jcfg.d_model)), jnp.float32)
    x = np.asarray(x.astype(dtype))
    return jcfg, tcfg, tree, x


def _to_torch(tree: dict) -> dict:
    return {k: _to_torch(v) if isinstance(v, dict) else tensor_from_numpy(v, "cpu")
            for k, v in tree.items()}


def _jax_choices(tree, x, cfg):
    """``moe.py:70-72``: the router in float32 and jax.lax.top_k."""
    xt = jnp.asarray(x).reshape(-1, cfg.d_model).astype(jnp.float32)
    probs = jax.nn.softmax((xt @ jnp.asarray(tree["router"])).astype(jnp.float32), axis=-1)
    return np.asarray(jax.lax.top_k(probs, cfg.moe.top_k)[1])


def _run_both(jcfg, tcfg, tree, x, dispatch):
    jout, jaux = jmoe.moe_apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), jcfg,
                                RuntimeConfig(moe_dispatch=dispatch), None)
    tout, taux = moe.moe_apply(_to_torch(tree), tensor_from_numpy(x, "cpu"), tcfg, dispatch)
    return np.asarray(jout, np.float32), jaux, tout, taux


def _assert_scaled_close(got: torch.Tensor, want: np.ndarray, tol: float, what: str):
    err = np.abs(got.float().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), (what, err, np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dispatch", ["einsum", "ragged", "a2a"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, dispatch, dtype):
    jcfg, tcfg, tree, x = _setup(arch, dtype)
    _, _, top_e, _ = moe.route(_to_torch(tree)["router"],
                               tensor_from_numpy(x, "cpu").reshape(-1, tcfg.d_model),
                               tcfg.moe.top_k)
    assert np.array_equal(top_e.numpy(), _jax_choices(tree, x, jcfg))
    jout, jaux, tout, taux = _run_both(jcfg, tcfg, tree, x, dispatch)
    assert tout.dtype == tensor_from_numpy(x, "cpu").dtype and tout.shape == (B, S, tcfg.d_model)
    _assert_scaled_close(tout, jout, TOL[dtype], f"{arch} {dispatch} output")
    np.testing.assert_allclose(float(taux["load_balance_loss"]),
                               float(jaux["load_balance_loss"]), rtol=1e-5)


@pytest.mark.parametrize("dispatch", ["einsum", "ragged"])
def test_dropped_tokens_match_jax(dispatch):
    """Capacity factor 0.5: an expert takes at most 12 of the 96 (token, k)
    pairs of 48 tokens, so pairs are dropped, as JAX drops them."""
    jcfg, tcfg, tree, x = _setup("arctic-480b", "float32", capacity_factor=0.5)
    assert moe.capacity(B * S, tcfg) == 12
    jout, _, tout, taux = _run_both(jcfg, tcfg, tree, x, dispatch)
    assert float(taux["dropped"]) >= 48  # 96 pairs, 4 experts of 12 slots
    _assert_scaled_close(tout, jout, TOL["float32"], f"{dispatch} with drops")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a2a_without_a_mesh_is_the_ragged_dispatch(dtype):
    _, tcfg, tree, x = _setup("arctic-480b", dtype)
    p, xt = _to_torch(tree), tensor_from_numpy(x, "cpu")
    a2a, ragged = moe.moe_apply(p, xt, tcfg, "a2a")[0], moe.moe_apply(p, xt, tcfg, "ragged")[0]
    assert torch.equal(a2a, ragged)
    with pytest.raises(ValueError, match="moe_dispatch"):
        moe.moe_apply(p, xt, tcfg, "shard_map")


def test_aux_reports_drops_margin_and_choices_without_a_host_sync():
    _, tcfg, tree, x = _setup("jamba-1.5-large-398b", "float32", capacity_factor=0.5)
    p, xt = _to_torch(tree), tensor_from_numpy(x, "cpu")
    _, aux = moe.moe_apply(p, xt, tcfg)
    probs, _, top_e, ranked = moe.route(p["router"], xt.reshape(B * S, -1), tcfg.moe.top_k)
    assert all(aux[n].dim() == 0 for n in ("load_balance_loss", "dropped", "margin"))
    assert torch.equal(aux["probs"], probs) and torch.equal(aux["top_e"], top_e)
    assert aux["kept"].shape == (B * S, 2) and float(aux["dropped"]) == (~aux["kept"]).sum()
    assert float(aux["margin"]) == float((ranked[:, 1] - ranked[:, 2]).min()) > 0
    assert float(aux["dropped"]) > 0


@pytest.mark.parametrize("dispatch", ["einsum", "ragged"])
def test_kept_pairs_are_each_experts_first_in_token_order(dispatch):
    """An expert keeps its first ``capacity`` (token, k) pairs in (token, k)
    order and drops the rest, as the cumsum of ``moe.py:101-104`` places them."""
    _, tcfg, tree, x = _setup("arctic-480b", "float32", capacity_factor=0.5)
    _, aux = moe.moe_apply(_to_torch(tree), tensor_from_numpy(x, "cpu"), tcfg, dispatch)
    cap = moe.capacity(B * S, tcfg)
    flat_e, kept = aux["top_e"].reshape(-1), aux["kept"].reshape(-1)
    for e in range(tcfg.moe.n_experts):
        mine = kept[flat_e == e]
        n = min(mine.numel(), cap)
        assert mine[:n].all() and not mine[n:].any(), e


def test_router_ties_pick_the_lower_expert_as_jax_top_k():
    """Experts 1 and 3 share a router column, and so every probability: the
    lower index comes first, as in jax.lax.top_k."""
    jcfg, tcfg, tree, x = _setup("arctic-480b", "float32")
    router = tree["router"].copy()
    router[:, 3] = router[:, 1] = np.abs(router[:, 1]) * 40
    tree = dict(tree, router=router)
    xt = np.abs(x)  # positive inputs: experts 1 and 3 lead every row
    _, _, top_e, _ = moe.route(torch.from_numpy(router), torch.from_numpy(xt).reshape(B * S, -1), 2)
    assert np.array_equal(top_e.numpy(), _jax_choices(tree, xt, jcfg))
    assert (top_e.numpy() == [1, 3]).all()


@pytest.mark.parametrize("factor", [0.5, 1.0, 1.25, 2.0, 8.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_jax(arch, factor):
    jcfg, tcfg, _, _ = _setup(arch, "float32", capacity_factor=factor)
    for n in [*range(0, 80), 999, 1000, 1024, 4096]:
        assert moe.capacity(n, tcfg) == jmoe._capacity(n, jcfg), n
    full = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, n_experts=128))
    jfull = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, n_experts=128))
    for n in (1, 16, 1000, 1024, 2048):
        assert moe.capacity(n, full) == jmoe._capacity(n, jfull), n
