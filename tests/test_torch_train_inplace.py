"""The training loop's in-place step against the pure step, on the CPU.

``run_train_loop`` steps with ``make_train_step(..., in_place=True)``: the
new weights and optimizer moments are written into the tensors it holds, in
the same f32 arithmetic as the pure step, which builds new trees beside the
old ones (JAX donates the old buffers instead). After 1 and 8 steps the
in-place loop must equal the pure step applied as often, bit for bit, on
reduced float32 and bfloat16 configs and for each optimizer, and the
tensors the caller gave are the ones stepped.
``chip_smoke.py`` phase 13 makes the same check on the card at full width.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch.configs.base import RuntimeConfig
from repro_torch.configs.registry import reduced_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.model import Model, init_params
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as tloop

torch.set_num_threads(1)


def _setup(arch: str, dtype: str):
    cfg = dataclasses.replace(reduced_config(arch), dtype=dtype)
    model = Model(cfg, runtime=RuntimeConfig(remat="full"))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    data = dict(seq_len=16, global_batch=2, vocab_size=cfg.vocab_size, seed=5)
    return model, params, data


def _pure(model, opt, params, data, steps: int):
    step = tloop.make_train_step(model, opt)
    state = topt.init_opt_state(opt, params)
    it = SyntheticLM(DataConfig(**data))
    losses = []
    for _ in range(steps):
        params, state, metrics = step(params, state, tloop.to_device(next(it), "cpu"))
        losses.append(float(metrics["loss"]))
    return params, state, losses


def _assert_same(a: dict, b: dict):
    la, lb = topt.tree_leaves(a), topt.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


@pytest.mark.parametrize("steps", [1, 8])
@pytest.mark.parametrize("arch,dtype,name", [
    ("olmo-1b", "float32", "adamw"), ("olmo-1b", "bfloat16", "adamw"),
    ("llama3.1-8b", "bfloat16", "adamw"), ("olmo-1b", "bfloat16", "lion"),
    ("olmo-1b", "float32", "sgd"),
])
def test_in_place_loop_equals_the_pure_step_bit_for_bit(arch, dtype, name, steps):
    model, params, data = _setup(arch, dtype)
    opt = topt.OptimizerConfig(name=name, warmup_steps=2, total_steps=20)
    p_pure, s_pure, losses = _pure(model, opt, params, data, steps)
    ptrs = [t.data_ptr() for t in topt.tree_leaves(params)]
    p_loop, s_loop, hist = tloop.run_train_loop(
        model, opt, tloop.TrainLoopConfig(steps=steps, log_every=1),
        SyntheticLM(DataConfig(**data)), params=params)
    _assert_same(p_loop, p_pure)
    _assert_same(s_loop, s_pure)
    assert [h["loss"] for h in hist] == losses
    assert [t.data_ptr() for t in topt.tree_leaves(p_loop)] == ptrs
    _assert_same(params, p_pure)  # the caller's tensors are the stepped ones


def test_the_loop_steps_a_given_state_in_place_and_resumes():
    """Two steps, then two more from the returned state at ``start_step``
    2: the state tensors the caller gave are the ones stepped, and the four
    steps equal four pure steps bit for bit."""
    model, params, data = _setup("olmo-1b", "bfloat16")
    opt = topt.OptimizerConfig(warmup_steps=2, total_steps=20)
    p_pure, s_pure, _ = _pure(model, opt, params, data, 4)
    state = topt.init_opt_state(opt, params)
    state_ptrs = [t.data_ptr() for t in topt.tree_leaves(state)]
    it = SyntheticLM(DataConfig(**data))
    p_loop, s_loop, _ = tloop.run_train_loop(
        model, opt, tloop.TrainLoopConfig(steps=2), it, params=params, opt_state=state)
    p_loop, s_loop, hist = tloop.run_train_loop(
        model, opt, tloop.TrainLoopConfig(steps=4), it, params=p_loop, opt_state=s_loop,
        start_step=2)
    assert [t.data_ptr() for t in topt.tree_leaves(s_loop)] == state_ptrs
    assert [h["step"] for h in hist] == [3]
    _assert_same(p_loop, p_pure)
    _assert_same(s_loop, s_pure)


@pytest.mark.parametrize("name", ["adamw", "lion", "sgd"])
def test_apply_updates_in_place_equals_the_pure_update(name):
    """One update on seeded weights, gradients and moments: the in-place
    form writes into the tensors it is given and returns them."""
    g = torch.Generator().manual_seed(3)
    params = {"a": {"w": torch.randn(4, 8, generator=g).bfloat16()},
              "b": torch.randn(8, generator=g)}
    grads = topt.tree_map(lambda p: torch.randn(p.shape, generator=g).to(p.dtype), params)
    opt = topt.OptimizerConfig(name=name)
    state = topt.init_opt_state(opt, params)
    state["step"].fill_(7)
    for k in ("m", "v"):
        if k in state:
            state[k] = topt.tree_map(lambda m: torch.rand(m.shape, generator=g), state[k])
    want_p, want_s = topt.apply_updates(opt, params, grads, state)
    copy = topt.tree_map(torch.clone, params)
    copy_s = topt.tree_map(torch.clone, state)
    got_p, got_s = topt.apply_updates(opt, copy, grads, copy_s, in_place=True)
    assert got_p is copy and got_s is copy_s
    _assert_same(got_p, want_p)
    _assert_same(got_s, want_s)
    assert not torch.equal(copy["b"], params["b"])  # the step moved the weights
