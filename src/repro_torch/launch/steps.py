"""Cell builders: (arch x shape x mesh) -> a callable and its arguments.

Twin of ``repro/launch/steps.py``, shared by the dry run
(``launch/dryrun.py``, on the ``meta`` device of an abstract mesh) and the
card (``chip_smoke.py`` phase 17, one device). A "cell" runs one of:

  train_4k     -> train_step  (loss + grad + AdamW update, remat, bf16 grads)
  prefill_32k  -> prefill_fn  (full prefill, emits populated KV/SSM cache)
  decode_32k   -> decode_fn   (one token, KV cache of seq_len)
  long_500k    -> decode_fn   (sub-quadratic archs only)

Where JAX's cell holds ShapeDtypeStructs and shardings to lower against,
the port's holds ``make_args(device)``: this rank's shards of the
parameters, the optimizer state or the cache (``local_shape`` of each
spec), and the global inputs, which the model takes whole under a mesh.
On ``meta`` nothing is allocated; elsewhere the parameters are the
model's seeded init, the moments zeros, tokens drawn from the seed and a
decode cache zeros with every row at its last position. JAX's
``lower_cell`` has no twin: ``launch/op_analysis.py`` counts the call as
it runs.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, RuntimeConfig, ShapeConfig, shape_applicable
from repro_torch.distributed.sharding import AxisRules, local_shape, tree_map
from repro_torch.models.model import Model
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_loop import make_train_step


@dataclass
class Cell:
    name: str
    fn: Callable
    make_args: Callable  # device (and an optional seed) -> the call's arguments
    notes: str = ""


def _decode_axes(rules: AxisRules, shape: ShapeConfig, runtime: RuntimeConfig):
    """(cache kv logical axes, kv shard mesh axes, batch mesh axes)."""
    multi_pod = "pod" in rules.mesh.axis_names
    if runtime.decode_kv == "replicated":
        return ("batch", None), (), ("pod", "data") if multi_pod else ("data",)
    if shape.name == "long_500k" or shape.global_batch < rules.dp:
        # batch unshardable: interleave KV seq across every mesh axis
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        return (None, "kv_seq_long"), axes, ()
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    return ("batch", "kv_seq"), ("model",), batch_axes


def _leaves(specs, rules: AxisRules | None, device) -> dict:
    """Empty tensors of this rank's shards of a ParamSpec tree."""
    def leaf(p):
        shape = p.shape if rules is None else local_shape(
            p.shape, rules.spec(p.logical_axes), rules.mesh)
        return torch.empty(shape, dtype=p.dtype, device=device)

    return tree_map(leaf, specs)


def _inputs(model: Model, shape: ShapeConfig, device, gen: torch.Generator | None) -> dict:
    """The global inputs of a cell: empty on meta, else tokens drawn below
    the vocab and embeddings from N(0, 1)."""
    out = {}
    for name, (s, dtype) in model.input_specs(shape).items():
        if gen is None:
            out[name] = torch.empty(s, dtype=dtype, device=device)
        elif dtype.is_floating_point:
            out[name] = torch.randn(s, generator=gen, device=device).to(dtype)
        else:
            out[name] = torch.randint(0, model.cfg.vocab_size, s, generator=gen,
                                      device=device, dtype=dtype)
    return out


def build_cell(
    cfg: ModelConfig,
    shape: ShapeConfig,
    rules: AxisRules | None = None,
    runtime: RuntimeConfig | None = None,
    opt_cfg: OptimizerConfig | None = None,
) -> Cell:
    """The cell of ``cfg`` at ``shape`` on one rank of ``rules``' mesh, or
    on one device with ``rules=None``."""
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"cell not applicable: {why}")
    runtime = runtime or RuntimeConfig()
    opt_cfg = opt_cfg or OptimizerConfig()
    kv_axes, shard_axes, b_axes = ("batch", "kv_seq"), ("model",), ("data",)
    if rules is not None:
        if "pod" in rules.mesh.axis_names:
            # extend long-decode interleaving across the pod axis on multi-pod
            rules = dataclasses.replace(
                rules, rules={**rules.rules, "kv_seq_long": ("pod", "data", "model")})
        if runtime.rowp_bf16_psum:
            rules = dataclasses.replace(rules, rowp_bf16=True)
        if shape.is_decode:
            kv_axes, shard_axes, b_axes = _decode_axes(rules, shape, runtime)
            if kv_axes[1] == "kv_seq_long":  # the model's cache sequence over every axis
                rules = dataclasses.replace(
                    rules, rules={**rules.rules, "kv_seq": rules.rules["kv_seq_long"]})
    model = Model(cfg, runtime=runtime, rules=rules)
    name = f"{cfg.name}.{shape.name}"

    def params_of(device, gen):
        if gen is None:
            return _leaves(model.param_specs(), rules, device)
        return model.init(gen, device)

    def generator(device, seed):
        if seed is None or torch.device(device).type == "meta":
            return None
        return torch.Generator(device=device).manual_seed(seed)

    if shape.kind == "train":
        def make_args(device, seed: int | None = 0):
            gen = generator(device, seed)
            params = params_of(device, gen)
            if gen is None:
                state = _leaves(opt_lib.opt_state_specs(opt_cfg, model.param_specs()), rules,
                                device)
            else:
                state = opt_lib.init_opt_state(opt_cfg, params)
            return params, state, _inputs(model, shape, device, gen)

        # the step writes the new weights and moments into its arguments, as
        # JAX's train step donates them (donate_argnums=(0, 1))
        return Cell(name, make_train_step(model, opt_cfg, in_place=True), make_args,
                    notes=f"train_step remat={runtime.remat} "
                    f"grad_compression={opt_cfg.grad_compression}")

    if shape.kind == "prefill":
        def make_args(device, seed: int | None = 0):
            gen = generator(device, seed)
            return params_of(device, gen), _inputs(model, shape, device, gen)

        return Cell(name, functools.partial(model.prefill_fn, max_len=shape.seq_len),
                    make_args, notes="prefill_fn -> (last logits, populated cache)")

    def make_args(device, seed: int | None = 0):
        gen = generator(device, seed)
        b = shape.global_batch
        tokens = _inputs(model, shape, device, gen)["tokens"]
        pos = torch.full((b,), shape.seq_len - 1, dtype=torch.int32, device=device)
        return (params_of(device, gen), model.init_cache(b, shape.seq_len, device), tokens,
                pos)

    # the step updates the cache in place, as JAX's donates it
    fn = functools.partial(model.decode_fn, kv_shard_axes=shard_axes, kv_batch_axes=b_axes)
    return Cell(name, fn, make_args,
                notes=f"decode_fn kv={runtime.decode_kv} kv_axes={kv_axes} "
                f"shard_axes={shard_axes}")
