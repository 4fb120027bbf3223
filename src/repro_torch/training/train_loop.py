"""Train step and host-side training loop.

Twin of ``repro/training/train_loop.py:30-143``. ``make_train_step`` gives

    (params, opt_state, batch) -> (params, opt_state, metrics)

where JAX's ``jax.value_and_grad(loss_fn)`` is PyTorch autograd through
``Model.loss_fn`` (the attention kernels' gradient is the backward kernel,
``kernels/ops.py``), in JAX's order:

  * gradients cast to bf16 (``OptimizerConfig.grad_compression="bf16"``)
    before the clip;
  * ``accum_steps`` microbatches: the batch's leading dimension split, each
    microbatch's (compressed) gradient added into f32 zeros, the sum and the
    loss divided by ``accum_steps``, the last microbatch's aux kept;
  * global-norm clipping, then the optimizer;
  * metrics ``loss``, ``grad_norm``, ``lr`` (of the new step) and ``aux/*``
    as 0-dim tensors on the parameters' device.

Under a mesh (``Model(rules=...)``, each rank of the world stepping its
shards) the step is the same function of the global batch, taken as
``distributed/collectives.py`` says: each rank seeds the backward with
1 / (world size); each gradient leaf is summed over the mesh axes its
spec replicates it along: over ``model`` in f32 for each microbatch, before
the compression rounds it once, as JAX rounds each microbatch's whole
gradient; over ``data`` once a step, after the microbatches are summed
locally, in bf16 with ``grad_compression="bf16"`` (JAX's DP reduction); the
global norm sums each leaf's squares over the axes it is sharded along;
the optimizer steps each rank's shards. The loss and metrics are the
global ones, equal on every rank.

The step is eager PyTorch: nothing is jitted. By default it is pure: the
parameters and state it is given are left as they were. With ``in_place``
it writes the new weights and moments into the tensors it was given, in
the same f32 arithmetic, so one copy of each is held instead of two (the
twin of JAX's ``donate_argnums=(0, 1)``, ``repro/training/train_loop.py:122``).
``run_train_loop`` steps in place, and with ``checkpoint_dir`` set saves
``{"params", "opt_state"}`` and the data iterator's state every
``checkpoint_every`` steps (``checkpoint/checkpointer.py``, JAX's format;
under a mesh every rank writes its shards).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.distributed.sharding import reduce_replicated
from repro_torch.models.model import Model
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.optimizer import (OptimizerConfig, tree_leaves, tree_map,
                                            tree_unflatten)


def value_and_grad(model: Model, params: dict, batch: dict, reduce: bool = True):
    """(loss, aux, gradient tree) of ``model.loss_fn`` at ``params``; a leaf
    the loss does not read gets zeros, as from ``jax.grad``. Under a mesh
    the tree is this rank's shards of the gradient: whole, or with
    ``reduce=False`` the rank's partials before ``reduce_replicated``."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, aux = model.loss_fn(live, batch)
        seed = None
        if model.rules is not None:  # the loss is replicated over the whole world
            seed = torch.full_like(loss, 1.0 / model.mesh.size)
        grads = torch.autograd.grad(loss, tree_leaves(live), grad_outputs=seed,
                                    allow_unused=True, materialize_grads=True)
    aux = {k: v.detach() for k, v in aux.items()}
    grads = tree_unflatten(params, grads)
    if model.rules is not None and reduce:
        grads = reduce_replicated(grads, model.partition_specs(), model.mesh)
    return loss.detach(), aux, grads


def make_train_step(model: Model, opt_cfg: OptimizerConfig, accum_steps: int = 1,
                    in_place: bool = False) -> Callable:
    def compress(g: dict) -> dict:
        if opt_cfg.grad_compression == "bf16":
            return tree_map(lambda x: x.to(torch.bfloat16), g)
        return g

    mesh = model.mesh
    specs = model.partition_specs()
    if mesh is not None:
        dp = mesh.axes(model.rules.rules["batch"])
        others = tuple(a for a in mesh.axis_names if a not in dp)
        wire = torch.bfloat16 if opt_cfg.grad_compression == "bf16" else None

    def grad(params: dict, batch: dict):
        """(loss, aux, gradient) of a (micro)batch, compressed. Under a mesh
        the ranks' partials are summed over the axes other than the batch's
        first, in f32, so that the gradient is rounded once, as JAX's."""
        loss, aux, g = value_and_grad(model, params, batch, reduce=False)
        if mesh is not None:
            g = reduce_replicated(g, specs, mesh, over=others)
        return loss, aux, compress(g)

    def train_step(params: dict, opt_state: dict, batch: dict):
        if accum_steps == 1:
            loss, aux, grads = grad(params, batch)
        else:
            def micro(x, i):
                b = x.shape[0]
                if b % accum_steps:
                    raise ValueError(f"batch {b} is not {accum_steps} whole microbatches")
                n = b // accum_steps
                return x[i * n:(i + 1) * n]

            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            loss = 0.0
            for i in range(accum_steps):
                mb = {k: micro(v, i) for k, v in batch.items()}
                l, aux, g = grad(params, mb)
                grads = tree_map(lambda a, b_: a + b_.to(a.dtype), grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / accum_steps, grads)
            loss = loss / accum_steps
        if mesh is not None:  # JAX's DP reduction, once a step
            grads = reduce_replicated(grads, specs, mesh, over=dp, wire_dtype=wire)

        grads, gnorm = opt_lib.clip_by_global_norm(grads, opt_cfg.grad_clip, specs, mesh)
        params, opt_state = opt_lib.apply_updates(opt_cfg, params, grads, opt_state,
                                                  in_place=in_place)
        metrics = {
            "loss": loss,
            "grad_norm": gnorm,
            "lr": opt_lib.lr_schedule(opt_cfg, opt_state["step"]),
            **{f"aux/{k}": v for k, v in aux.items()},
        }
        return params, opt_state, metrics

    return train_step


def state_specs(model: Model, opt_cfg: OptimizerConfig) -> dict:
    """The training state ``{"params", "opt_state"}`` as ParamSpec leaves:
    what a world's checkpoint keys and cuts its shards by."""
    specs = model.param_specs()
    return {"params": specs, "opt_state": opt_lib.opt_state_specs(opt_cfg, specs)}


@dataclass
class TrainLoopConfig:
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: str | None = None
    keep_checkpoints: int = 2


def to_device(batch: dict, device) -> dict:
    """A numpy batch (``data.pipeline``) as tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device) if not isinstance(v, torch.Tensor)
            else v.to(device) for k, v in batch.items()}


def run_train_loop(
    model: Model,
    opt_cfg: OptimizerConfig,
    loop_cfg: TrainLoopConfig,
    data_iter,
    params: dict | None = None,
    opt_state: dict | None = None,
    start_step: int = 0,
    step_fn=None,
    on_metrics=None,
):
    """Steps ``start_step`` .. ``loop_cfg.steps`` on batches from ``data_iter``,
    each moved to the parameters' device; returns (params, opt_state,
    history), history holding the metrics as floats at the first step and
    every ``log_every`` steps. ``params`` is required: the port draws no
    JAX key (``models.model.init_params`` makes them from a generator).

    The default step updates the weights and moments in place
    (``make_train_step(..., in_place=True)``): the loop steps the very
    tensors it is given, as JAX's donates them, and holds no copy. A caller
    that needs its weights afterwards passes a copy.

    With ``loop_cfg.checkpoint_dir`` set, after every ``checkpoint_every``
    steps the loop saves step ``step + 1``: the weights and moments as they
    stand, and ``extra={"data_state": data_iter.state_dict()}``, as JAX's
    loop does; a resumed run restores them and passes ``start_step``."""
    if params is None:
        raise ValueError("run_train_loop needs params (models.model.init_params makes them)")
    ckpt = None
    if loop_cfg.checkpoint_dir:
        if not hasattr(data_iter, "state_dict"):
            raise TypeError("a checkpointed loop needs a data iterator with state_dict() "
                            "(data.pipeline's datasets have one)")
        ckpt = Checkpointer(loop_cfg.checkpoint_dir, keep=loop_cfg.keep_checkpoints,
                            rules=model.rules)
    if opt_state is None:
        opt_state = opt_lib.init_opt_state(opt_cfg, params)
    if step_fn is None:
        step_fn = make_train_step(model, opt_cfg, in_place=True)
    device = tree_leaves(params)[0].device

    history = []
    for step in range(start_step, loop_cfg.steps):
        batch = to_device(next(data_iter), device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if (step + 1) % loop_cfg.log_every == 0 or step == start_step:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": step + 1, **m})
            if on_metrics:
                on_metrics(step + 1, m)
        if ckpt and (step + 1) % loop_cfg.checkpoint_every == 0:
            ckpt.save(step + 1, {"params": params, "opt_state": opt_state},
                      extra={"data_state": data_iter.state_dict()},
                      specs=state_specs(model, opt_cfg))
    return params, opt_state, history
