"""Optimizers from scratch: AdamW, Lion, SGD, the schedule and clipping.

Twin of ``repro/training/optimizer.py:19-163`` over the port's parameter
tree (nested dicts of tensors). The details that decide the numbers are
JAX's: moments in f32 whatever the parameter dtype; the update computed in
f32 and cast back to each leaf's dtype; the schedule and the bias
corrections ``b ** step`` computed in float32 tensors, not Python doubles;
decoupled weight decay on every leaf with ``ndim >= 2``, which takes in the
stacked per-layer vectors (a norm weight of shape (layers, d)), as JAX's
does. Leaves are visited in JAX's flattening order (sorted keys), so the
global norm sums them as JAX does. Every function is pure (it returns new
tensors and changes none it was given) except ``apply_updates`` with
``in_place``, which the training loop uses to keep one copy of the weights
and moments.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"  # adamw | lion | sgd
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # "none" | "bf16": gradients cast to bf16 before clipping (JAX casts them
    # before its data-parallel all-reduce; on one device only the rounding is left)
    grad_compression: str = "bf16"


def tree_leaves(tree: dict) -> list[torch.Tensor]:
    """The leaves of a nested dict in JAX's order: keys sorted, depth first."""
    out = []
    for key in sorted(tree):
        v = tree[key]
        out.extend(tree_leaves(v) if isinstance(v, dict) else [v])
    return out


def tree_unflatten(like: dict, leaves) -> dict:
    """``leaves`` (in ``tree_leaves`` order) in the structure of ``like``."""
    it = iter(leaves)

    def walk(t: dict) -> dict:
        return {k: walk(t[k]) if isinstance(t[k], dict) else next(it) for k in sorted(t)}

    return walk(like)


def tree_map(fn, tree: dict, *rest: dict) -> dict:
    """``fn`` over the leaves of trees of one structure."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr``, a float32 scalar."""
    step = step.to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree: dict, specs: dict | None = None, mesh=None) -> torch.Tensor:
    """The L2 norm over every leaf. Under a mesh (``specs``: the leaves'
    PartitionSpecs) ``tree`` holds this rank's whole-gradient shards: each
    leaf's sum of squares is summed over the axes it is sharded along (one
    ``all_reduce`` per tuple of axes), so no replica counts twice, and the
    leaves' sums are added in JAX's leaf order on every rank alike."""
    squares = [torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree)]
    if mesh is not None:
        from repro_torch.distributed import collectives as coll
        from repro_torch.distributed.sharding import sharded_axes

        groups: dict[tuple, list[int]] = {}
        for i, spec in enumerate(tree_leaves(specs)):
            groups.setdefault(sharded_axes(spec, mesh), []).append(i)
        for axes, idx in groups.items():
            if axes:
                summed = coll.all_reduce(torch.stack([squares[i] for i in idx]), mesh, axes)
                for j, i in enumerate(idx):
                    squares[i] = summed[j]
    return torch.sqrt(sum(squares))


def clip_by_global_norm(grads: dict, max_norm: float, specs: dict | None = None,
                        mesh=None) -> tuple[dict, torch.Tensor]:
    norm = global_norm(grads, specs, mesh)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), norm


def init_opt_state(cfg: OptimizerConfig, params: dict) -> dict:
    """{"step": int32 0, and the f32 moments the optimizer keeps: "m" and
    "v" (AdamW), "m" (Lion), none (SGD)}, on the parameters' device."""
    device = tree_leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    state = {"step": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.name == "adamw":
        state["m"] = tree_map(zeros, params)
        state["v"] = tree_map(zeros, params)
    elif cfg.name == "lion":
        state["m"] = tree_map(zeros, params)
    elif cfg.name != "sgd":
        raise ValueError(cfg.name)
    return state


def apply_updates(cfg: OptimizerConfig, params: dict, grads: dict, state: dict,
                  in_place: bool = False) -> tuple[dict, dict]:
    """One optimizer step: (new params, new state). With ``in_place`` each
    leaf's new value and moments are written into the tensors it was given,
    leaf by leaf (so only one leaf's f32 temporaries live at a time), and
    ``params`` and ``state`` themselves come back; the arithmetic is the
    same, so the values equal the pure step's bit for bit."""
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2

    if cfg.name == "adamw":
        bc1 = 1.0 - torch.pow(_f32(b1, step.device), step.to(torch.float32))
        bc2 = 1.0 - torch.pow(_f32(b2, step.device), step.to(torch.float32))

        def update(p, g, m, v):
            g = g.to(torch.float32)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * torch.square(g)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if p.ndim >= 2:  # decoupled weight decay on matrices (and stacked vectors)
                delta = delta + cfg.weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * delta).to(p.dtype), m, v

        moments = ("m", "v")
    elif cfg.name == "lion":
        def update(p, g, m):
            g = g.to(torch.float32)
            u = torch.sign(b1 * m + (1 - b1) * g)
            if p.ndim >= 2:
                u = u + cfg.weight_decay * p.to(torch.float32)
            m = b2 * m + (1 - b2) * g
            return (p.to(torch.float32) - lr * u).to(p.dtype), m

        moments = ("m",)
    elif cfg.name == "sgd":
        def update(p, g):
            return ((p.to(torch.float32) - lr * g.to(torch.float32)).to(p.dtype),)

        moments = ()
    else:
        raise ValueError(cfg.name)

    if in_place:
        for leaves in zip(tree_leaves(params), tree_leaves(grads),
                          *(tree_leaves(state[k]) for k in moments)):
            for dst, new in zip((leaves[0], *leaves[2:]), update(*leaves)):
                dst.copy_(new)
        state["step"].copy_(step)
        return params, state
    out = tree_map(update, params, grads, *(state[k] for k in moments))
    new_state = {"step": step, **{k: _nth(out, i + 1) for i, k in enumerate(moments)}}
    return _nth(out, 0), new_state


def _nth(tree: dict, i: int) -> dict:
    """A tree of tuples -> the tree of their i-th items."""
    return {k: _nth(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def opt_state_specs(cfg: OptimizerConfig, param_specs: dict) -> dict:
    """The optimizer state as ParamSpec leaves (``repro/training/
    optimizer.py:78-91``): ``step`` a scalar int32, and per moment the
    parameters' shapes and logical axes in float32, at zeros. Under a mesh
    each rank's moments are its shards of these (``init_opt_state`` of its
    parameter shards), and a world's checkpoint is keyed and cut by them."""
    from repro_torch.distributed.sharding import ParamSpec, tree_map

    def f32(p):
        return ParamSpec(p.shape, torch.float32, p.logical_axes, init="zeros")

    state = {"step": ParamSpec((), torch.int32, (), init="zeros")}
    if cfg.name == "adamw":
        state["m"] = tree_map(f32, param_specs)
        state["v"] = tree_map(f32, param_specs)
    elif cfg.name == "lion":
        state["m"] = tree_map(f32, param_specs)
    return state
