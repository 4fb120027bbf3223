"""Named-axis collectives over a ``Mesh``, and the row-parallel product.

Twin of ``repro/distributed/collectives.py`` plus the few collectives that
JAX's partitioner or ``shard_map`` places for the model (``all_gather``,
``psum``, ``pmax``, ``all_to_all``): each runs over the process group of a
tuple of mesh axes (``Mesh.group``), shards in row-major order over those
axes. Only forms that gloo takes are used. Gloo reduces in host memory, so
a tensor on the card goes through a host copy and comes back to its device;
NCCL would refuse two ranks on one device, which is how one card runs a
world.

``row_parallel_matmul`` is the Megatron TP epilogue: each rank multiplies
its column shard of the activation by its row shard of the weight, then
the partials are summed over ``model``. With ``rowp_bf16`` the partial is
cast to the activation dtype before the sum (JAX's ``shard_map`` + bf16
``psum``); without it the f32 partials are summed and the sum cast, as the
partitioner reduces the f32 accumulator.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _staged(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous() if t.device.type != "cpu" else t.contiguous()


def _back(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t.to(like.device, non_blocking=False) if like.device.type != "cpu" else t


def all_reduce(t: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """``psum`` (op "sum") or ``pmax`` (op "max") over ``axes``; a new tensor."""
    if mesh.axis_size(axes) == 1:
        return t
    buf = _staged(t).clone()
    dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op],
                    group=mesh.group(axes))
    return _back(buf, t)


def all_gather(t: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """The shards over ``axes`` concatenated along ``dim`` in shard order."""
    n = mesh.axis_size(axes)
    if n == 1:
        return t
    src = _staged(t.movedim(dim, 0))
    out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=src.dtype)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, src, group=mesh.group(axes))
    return _back(out, t).movedim(0, dim).contiguous()


def all_gather_stacked(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Every shard's ``t`` over ``axes``, stacked on a new leading dim in
    shard order: (n, *t.shape)."""
    return all_gather(t[None], 0, mesh, axes)


def all_gather_flat(parts: list, dims: list, mesh, axes) -> list:
    """``all_gather(part, dim)`` of every part in ONE collective: each part
    with its dim moved first is flattened into one buffer, the buffers are
    gathered, and each part is cut back out of every shard's buffer."""
    n = mesh.axis_size(axes)
    if n == 1 or not parts:
        return list(parts)
    moved = [p.movedim(d, 0) for p, d in zip(parts, dims)]
    flat = torch.cat([m.reshape(-1).to(parts[0].dtype) for m in moved])
    every = all_gather_stacked(flat, mesh, axes)  # (n, total)
    out, at = [], 0
    for p, m, d in zip(parts, moved, dims):
        k = m.numel()
        whole = every[:, at: at + k].reshape(n * m.shape[0], *m.shape[1:])
        out.append(whole.to(p.dtype).movedim(0, d).contiguous())
        at += k
    return out


def all_to_all(t: torch.Tensor, mesh, axes="model") -> torch.Tensor:
    """JAX's tiled ``all_to_all`` on dim 0: chunk i of dim 0 goes to shard
    i, and the result's chunk i comes from shard i."""
    n = mesh.axis_size(axes)
    if n == 1:
        return t
    if t.shape[0] % n:
        raise ValueError(f"all_to_all of dim 0 = {t.shape[0]} over {n} shards")
    src = _staged(t)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group(axes))
    return _back(out, t)


def row_parallel_matmul(x: torch.Tensor, w: torch.Tensor, rules) -> torch.Tensor:
    """x (..., f) with f sharded over ``model``, w (f, d) with rows sharded
    likewise -> x @ w summed over ``model``, in x's dtype."""
    if rules.tp == 1:
        return x @ w
    if rules.rowp_bf16:
        return all_reduce(x @ w, rules.mesh, "model")
    part = x.float() @ w.float()
    return all_reduce(part, rules.mesh, "model").to(x.dtype)
