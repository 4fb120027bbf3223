"""Named-axis collectives over a ``Mesh``, and the row-parallel product.

Twin of ``repro/distributed/collectives.py`` plus the few collectives that
JAX's partitioner or ``shard_map`` places for the model (``all_gather``,
``psum``, ``pmax``, ``all_to_all``): each runs over the process group of a
tuple of mesh axes (``Mesh.group``), shards in row-major order over those
axes. Only forms that gloo takes are used. Gloo reduces in host memory, so
a tensor on the card goes through a host copy and comes back to its device;
NCCL would refuse two ranks on one device, which is how one card runs a
world.

Each collective runs inside ``kernels.accounting.collective``, which tells
the op analyzer (``launch/op_analysis.py``) its kind, axes, bytes sent per
device (its operand's, at the operand's dtype, as JAX's analyzer counts)
and dtype, and keeps the host copies of its staging out of the count. On
an abstract mesh (``Mesh(rank=None)``, the dry run's) a collective of
``meta`` tensors stages nothing: it is recorded and returns an empty
tensor of the result's shape and dtype. A real tensor under an abstract
mesh raises, as ``Mesh.group`` does.

``row_parallel_matmul`` is the Megatron TP epilogue: each rank multiplies
its column shard of the activation by its row shard of the weight, then
the partials are summed over ``model``. With ``rowp_bf16`` the partial is
cast to the activation dtype before the sum (JAX's ``shard_map`` + bf16
``psum``); without it the f32 partials are summed and the sum cast, as the
partitioner reduces the f32 accumulator.

Gradients. A collective called under grad mode on a tensor that requires
grad goes through a ``torch.autograd.Function`` whose backward runs its own
collective over the same group, on the tensors' device (so every backward
collective runs on the one autograd thread of that device, in the graph's
order, which is the same on every rank):

* ``all_reduce`` sum: a psum of the cotangent;
* ``all_reduce`` max: no gradient. Its one use is the shift of a
  log-sum-exp (``layers.sharded_log_softmax_pick``), which the result does
  not depend on, so zero is exact there;
* ``all_gather`` (and ``all_gather_stacked``): a reduce-scatter of the
  cotangent along the gathered dim; ``all_gather_flat`` one reduce-scatter
  of the flat buffer, so FSDP's gather of a layer costs one collective in
  the backward as in the forward;
* ``all_to_all``: the all-to-all of the cotangent (the tiled all-to-all is
  its own inverse); ``row_parallel_matmul`` follows from ``all_reduce``.

These are the transposes of the collectives when every rank's cotangent is
a *partial*: the true cotangent of a value is the sum of the cotangents
that the ranks holding a copy of it carry. A loss that every rank of the
world computes alike is seeded with 1 / (world size) on each rank; then
a parameter shard's gradient is whole once it is summed over the mesh axes
its spec replicates it along (``sharding.reduce_replicated``): a leaf
sharded over every axis of size > 1 (FSDP over ``data``, TP over
``model``) comes out of the reduce-scatters whole, a replicated one (a norm
weight) needs the psum. Activations replicated over ``model`` need no copy
op at the entry to sharded compute (Megatron's "f"): each rank's partial
cotangent of them is its own part of the sum.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels import accounting

OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _staged(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous() if t.device.type != "cpu" else t.contiguous()


def _back(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t.to(like.device, non_blocking=False) if like.device.type != "cpu" else t


def _tracked(*ts: torch.Tensor) -> bool:
    """Whether a collective of ``ts`` belongs in the autograd graph."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


# ---------------------------------------------------------------------------
# The collectives themselves, outside autograd
# ---------------------------------------------------------------------------


def _abstract(t: torch.Tensor, mesh) -> bool:
    """Whether a collective of ``t`` over ``mesh`` is only recorded: the
    mesh is abstract, which takes meta tensors alone."""
    if mesh.rank is None:
        if t.device.type != "meta":
            raise RuntimeError(f"an abstract mesh runs collectives of meta tensors only, "
                               f"not of a tensor on {t.device}")
        return True
    return False


def _recorded(kind: str, t: torch.Tensor, mesh, axes, out_numel: int | None = None):
    """The accounting region of a collective of ``t`` whose result has
    ``out_numel`` elements (default: as many as ``t``)."""
    out_numel = t.numel() if out_numel is None else out_numel
    return accounting.collective(kind, mesh.axes(axes), t.numel() * t.element_size(),
                                 out_numel * t.element_size(), t.dtype)


def _psum(t: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    with _recorded("all-reduce", t, mesh, axes):
        if _abstract(t, mesh):
            return t.new_empty(t.shape)
        buf = _staged(t).clone()
        dist.all_reduce(buf, op=OPS[op], group=mesh.group(axes))
        return _back(buf, t)


def _gather0(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Every shard's ``t`` concatenated along dim 0."""
    n = mesh.axis_size(axes)
    with _recorded("all-gather", t, mesh, axes, n * t.numel()):
        if _abstract(t, mesh):
            return t.new_empty((n * t.shape[0], *t.shape[1:]))
        src = _staged(t)
        out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=src.dtype)
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        gather(out, src, group=mesh.group(axes))
        return _back(out, t)


def _scatter0(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum over the shards of ``t``, cut along dim 0 into as many
    chunks: this rank's chunk (the reduce-scatter, transpose of ``_gather0``)."""
    n = mesh.axis_size(axes)
    with _recorded("reduce-scatter", t, mesh, axes, t.numel() // n):
        if _abstract(t, mesh):
            return t.new_empty((t.shape[0] // n, *t.shape[1:]))
        src = _staged(t)
        out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=src.dtype)
        scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
        scatter(out, src, group=mesh.group(axes))
        return _back(out, t)


def _a2a(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    with _recorded("all-to-all", t, mesh, axes):
        if _abstract(t, mesh):
            return t.new_empty(t.shape)
        src = _staged(t)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=mesh.group(axes))
        return _back(out, t)


def _gather(t: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    return _gather0(t.movedim(dim, 0), mesh, axes).movedim(0, dim).contiguous()


def _scatter(t: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    return _scatter0(t.movedim(dim, 0), mesh, axes).movedim(0, dim).contiguous()


def _gather_flat(parts, dims, mesh, axes) -> list:
    n = mesh.axis_size(axes)
    moved = [p.movedim(d, 0) for p, d in zip(parts, dims)]
    flat = torch.cat([m.reshape(-1).to(parts[0].dtype) for m in moved])
    every = _gather0(flat[None], mesh, axes)  # (n, total)
    out, at = [], 0
    for p, m, d in zip(parts, moved, dims):
        k = m.numel()
        whole = every[:, at: at + k].reshape(n * m.shape[0], *m.shape[1:])
        out.append(whole.to(p.dtype).movedim(0, d).contiguous())
        at += k
    return out


# ---------------------------------------------------------------------------
# Their autograd Functions
# ---------------------------------------------------------------------------


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, op):
        ctx.mesh, ctx.axes, ctx.op = mesh, axes, op
        return _psum(t, mesh, axes, op)

    @staticmethod
    def backward(ctx, g):
        if ctx.op == "max":
            return None, None, None, None
        return _psum(g, ctx.mesh, ctx.axes), None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, mesh, axes):
        ctx.dim, ctx.mesh, ctx.axes = dim, mesh, axes
        return _gather(t, dim, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.dim, ctx.mesh, ctx.axes), None, None, None


class _AllGatherFlat(torch.autograd.Function):
    """``all_gather_flat``'s parts in one gather, and their cotangents in
    one reduce-scatter of the same flat layout."""

    @staticmethod
    def forward(ctx, mesh, axes, dims, *parts):
        ctx.mesh, ctx.axes, ctx.dims = mesh, axes, dims
        ctx.shapes = [p.movedim(d, 0).shape for p, d in zip(parts, dims)]
        ctx.dtypes = [p.dtype for p in parts]
        return tuple(_gather_flat(parts, dims, mesh, axes))

    @staticmethod
    def backward(ctx, *grads):
        n = ctx.mesh.axis_size(ctx.axes)
        # each part's cotangent as (n, its size): row r is shard r's part
        rows = [g.movedim(d, 0).reshape(n, -1).to(ctx.dtypes[0])
                for g, d in zip(grads, ctx.dims)]
        mine = _scatter0(torch.cat(rows, 1), ctx.mesh, ctx.axes)[0]
        out, at = [], 0
        for shape, d, dt in zip(ctx.shapes, ctx.dims, ctx.dtypes):
            k = shape.numel()
            out.append(mine[at: at + k].reshape(shape).to(dt).movedim(0, d).contiguous())
            at += k
        return (None, None, None, *out)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _a2a(t, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.mesh, ctx.axes), None, None


# ---------------------------------------------------------------------------
# The collectives the model calls
# ---------------------------------------------------------------------------


def all_reduce(t: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """``psum`` (op "sum") or ``pmax`` (op "max") over ``axes``; a new tensor."""
    if mesh.axis_size(axes) == 1:
        return t
    if _tracked(t):
        return _AllReduce.apply(t, mesh, axes, op)
    return _psum(t, mesh, axes, op)


def all_gather(t: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """The shards over ``axes`` concatenated along ``dim`` in shard order."""
    if mesh.axis_size(axes) == 1:
        return t
    if _tracked(t):
        return _AllGather.apply(t, dim, mesh, axes)
    return _gather(t, dim, mesh, axes)


def all_gather_stacked(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Every shard's ``t`` over ``axes``, stacked on a new leading dim in
    shard order: (n, *t.shape)."""
    return all_gather(t[None], 0, mesh, axes)


def all_gather_flat(parts: list, dims: list, mesh, axes) -> list:
    """``all_gather(part, dim)`` of every part in ONE collective: each part
    with its dim moved first is flattened into one buffer (the first part's
    dtype), the buffers are gathered, and each part is cut back out of every
    shard's buffer."""
    if mesh.axis_size(axes) == 1 or not parts:
        return list(parts)
    if _tracked(*parts):
        return list(_AllGatherFlat.apply(mesh, axes, tuple(dims), *parts))
    return _gather_flat(parts, dims, mesh, axes)


def all_to_all(t: torch.Tensor, mesh, axes="model") -> torch.Tensor:
    """JAX's tiled ``all_to_all`` on dim 0: chunk i of dim 0 goes to shard
    i, and the result's chunk i comes from shard i."""
    n = mesh.axis_size(axes)
    if n == 1:
        return t
    if t.shape[0] % n:
        raise ValueError(f"all_to_all of dim 0 = {t.shape[0]} over {n} shards")
    if _tracked(t):
        return _AllToAll.apply(t, mesh, axes)
    return _a2a(t, mesh, axes)


def row_parallel_matmul(x: torch.Tensor, w: torch.Tensor, rules) -> torch.Tensor:
    """x (..., f) with f sharded over ``model``, w (f, d) with rows sharded
    likewise -> x @ w summed over ``model``, in x's dtype."""
    if rules.tp == 1:
        return x @ w
    if rules.rowp_bf16:
        return all_reduce(x @ w, rules.mesh, "model")
    part = x.float() @ w.float()
    return all_reduce(part, rules.mesh, "model").to(x.dtype)
