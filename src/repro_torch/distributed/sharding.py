"""Logical-axis sharding rules, and one rank's shards of a parameter tree.

Twin of ``repro/distributed/sharding.py``. Every parameter, cache leaf and
activation carries a tuple of *logical* axis names; ``AxisRules`` maps them
to mesh axes exactly as JAX's does (``spec``), for the production meshes

  single-pod  : (16, 16)      axes ("data", "model")
  multi-pod   : (2, 16, 16)   axes ("pod", "data", "model")

Weights are TP-sharded over ``model`` (heads / d_ff / vocab / experts) and
FSDP-sharded over ``data`` (+``pod``) on the remaining large dimension.

Where JAX hands a ``NamedSharding`` to the partitioner, the port computes a
rank's shard itself: a spec entry's mesh axes cut the dim into as many
equal, contiguous shards, numbered row-major over those axes
(``Mesh.axis_index``), and the rank keeps the one at its coordinates
(``local_shape``, ``local_slice``, ``shard_tree``). A dim that its axes do
not divide raises a ``ValueError`` naming the leaf and the axes, where
JAX's partitioner would pad. ``init_tree`` draws the single-device values
in the single-device order and keeps the rank's slice, so every rank holds
its shard of the same global tree (JAX's ``jit(init, out_shardings=...)``).
What compute needs whole, the FSDP dims over ``data``, ``gather_tree``
gathers at use, a layer at a time; the dims over ``model`` stay sharded
(tensor parallelism). A gradient of a rank's shards is made whole by
``reduce_replicated`` (``distributed/collectives.py`` says why).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import torch

MeshAxes = tuple[str, ...] | str | None
INIT_SCALE = 0.02


def _default_rules(multi_pod: bool) -> dict[str, MeshAxes]:
    fsdp: MeshAxes = ("pod", "data") if multi_pod else ("data",)
    batch: MeshAxes = ("pod", "data") if multi_pod else ("data",)
    return {
        # --- weight axes ---
        "embed": fsdp,  # d_model dim of weights (FSDP)
        "vocab": "model",
        "heads": "model",
        "kv_heads": None,  # replicated (GQA kv < TP degree)
        "kv_flat": "model",  # flattened (hkv*hd) KV projection columns
        "head_dim": None,
        "mlp": "model",
        "experts": "model",
        "expert_mlp": None,
        "ssm_inner": "model",  # d_inner / ssm heads
        "ssm_state": None,
        "conv_dim": None,
        "layers": None,  # stacked leading dim
        "norm": None,
        # --- activation axes ---
        "batch": batch,
        "seq": None,
        "act_embed": None,  # d_model dim of activations
        "act_heads": "model",
        "act_mlp": "model",
        "act_vocab": "model",
        "kv_seq": "model",  # pool-interleaved KV sequence (Beluga O9)
        "kv_seq_long": ("data", "model"),  # long-context single-request decode
        "pool_blocks": "model",  # Beluga pool block interleaving
    }


@dataclass(frozen=True)
class AxisRules:
    mesh: object  # launch.mesh.Mesh
    rules: dict
    # row-parallel products: each rank's partial cast to the activation
    # dtype before the sum over `model` (collectives.row_parallel_matmul)
    rowp_bf16: bool = False

    @classmethod
    def create(cls, mesh, overrides: dict | None = None, rowp_bf16: bool = False) -> "AxisRules":
        rules = _default_rules("pod" in mesh.axis_names)
        if overrides:
            rules.update(overrides)
        return cls(mesh=mesh, rules=rules, rowp_bf16=rowp_bf16)

    def spec(self, logical_axes: tuple) -> tuple:
        """The PartitionSpec of a tuple of logical axis names, as a plain
        tuple: per dim None, a mesh axis, or a tuple of two or more mesh
        axes (one axis stands alone, as PartitionSpec writes it). A mesh
        axis that an earlier dim already used is dropped."""
        out: list[MeshAxes] = []
        used: set[str] = set()
        for ax in logical_axes:
            if ax is None:
                out.append(None)
                continue
            if ax not in self.rules:
                raise KeyError(f"unknown logical axis {ax!r}")
            mesh_ax = self.rules[ax]
            if isinstance(mesh_ax, tuple):
                mesh_ax = tuple(m for m in mesh_ax if m not in used) or None
            elif mesh_ax in used:
                mesh_ax = None
            if isinstance(mesh_ax, tuple):
                used.update(mesh_ax)
                if len(mesh_ax) == 1:  # PartitionSpec's form of a single axis
                    mesh_ax = mesh_ax[0]
            elif mesh_ax is not None:
                used.add(mesh_ax)
            out.append(mesh_ax)
        return tuple(out)

    def axis_size(self, name: str) -> int:
        return self.mesh.shape[name]

    @property
    def tp(self) -> int:
        return self.mesh.shape["model"]

    @property
    def dp(self) -> int:
        n = self.mesh.shape["data"]
        if "pod" in self.mesh.axis_names:
            n *= self.mesh.shape["pod"]
        return n

    @property
    def batch_axes(self) -> tuple[str, ...]:
        return self.mesh.axes(self.rules.get("batch"))


class ParamSpec:
    """A leaf descriptor: shape, torch dtype, logical axes, init rule and scale."""

    __slots__ = ("shape", "dtype", "logical_axes", "init", "scale")

    def __init__(self, shape, dtype, logical_axes, init="normal", scale=INIT_SCALE):
        if len(shape) != len(logical_axes):
            raise ValueError(f"shape {shape} for logical axes {logical_axes}")
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.logical_axes = tuple(logical_axes)
        self.init = init
        self.scale = scale

    def __repr__(self):
        return f"ParamSpec({self.shape}, {self.dtype}, {self.logical_axes})"


def is_param_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a dict tree (and matching trees ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_specs(param_tree, rules: AxisRules):
    """A tree of ParamSpec leaves -> the tree of their PartitionSpecs."""
    return tree_map(lambda p: rules.spec(p.logical_axes), param_tree)


# ---------------------------------------------------------------------------
# One rank's shard
# ---------------------------------------------------------------------------


def shard_bounds(mesh, entry, size: int, name: str = "", dim: int = 0) -> tuple[int, int]:
    """(start, length) of this rank's shard of a dim of ``size`` cut over
    the mesh axes ``entry`` (a PartitionSpec entry)."""
    n = mesh.axis_size(entry)
    if size % n:
        raise ValueError(f"{name or 'leaf'}: dim {dim} of {size} does not divide over mesh "
                         f"axes {mesh.axes(entry)} ({n} shards)")
    per = size // n
    return mesh.axis_index(entry) * per, per


def shard_box(shape, spec: tuple, mesh, name: str = "") -> tuple[slice, ...]:
    """This rank's shard of a leaf of global ``shape`` under PartitionSpec
    ``spec``: a slice of the whole leaf per dim."""
    return tuple(slice(lo, lo + n) for lo, n in (
        shard_bounds(mesh, e, s, name, i) for i, (s, e) in enumerate(zip(shape, spec))))


def local_shape(shape, spec: tuple, mesh, name: str = "") -> tuple[int, ...]:
    return tuple(shard_bounds(mesh, e, s, name, i)[1] for i, (s, e) in enumerate(zip(shape, spec)))


def local_slice(t: torch.Tensor, spec: tuple, mesh, name: str = "") -> torch.Tensor:
    """This rank's shard of a full tensor (or numpy array), a view."""
    for i, e in enumerate(spec):
        if e is not None:
            lo, n = shard_bounds(mesh, e, t.shape[i], name, i)
            t = t[(slice(None),) * i + (slice(lo, lo + n),)]
    return t


def shard_tree(tree, specs, rules: AxisRules):
    """A full tree (the port's, or JAX's converted one) and its ParamSpec
    tree -> this rank's shards, contiguous copies."""

    def walk(t, s, path):
        if isinstance(s, dict):
            if set(t) != set(s):
                raise ValueError(f"{path or 'tree'}: keys {sorted(t)} != {sorted(s)}")
            return {k: walk(t[k], s[k], f"{path}/{k}") for k in s}
        return local_slice(t, rules.spec(s.logical_axes), rules.mesh, path).contiguous()

    return walk(tree, specs, "")


def _drawn_dims(spec: ParamSpec) -> int:
    """Leading dims drawn one index at a time: the stacked layer dim, and
    then an expert dim, so that the f32 draw never holds more than one
    layer of one tensor, or one expert of it."""
    n = 0
    for ax in spec.logical_axes:
        if ax not in ("layers", "experts"):
            break
        n += 1
    return n


def _draw(shape, init: str, generator, device) -> torch.Tensor:
    if init == "normal":
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device).mul_(INIT_SCALE)
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
    if init == "ssm_a":  # A_log: log of uniform [1, 16]
        return torch.log(u * 15.0 + 1.0)
    if init == "ssm_dt":  # dt_bias: softplus^-1(uniform [1e-3, 1e-1])
        u = u * (1e-1 - 1e-3) + 1e-3
        return u + torch.log(-torch.expm1(-u))
    raise ValueError(init)


def init_tree(param_tree, generator: torch.Generator, device, rules: AxisRules | None = None):
    """Random parameters on ``device`` (``generator`` lives there too): the
    JAX init rules (normal(0, 1) * scale drawn in f32 and cast; ones; zeros;
    ``ssm_a``, ``ssm_dt``: ``repro/distributed/sharding.py:200-224``), drawn
    leaf by leaf in the tree's order and each leaf part by part
    (``_drawn_dims``). With ``rules``, every part is still drawn whole, in
    the same order, and only this rank's shard of it is kept: each rank
    holds its shard of the tree one device would draw."""

    def make(spec: ParamSpec, path: str) -> torch.Tensor:
        pspec = rules.spec(spec.logical_axes) if rules is not None else (None,) * len(spec.shape)
        mesh = rules.mesh if rules is not None else None
        shape = (local_shape(spec.shape, pspec, mesh, path) if rules is not None
                 else spec.shape)
        if spec.init in ("ones", "zeros"):
            fill = torch.ones if spec.init == "ones" else torch.zeros
            return fill(shape, dtype=spec.dtype, device=device)
        out = torch.empty(shape, dtype=spec.dtype, device=device)
        lead = _drawn_dims(spec)
        ranges = []  # per leading dim: (start, length) of the kept shard
        for i in range(lead):
            ranges.append(shard_bounds(mesh, pspec[i], spec.shape[i], path, i) if pspec[i] is not None
                          else (0, spec.shape[i]))
        for idx in itertools.product(*(range(s) for s in spec.shape[:lead])):
            part = _draw(spec.shape[lead:], spec.init, generator, device)
            if not all(lo <= j < lo + n for j, (lo, n) in zip(idx, ranges)):
                continue
            if rules is not None:
                part = local_slice(part, pspec[lead:], mesh, path)
            out[tuple(j - lo for j, (lo, _) in zip(idx, ranges))] = part
        return out

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in tree.items()}
        return make(tree, path)

    return walk(param_tree, "")


# ---------------------------------------------------------------------------
# What compute needs whole
# ---------------------------------------------------------------------------


def gather_tree(tree, specs, mesh):
    """A tree of weight shards with their FSDP dims (those sharded over mesh
    axes other than ``model``) gathered whole, in one collective per tuple
    of mesh axes and dtype: a layer's weights are gathered at use and
    dropped after. Dims over ``model`` stay as they are."""
    from repro_torch.distributed import collectives as coll

    leaves, todo = {}, {}
    flat = list(_flatten(tree, specs))
    for path, t, spec in flat:
        dims = [(i, mesh.axes(e)) for i, e in enumerate(spec)
                if mesh.axes(e) and "model" not in mesh.axes(e) and mesh.axis_size(e) > 1]
        if len(dims) > 1:
            raise ValueError(f"{path}: FSDP-sharded on {len(dims)} dims")
        if dims:
            todo.setdefault((dims[0][1], t.dtype), []).append((path, t, dims[0][0]))
        else:
            leaves[path] = t
    for (axes, _), items in todo.items():
        got = coll.all_gather_flat([t for _, t, _ in items], [d for _, _, d in items], mesh, axes)
        leaves.update({path: g for (path, _, _), g in zip(items, got)})
    return _unflatten(tree, leaves)


def replicated_axes(spec: tuple, mesh) -> tuple[str, ...]:
    """The mesh axes of more than one shard that a leaf of PartitionSpec
    ``spec`` is replicated along (those no dim of it is sharded over)."""
    used = {a for e in spec for a in mesh.axes(e)}
    return tuple(a for a in mesh.axis_names if a not in used and mesh.shape[a] > 1)


def sharded_axes(spec: tuple, mesh) -> tuple[str, ...]:
    """The mesh axes of more than one shard that a leaf of ``spec`` is cut along."""
    used = {a for e in spec for a in mesh.axes(e)}
    return tuple(a for a in mesh.axis_names if a in used and mesh.shape[a] > 1)


def reduce_replicated(tree, specs, mesh, over=None, wire_dtype: torch.dtype | None = None):
    """A tree of each rank's partial gradients of its shards (module
    docstring of ``collectives``) -> the whole gradients: every leaf summed
    over the mesh axes its spec replicates it along, in one ``all_reduce``
    per tuple of axes and dtype (a leaf sharded over every axis is already
    whole). ``over`` keeps only those of the mesh axes (a spec entry; None:
    all), so that a sum can be taken in stages. With ``wire_dtype`` the
    leaves summed are cast to it for the sum and back (the bf16 gradient
    sum of ``grad_compression="bf16"``)."""
    from repro_torch.distributed import collectives as coll

    keep = mesh.axis_names if over is None else mesh.axes(over)
    leaves, todo = {}, {}
    for path, t, spec in _flatten(tree, specs):
        axes = tuple(a for a in replicated_axes(spec, mesh) if a in keep)
        if axes:
            todo.setdefault((axes, wire_dtype or t.dtype), []).append((path, t))
        else:
            leaves[path] = t
    for (axes, dtype), items in todo.items():
        flat = torch.cat([t.reshape(-1).to(dtype) for _, t in items])
        flat = coll.all_reduce(flat, mesh, axes)
        at = 0
        for path, t in items:
            leaves[path] = flat[at: at + t.numel()].reshape(t.shape).to(t.dtype)
            at += t.numel()
    return _unflatten(tree, leaves)


def _flatten(tree, specs, path=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flatten(tree[k], specs[k], f"{path}/{k}")
    else:
        yield path, tree, specs


def _unflatten(tree, leaves: dict, path=""):
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, f"{path}/{k}") for k, v in tree.items()}
    return leaves[path]
