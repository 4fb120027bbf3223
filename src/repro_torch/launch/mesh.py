"""Device meshes over a process world (twin of ``repro/launch/mesh.py``).

A ``Mesh`` names the axes of a world of ``torch.distributed`` ranks laid
out row-major, as a JAX mesh names its devices' axes: rank r of a (D, M)
mesh ("data", "model") sits at coordinates (r // M, r % M). It holds the
axis names, the shape, this rank's coordinates and one process group for
every tuple of axes a collective may run over (each axis alone, and every
tuple of axes in mesh order: ``("pod", "data")``, ``("data", "model")``,
...). Every rank creates those groups in one fixed order, since a rank that
skipped a ``new_group`` would leave the others waiting for it.

A ``Mesh`` built with ``rank=None`` is abstract: it has axes, a shape and
coordinates (all 0, or those given) but no groups, which is all that
``AxisRules.spec`` and the shard arithmetic read.

The production and debug meshes keep JAX's shapes and axis names; the
world must already be initialised with as many ranks.

The card's constants price a cell (``launch/roofline.py``) and every
kernel's bound (``chip_smoke.py``, the experiments): one NVIDIA H100 SXM
from NVIDIA's data sheet, dense rates without sparsity, where JAX's
``mesh.py`` has a TPU's. ``COLLECTIVE_BW`` is MODELED: one NDR 400 Gb/s
InfiniBand port a GPU, as in a DGX H100. The production ``model`` axis of
16 spans two 8-GPU NVLink domains, so every collective of the 16x16 and
2x16x16 meshes crosses that fabric; one card cannot measure it.
"""

from __future__ import annotations

import itertools
import math
from datetime import timedelta

PEAK_FLOPS_BF16 = 989e12  # dense tensor-core bf16 (and fp16), per GPU
PEAK_FLOPS_TF32 = 495e12  # dense tensor-core TF32
PEAK_FLOPS_F32 = 67e12  # float32 outside the tensor cores
HBM_BW = 3.35e12  # bytes/s per GPU
HBM_PER_CHIP = 80e9  # the data sheet's 80 GB
COLLECTIVE_BW = 50e9  # bytes/s per GPU: one NDR 400 Gb/s port (MODELED)

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


class Mesh:
    def __init__(self, shape, axis_names, rank: int | None = None, device=None,
                 coords: dict | None = None, timeout_s: float = 300.0):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} for axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())
        self.device = device
        self.rank = rank
        self._groups: dict[tuple[str, ...], object] = {}
        if rank is not None:
            coords = self.coords_of(rank)
        self.coords = {a: 0 for a in self.axis_names} | dict(coords or {})
        if rank is not None:
            self._make_groups(timeout_s)

    def coords_of(self, rank: int) -> dict:
        out, r = {}, rank
        for a in reversed(self.axis_names):
            out[a] = r % self.shape[a]
            r //= self.shape[a]
        return {a: out[a] for a in self.axis_names}

    def rank_of(self, coords: dict) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def axes(self, axes) -> tuple[str, ...]:
        """A spec entry (None, an axis, or a tuple of axes) as a tuple in
        mesh order; raises on an axis the mesh lacks."""
        if axes is None:
            return ()
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"mesh {self.axis_names} has no axis {a!r}")
        return tuple(a for a in self.axis_names if a in axes)

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self.axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's shard index over ``axes``, row-major (JAX's
        ``axis_index`` of each axis combined as ``pos * size + index``)."""
        i = 0
        for a in self.axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes):
        """The process group of this rank's peers along ``axes``: the ranks
        that share its coordinates on every other axis, in shard order."""
        axes = self.axes(axes)
        if self.rank is None:
            raise RuntimeError("an abstract mesh has no process groups")
        return self._groups[axes]

    def _make_groups(self, timeout_s: float) -> None:
        import torch.distributed as dist

        if dist.get_world_size() != self.size:
            raise ValueError(f"a {self.size}-rank mesh {self.shape} in a world of "
                             f"{dist.get_world_size()} ranks")
        timeout = timedelta(seconds=timeout_s)
        for n in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, n):
                rest = [a for a in self.axis_names if a not in axes]
                for other in itertools.product(*(range(self.shape[a]) for a in rest)):
                    fixed = dict(zip(rest, other))
                    members = sorted(
                        self.rank_of(fixed | dict(zip(axes, inner)))
                        for inner in itertools.product(*(range(self.shape[a]) for a in axes)))
                    # every rank calls new_group for every group, in this order
                    g = dist.new_group(members, timeout=timeout)
                    if self.rank in members:
                        self._groups[axes] = g

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def make_mesh(shape, axis_names, device=None, timeout_s: float = 300.0) -> Mesh:
    """The mesh of this process's rank in the initialised world."""
    import torch.distributed as dist

    return Mesh(shape, axis_names, rank=dist.get_rank(), device=device, timeout_s=timeout_s)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    shape, axes = PRODUCTION[multi_pod]
    return make_mesh(shape, axes, device)


def make_debug_mesh(*, multi_pod: bool = False, model: int = 4, device=None) -> Mesh:
    """Small mesh with the same axis names, over the whole world."""
    import torch.distributed as dist

    n = dist.get_world_size()
    if multi_pod:
        return make_mesh((2, max(1, n // (2 * model)), model), ("pod", "data", "model"), device)
    return make_mesh((max(1, n // model), model), ("data", "model"), device)
