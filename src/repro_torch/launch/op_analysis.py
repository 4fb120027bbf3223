"""Op-level cost analyzer for the roofline report.

Twin of ``repro/launch/hlo_analysis.py``. The port runs eagerly and has no
HLO, so there is nothing to parse: ``OpAnalyzer`` is a
``TorchDispatchMode`` that counts what a call dispatches, op by op, as it
runs, on the card, on the CPU or on the ``meta`` device (a dry run). Used
as ``with OpAnalyzer(track=args) as a: fn(*args)``, then ``a.result()``.

All numbers are **per device**: under a mesh the call is one rank's
program (on an abstract mesh, ``launch/mesh.Mesh(rank=None)``, every
collective is recorded and staged nowhere). Counted:

  * FLOPs of the aten ops that ``torch.utils.flop_counter`` knows (GEMMs,
    convolutions), from its registry, exactly;
  * one FLOP an output element for elementwise ops and one an input
    element for reductions, transcendentals apart (JAX's ``ELEMENTWISE`` /
    ``TRANSCENDENTAL`` sets, ``reduce`` counted as JAX counts it);
  * bytes as eager execution moves them: each op's tensor inputs read and
    outputs written, nothing for views and aliases (JAX's ``_ALIAS_OPS`` /
    ``ZERO_COST``), nothing for an uninitialised allocation, twice the
    output for a gather-like read and twice the update for a scatter-like
    write (JAX's ``_SLICE_READS`` / ``_SLICE_WRITES``). Nothing fuses on the
    eager path, so this is the one bytes figure (JAX has ``bytes_fused``
    beside its as-compiled bytes);
  * one entry per hand-written kernel launch with its ``cost``
    (``kernels/ops.py``), and no count of the ops inside it
    (``kernels/accounting.py``);
  * collectives by type, with the bytes each device sends, and without the
    host-staging copies inside a real one, so that a run on the card and a
    dry run on ``meta`` agree;
  * the peak of live storage bytes, the tracked arguments included: each
    storage counted once, from the op that first makes or reads it until
    its ``weakref.finalize`` fires (the twin of JAX's
    ``memory_analysis()`` live bytes).

There are no trip counts to correct: a layer loop and remat's recompute
(non-reentrant ``torch.utils.checkpoint``) are dispatched op by op, so
they are counted as they run. Attribution labels each op by its innermost
frame under ``repro_torch/{models,training,kernels,distributed}``, as JAX
labels by ``op_name``; an op the autograd engine dispatches with no such
frame below it is "(autograd backward)".
"""

from __future__ import annotations

import collections
import os
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import accounting

ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "sign", "sgn", "floor", "ceil", "round",
    "trunc", "clamp", "clamp_min", "clamp_max", "maximum", "minimum", "fmax", "fmin", "where",
    "eq", "ne", "lt", "le", "gt", "ge", "logical_and", "logical_or", "logical_not",
    "logical_xor", "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not", "remainder",
    "fmod", "reciprocal", "lerp", "addcmul", "addcdiv", "masked_fill", "relu",
    "threshold_backward", "copysign", "isfinite", "isnan", "isinf", "square", "nan_to_num",
    "tanh_backward", "sigmoid_backward", "_softmax_backward_data",
    "_log_softmax_backward_data",
}
TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "tanh", "sigmoid", "rsqrt",
    "sqrt", "sin", "cos", "tan", "erf", "erfc", "erfinv", "pow", "silu", "gelu", "softplus",
    "_softmax", "_log_softmax", "silu_backward", "gelu_backward", "softplus_backward", "atan2",
}
REDUCE = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "cumsum", "cumprod", "logsumexp",
    "var", "var_mean", "std", "argmax", "argmin", "norm", "linalg_vector_norm", "any", "all",
}
# allocations that initialise nothing move no bytes
UNINITIALISED = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}
# reads that fetch only what they return (JAX's _SLICE_READS): twice the output
GATHER_READS = {"embedding", "index_select", "gather", "index", "take"}
# in-place updates that touch only their update (JAX's _SLICE_WRITES): twice the update
SCATTER_WRITES = {"index_put", "index_put_", "scatter", "scatter_", "scatter_add",
                  "scatter_add_", "index_add", "index_add_", "index_copy", "index_copy_"}
# writes whose destination is not read
WRITE_ONLY = {"copy_", "fill_", "zero_", "fill", "zeros", "zeros_like", "full", "full_like",
              "ones", "ones_like", "arange", "scalar_tensor", "normal_", "uniform_"}
# the marker PyTorch dispatches for a tensor made from host data
# (``torch.tensor``) on a real device and never on meta; it moves nothing
UNCOUNTED = {"lift_fresh"}
ATTRIBUTED = tuple(os.sep + os.path.join("repro_torch", d) + os.sep
                   for d in ("models", "training", "kernels", "distributed"))
BACKWARD = "(autograd backward)"
_ENGINE = os.path.join("torch", "autograd", "graph.py")


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _label() -> str:
    """The innermost frame under ``ATTRIBUTED`` that dispatched this op, or
    BACKWARD where the autograd engine did with none in between."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if any(d in name for d in ATTRIBUTED):
            rel = name[name.rindex(os.sep + "repro_torch" + os.sep) + len("repro_torch") + 2:]
            return f"{rel}:{f.f_lineno} ({f.f_code.co_name})"
        if name.endswith(_ENGINE):
            return BACKWARD
        f = f.f_back
    return BACKWARD


class OpAnalyzer(TorchDispatchMode):
    """Counts a call's work op by op (module docstring). ``track``: tensors
    (any pytree of them) alive when the call starts, the arguments, whose
    storages count toward the live bytes from the start."""

    def __init__(self, track=()):
        super().__init__()
        self.flops = 0
        self.transcendentals = 0
        self.bytes = 0
        self.op_flops: collections.Counter = collections.Counter()  # by aten op
        self.ops: collections.Counter = collections.Counter()  # (op, input shapes, dtypes)
        self.kernels: dict[str, dict] = {}
        self.collectives: list[tuple] = []  # (kind, axes, bytes sent, dtype)
        self.attr_flops: collections.Counter = collections.Counter()
        self.attr_bytes: collections.Counter = collections.Counter()
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._live: dict[int, int] = {}
        self._regions: list[str] = []  # "kernel" / "collective" entered, innermost last
        self._listen = None
        for t in _tensors(track):
            self._track(t)

    # ------------------------------------------------------------------
    def __enter__(self):
        self._listen = accounting.listening(self)
        self._listen.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._listen.__exit__(*exc)

    def enter_kernel(self, name: str, flops: int, nbytes: int) -> None:
        if not self._regions:
            k = self.kernels.setdefault(name, {"launches": 0, "flops": 0, "bytes": 0})
            k["launches"] += 1
            k["flops"] += flops
            k["bytes"] += nbytes
            self.flops += flops
            self.bytes += nbytes
            self.attr_flops[f"{name} (kernel)"] += flops
            self.attr_bytes[f"{name} (kernel)"] += nbytes
        self._regions.append("kernel")

    def enter_collective(self, kind: str, axes: tuple, nbytes: int, out_nbytes: int,
                         dtype) -> None:
        if not self._regions:
            self.collectives.append((kind, tuple(axes), int(nbytes), str(dtype)))
            self.bytes += nbytes + out_nbytes
            self.attr_bytes[f"{kind} {'/'.join(axes)}"] += nbytes + out_nbytes
        self._regions.append("collective")

    def exit_region(self) -> None:
        self._regions.pop()

    # ------------------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if self._regions:
            # a kernel's outputs and scratch live on its device; a real
            # collective's staging lives in host memory and is not counted
            for t in outs:
                if self._regions[-1] == "kernel" or t.device.type != "cpu":
                    self._track(t)
            return out
        ins = _tensors((args, kwargs))
        for t in ins + outs:
            self._track(t)
        name = func.overloadpacket.__name__
        if name in UNCOUNTED:
            return out
        self.ops[(str(func), tuple((tuple(t.shape), str(t.dtype)) for t in ins))] += 1
        flops = 0
        if func.overloadpacket in flop_registry:
            flops = int(flop_registry[func.overloadpacket](*args, **kwargs, out_val=out))
            self.op_flops[str(func.overloadpacket)] += flops
        elif outs and name.rstrip("_") in ELEMENTWISE:
            flops = outs[0].numel()
        elif outs and name.rstrip("_") in TRANSCENDENTAL:
            self.transcendentals += outs[0].numel()
        elif ins and name in REDUCE:
            flops = ins[0].numel()
        nbytes = self._bytes(func, name, ins, outs, args)
        self.flops += flops
        self.bytes += nbytes
        if flops or nbytes:
            label = _label()
            self.attr_flops[label] += flops
            self.attr_bytes[label] += nbytes
        return out

    @staticmethod
    def _bytes(func, name: str, ins, outs, args) -> int:
        returns = func._schema.returns
        if returns and all(r.alias_info is not None and not r.alias_info.is_write
                           for r in returns):
            return 0  # a view or an alias
        if not func._schema.is_mutable and outs:
            inputs = {t.untyped_storage()._cdata for t in ins}
            if all(t.untyped_storage()._cdata in inputs for t in outs):
                return 0  # an output that shares an input's storage (_unsafe_view)
        if name in UNINITIALISED:
            return 0
        if name in GATHER_READS:
            return 2 * sum(_nbytes(t) for t in outs)
        if name in SCATTER_WRITES:
            upd = [a for a in args[2:] if isinstance(a, torch.Tensor)] or outs
            return 2 * _nbytes(upd[-1])
        read = ins[1:] if name in WRITE_ONLY else ins
        written = sum(_nbytes(t) for t in outs)
        return sum(_nbytes(t) for t in read) + written

    # ------------------------------------------------------------------
    def collectives_by_type(self) -> dict[str, int]:
        out: dict[str, int] = collections.defaultdict(int)
        for kind, _, nbytes, _ in self.collectives:
            out[kind] += nbytes
        return dict(out)

    def result(self, top: int = 5) -> dict:
        """The count under JAX's keys (``analyze_hlo``), plus
        ``transcendentals``, ``kernels`` and ``peak_live_bytes``."""
        counts = collections.Counter(kind for kind, *_ in self.collectives)
        return {
            "flops": float(self.flops),
            "transcendentals": float(self.transcendentals),
            "bytes_accessed": float(self.bytes),
            "collective_bytes": float(sum(c[2] for c in self.collectives)),
            "collectives_by_type": {k: float(v) for k, v in self.collectives_by_type().items()},
            "collective_counts": {k: float(v) for k, v in counts.items()},
            "top_flops": [[k, float(v)] for k, v in self.attr_flops.most_common(top) if v],
            "top_bytes": [[k, float(v)] for k, v in self.attr_bytes.most_common(top) if v],
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
            "peak_live_bytes": int(self.peak_live_bytes),
        }
