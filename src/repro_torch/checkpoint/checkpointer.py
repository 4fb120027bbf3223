"""Checkpoints of a training state in the JAX package's on-disk format.

Twin of ``repro/checkpoint/checkpointer.py:1-229``, with its class and
method names, over trees of nested dicts of tensors. Layout (one directory
per step), the same bytes JAX writes and reads:

    <dir>/step_000000123/
        manifest.json          {"leaves": {key: {"shape", "dtype"}}, "nprocs"}
        extra.json             user metadata (the data iterator's state, ...)
        proc_<k>.npz           the shards process k owns
        _COMMITTED             commit marker, written last

A step is written into ``step_<n>.tmp`` and ``os.replace``d into place once
``_COMMITTED`` is in it, so ``latest_step`` and ``restore`` never see a
partial write; after each save only the newest ``keep`` steps stay.

* Keys are the ``/``-joined dict paths (``opt_state/m/blocks/attn/wq``),
  the strings JAX's ``_flatten_with_paths`` makes for the same tree; leaves
  go in the port's ``tree_leaves`` order (keys sorted), which is JAX's.
* Manifest dtypes carry JAX's names (``bfloat16``, ``float32``, ``int32``,
  ``float8_e4m3fn``). npz cannot hold bf16 or fp8, so their bits are stored
  as ``uint16`` / ``uint8`` views, as JAX stores them.
* One process on one device writes ``proc_0.npz`` with one ``key||full``
  member a leaf and ``"nprocs": 1``. It reads what JAX writes from any
  number of processes: ``key||full`` (an async save) or one member per
  shard, ``key||0:4,0:8``, with an empty index for a 0-dim leaf
  (``key||``), the shards reassembled into the leaf.
* A world of ranks (``Checkpointer(..., rules=AxisRules)``, every rank
  calling ``save`` and ``restore`` alike with the tree's ``specs``, its
  ParamSpec leaves) saves as JAX's sync save does from as many processes:
  rank k writes ``proc_<k>.npz`` with one ``key||<index>`` member per shard
  it holds, where it is the shard's first replica (coordinate 0 on every
  mesh axis the leaf is replicated along, JAX's ``replica_id == 0``); the
  manifest holds the global shapes and ``"nprocs"`` the world size. Rank 0
  makes the ``.tmp`` directory, every rank writes its file, then rank 0
  writes the manifest, ``extra.json`` and ``_COMMITTED`` and renames, with
  a barrier of the world between the steps and after them. A rank restores
  only its own slices, from the members that overlap them (whatever
  process count or mesh wrote them), so no rank holds a whole leaf other
  than while it reads a ``||full`` member.
* ``save`` with ``async_save`` returns once a private host copy of every
  leaf exists (pinned memory filled from the card, then synchronised; a
  clone on the CPU), so a caller may step the same tensors in place while
  a ``threading.Thread`` writes the copy. Each save first waits for the one
  before; ``wait`` joins the thread and raises what it raised.
* ``restore`` returns each leaf on the target leaf's device in its dtype (a
  stored dtype that differs is cast, as JAX's ``astype``). A missing leaf
  raises ``KeyError``. A leaf whose stored shape differs from the target's
  raises ``ValueError`` naming both, where JAX returns a ``||full`` payload
  of the stored shape. With ``in_place`` each value is copied into the
  target's own tensors, which are returned: the same values, bit for bit,
  as a restore into new tensors (``tests/test_torch_checkpoint.py``), and
  no second copy of the state on the device.
* Sync saves and restores move one leaf at a time between the device and
  the host, so host memory stays near one leaf.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import re
import shutil
import threading
import zipfile
from contextlib import ExitStack
from typing import Iterable, Iterator

import numpy as np
import torch

from repro_torch.distributed.sharding import replicated_axes, shard_box
from repro_torch.training.optimizer import tree_leaves, tree_unflatten

# dtypes npz cannot hold: (the torch dtype their bits are viewed as, numpy's)
_BITS = {torch.bfloat16: (torch.int16, np.uint16), torch.float8_e4m3fn: (torch.uint8, np.uint8)}


def _dtype_name(dtype: torch.dtype) -> str:
    """JAX's (numpy's) name of a torch dtype: ``torch.bfloat16`` -> ``bfloat16``."""
    return str(dtype).removeprefix("torch.")


def _flatten(tree: dict, prefix: str = "") -> Iterator[tuple[str, torch.Tensor]]:
    """(key, leaf) in ``tree_leaves`` order, keys as JAX's paths."""
    for k in sorted(tree):
        key = f"{prefix}/{k}" if prefix else str(k)
        v = tree[k]
        if isinstance(v, dict):
            yield from _flatten(v, key)
        else:
            yield key, v


class Checkpointer:
    def __init__(self, directory: str, keep: int = 2, async_save: bool = False, rules=None):
        if rules is not None and async_save:
            raise ValueError("a world's checkpoint is saved synchronously")
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self.rules = rules
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}")

    def latest_step(self) -> int | None:
        steps = [int(m.group(1)) for name in os.listdir(self.dir)
                 if (m := re.fullmatch(r"step_(\d+)", name))
                 and os.path.exists(os.path.join(self.dir, name, "_COMMITTED"))]
        return max(steps) if steps else None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: dict, extra: dict | None = None,
             specs: dict | None = None) -> None:
        """Save ``tree`` as step ``step``; under ``rules`` every rank calls
        this with its shards and the tree's ``specs`` (ParamSpec leaves)."""
        if self.rules is not None:
            self._save_world(step, tree, extra, specs)
            return
        self.wait()
        if not self.async_save:
            self._save_sync(step, _flatten(tree), extra)
            return
        flat = [(key, _host_copy(t)) for key, t in _flatten(tree)]
        for dev in {t.device for _, t in _flatten(tree) if t.device.type == "cuda"}:
            torch.cuda.current_stream(dev).synchronize()  # the copies have landed
        self._thread = threading.Thread(target=self._save_in_thread, args=(step, flat, extra))
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _save_in_thread(self, step: int, flat: list, extra: dict | None) -> None:
        try:
            self._save_sync(step, iter(flat), extra)
        except Exception as e:  # raised again by wait()
            self._error = e

    def _save_sync(self, step: int, flat: Iterable[tuple[str, torch.Tensor]],
                   extra: dict | None) -> None:
        d = self.step_dir(step)
        tmp = d + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"leaves": {}, "nprocs": 1}

        def members():
            for key, t in flat:
                manifest["leaves"][key] = {"shape": list(t.shape),
                                           "dtype": _dtype_name(t.dtype)}
                yield f"{key}||full", _to_savable(t)

        _write_npz(os.path.join(tmp, "proc_0.npz"), members())
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "extra.json"), "w") as f:
            json.dump(extra or {}, f)
        with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
            f.write("ok")
        if os.path.exists(d):
            shutil.rmtree(d)
        os.replace(tmp, d)
        self._gc()

    def _save_world(self, step: int, tree: dict, extra: dict | None, specs: dict) -> None:
        import torch.distributed as dist

        mesh = self.rules.mesh
        d = self.step_dir(step)
        tmp = d + ".tmp"
        if mesh.rank == 0:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
        dist.barrier()
        manifest = {"leaves": {}, "nprocs": mesh.size}

        def members():
            for (key, t), spec in zip(_flatten(tree), _spec_leaves(specs)):
                manifest["leaves"][key] = {"shape": list(spec.shape),
                                           "dtype": _dtype_name(t.dtype)}
                pspec = self.rules.spec(spec.logical_axes)
                if all(mesh.coords[a] == 0 for a in replicated_axes(pspec, mesh)):
                    index = ",".join(f"{sl.start}:{sl.stop}" for sl in
                                     shard_box(spec.shape, pspec, mesh, key))
                    yield f"{key}||{index}", _to_savable(t)

        _write_npz(os.path.join(tmp, f"proc_{mesh.rank}.npz"), members())
        dist.barrier()
        if mesh.rank == 0:
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, "extra.json"), "w") as f:
                json.dump(extra or {}, f)
            with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
                f.write("ok")
            if os.path.exists(d):
                shutil.rmtree(d)
            os.replace(tmp, d)
            self._gc()
        dist.barrier()

    def _gc(self) -> None:
        steps = sorted(int(m.group(1)) for name in os.listdir(self.dir)
                       if (m := re.fullmatch(r"step_(\d+)", name)))
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.step_dir(s))

    # ------------------------------------------------------------------
    def restore(self, step: int, target_tree: dict, in_place: bool = False,
                specs: dict | None = None) -> dict:
        """Restore into the structure of ``target_tree`` (shapes, dtypes,
        devices); with ``in_place``, into its tensors. Under ``rules`` the
        target holds this rank's shards of the leaves ``specs`` describes."""
        d = self.step_dir(step)
        if not os.path.exists(os.path.join(d, "_COMMITTED")):
            raise FileNotFoundError(f"no committed checkpoint at {d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)["leaves"]
        with ExitStack() as stack:
            shards: dict[str, list] = {}  # leaf key -> [(npz, member, index)]
            for name in sorted(os.listdir(d)):
                if name.startswith("proc_") and name.endswith(".npz"):
                    z = stack.enter_context(np.load(os.path.join(d, name)))
                    for member in z.files:
                        key, idx = member.split("||")
                        shards.setdefault(key, []).append((z, member, idx))
            out = []
            spec_leaves = (_spec_leaves(specs) if self.rules is not None
                           else itertools.repeat(None))
            for (key, leaf), spec in zip(_flatten(target_tree), spec_leaves):
                if spec is None:  # one device: the whole leaf
                    shape, box = tuple(leaf.shape), tuple(slice(0, n) for n in leaf.shape)
                else:
                    shape = spec.shape
                    box = shard_box(shape, self.rules.spec(spec.logical_axes),
                                    self.rules.mesh, key)
                t = _read_slice(key, shape, box, shards, manifest)
                if in_place:
                    leaf.copy_(t)
                    out.append(leaf)
                else:
                    out.append(t.to(device=leaf.device, dtype=leaf.dtype))
        return tree_unflatten(target_tree, out)

    def load_extra(self, step: int) -> dict:
        with open(os.path.join(self.step_dir(step), "extra.json")) as f:
            return json.load(f)


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A host tensor of ``t``'s values that nothing else writes; from the card
    it is filled asynchronously, so the caller synchronises before use."""
    t = t.detach()
    if t.device.type == "cpu":
        return t.clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t, non_blocking=True)


def _to_savable(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype in _BITS:
        bits, np_bits = _BITS[t.dtype]
        return t.view(bits).numpy().view(np_bits)
    return t.numpy()


def _write_npz(path: str, members: Iterable[tuple[str, np.ndarray]]) -> None:
    """``np.savez`` one member at a time (its format: stored, zip64 entries)."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for name, arr in members:
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)


def _spec_leaves(specs: dict) -> list:
    """The ParamSpec leaves of ``specs`` in ``tree_leaves`` order."""
    if specs is None:
        raise ValueError("a world's checkpoint needs the tree's specs (ParamSpec leaves)")
    return tree_leaves(specs)


def _read_slice(key: str, shape, box: tuple, shards: dict, manifest: dict) -> torch.Tensor:
    """The part ``box`` (a slice per dim, ``sharding.shard_box``; the whole
    leaf on one device) of the stored leaf ``key`` of global ``shape``, from the members
    that overlap it, as a CPU tensor of the stored dtype."""
    if key not in shards:
        raise KeyError(f"checkpoint missing leaf {key}")
    shape = tuple(shape)
    stored = tuple(manifest[key]["shape"])
    if stored != shape:
        raise ValueError(f"checkpoint leaf {key} has shape {stored}, the target {shape}")
    want = [(sl.start, sl.stop) for sl in box]
    out, covered = None, 0
    for z, member, idx in shards[key]:
        have = ([(0, n) for n in shape] if idx == "full" else
                [(sl.start, sl.stop) for sl in _parse_index(idx, shape)])
        over = [(max(a, lo), min(b, hi)) for (a, b), (lo, hi) in zip(have, want)]
        if any(a >= b for a, b in over):
            continue
        val = z[member]
        if val.shape != tuple(b - a for a, b in have):
            raise ValueError(f"checkpoint leaf {key}: member {member} holds shape {val.shape}")
        if have == want:  # the member is the slice: no copy
            out, covered = val, val.size
            break
        if out is None:
            out = np.empty(tuple(hi - lo for lo, hi in want), dtype=val.dtype)
        out[tuple(slice(a - lo, b - lo) for (a, b), (lo, _) in zip(over, want))] = val[
            tuple(slice(a - h, b - h) for (a, b), (h, _) in zip(over, have))]
        covered += math.prod(b - a for a, b in over)
    size = math.prod(hi - lo for lo, hi in want)
    if out is None or covered != size:
        raise ValueError(f"checkpoint leaf {key}: its members cover {covered} of the {size} "
                         "elements of the slice read")
    t = torch.from_numpy(out)
    dtype = getattr(torch, manifest[key]["dtype"])
    return t.view(dtype) if dtype in _BITS else t


def _parse_index(s: str, shape: tuple) -> tuple:
    if not s:
        return tuple(slice(0, n) for n in shape)
    out = []
    for part in s.split(","):
        a, b = part.split(":")
        out.append(slice(int(a), int(b)))
    return tuple(out)
