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
* The port runs one process on one device: it writes ``proc_0.npz`` with
  one ``key||full`` member a leaf and ``"nprocs": 1``. It reads what JAX
  writes from any number of processes: ``key||full`` (an async save) or
  one member per shard, ``key||0:4,0:8``, with an empty index for a 0-dim
  leaf (``key||``), the shards reassembled into the leaf.
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

import json
import os
import re
import shutil
import threading
import zipfile
from contextlib import ExitStack
from typing import Iterable, Iterator

import numpy as np
import torch

from repro_torch.training.optimizer import tree_unflatten

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
    def __init__(self, directory: str, keep: int = 2, async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
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
    def save(self, step: int, tree: dict, extra: dict | None = None) -> None:
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

    def _gc(self) -> None:
        steps = sorted(int(m.group(1)) for name in os.listdir(self.dir)
                       if (m := re.fullmatch(r"step_(\d+)", name)))
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.step_dir(s))

    # ------------------------------------------------------------------
    def restore(self, step: int, target_tree: dict, in_place: bool = False) -> dict:
        """Restore into the structure of ``target_tree`` (shapes, dtypes,
        devices); with ``in_place``, into its tensors."""
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
            for key, leaf in _flatten(target_tree):
                t = _read_leaf(key, tuple(leaf.shape), shards, manifest)
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


def _read_leaf(key: str, shape: tuple, shards: dict, manifest: dict) -> torch.Tensor:
    """The stored leaf ``key`` as a CPU tensor of its stored dtype."""
    if key not in shards:
        raise KeyError(f"checkpoint missing leaf {key}")
    stored = tuple(manifest[key]["shape"])
    if stored != shape:
        raise ValueError(f"checkpoint leaf {key} has shape {stored}, the target {shape}")
    parts = shards[key]
    full = [p for p in parts if p[2] == "full"]
    if full:
        z, member, _ = full[0]
        arr = z[member]
        if arr.shape != shape:
            raise ValueError(f"checkpoint leaf {key} holds shape {arr.shape}, the target {shape}")
    else:
        arr, covered = None, 0
        for z, member, idx in parts:
            val = z[member]
            if arr is None:
                arr = np.empty(shape, dtype=val.dtype)
            arr[_parse_index(idx, shape)] = val
            covered += val.size
        if covered != arr.size:
            raise ValueError(f"checkpoint leaf {key}: shards cover {covered} of {arr.size} "
                             "elements")
    t = torch.from_numpy(arr)
    dtype = getattr(torch, manifest[key]["dtype"])
    return t.view(dtype) if dtype in _BITS else t


def _parse_index(s: str, shape: tuple) -> tuple:
    if not s:
        return tuple(slice(None) for _ in shape)
    out = []
    for part in s.split(","):
        a, b = part.split(":")
        out.append(slice(int(a), int(b)))
    return tuple(out)
