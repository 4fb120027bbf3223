"""KVBlockPool: the interleaved KV block pool, with its payload on the card.

Twin of ``repro.core.pool.BelugaPool``: the same allocator, the same
per-block epochs, refcounts and committed flags, and the same batched
``write_blocks`` publish.

Block ``b`` lives on shard ``b % n_shards``, one free stack per shard, and
an allocation goes round-robin over the fullest shards first, ties to the
shard whose oldest free block has been free longest; when that order runs
dry it sweeps what is left by shard. The reference's non-interleaved FIFO
(``interleave=False``) is not ported: nothing in the port runs it.

``write_blocks`` / ``read_blocks`` move payload rows by block id with one
batched epoch bump or snapshot: the calls through which a transfer, and a
tier chain (``tiering/tiers.py``), reach a pool's bytes.

``share_meta`` moves the epochs, refcounts and committed flags into one
named segment of 13n bytes (int64 epochs at 0, int32 refcounts at 8n, bool
committed at 12n: the reference's layout, so a service of either package
attaches either pool), which a shard service process maps read-only
(``core/procserver.PoolMetaView``); every later write to those arrays is in
place. ``unshare_meta`` copies them back and unlinks the segment.

``share_data`` moves the payload itself into one named segment of
``(n_blocks, block_bytes)`` rows, the reference's byte layout, and implies
``share_meta``: an engine worker process (``serving/engineproc.py``) maps it
(``core/shmpool.SharedPoolSegment``) and moves blocks by plain loads and
stores, while allocation stays with this pool behind a ring. The payload
must lie on the CPU (``device="cpu"``, the twin of the reference's
``backing="numpy"``); the pool's ``data`` becomes a tensor over the
segment, built through numpy so that the mapping cannot be dropped while a
view of it lives (``close`` raises ``BufferError`` then). ``unshare_data``
copies the payload back and unlinks the segment.

The payload is one tensor of shape ``(n_blocks, 2L, block_tokens, hkv,
hd)``: every layer's K and V fragments of a block, interleaved ``[k0, v0,
k1, v1, ...]`` — the layout that ``kv_gather_write`` packs and
``kv_scatter_read`` unpacks. On ``torch.device("meta")`` it holds no bytes:
the twin of the reference's ``backing="meta"``, where the allocator, the
epochs and the index run for real at the paper's pool size (the cluster
simulator's 262,144 Qwen3-32B blocks, 640 GiB of KV) and no payload is
stored (``payload_free``).

The port's engines are single-threaded, so the pool takes no lock.
"""

from __future__ import annotations

import atexit
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.shm import close_segment, create_segment


@dataclass(frozen=True)
class KVBlockLayout:
    """Shape of one pool block for a model config."""

    block_tokens: int
    n_layers_kv: int  # attention layers
    n_kv_heads: int
    head_dim: int
    dtype_bytes: int = 2

    @property
    def block_shape(self) -> tuple[int, int, int, int]:
        """(2L fragments [k0, v0, k1, v1, ...], tokens, kv heads, head_dim)."""
        return (2 * self.n_layers_kv, self.block_tokens, self.n_kv_heads, self.head_dim)

    @property
    def fragment_bytes(self) -> int:
        """One (layer, k|v) fragment of a block: the paper's 20 KB unit."""
        return self.block_tokens * self.n_kv_heads * self.head_dim * self.dtype_bytes

    @property
    def n_fragments(self) -> int:
        """Fragments per block: 2 * n_layers (Qwen3-32B: 128)."""
        return 2 * self.n_layers_kv

    @property
    def block_bytes(self) -> int:
        return self.n_fragments * self.fragment_bytes

    @property
    def token_bytes(self) -> int:
        return self.block_bytes // self.block_tokens

    @classmethod
    def for_model(cls, cfg: ModelConfig, block_tokens: int = 16) -> "KVBlockLayout":
        """The attention layers' KV (an attention stack: every layer), as the
        reference's ``PoolLayout.for_model`` counts it (``pool.py:72``)."""
        return cls(
            block_tokens=block_tokens,
            n_layers_kv=max(1, len(cfg.attn_layer_ids())),
            n_kv_heads=max(1, cfg.n_kv_heads),
            head_dim=max(1, cfg.head_dim),
        )


class PoolExhausted(RuntimeError):
    pass


N_SHARDS = 8  # as the JAX RealEngine's pool
PAYLOAD_DTYPES = {1: torch.uint8, 2: torch.bfloat16, 4: torch.float32}


class KVBlockPool:
    """Block allocator + device payload over interleaved shards."""

    is_tiered = False

    def __init__(
        self,
        layout: KVBlockLayout,
        n_blocks: int,
        device: str | torch.device,
        n_shards: int = N_SHARDS,
    ):
        if n_blocks % n_shards:
            raise ValueError(f"n_blocks={n_blocks} is not a multiple of {n_shards} shards")
        self.layout = layout
        self.n_blocks = n_blocks
        self.n_shards = n_shards
        self.epochs = np.zeros(n_blocks, np.int64)
        self.refcounts = np.zeros(n_blocks, np.int32)
        self.committed = np.zeros(n_blocks, bool)
        self._free_by_shard: list[list[int]] = [
            list(range(s, n_blocks, n_shards)) for s in range(n_shards)
        ]
        # free-age stamps: ties between equally full shards go to the shard
        # whose oldest free block has been free longest
        self._age = np.arange(n_blocks, dtype=np.int64)
        self._stamp = n_blocks
        self._n_free = n_blocks
        self._occ = [0] * n_shards
        self.alloc_count = 0  # blocks handed out, ever
        self._meta_segment = None
        self._meta_spec: dict | None = None
        self._data_segment = None
        self._data_spec: dict | None = None
        self.data = torch.zeros(
            (n_blocks, *layout.block_shape), dtype=PAYLOAD_DTYPES[layout.dtype_bytes],
            device=device,
        )

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def payload_free(self) -> bool:
        """The payload lies on ``meta``: metadata only, no bytes."""
        return self.data.device.type == "meta"

    # ------------------------------------------------------------------
    def share_meta(self) -> dict:
        """Move the metadata into a named segment (idempotent); returns the
        attach spec, plain data: ``shm_name``, ``n_blocks``,
        ``block_tokens``."""
        if self._meta_spec is None:
            seg, arrays = shared_meta_segment(self.n_blocks)
            for dst, src in zip(arrays, (self.epochs, self.refcounts, self.committed)):
                dst[:] = src
            self.epochs, self.refcounts, self.committed = arrays
            self._meta_segment = seg
            self._meta_spec = {"shm_name": seg.name, "n_blocks": self.n_blocks,
                               "block_tokens": self.layout.block_tokens}
            atexit.register(self.unshare_meta)
        return self._meta_spec

    def unshare_meta(self) -> None:
        """Copy the metadata back into private arrays and unlink the
        segment; safe to repeat, and when never shared."""
        seg = self._meta_segment
        if seg is None:
            return
        self.epochs = np.array(self.epochs, np.int64)
        self.refcounts = np.array(self.refcounts, np.int32)
        self.committed = np.array(self.committed, bool)
        self._meta_segment = self._meta_spec = None
        close_segment(seg, unlink=True)
        atexit.unregister(self.unshare_meta)

    def share_data(self) -> dict:
        """Move the payload into a named segment (idempotent; implies
        ``share_meta``); returns the attach spec, plain data in the
        reference's keys: ``data_shm_name``, ``meta`` (``share_meta``'s
        spec), ``n_blocks`` and the layout's five numbers. A payload off the
        CPU raises, as the reference's non-numpy backing does."""
        if self._data_spec is None:
            if self.data.device.type != "cpu":
                raise ValueError("share_data requires device='cpu' (the reference's "
                                 f"backing='numpy'), not {self.data.device.type!r}")
            meta = self.share_meta()
            seg, view = shared_data_segment(self.n_blocks, self.layout)
            view.copy_(self.data)
            self.data = view
            self._data_segment = seg
            self._data_spec = data_spec(seg.name, meta, self.n_blocks, self.layout)
            atexit.register(self.unshare_data)
        return self._data_spec

    def unshare_data(self) -> None:
        """Copy the payload back into a private tensor and unlink the
        segment; safe to repeat, and when never shared. ``share_meta`` is
        left as it is."""
        seg = self._data_segment
        if seg is None:
            return
        self.data = self.data.clone()  # the last view of the segment goes
        self._data_segment = self._data_spec = None
        close_segment(seg, unlink=True)
        atexit.unregister(self.unshare_data)

    # ------------------------------------------------------------------
    def free_blocks(self) -> int:
        return self._n_free

    def shard_occupancy(self) -> list[int]:
        return list(self._occ)

    # ------------------------------------------------------------------
    def allocate(self, n: int) -> list[int]:
        """Allocate n blocks round-robin over the shards, fullest first."""
        if self._n_free < n:
            raise PoolExhausted(f"need {n}, have {self._n_free}")
        stacks, age = self._free_by_shard, self._age
        order = sorted(
            (s for s in range(self.n_shards) if stacks[s]),
            key=lambda s: (-len(stacks[s]), age[stacks[s][0]]),
        )
        out: list[int] = []
        i = 0
        while len(out) < n:
            s = order[i % len(order)]
            if stacks[s]:
                out.append(stacks[s].pop())
                self._occ[s] += 1
            i += 1
            if i > 4 * self.n_shards + n * 2:
                # the round-robin order ran dry: sweep what is left in
                # by-shard order, oldest free block first
                rem = sorted(
                    (s for s in range(self.n_shards) if stacks[s]),
                    key=lambda s: age[stacks[s][0]],
                )
                for s in rem:
                    k = min(len(stacks[s]), n - len(out))
                    if k <= 0:
                        break
                    out.extend(stacks[s][:k])
                    del stacks[s][:k]
                    self._occ[s] += k
                break
        self._n_free -= n
        ids = np.asarray(out, np.intp)
        self.refcounts[ids] = 1
        self.committed[ids] = False
        self.alloc_count += n
        return out

    def retain(self, block_ids: list[int]) -> None:
        if not len(block_ids):
            return
        ids = np.asarray(block_ids, np.intp)
        if not (self.refcounts[ids] > 0).all():
            raise ValueError("retain of a free block")
        np.add.at(self.refcounts, ids, 1)

    def release(self, block_ids: list[int]) -> None:
        if not len(block_ids):
            return
        ids = np.asarray(block_ids, np.intp)
        np.subtract.at(self.refcounts, ids, 1)
        if (self.refcounts[ids] < 0).any():
            raise ValueError("double free")
        zero = self.refcounts[ids] == 0
        if not zero.any():
            return
        # freed blocks re-enter the free stacks in caller order (dedup'd)
        seen: set[int] = set()
        freed = [
            b for b, z in zip(ids.tolist(), zero.tolist())
            if z and not (b in seen or seen.add(b))
        ]
        farr = np.asarray(freed, np.intp)
        self.committed[farr] = False
        self.epochs[farr] += 1  # invalidate readers holding stale ids
        for b in freed:
            s = b % self.n_shards
            self._free_by_shard[s].append(b)
            self._occ[s] -= 1
            self._age[b] = self._stamp
            self._stamp += 1
        self._n_free += len(freed)

    # ------------------------------------------------------------------
    def write_blocks(self, block_ids: list[int], payloads: torch.Tensor | None = None) -> list[int]:
        """Publish blocks: store ``payloads`` (n, *block_shape) into their
        rows when given (a payload-free pool stores nothing; without them
        the rows were written in place), then one batched epoch bump.
        Returns the publish epochs."""
        ids = np.asarray(block_ids, np.intp)
        if payloads is not None and not self.payload_free:
            rows = payloads.to(self.data.device, self.data.dtype).reshape(len(ids), -1)
            self.data.flatten(1).index_copy_(0, self._index(ids), rows)
        self.epochs[ids] += 1
        self.committed[ids] = True
        return self.epochs[ids].tolist()

    def read_blocks(self, block_ids) -> tuple[torch.Tensor | None, np.ndarray]:
        """(payload rows (n, *block_shape), or None on a payload-free pool;
        the epochs at the read, snapshot before the copy)."""
        ids = np.asarray(block_ids, np.intp)
        eps = self.epochs[ids].copy()
        if self.payload_free:
            return None, eps
        rows = self.data.flatten(1).index_select(0, self._index(ids))
        return rows.view(len(ids), *self.layout.block_shape), eps

    def _index(self, ids: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(ids, dtype=torch.long, device=self.data.device)

    def validate_epochs(self, block_ids, epochs) -> np.ndarray:
        """Vectorized committed + epoch check."""
        ids = np.asarray(block_ids, np.intp)
        return self.committed[ids] & (self.epochs[ids] == np.asarray(epochs))


def shared_meta_segment(n: int):
    """A zeroed segment of ``n`` blocks' metadata and its three views
    (epochs int64 at 0, refcounts int32 at 8n, committed bool at 12n)."""
    seg = create_segment(13 * n)
    return seg, (np.frombuffer(seg.buf, np.int64, n, 0),
                 np.frombuffer(seg.buf, np.int32, n, 8 * n),
                 np.frombuffer(seg.buf, np.bool_, n, 12 * n))


def shared_data_segment(n: int, layout: KVBlockLayout):
    """A zeroed segment of ``n`` rows of ``layout.block_bytes`` and a payload
    tensor over it, shape ``(n, *layout.block_shape)``, whose numpy base
    holds the segment's buffer while any view of it lives."""
    seg = create_segment(n * layout.block_bytes)
    raw = torch.from_numpy(np.frombuffer(seg.buf, np.uint8))
    return seg, raw.view(PAYLOAD_DTYPES[layout.dtype_bytes]).view(n, *layout.block_shape)


def data_spec(name: str, meta: dict, n: int, layout: KVBlockLayout) -> dict:
    """``share_data``'s attach spec, the reference's keys."""
    return {"data_shm_name": name, "meta": meta, "n_blocks": n,
            "block_tokens": layout.block_tokens, "n_layers_kv": layout.n_layers_kv,
            "n_kv_heads": layout.n_kv_heads, "head_dim": layout.head_dim,
            "dtype_bytes": layout.dtype_bytes}
