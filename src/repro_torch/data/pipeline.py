"""Deterministic, sharded, checkpointable token pipeline, numpy only.

The port's own copy of ``repro/data/pipeline.py:1-120`` (the port imports
nothing of ``repro``); it yields the same arrays bit for bit:

  * every (host, dp-rank) reads a disjoint shard of the corpus;
  * iteration order is a pure function of (seed, epoch, step) — restart from
    a saved state reproduces the exact remaining stream (`state_dict` /
    `load_state_dict`);
  * two sources: ``SyntheticLM`` (deterministic PRNG tokens, for smoke runs)
    and ``PackedFileDataset`` (memory-mapped token file packed into
    fixed-length sequences).

Batches are numpy; ``training.train_loop.run_train_loop`` moves each to the
model's device.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import numpy as np


@dataclass
class DataConfig:
    seq_len: int = 4096
    global_batch: int = 256
    dp_rank: int = 0
    dp_size: int = 1
    seed: int = 0
    vocab_size: int = 50304
    source: str = "synthetic"  # synthetic | file
    path: str | None = None


class SyntheticLM:
    """Deterministic synthetic LM batches (counter-based PRNG: O(1) state)."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.dp_size == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.dp_size
        self.step = 0

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        cfg = self.cfg
        # counter-based: seed ^ step ^ rank -> independent of call history
        rng = np.random.default_rng(
            np.uint64(cfg.seed) * np.uint64(1_000_003)
            + np.uint64(self.step) * np.uint64(65_537)
            + np.uint64(cfg.dp_rank)
        )
        tokens = rng.integers(
            0, cfg.vocab_size, size=(self.local_batch, cfg.seq_len), dtype=np.int32
        )
        self.step += 1
        return {"tokens": tokens, "labels": tokens}

    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])


class PackedFileDataset:
    """Memory-mapped int32 token file -> packed fixed-length sequences.

    Shuffling is a seeded permutation of sequence indices per epoch; each
    dp rank takes indices [rank::dp_size]. State = (epoch, cursor).
    """

    def __init__(self, cfg: DataConfig):
        assert cfg.path and os.path.exists(cfg.path), cfg.path
        self.cfg = cfg
        self.tokens = np.memmap(cfg.path, dtype=np.int32, mode="r")
        self.n_seqs = len(self.tokens) // cfg.seq_len
        assert self.n_seqs >= cfg.global_batch, "corpus smaller than one batch"
        self.local_batch = cfg.global_batch // cfg.dp_size
        self.epoch = 0
        self.cursor = 0  # position within this rank's index stream

    def _perm(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.cfg.seed + epoch)
        return rng.permutation(self.n_seqs)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        cfg = self.cfg
        perm = self._perm(self.epoch)
        mine = perm[cfg.dp_rank :: cfg.dp_size]
        if self.cursor + self.local_batch > len(mine):
            self.epoch += 1
            self.cursor = 0
            perm = self._perm(self.epoch)
            mine = perm[cfg.dp_rank :: cfg.dp_size]
        idx = mine[self.cursor : self.cursor + self.local_batch]
        self.cursor += self.local_batch
        batch = np.stack(
            [self.tokens[i * cfg.seq_len : (i + 1) * cfg.seq_len] for i in idx]
        ).astype(np.int32)
        return {"tokens": batch, "labels": batch}

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "cursor": self.cursor, "seed": self.cfg.seed}

    def load_state_dict(self, state: dict) -> None:
        self.epoch = int(state["epoch"])
        self.cursor = int(state["cursor"])


def make_dataset(cfg: DataConfig):
    if cfg.source == "synthetic":
        return SyntheticLM(cfg)
    if cfg.source == "file":
        return PackedFileDataset(cfg)
    raise ValueError(cfg.source)
