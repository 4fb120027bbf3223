"""The port's numpy data pipeline against ``repro.data.pipeline``, bit for bit.

``repro_torch.data.pipeline`` is the port's own copy (the port imports
nothing of ``repro``). Both are run side by side: ``SyntheticLM`` over
seeds, data-parallel ranks and vocabularies; ``PackedFileDataset`` over a
seeded token file, through ranks and epoch roll-overs; and each restarted
from a ``state_dict`` taken mid-stream, which must give the batches the
uninterrupted stream gives.
"""

from __future__ import annotations

import numpy as np
import pytest

from repro.data import pipeline as jpipe
from repro_torch.data import pipeline as tpipe


def _same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _both(**kw):
    return (jpipe.make_dataset(jpipe.DataConfig(**kw)),
            tpipe.make_dataset(tpipe.DataConfig(**kw)))


@pytest.mark.parametrize("seed,rank,size,vocab", [
    (0, 0, 1, 50304), (7, 1, 2, 256), (3, 3, 4, 151936), (0, 0, 2, 92553),
])
def test_synthetic_batches_equal_jax(seed, rank, size, vocab):
    j, t = _both(seq_len=33, global_batch=8, dp_rank=rank, dp_size=size, seed=seed,
                 vocab_size=vocab)
    for _ in range(5):
        _same(next(j), next(t))
    assert j.state_dict() == t.state_dict()


def test_synthetic_resumes_from_its_state():
    kw = dict(seq_len=16, global_batch=4, seed=5, vocab_size=1000)
    _, t = _both(**kw)
    stream = [next(t) for _ in range(6)]
    again = tpipe.SyntheticLM(tpipe.DataConfig(**kw))
    for _ in range(3):
        next(again)
    fresh = tpipe.SyntheticLM(tpipe.DataConfig(**kw))
    fresh.load_state_dict(again.state_dict())
    for want in stream[3:]:
        _same(next(fresh), want)


@pytest.fixture
def token_file(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(11).integers(0, 50304, size=37 * 24 + 5,
                                       dtype=np.int32).tofile(path)
    return str(path)


@pytest.mark.parametrize("rank,size", [(0, 1), (0, 2), (1, 2), (2, 3)])
def test_packed_file_batches_equal_jax_across_epochs(token_file, rank, size):
    j, t = _both(seq_len=24, global_batch=6, dp_rank=rank, dp_size=size, seed=2,
                 source="file", path=token_file)
    for _ in range(14):  # 37 sequences: several epochs roll over on every rank
        _same(next(j), next(t))
    assert j.state_dict() == t.state_dict() and t.state_dict()["epoch"] > 0


def test_packed_file_resumes_from_its_state(token_file):
    kw = dict(seq_len=24, global_batch=6, dp_rank=1, dp_size=2, seed=4, source="file",
              path=token_file)
    j, t = _both(**kw)
    for _ in range(5):
        next(j), next(t)
    state = t.state_dict()
    assert state == j.state_dict()
    resumed = tpipe.make_dataset(tpipe.DataConfig(**kw))
    resumed.load_state_dict(state)
    for _ in range(6):
        _same(next(resumed), next(j))


def test_unknown_source_raises_on_both():
    for pipe in (jpipe, tpipe):
        with pytest.raises(ValueError):
            pipe.make_dataset(pipe.DataConfig(source="nowhere"))
