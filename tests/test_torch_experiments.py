"""The port's twins of exp09 and exp10, and its copy of the fabric and
transfer accounting, against the JAX package.

* ``core/fabric.py`` and ``core/transfer.py`` give the reference's
  constants and modeled latencies exactly (pure Python on both sides);
* every modeled row of the twins equals the JAX ``benchmarks`` row string
  for string, given the same non-contiguous fraction;
* the contiguity selection on the reduced qwen3-32b, with the weights of
  the JAX ``Model.init`` carried across, picks the same token ids as the
  JAX function up to near-ties of the bf16 scores (see ``TIE_TOL``);
* the twins' entry points run with ``--device cpu``;
* every edit that the kernel probes make to a kernel source still finds its
  text in the current source, as often as the edit says.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.exp09_dense_transfer as jexp09
import benchmarks.exp10_sparse as jexp10
from repro.configs.base import RuntimeConfig
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduced_config as jax_reduced_config
from repro.core import fabric as jfabric
from repro.core.pool import BelugaPool, PoolLayout
from repro.core.transfer import TransferEngine
from repro.models import Model as JaxModel
from repro.models import attention as jattn
from repro.models.layers import norm_apply as jnorm_apply
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import fabric, transfer
from repro_torch.core.pool import KVBlockLayout
from repro_torch.experiments import exp09_dense_transfer as exp09
from repro_torch.experiments import exp10_sparse as exp10
from repro_torch.experiments import paged_probe, sparse_probe, ssd_probe
from repro_torch.kernels import build

torch.set_num_threads(1)  # tiny shapes; keep off the other test workers' cores

ARCHS = ["llama3.1-8b", "qwen3-32b", "olmo-1b", "qwen1.5-0.5b"]


# the reference's fields that the port's fabric model reads; each is a
# module constant of the same name in upper case
LINK_FIELDS = ["cxl_64b_latency", "gpu_cxl_bw", "kernel_launch", "rdma_base_latency",
               "rdma_bw", "rdma_request_overhead", "rdma_sgl_max", "bounce_copy_bw",
               "host_sync_overhead"]


@pytest.mark.parametrize("name", LINK_FIELDS)
def test_link_constants_are_the_reference_values(name):
    assert getattr(fabric, name.upper()) == getattr(jfabric.DEFAULT, name)


@pytest.mark.parametrize("size", [1, 4096, 20480, 2**20, 123457])
@pytest.mark.parametrize("n_frag", [1, 7, 64, 1024])
def test_fabric_latencies_equal_reference(size, n_frag):
    """The two paths the twins price: the fused kernel and GPU-side RDMA."""
    assert fabric.gpu_transfer_latency(size) == \
        jfabric.gpu_transfer_latency(size, n_frag, "fused_kernel")
    assert fabric.rdma_transfer_latency(size, n_frag) == \
        jfabric.rdma_transfer_latency(size, n_frag, gpu_side=True)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype_bytes", [1, 2])
def test_transfer_accounting_equals_transfer_engine(arch, dtype_bytes):
    """Modeled seconds and requests of gather_write / scatter_read (with and
    without LMCache super-blocks) and of the 16-token sparse read."""
    layout = KVBlockLayout.for_model(get_config(arch), 16)
    jlayout = dataclasses.replace(PoolLayout.for_model(jax_get_config(arch)),
                                  dtype_bytes=dtype_bytes)
    assert transfer.block_bytes(layout, dtype_bytes) == jlayout.block_bytes
    for mode in ("beluga", "rdma"):
        for sb in (0, 256):
            for n in (1, 3, 20):
                eng = TransferEngine(BelugaPool(jlayout, 64, n_shards=8, backing="meta"),
                                     mode=mode, super_block_tokens=sb)
                ids = eng.pool.allocate(n)
                eng.gather_write(ids, None)
                w = (eng.stats.modeled_write_s, eng.stats.requests_issued)
                eng.scatter_read(ids)
                r = (eng.stats.modeled_read_s, eng.stats.requests_issued - w[1])
                assert transfer.block_transfer_cost(layout, n, mode, dtype_bytes, sb) == w == r
        for frac in (0.0, 0.26, 0.871):
            assert transfer.sparse_read_latency(layout, 16, frac, mode, dtype_bytes) == \
                eng.sparse_read_latency(16, frac)


def test_exp09_modeled_rows_equal_reference():
    want = jexp09.run()
    got = exp09.modeled_rows()
    assert got == [r for r in want if r[0] != "exp09.kernel_single_launch"]


@pytest.mark.parametrize("frac", [0.0, 0.26, 0.871])
def test_exp10_modeled_rows_equal_reference(monkeypatch, frac):
    monkeypatch.setattr(jexp10, "_contiguity_from_real_model", lambda: frac)
    want = [r for r in jexp10.run() if r[0] != "exp10.kernel_allclose"]
    assert exp10.modeled_rows(frac) == want


# bf16 scores of the reduced model: two scores closer than this to the k-th
# largest may swap places between the frameworks (XLA and PyTorch round the
# bf16 products after differently ordered f32 sums). The scores lie below
# 0.5, where one bf16 step is 2**-9; the limit is two steps. Reading: the
# two selections are identical (no id of the 128 differs).
TIE_TOL = 2**-8


def _jax_selection():
    """The body of exp10's ``_contiguity_from_real_model`` (exp10_sparse.py:18),
    returning what it computes on the way."""
    cfg = jax_reduced_config("qwen3-32b")
    m = JaxModel(cfg, RuntimeConfig(remat="none", attn_chunk_q=64, attn_chunk_kv=64))
    params = m.init(jax.random.key(0))
    tokens = jax.random.randint(jax.random.key(1), (1, 256), 0, cfg.vocab_size)
    x, positions = m.embed(params, {"tokens": tokens})
    pp = jax.tree.map(lambda a: a[0], params["stack"]["pos_0"])
    h = jnorm_apply(pp["ln1"], x, cfg)
    q, k, v = jattn.qkv_proj(pp["attn"], h, cfg, positions, None)
    k = jattn._repeat_kv(k, q.shape[2] // k.shape[2])
    scores = jnp.einsum("bshd,bthd->bhst", q[:, -1:], k)
    sel = jnp.sort(jax.lax.top_k(scores[0, :, 0, :], 32)[1], axis=-1)
    return params, np.array(tokens), np.array(sel)


def test_contiguity_selection_matches_jax_function():
    params, tokens, jsel = _jax_selection()
    assert exp10.noncontiguous_fraction(torch.from_numpy(jsel)) == \
        jexp10._contiguity_from_real_model()
    cfg = exp10.contiguity_config(reduced=True)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    sel, k, v, scores = exp10.select_tokens(tparams, torch.from_numpy(tokens), cfg)
    assert sel.shape == jsel.shape == (cfg.n_heads, exp10.TOP)
    assert k.shape == v.shape == (256, cfg.n_kv_heads, cfg.head_dim)
    s = scores.float()
    kth = s.sort(dim=-1, descending=True).values[:, exp10.TOP - 1]
    for h in range(cfg.n_heads):
        differ = set(sel[h].tolist()) ^ set(jsel[h].tolist())
        assert all(abs(s[h, t] - kth[h]) <= TIE_TOL for t in differ), (h, differ)
    n_same = sum(len(set(sel[h].tolist()) & set(jsel[h].tolist())) for h in range(cfg.n_heads))
    assert n_same >= 0.9 * sel.numel()


def test_piece_ids_address_the_pool_payload():
    layout = KVBlockLayout(block_tokens=4, n_layers_kv=3, n_kv_heads=2, head_dim=8)
    n_blocks = 5
    data = torch.arange(n_blocks * 6 * 4 * 2 * 8, dtype=torch.float32).reshape(
        n_blocks, 6, 4, 2, 8)
    block_ids = torch.tensor([3, 0, 4])  # a 12-token context, scattered
    positions = torch.tensor(np.random.default_rng(0).integers(0, 12, size=(3, 2, 5)))
    ids = exp10.piece_ids(block_ids, positions, layout).reshape(3, 2, 2, 5)
    view = data.view(-1, 1, 8)
    for l, f, h, t in np.ndindex(3, 2, 2, 5):
        p = int(positions[l, h, t])
        want = data[block_ids[p // 4], 2 * l + f, p % 4, h]
        assert torch.equal(view[ids[l, f, h, t], 0], want)


def test_exp10_twin_runs_on_cpu(capsys):
    rows = {r[0]: r for r in exp10.main(["--device", "cpu", "--reduced"])}
    out = capsys.readouterr().out
    assert "MODELED" in out and "exp10.kernel_allclose,1,ok=True" in out
    for name in ("exp10.topk_gather", "exp10.sparse16.llama3.1-8b.device",
                 "exp10.sparse16.qwen3-32b.device"):
        assert rows[name][1] == "not measured" and "bit_exact=True" in rows[name][2]
    assert "finite=True" in rows["exp10.topk_gather"][2]
    assert 0.0 <= float(rows["exp10.noncontiguous_fraction"][1]) <= 100.0


def test_exp09_twin_runs_on_cpu(capsys):
    rows = {r[0]: r for r in exp09.main(["--device", "cpu", "--reduced"])}
    assert "MODELED" in capsys.readouterr().out
    for arch in ("qwen3-32b", "llama3.1-8b"):
        for what in ("write", "read"):
            r = rows[f"exp09.{arch}.{what}.device"]
            assert r[1] == "not measured" and "bit_exact=True" in r[2]
    assert "out shape (4, 8, 16, 2, 32)" in rows["exp09.kernel_single_launch"][2]


def test_twins_refuse_to_pretend_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp10.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp09.run()


def test_cold_id_sets_read_whole_contexts_anywhere_in_the_pool():
    """Each timed read is a read of the same size as the checked one: 16
    distinct positions per (layer, kv head, k|v) inside one context of
    ctx_blocks pool blocks."""
    layout = KVBlockLayout(block_tokens=4, n_layers_kv=3, n_kv_heads=2, head_dim=8)
    n_pool, ctx_blocks = 10, 5
    sets = exp10.cold_id_sets(layout, n_pool, ctx_blocks, torch.Generator().manual_seed(0))
    assert len(sets) == exp10.ID_SETS
    for ids in sets:
        assert ids.dtype == torch.int32 and ids.numel() == exp10.N_TOKENS * 3 * 2 * 2
        blk = ids.long() // (2 * 3 * 4 * 2)  # piece id -> pool block
        assert int(blk.max()) < n_pool and len(set(blk.tolist())) <= ctx_blocks
        per_piece = ids.reshape(3, 2, 2, exp10.N_TOKENS)
        assert all(len(set(p.tolist())) == exp10.N_TOKENS for p in per_piece.reshape(-1, 16))
    assert len({tuple(ids.tolist()) for ids in sets}) == exp10.ID_SETS


PROBE_EDITS = [("paged_attention", f"paged_probe.{k}", v) for k, v in paged_probe.ABLATIONS.items()]
PROBE_EDITS += [("ssd_chunk", f"ssd_probe.{k}", v) for k, v in ssd_probe.VARIANTS.items()]
PROBE_EDITS += [("ssd_chunk", "ssd_probe.timeline", ssd_probe.TIMELINE)]
PROBE_EDITS += [("kv_transfer", f"sparse_probe.{k}", v) for k, v in sparse_probe.VARIANTS.items()]
PROBE_EDITS += [("kv_transfer", "sparse_probe.timeline", sparse_probe.TIMELINE)]


@pytest.mark.parametrize("source,name,edits", PROBE_EDITS, ids=[p[1] for p in PROBE_EDITS])
def test_probe_edits_apply_to_the_current_source(source, name, edits):
    patched = build.patched_source(source, edits)
    assert patched != (build.CSRC / f"{source}.cu").read_text()
    assert all(new in patched for _, new, _ in edits)


def test_patched_source_refuses_a_stale_edit():
    with pytest.raises(RuntimeError, match="no longer holds"):
        build.patched_source("ssd_chunk", [("no such text in the source", "", 1)])
    with pytest.raises(RuntimeError, match="no longer holds"):
        build.patched_source("ssd_chunk", [("__expf(", "expf(", 1)])
