"""``launch/op_analysis.OpAnalyzer`` against programs whose count is known,
the kernels' ``cost`` against ``PERF.md``'s bound column, a dry run on
``meta`` against the same cell on the CPU, and an abstract mesh's
collectives against a gloo world's.

* one ``mm`` counted exactly (the twin of JAX's
  ``test_analyzer_on_plain_text``), and a 10-layer loop of tanh(h @ w) on an
  abstract (2, 4) mesh with an all-gather a layer (the twin of
  ``test_analyzer_counts_scan_trip_counts``): FLOPs exact, 10 all-gathers;
* ``row_parallel_matmul`` records bf16 bytes under ``rowp_bf16`` and f32
  bytes without (the twin of ``test_collective_dtype_correction``);
* each kernel's ``cost`` at ``PERF.md`` section 6's shapes gives its bound
  column to the printed digits;
* reduced configs' train, prefill and decode cells on ``meta`` count
  exactly as the same cells on CPU tensors through the kernel route (each
  kernel stood in for by its plain version inside its accounting region,
  as on the card): the same (op, shapes, dtypes), FLOPs, bytes,
  transcendentals and kernels; remat's recompute is counted;
* a 4-rank gloo world on the CPU (2x2, reduced configs) records on every
  rank the collectives and bytes of the abstract 2x2 mesh on ``meta``; a
  real tensor under an abstract mesh raises.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch.configs.base import RuntimeConfig, ShapeConfig
from repro_torch.configs.registry import reduced_config
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import AxisRules
from repro_torch.distributed.world import run_world
from repro_torch.kernels import accounting, ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import kv_transfer as kv
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ssd_chunk as ssd
from repro_torch.launch import steps
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16, Mesh
from repro_torch.launch.op_analysis import OpAnalyzer


def test_one_mm_counted_exactly():
    for device in ("cpu", "meta"):
        a, b = torch.ones(128, 256, device=device), torch.ones(256, 64, device=device)
        with OpAnalyzer(track=(a, b)) as an:
            c = a @ b
        r = an.result()
        assert r["flops"] == 2 * 128 * 256 * 64
        assert r["bytes_accessed"] == 4 * (128 * 256 + 256 * 64 + 128 * 64)
        assert r["peak_live_bytes"] == r["bytes_accessed"] and c.shape == (128, 64)
        assert an.op_flops == {"aten.mm": 2 * 128 * 256 * 64}
        assert r["collective_bytes"] == 0 and r["kernels"] == {}


def test_layer_loop_on_an_abstract_mesh():
    mesh = Mesh((2, 4), ("data", "model"))
    B, S, D, L = 8, 16, 256, 10
    h = torch.empty(B // 2, S, D // 4, dtype=torch.bfloat16, device="meta")
    w = torch.empty(L, D, D // 4, dtype=torch.bfloat16, device="meta")
    with OpAnalyzer(track=(h, w)) as an:
        for layer in range(L):
            h = torch.tanh(coll.all_gather(h, 2, mesh, "model") @ w[layer])
        h.sum()
    r = an.result()
    gemm = 2 * (B // 2) * S * D * (D // 4) * L
    assert an.op_flops == {"aten.mm": gemm}
    assert r["flops"] == gemm + (B // 2) * S * (D // 4)  # the sum's one FLOP an element
    assert r["transcendentals"] == L * (B // 2) * S * (D // 4)
    assert r["collective_counts"] == {"all-gather": L}
    assert r["collectives_by_type"] == {"all-gather": L * (B // 2) * S * (D // 4) * 2}
    assert {c[1] for c in an.collectives} == {("model",)}


@pytest.mark.parametrize("rowp_bf16, width", [(True, 2), (False, 4)])
def test_row_parallel_matmul_records_its_dtype(rowp_bf16, width):
    rules = AxisRules.create(Mesh((1, 4), ("data", "model")), rowp_bf16=rowp_bf16)
    x = torch.empty(2, 16, 64, dtype=torch.bfloat16, device="meta")
    w = torch.empty(64, 256, dtype=torch.bfloat16, device="meta")
    with OpAnalyzer() as an:
        out = coll.row_parallel_matmul(x, w, rules)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 16, 256)
    assert an.collectives == [("all-reduce", ("model",), 2 * 16 * 256 * width,
                               "torch.bfloat16" if rowp_bf16 else "torch.float32")]


def test_abstract_mesh_refuses_real_tensors():
    mesh = Mesh((1, 4), ("data", "model"))
    with pytest.raises(RuntimeError, match="meta tensors only"):
        coll.all_reduce(torch.ones(4), mesh, "model")


def _bound(cost) -> tuple[str, str]:
    flops, nbytes = cost
    t_ops, t_bytes = flops / PEAK_FLOPS_BF16, nbytes / HBM_BW
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


# PERF.md section 6's bound column: (cost, printed digits, bound by)
BOUNDS = {
    "kv_gather_write": (kv.kv_gather_write.cost(64, 32, 16, 8, 128, 2), "0.0801", "bytes"),
    "kv_scatter_read": (kv.kv_scatter_read.cost(64, 32, 128, 16, 8, 128, 2), "0.1202", "bytes"),
    # 16 tokens of each of 32 layers x 8 kv heads, K and V: 8192 pieces of 256 B
    "sparse_kv_gather": (kv.sparse_kv_gather.cost(16 * 32 * 8 * 2, 256), "0.00125", "bytes"),
    "flash_attention": (fa.flash_attention.cost(1, 1024, 1024, 32, 8, 128), "0.0087",
                        "operations"),
    "paged_attention": (pa.paged_attention.cost(1, 32, 8, 128, 1040), "0.0013", "bytes"),
    "ssd_chunk": (ssd.ssd_chunk.cost(4, 256, 80, 64, 1, 128, 2, True), "0.0160", "bytes"),
    "flash_attention_bwd": (fa.flash_attention_bwd.cost(4, 2048, 2048, 16, 16, 128),
                            "0.1738", "operations"),
    "ssd_chunk_bwd": (ssd.ssd_chunk_bwd.cost(32, 256, 80, 64, 1, 128, 2, True), "0.1801",
                      "bytes"),
}


@pytest.mark.parametrize("name", sorted(BOUNDS))
def test_kernel_cost_gives_perf_bound(name):
    cost, digits, by = BOUNDS[name]
    ms, got_by = _bound(cost)
    assert f"{ms:.{len(digits) - 2}f}" == digits and got_by == by
    assert ops.KERNELS[name].cost is not None


# ---------------------------------------------------------------------------
# A dry run on meta against the same cell on CPU tensors
# ---------------------------------------------------------------------------

def _dense(out):
    """The plain version's outputs laid out as the kernel writes them."""
    return tuple(t.contiguous() for t in out) if isinstance(out, tuple) else out.contiguous()


def _flash(q, k, v, causal=True, *, force_route=None, return_lse=False):
    b, sq, hq, d = q.shape
    with accounting.kernel("flash_attention", fa.forward_cost(
            b, sq, k.shape[1], hq, k.shape[2], d, causal, q.element_size(), return_lse)):
        return _dense(ref.flash_attention_lse_ref(q, k, v, causal) if return_lse
                      else ref.flash_attention_ref(q, k, v, causal))


def _flash_bwd(q, k, v, o, lse, do, causal=True, *, force_route=None):
    b, sq, hq, d = q.shape
    with accounting.kernel("flash_attention_bwd", fa.backward_cost(
            b, sq, k.shape[1], hq, k.shape[2], d, causal, q.element_size())):
        return _dense(ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal))


def _ssd_cost(cost, x, b):
    nb, lc, nh, hp = x.shape
    g = 1 if b.stride(2) == 0 else b.shape[2]
    return lambda *more: cost(nb, lc, nh, hp, g, b.shape[3], b.element_size(), *more)


def _ssd(x, a_log, b_mat, c_mat, return_cum=False):
    with accounting.kernel("ssd_chunk", _ssd_cost(ssd.forward_cost, x, b_mat)(return_cum)):
        return _dense(ref.ssd_chunk_ref(x, a_log, b_mat, c_mat, return_cum=return_cum))


def _ssd_bwd(x, a_log, b_mat, c_mat, dy, dst, dcum=None):
    cost = _ssd_cost(ssd.backward_cost, x, b_mat)(dcum is not None)
    with accounting.kernel("ssd_chunk_bwd", cost):
        dx, da, db, dc = ref.ssd_chunk_bwd_ref(x, a_log, b_mat, c_mat, dy, dst, dcum)
        return _dense((dx, da, db.to(b_mat.dtype), dc.to(c_mat.dtype)))


def _paged(q, k_blocks, v_blocks, block_table, context_lens, return_lse=False):
    b, hq, d = q.shape
    _, bt, hkv, _ = k_blocks.shape
    with accounting.kernel("paged_attention", pa.cost(
            b, hq, hkv, d, b * block_table.shape[1] * bt, q.element_size(),
            k_blocks.element_size(), return_lse)):
        return _dense(ref.paged_attention_ref(q, k_blocks, v_blocks, block_table, context_lens,
                                              return_lse=return_lse))


def _count(cell, device):
    """The count of a cell's second call (the first builds the decode
    block table, a host-side step the card's count would also skip)."""
    args = cell.make_args(device)
    cell.fn(*args)
    with OpAnalyzer(track=args) as an:
        cell.fn(*args)
    return an


SHAPES = {"train": ShapeConfig("t", 32, 2, "train"), "prefill": ShapeConfig("p", 64, 2, "prefill"),
          "decode": ShapeConfig("d", 64, 2, "decode")}
ARCHS = ["olmo-1b", "command-r-35b", "mamba2-2.7b", "jamba-1.5-large-398b", "arctic-480b"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_meta_count_equals_the_cpu_kernel_route(monkeypatch, arch, kind):
    cfg = reduced_config(arch)
    if cfg.moe.enabled:  # no token dropped at a one-token decode either
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    cell = steps.build_cell(cfg, SHAPES[kind])
    meta = _count(cell, "meta")
    for mod, name, fn in ((fa, "flash_attention", _flash), (fa, "flash_attention_bwd", _flash_bwd),
                          (ssd, "ssd_chunk", _ssd), (ssd, "ssd_chunk_bwd", _ssd_bwd),
                          (pa, "paged_attention", _paged)):
        monkeypatch.setattr(mod, name, fn)
    monkeypatch.setattr(ops, "use_kernel", lambda t, mode: mode != "ref")
    cpu = _count(steps.build_cell(cfg, SHAPES[kind]), "cpu")
    assert meta.ops == cpu.ops
    got, want = meta.result(), cpu.result()
    for key in ("flops", "transcendentals", "bytes_accessed", "kernels", "collective_bytes"):
        assert got[key] == want[key], key
    # an SSM decode step runs no kernel (the recurrence is plain PyTorch)
    assert bool(got["kernels"]) != (cfg.family == "ssm" and kind == "decode")


def test_remat_recompute_is_counted():
    cfg = reduced_config("olmo-1b")
    shape = SHAPES["train"]
    count = {remat: _count(steps.build_cell(cfg, shape, runtime=RuntimeConfig(remat=remat)),
                           "meta").result() for remat in ("none", "full")}
    fwd = _count(steps.build_cell(cfg, ShapeConfig("p", shape.seq_len, shape.global_batch,
                                                   "prefill")), "meta").result()
    extra = count["full"]["flops"] - count["none"]["flops"]
    # the recompute is one forward of the stack (no logits, no cache writes)
    assert 0.5 * fwd["flops"] < extra < fwd["flops"]
    assert count["full"]["kernels"]["flash_attention"]["launches"] == 2 * cfg.n_layers
    assert count["none"]["kernels"]["flash_attention"]["launches"] == cfg.n_layers


# ---------------------------------------------------------------------------
# An abstract mesh against a gloo world
# ---------------------------------------------------------------------------

WORLD_CELLS = [("command-r-35b", "train"), ("arctic-480b", "prefill"),
               ("command-r-35b", "decode")]


def _world_cell(arch: str, kind: str, mesh):
    cfg = reduced_config(arch)
    shape = dataclasses.replace(SHAPES[kind], global_batch=4)
    return steps.build_cell(cfg, shape, AxisRules.create(mesh))


def _rank(rank: int, n: int):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"))
    out = {}
    for arch, kind in WORLD_CELLS:
        cell = _world_cell(arch, kind, mesh)
        args = cell.make_args("cpu")
        with OpAnalyzer(track=args) as an:
            cell.fn(*args)
        out[f"{arch}.{kind}"] = an.collectives
    every = [None] * n
    dist.all_gather_object(every, out)
    return every


@pytest.fixture(scope="module")
def world():
    return run_world(_rank, 4, timeout_s=240.0)


@pytest.mark.parametrize("arch, kind", WORLD_CELLS)
def test_gloo_world_records_the_abstract_mesh_collectives(world, arch, kind):
    cell = _world_cell(arch, kind, Mesh((2, 2), ("data", "model")))
    args = cell.make_args("meta")
    with OpAnalyzer(track=args) as an:
        cell.fn(*args)
    assert an.collectives, "the cell ran no collective"
    for rank, got in enumerate(world):
        assert got[f"{arch}.{kind}"] == an.collectives, rank
