"""The launch tooling (``repro_torch.launch.{steps,dryrun,roofline}`` and the
config methods they read) held against the JAX package's on the CPU.

* ``param_count``, ``active_param_count``, ``kv_bytes_per_token``,
  ``ssm_state_bytes`` and ``describe`` equal JAX's, integer for integer, on
  all 12 registry configs; ``SHAPES`` and ``shape_applicable`` equal JAX's;
* ``_decode_axes`` equal to JAX's on the three cases of
  ``tests/test_fabric_roofline.py``; ``useful_bytes_per_dev`` equal on
  command-r-35b ``decode_32k``;
* ``model_flops`` / ``attn_model_flops`` equal to JAX's on every cell,
  JAX's computed in a subprocess: ``repro.launch.dryrun`` sets
  ``XLA_FLAGS`` to 512 fake devices when it is imported;
* the H100 constants, one source, and no TPU constant left in the port;
* ``run_cell`` on the 16x16 mesh: ``ok`` records with FLOPs, bytes,
  collectives by type and a live-bytes peak for one cell of each kind and
  family, a ``skipped`` record for a dense arch at ``long_500k``; the
  roofline table and its three picks over them.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.configs import base as jax_base
from repro.configs import registry as jax_registry
from repro.launch import roofline as jax_roofline
from repro.launch import steps as jax_steps
from repro_torch.configs import base
from repro_torch.configs import registry
from repro_torch.launch import dryrun, mesh, roofline, steps

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch", sorted(registry.REGISTRY))
def test_config_counts_equal_jax(arch):
    cfg, ref = registry.get_config(arch), jax_registry.get_config(arch)
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    for b in (1, 2):
        assert cfg.kv_bytes_per_token(b) == ref.kv_bytes_per_token(b)
    for b in (2, 4):
        assert cfg.ssm_state_bytes(b) == ref.ssm_state_bytes(b)
    assert base.describe(cfg) == jax_base.describe(ref)


def test_shapes_and_applicability_equal_jax():
    assert {k: (s.name, s.seq_len, s.global_batch, s.kind) for k, s in base.SHAPES.items()} \
        == {k: (s.name, s.seq_len, s.global_batch, s.kind) for k, s in jax_base.SHAPES.items()}
    for arch in registry.REGISTRY:
        for name in base.SHAPES:
            assert base.shape_applicable(registry.get_config(arch), base.SHAPES[name]) == \
                jax_base.shape_applicable(jax_registry.get_config(arch), jax_base.SHAPES[name])


class _Rules:  # the stand-in of tests/test_fabric_roofline.py: _decode_axes reads these
    class mesh:
        axis_names = ("data", "model")

    dp = 16
    rules = {"batch": ("data",)}


@pytest.mark.parametrize("shape, decode_kv", [("decode_32k", "pool_interleaved"),
                                              ("long_500k", "pool_interleaved"),
                                              ("decode_32k", "replicated")])
def test_decode_axes_equal_jax(shape, decode_kv):
    got = steps._decode_axes(_Rules, base.SHAPES[shape], base.RuntimeConfig(decode_kv=decode_kv))
    want = jax_steps._decode_axes(_Rules, jax_base.SHAPES[shape],
                                  jax_base.RuntimeConfig(decode_kv=decode_kv))
    assert got == want


def test_useful_bytes_equal_jax():
    rec = {"arch": "command-r-35b", "shape": "decode_32k", "n_chips": 256}
    assert roofline.useful_bytes_per_dev(rec) == jax_roofline.useful_bytes_per_dev(rec)


def test_model_flops_equal_jax():
    code = textwrap.dedent("""
        import json
        from repro.configs.base import SHAPES
        from repro.configs.registry import ASSIGNED
        from repro.launch.dryrun import attn_model_flops, model_flops
        print(json.dumps({f"{a}.{s}": [model_flops(c, SHAPES[s]), attn_model_flops(c, SHAPES[s])]
                          for a, c in ASSIGNED.items() for s in SHAPES}))
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    got = {f"{a}.{s}": [dryrun.model_flops(c, base.SHAPES[s]),
                        dryrun.attn_model_flops(c, base.SHAPES[s])]
           for a, c in registry.ASSIGNED.items() for s in base.SHAPES}
    assert got == want


def test_h100_constants_one_source_and_no_tpu_constant():
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW, mesh.HBM_PER_CHIP, mesh.COLLECTIVE_BW) == \
        (989e12, 3.35e12, 80e9, 50e9)
    from repro_torch.experiments import common, flash_probe

    assert common.HBM_BYTES_PER_S is mesh.HBM_BW
    assert flash_probe.BF16_FLOP_PER_S is mesh.PEAK_FLOPS_BF16
    smoke = (REPO / "chip_smoke.py").read_text()
    assert "from repro_torch.launch.mesh import" in smoke
    assert "= 989e12" not in smoke and "= 3.35e12" not in smoke
    bad = [f"{p.relative_to(REPO)}:{i}" for p in (REPO / "src" / "repro_torch").rglob("*.py")
           for i, line in enumerate(p.read_text().splitlines(), 1)
           if any(t in line for t in ("197e12", "819e9", "v5e"))]
    assert not bad, bad


# one cell of each kind and family on the 16x16 mesh, and a skip; then the
# cells that found the kernel routes' faults under a mesh (ROADMAP section
# 3): olmo-1b's decode (one q head a rank: a strided q for paged) and
# jamba's long decode (its KV sequence over data and model); arctic's
# prefill has 8 kv heads over 16 ranks (a strided K/V slice for flash)
CELLS = [("olmo-1b", "train_4k", "ok"), ("command-r-35b", "decode_32k", "ok"),
         ("mamba2-2.7b", "long_500k", "ok"), ("arctic-480b", "prefill_32k", "ok"),
         ("llama4-maverick-400b-a17b", "long_500k", "skipped"),
         ("olmo-1b", "decode_32k", "ok"), ("jamba-1.5-large-398b", "long_500k", "ok")]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    recs = {}
    for arch, shape, _ in CELLS:
        rec = dryrun.run_cell(arch, shape, False, str(out))
        with open(out / f"{rec['cell']}.json", "w") as f:
            json.dump(rec, f)
        recs[(arch, shape)] = rec
    return out, recs


@pytest.mark.parametrize("arch, shape, status", CELLS)
def test_run_cell_records(records, arch, shape, status):
    out, recs = records
    rec = recs[(arch, shape)]
    assert rec["status"] == status, rec.get("traceback", rec.get("reason"))
    assert rec["cell"] == f"{arch}.{shape}.pod16x16"
    if status == "skipped":
        assert rec["reason"] == jax_base.shape_applicable(
            jax_registry.get_config(arch), jax_base.SHAPES[shape])[1]
        return
    oa = rec["op_analysis"]
    assert rec["n_chips"] == 256 and oa["flops"] > 0 and oa["bytes_accessed"] > 0
    assert oa["collective_bytes"] == sum(oa["collectives_by_type"].values()) > 0
    assert rec["peak_live_bytes_per_device"] == oa["peak_live_bytes"] > 0
    assert (out / "ops" / f"{rec['cell']}.json.gz").exists()
    cfg = registry.get_config(arch)
    # the kernels of each kind of cell, on one rank of the mesh
    kind = base.SHAPES[shape].kind
    attn = {"train": {"flash_attention", "flash_attention_bwd"}, "prefill": {"flash_attention"},
            "decode": {"paged_attention"}}[kind]
    ssm = {"train": {"ssd_chunk", "ssd_chunk_bwd"}, "prefill": {"ssd_chunk"}, "decode": set()}[kind]
    want = (attn if cfg.attn_layer_ids() else set()) | (ssm if cfg.has_ssm_layers else set())
    assert set(oa["kernels"]) == want
    if shape == "train_4k":  # remat "full": each period's forward runs twice
        assert oa["kernels"]["flash_attention"]["launches"] == 2 * cfg.n_layers
        assert oa["kernels"]["flash_attention_bwd"]["launches"] == cfg.n_layers
    # the count covers at least the per-device model FLOPs
    assert oa["flops"] >= rec["model_flops_total"] / rec["n_chips"]


def test_roofline_table_and_picks(records):
    out, _ = records
    rows = [t for r in roofline.load_records(str(out)) if (t := roofline.roofline_terms(r))]
    assert len(rows) == 6
    text = roofline.render_markdown(rows)
    assert text.startswith(roofline.HEADER) and text.count("\n| ") == 7
    # both meshes in one row: the 2x16x16 records of two of the cells
    both = rows + [dict(r, mesh="pod2x16x16", compute_s=2 * r["compute_s"]) for r in rows[:2]]
    lines = roofline.render_markdown(both).splitlines()
    assert len(lines) == 4 + 6 and lines[0].endswith("pod16x16 / pod2x16x16")
    a = rows[0]
    assert lines[4].startswith(f"| {a['arch']}.{a['shape']} | {a['compute_s']:.4f} / "
                               f"{2 * a['compute_s']:.4f} | ")
    assert lines[-1].split(" | ")[1].endswith(" / -")
    picks = roofline.pick_hillclimb_cells(rows)
    assert set(picks) == {"worst_fraction", "most_collective", "paper_representative"}
    assert picks["paper_representative"]["cell"] == "command-r-35b.decode_32k.pod16x16"
    # the cells of archs over 90 B parameters
    assert picks["worst_fraction"]["arch"] in ("arctic-480b", "jamba-1.5-large-398b")
    for r in rows:
        assert r["dominant"] in roofline.HINTS and 0 < r["model_flops_ratio"]
        assert r["fits_hbm"] == (r["live_bytes_per_dev"] <= 80e9)
