"""Multi-pod dry run: count every (architecture x input shape) on the
production meshes and keep the roofline inputs of each.

Twin of ``repro/launch/dryrun.py``, which lowers and compiles each cell on
512 fake CPU devices and reads the compiled artifact. The port has nothing
to lower: each cell is built for one rank of an abstract production mesh
(``launch/mesh.Mesh`` with ``rank=None``; every collective recorded, none
staged) on the ``meta`` device, and run once under
``launch/op_analysis.OpAnalyzer``. It touches no card and does no
arithmetic on the CPU.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
        --out results/dryrun_torch

Per cell this records (JSON, one file per cell, under JAX's keys):
  * ``op_analysis`` in place of ``hlo_analysis``: per-device FLOPs, bytes,
    collective bytes by type, transcendentals, kernel launches with their
    costs, the top five by FLOPs and by bytes;
  * ``peak_live_bytes_per_device``: the peak of live storage bytes,
    arguments included, in place of ``memory_analysis``;
  * ``t_run_s`` in place of the lower and compile times; analytic
    MODEL_FLOPS.
and beside it ``ops/<cell>.json.gz``, the count of every (aten op, input
shapes, dtypes), in place of the HLO text.
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import os
import time
import traceback

DEFAULT_OUT = "results/dryrun_torch"


def model_flops(cfg, shape) -> float:
    """Analytic useful FLOPs for the cell (6·N·D train, 2·N_active fwd)."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (1 if shape.is_decode else shape.seq_len)
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    return 2.0 * n_active * tokens


def attn_model_flops(cfg, shape) -> float:
    """Analytic causal-attention FLOPs (not in 6·N·D; reported separately)."""
    n_attn = len(cfg.attn_layer_ids())
    if n_attn == 0 or cfg.n_heads == 0:
        return 0.0
    h, d = cfg.n_heads, cfg.head_dim
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        per = 2 * 2 * h * d * s * s / 2  # causal half, fwd
        return 3 * per * b * n_attn  # fwd + bwd(2x)
    if shape.kind == "prefill":
        return 2 * 2 * h * d * s * s / 2 * b * n_attn
    return 2 * 2 * h * d * s * b * n_attn  # decode: q=1 vs kv=s


def mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def cell_id(arch: str, shape_name: str, multi_pod: bool, tag: str = "") -> str:
    return f"{arch}.{shape_name}.{mesh_name(multi_pod)}" + (f".{tag}" if tag else "")


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             runtime_overrides: dict | None = None, tag: str = "") -> dict:
    """One cell's record; with ``out_dir`` also its op count under
    ``out_dir/ops``. An error is recorded with its traceback, not raised."""
    from repro_torch.configs.base import SHAPES, RuntimeConfig, shape_applicable
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.sharding import AxisRules
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import PRODUCTION, Mesh
    from repro_torch.launch.op_analysis import OpAnalyzer

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    cid = cell_id(arch, shape_name, multi_pod, tag)
    rec: dict = {"cell": cid, "arch": arch, "shape": shape_name,
                 "mesh": mesh_name(multi_pod), "tag": tag or "baseline"}

    ok, why = shape_applicable(cfg, shape)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec

    runtime = RuntimeConfig(**(runtime_overrides or {}))
    rec["runtime"] = dataclasses.asdict(runtime)
    mesh = Mesh(*PRODUCTION[multi_pod])  # abstract: rank None, coordinates 0
    rules = AxisRules.create(mesh)

    t0 = time.perf_counter()
    try:
        cell = steps_lib.build_cell(cfg, shape, rules, runtime)
        args = cell.make_args("meta")
        with OpAnalyzer(track=args) as analyzer:
            cell.fn(*args)
    except Exception as e:  # noqa: BLE001 - recorded with its traceback
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        return rec

    rec["status"] = "ok"
    rec["notes"] = cell.notes
    rec["n_chips"] = mesh.size
    rec["t_run_s"] = round(time.perf_counter() - t0, 2)
    rec["op_analysis"] = analyzer.result()
    rec["peak_live_bytes_per_device"] = analyzer.peak_live_bytes
    rec["model_flops_total"] = model_flops(cfg, shape)
    rec["attn_model_flops_total"] = attn_model_flops(cfg, shape)
    rec["param_count"] = cfg.param_count()
    rec["active_param_count"] = cfg.active_param_count()

    if out_dir:
        os.makedirs(os.path.join(out_dir, "ops"), exist_ok=True)
        with gzip.open(os.path.join(out_dir, "ops", cid + ".json.gz"), "wt") as f:
            json.dump([[op, [list(s) for s in shapes], n]
                       for (op, shapes), n in analyzer.ops.most_common()], f)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--tag", default="")
    ap.add_argument("--runtime-json", default=None,
                    help='RuntimeConfig overrides, e.g. \'{"decode_kv":"replicated"}\'')
    args = ap.parse_args(argv)

    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import ASSIGNED

    overrides = json.loads(args.runtime_json) if args.runtime_json else None

    archs = list(ASSIGNED) if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = ([False, True] if (args.both_meshes or (args.all and not args.multi_pod))
              else [args.multi_pod])
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    os.makedirs(args.out, exist_ok=True)
    summary = []
    t_all = time.perf_counter()
    for arch, shape, mp in cells:
        cid = cell_id(arch, shape, mp, args.tag)
        path = os.path.join(args.out, cid + ".json")
        if os.path.exists(path):
            with open(path) as f:
                rec = json.load(f)
            print(f"[cached] {cid}: {rec.get('status')}")
            summary.append(rec)
            continue
        print(f"[run] {cid}", flush=True)
        rec = run_cell(arch, shape, mp, args.out, overrides, args.tag)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        status = rec.get("status")
        extra = ""
        if status == "ok":
            oa = rec["op_analysis"]
            extra = (
                f" flops/dev={oa['flops']:.3e} bytes/dev={oa['bytes_accessed']:.3e}"
                f" coll/dev={oa['collective_bytes']:.3e}"
                f" peak/dev={rec['peak_live_bytes_per_device']:.3e} run={rec['t_run_s']}s"
            )
        print(f"[done] {cid}: {status}{extra}", flush=True)
        summary.append(rec)

    n_ok = sum(1 for r in summary if r.get("status") == "ok")
    n_skip = sum(1 for r in summary if r.get("status") == "skipped")
    n_err = sum(1 for r in summary if r.get("status") == "error")
    print(f"\ndry-run complete: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"in {time.perf_counter() - t_all:.1f} s of CPU")
    for r in summary:
        if r.get("status") == "error":
            print(f"  ERROR {r['cell']}: {r['error']}")


if __name__ == "__main__":
    main()
