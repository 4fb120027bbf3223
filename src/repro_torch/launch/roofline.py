"""Roofline report from dry-run records (twin of ``repro/launch/roofline.py``).

Per (arch x shape x mesh) cell, priced with one NVIDIA H100 SXM's data
sheet (``launch/mesh.py``), all per device (the dry run counts one rank):

    compute term    = flops_per_dev / PEAK_FLOPS_BF16
    memory term     = bytes_per_dev / HBM_BW
    collective term = collective_bytes_per_dev / COLLECTIVE_BW  (MODELED)

There is one bytes figure: eager execution's as-run bytes
(``launch/op_analysis.py``). Nothing fuses on the eager path, so there is
no twin of JAX's ``bytes_fused``. Also: MODEL_FLOPS / counted FLOPs, the
dominant bottleneck, whether the live bytes fit in 80 GB, and a one-line
"what would move the dominant term" note per cell. No device ran these
cells: every term is MODELED from the data sheet.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--out results/dryrun_torch]
"""

from __future__ import annotations

import glob
import json
import os

from repro_torch.launch.dryrun import DEFAULT_OUT
from repro_torch.launch.mesh import COLLECTIVE_BW, HBM_BW, HBM_PER_CHIP, PEAK_FLOPS_BF16

HEADER = "**MODELED from the H100 SXM data sheet; no device ran these cells**"


def load_records(out_dir: str = DEFAULT_OUT, tag: str | None = "baseline"):
    recs = []
    for f in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        if tag is not None and r.get("tag", "baseline") != tag:
            continue
        recs.append(r)
    return recs


def useful_bytes_per_dev(rec: dict) -> float:
    """Minimal HBM traffic the step fundamentally requires, per chip
    (``useful_bytes`` of the record's arch, shape and chips)."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import get_config

    return useful_bytes(get_config(rec["arch"]), SHAPES[rec["shape"]], rec["n_chips"])


def useful_bytes(cfg, shape, n: int = 1) -> float:
    """Minimal HBM traffic of ``cfg`` at ``shape`` over ``n`` chips, per chip.

    train:   read+write params (bf16) + read+write adam moments (fp32) +
             grads (bf16) — activation traffic excluded (optimizable).
    prefill: read params once + write the KV/SSM cache.
    decode:  read params once + read the full KV cache (+SSM states).
    """
    n_params_loc = cfg.param_count() / n
    b, s = shape.global_batch, shape.seq_len
    kv_loc = cfg.kv_bytes_per_token() * b * s / n
    ssm_loc = cfg.ssm_state_bytes() * b / n
    if shape.kind == "train":
        return n_params_loc * (2 + 2 + 2 + 16)  # w r/w, grads, m+v r/w
    if shape.kind == "prefill":
        return n_params_loc * 2 + kv_loc + ssm_loc
    return n_params_loc * 2 + kv_loc + ssm_loc  # decode reads the cache


def roofline_terms(rec: dict) -> dict | None:
    if rec.get("status") != "ok":
        return None
    oa = rec["op_analysis"]
    n = rec["n_chips"]
    compute = oa["flops"] / PEAK_FLOPS_BF16
    memory = oa["bytes_accessed"] / HBM_BW
    collective = oa["collective_bytes"] / COLLECTIVE_BW
    terms = {"compute": compute, "memory": memory, "collective": collective}
    dominant = max(terms, key=terms.get)
    bound = terms[dominant]
    model_flops_dev = rec["model_flops_total"] / n
    useful_ratio = model_flops_dev / max(oa["flops"], 1.0)
    # roofline fraction: time the step fundamentally needs (max of useful
    # compute and useful memory) / modeled bottleneck time — the score.
    useful_time = max(
        model_flops_dev / PEAK_FLOPS_BF16,
        useful_bytes_per_dev(rec) / HBM_BW,
    )
    frac = useful_time / max(bound, 1e-12)
    live = rec.get("peak_live_bytes_per_device")
    return {
        "cell": rec["cell"],
        "arch": rec["arch"],
        "shape": rec["shape"],
        "mesh": rec["mesh"],
        "compute_s": compute,
        "memory_s": memory,
        "collective_s": collective,
        "dominant": dominant,
        "model_flops_ratio": useful_ratio,
        "roofline_frac": frac,
        "bytes_per_dev": oa["bytes_accessed"],
        "flops_per_dev": oa["flops"],
        "coll_bytes_per_dev": oa["collective_bytes"],
        "coll_by_type": oa.get("collectives_by_type", {}),
        "live_bytes_per_dev": live,
        "fits_hbm": (live is not None and live <= HBM_PER_CHIP),
        "top_flops": oa.get("top_flops", [])[:5],
        "top_bytes": oa.get("top_bytes", [])[:5],
    }


HINTS = {
    "compute": "shave non-model FLOPs: causal block-skip in attention "
    "(the flash kernels), cheaper remat policy, leaner MoE dispatch",
    "memory": "shrink HBM traffic: fuse eager elementwise chains into "
    "kernels, narrower remat, KV in fp8, avoid staging copies of the cache",
    "collective": "re-shard to cut collective bytes: overlap DP all-reduce, "
    "reduce-scatter grads, keep activations model-sharded longer",
}


MESHES = ("pod16x16", "pod2x16x16")
COLUMNS = (  # header, the value of one record
    ("compute (s)", lambda r: f"{r['compute_s']:.4f}"),
    ("memory (s)", lambda r: f"{r['memory_s']:.4f}"),
    ("collective (s, MODELED)", lambda r: f"{r['collective_s']:.4f}"),
    ("dominant", lambda r: r["dominant"]),
    ("useful/counted", lambda r: f"{r['model_flops_ratio']:.2f}"),
    ("roofline frac", lambda r: f"{r['roofline_frac']:.3f}"),
    ("live GB/chip", lambda r: "?" if r["live_bytes_per_dev"] is None
     else f"{r['live_bytes_per_dev'] / 1e9:.2f}"),
    ("fits 80 GB", lambda r: "yes" if r["fits_hbm"] else "no"),
)


def render_markdown(rows: list[dict]) -> str:
    """One row per (arch, shape), in the order of ``rows``. Where the
    records hold both production meshes each column reads "pod16x16 /
    pod2x16x16", so the sweep of both meshes is one table of half the rows
    (JAX's has a row per mesh)."""
    meshes = [m for m in MESHES if any(r["mesh"] == m for r in rows)]
    cells: dict[str, dict] = {}
    for r in rows:
        cells.setdefault(f"{r['arch']}.{r['shape']}", {})[r["mesh"]] = r
    lines = [f"{HEADER}; each column {' / '.join(meshes)}", "",
             "| cell | " + " | ".join(h for h, _ in COLUMNS) + " |",
             "|---" * (len(COLUMNS) + 1) + "|"]
    for cell, by_mesh in cells.items():
        values = [" / ".join(fmt(by_mesh[m]) if m in by_mesh else "-" for m in meshes)
                  for _, fmt in COLUMNS]
        lines.append(f"| {cell} | " + " | ".join(values) + " |")
    return "\n".join(lines) + "\n"


def pick_hillclimb_cells(rows: list[dict]) -> dict:
    """worst roofline fraction, most collective-bound, most paper-representative.

    Worst-fraction is restricted to >=90B-param cells: tiny archs at frac~0
    are bounded by fixed overheads, not by anything a sharding/kernel change
    can move, so hillclimbing them wastes the budget.
    """
    from repro_torch.configs.registry import get_config

    single = [r for r in rows if r["mesh"] == "pod16x16"]
    big = [r for r in single if get_config(r["arch"]).param_count() > 9e10]
    worst = min(big or single, key=lambda r: r["roofline_frac"])
    coll = max(
        single,
        key=lambda r: r["collective_s"]
        / max(r["compute_s"], r["memory_s"], 1e-12),
    )
    # paper-representative: decode with a big KV cache (the KVCache read path
    # Beluga optimizes) on the paper-scale dense GQA arch
    reps = [
        r
        for r in single
        if r["shape"] == "decode_32k" and r["arch"] in ("command-r-35b", "internvl2-26b")
    ]
    rep = reps[0] if reps else min(
        (r for r in single if r["shape"] == "decode_32k"),
        key=lambda r: r["roofline_frac"],
    )
    return {"worst_fraction": worst, "most_collective": coll, "paper_representative": rep}


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--tag", default="baseline")
    args = ap.parse_args(argv)
    rows = [t for r in load_records(args.out, args.tag) if (t := roofline_terms(r))]
    rows.sort(key=lambda r: (r["mesh"], r["arch"], r["shape"]))
    print(render_markdown(rows))
    picks = pick_hillclimb_cells(rows)
    print("hillclimb picks:")
    for k, v in picks.items():
        print(
            f"  {k}: {v['cell']} (dominant={v['dominant']}, frac={v['roofline_frac']:.3f})"
        )
        print(f"    hint: {HINTS[v['dominant']]}")


if __name__ == "__main__":
    main()
