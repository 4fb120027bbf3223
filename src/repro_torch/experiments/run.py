"""One entry for every experiment twin, then the roofline summary.

Twin of ``benchmarks/run.py``:

    python -m repro_torch.experiments.run [--only exp05,exp12] [--fast] [--device cpu]
    python -m repro_torch.experiments.run --smoke   # exp11-14 at --fast size

Prints ``name,us_per_call,derived`` CSV for each row, an ``expNN.FAILED``
row for each twin that raises, then one ``roofline.<cell>`` row for each
dry-run record under ``results/dryrun_torch`` (``launch/roofline.py``; the
terms are MODELED), or ``roofline.SKIPPED`` where there is none. Exits 1
if any twin failed. ``--fast`` shrinks exp05 (64 clients of 4096 tokens)
and exp11-14, as the reference's does; ``--device`` is the device of the
exp09 and exp10 twins (the card unless ``cpu`` is named), which time their
``.device`` rows on the card only.

An id that is not in ``MODULES`` is an error that names the known ids
(the reference silently runs nothing). ``run_modules`` is the dispatch
(``chip_smoke.py`` calls it too): the twins' ``run`` functions differ in
their arguments and in what they return.
"""

from __future__ import annotations

import argparse
import importlib
import sys
import time

from repro_torch.experiments.common import emit

MODULES = [
    ("exp01", "repro_torch.experiments.exp01_coherence"),
    ("exp02", "repro_torch.experiments.exp02_latency"),
    ("exp03", "repro_torch.experiments.exp03_skew"),
    ("exp04", "repro_torch.experiments.exp04_background"),
    ("exp05", "repro_torch.experiments.exp05_e2e"),
    ("exp06", "repro_torch.experiments.exp06_rates"),
    ("exp07", "repro_torch.experiments.exp07_context"),
    ("exp08", "repro_torch.experiments.exp08_software"),
    ("exp09", "repro_torch.experiments.exp09_dense_transfer"),
    ("exp10", "repro_torch.experiments.exp10_sparse"),
    ("exp11", "repro_torch.experiments.exp11_rpc"),
    ("exp12", "repro_torch.experiments.exp12_control_plane"),
    ("exp13", "repro_torch.experiments.exp13_tiering"),
    ("exp14", "repro_torch.experiments.exp14_procengine"),
]
SMOKE = ("exp11", "exp12", "exp13", "exp14")
ROOFLINE_DIR = "results/dryrun_torch"


def select(only: str | None, smoke: bool = False) -> list[str]:
    """The ids to run, in ``MODULES`` order; an unknown id raises
    ``ValueError`` naming the known ones."""
    known = [i for i, _ in MODULES]
    if smoke:
        return list(SMOKE)
    if not only:
        return known
    want = [s for s in only.split(",") if s]
    unknown = [s for s in want if s not in known]
    if unknown:
        raise ValueError(f"unknown experiment id(s) {unknown}; known: {','.join(known)}")
    return [i for i in known if i in want]


def _call(exp_id: str, mod, fast: bool, device) -> tuple[list[tuple], dict | None]:
    """One twin's rows, and its results where its ``run`` returns them."""
    if exp_id == "exp05":
        return (mod.run(n=64, in_len=4096) if fast else mod.run()), None
    if exp_id in ("exp11", "exp12", "exp14"):
        return mod.run(fast=fast)
    if exp_id == "exp13":
        return mod.run(fast=fast), None
    if exp_id in ("exp09", "exp10"):
        return mod.run(device), None
    return mod.run(), None


def run_modules(ids: list[str], fast: bool = False, device=None
                ) -> tuple[list[tuple], list[tuple[str, str]], dict]:
    """Run the twins ``ids`` in turn: (every row, an ``expNN.FAILED`` row
    for each that raised; the failures as (id, repr); results by id, for
    the twins whose ``run`` returns them). Each twin's wall time goes to
    stderr."""
    names = dict(MODULES)
    rows: list[tuple] = []
    failures: list[tuple[str, str]] = []
    results: dict = {}
    for exp_id in ids:
        t0 = time.perf_counter()
        try:
            got, res = _call(exp_id, importlib.import_module(names[exp_id]), fast, device)
        except Exception as e:  # noqa: BLE001 - reported as the twin's FAILED row
            failures.append((exp_id, repr(e)))
            rows.append((f"{exp_id}.FAILED", "0", repr(e)))
            continue
        rows += got
        if res is not None:
            results[exp_id] = res
        print(f"# {exp_id} done in {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    return rows, failures, results


def roofline_rows(out_dir: str = ROOFLINE_DIR) -> list[tuple]:
    """One row a dry-run record (``launch/roofline.py``, MODELED), or
    ``roofline.SKIPPED`` when there is none or they cannot be read."""
    from repro_torch.launch.roofline import load_records, roofline_terms

    try:
        terms = [t for r in load_records(out_dir) if (t := roofline_terms(r))]
    except Exception as e:  # noqa: BLE001 - reported as the SKIPPED row
        return [("roofline.SKIPPED", "0", repr(e))]
    if not terms:
        return [("roofline.SKIPPED", "0", f"no dry-run records under {out_dir}")]
    rows = []
    for r in sorted(terms, key=lambda x: (x["mesh"], x["arch"], x["shape"])):
        bound = max(r["compute_s"], r["memory_s"], r["collective_s"])
        rows.append((f"roofline.{r['cell']}", f"{bound * 1e6:.0f}",
                     f"dominant={r['dominant']};frac={r['roofline_frac']:.3f};"
                     f"useful/counted={r['model_flops_ratio']:.2f}"))
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None, help="comma-separated exp ids")
    ap.add_argument("--fast", action="store_true", help="smaller exp05 and exp11-14")
    ap.add_argument("--smoke", action="store_true", help="exp11-14 only, at --fast size")
    ap.add_argument("--device", default=None, help="exp09 / exp10's device (default: cuda)")
    args = ap.parse_args(argv)
    try:
        ids = select(args.only, args.smoke)
    except ValueError as e:
        ap.error(str(e))
    fast = args.fast or args.smoke
    print("name,us_per_call,derived")
    rows, failures, _ = run_modules(ids, fast, args.device)
    emit(rows)
    emit(roofline_rows())
    if failures:
        print(f"# FAILURES: {failures}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
