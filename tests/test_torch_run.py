"""The runner twin (``repro_torch/experiments/run.py``) against
``benchmarks/run.py``:

* with every experiment module stubbed on both sides, ``--only``,
  ``--fast`` and ``--smoke`` call the same twins in the same order with
  the same sizes (exp05's clients and prompt length, exp11-14's ``fast``),
  and print the same CSV rows; exp09 / exp10 get the runner's device;
* an id outside ``MODULES`` is refused with the known ids named (the
  reference runs nothing and exits 0: a difference by design);
* a twin that raises gives the reference's ``expNN.FAILED`` row and exit
  status 1, the others still run;
* the roofline summary reads ``results/dryrun_torch`` (a record there gives
  its ``roofline.<cell>`` row, none gives ``roofline.SKIPPED``);
* one real run of ``--only exp01,exp02,exp12 --fast`` in a subprocess.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import types

import pytest

import benchmarks.run as jrun
from repro_torch.experiments import run
from repro_torch.launch.roofline import roofline_terms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RETURNS_RESULTS = {"exp11", "exp12", "exp14"}  # the port's twins that return (rows, results)


def _stub(monkeypatch, side: str, log: list, raising=()) -> None:
    """Replace each experiment module of ``side`` by a stub whose ``run``
    logs its arguments and returns one row (or raises)."""
    table = run if side == "port" else jrun
    mods = []
    for exp_id, _ in table.MODULES:
        name = f"_stub_{side}_{exp_id}"

        def fn(*args, _id=exp_id, **kwargs):
            log.append((_id, args, kwargs))
            if _id in raising:
                raise RuntimeError(f"{_id} broke")
            rows = [(f"{_id}.row", "1.5", "k=v")]
            return (rows, {"id": _id}) if side == "port" and _id in RETURNS_RESULTS else rows

        monkeypatch.setitem(sys.modules, name, types.SimpleNamespace(run=fn))
        mods.append((exp_id, name))
    monkeypatch.setattr(table, "MODULES", mods)


def _jax_main(monkeypatch, argv) -> int:
    monkeypatch.setattr(sys, "argv", ["benchmarks.run", *argv])
    try:
        jrun.main()
    except SystemExit as e:
        return e.code
    return 0


def _csv(out: str) -> list[str]:
    return [ln for ln in out.splitlines() if ln and not ln.startswith("roofline.")]


ARGVS = [[], ["--fast"], ["--only", "exp05,exp12"], ["--only", "exp12,exp05", "--fast"],
         ["--smoke"], ["--only", "exp09,exp10,exp01"]]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "all")
def test_selection_and_sizes_equal_the_reference(monkeypatch, tmp_path, capsys, argv):
    monkeypatch.chdir(tmp_path)
    jlog, plog = [], []
    _stub(monkeypatch, "jax", jlog)
    _stub(monkeypatch, "port", plog)
    assert _jax_main(monkeypatch, argv) == 0
    jout = capsys.readouterr().out
    assert run.main(argv + ["--device", "cpu"]) == 0
    pout = capsys.readouterr().out
    assert [e[0] for e in plog] == [e[0] for e in jlog] and plog
    for (pid, pargs, pkw), (_, jargs, jkw) in zip(plog, jlog):
        if pid in ("exp09", "exp10"):
            assert (pargs, pkw) == (("cpu",), {})  # the port's twins take a device
        else:
            assert (pargs, pkw) == (jargs, jkw)
    assert _csv(pout) == _csv(jout)
    assert "roofline.SKIPPED,0," in pout  # no dry-run records here


def test_smoke_is_exp11_to_14_at_fast_size(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    log = []
    _stub(monkeypatch, "port", log)
    assert run.select(None, smoke=True) == ["exp11", "exp12", "exp13", "exp14"]
    assert run.main(["--smoke"]) == 0
    assert log == [(i, (), {"fast": True}) for i in ("exp11", "exp12", "exp13", "exp14")]


def test_an_unknown_id_is_refused(monkeypatch, tmp_path, capsys):
    monkeypatch.chdir(tmp_path)
    log = []
    _stub(monkeypatch, "port", log)
    with pytest.raises(ValueError, match="exp01,exp02.*exp14"):
        run.select("exp01,exp99")
    with pytest.raises(SystemExit) as e:
        run.main(["--only", "exp12,exp99"])
    assert e.value.code != 0 and log == []
    assert "exp99" in capsys.readouterr().err


def test_a_raising_twin_gives_a_failed_row_and_exit_1(monkeypatch, tmp_path, capsys):
    monkeypatch.chdir(tmp_path)
    jlog, plog = [], []
    _stub(monkeypatch, "jax", jlog, raising={"exp03"})
    _stub(monkeypatch, "port", plog, raising={"exp03"})
    argv = ["--only", "exp02,exp03,exp04"]
    assert _jax_main(monkeypatch, argv) == 1
    jout = capsys.readouterr().out
    assert run.main(argv) == 1
    pout = capsys.readouterr().out
    assert "exp03.FAILED,0,RuntimeError('exp03 broke')" in _csv(pout)
    assert _csv(pout) == _csv(jout)
    rows, failures, results = run.run_modules(["exp03", "exp12"])
    assert failures == [("exp03", "RuntimeError('exp03 broke')")]
    assert rows == [("exp03.FAILED", "0", "RuntimeError('exp03 broke')"),
                    ("exp12.row", "1.5", "k=v")]
    assert results == {"exp12": {"id": "exp12"}}


def test_roofline_summary_reads_results_dryrun_torch(monkeypatch, tmp_path, capsys):
    monkeypatch.chdir(tmp_path)
    rec = {"cell": "olmo-1b.train_4k.pod16x16", "arch": "olmo-1b", "shape": "train_4k",
           "mesh": "pod16x16", "status": "ok", "n_chips": 256, "model_flops_total": 4.0e18,
           "op_analysis": {"flops": 2.0e16, "bytes_accessed": 3.0e12,
                           "collective_bytes": 5.0e10}}
    os.makedirs("results/dryrun_torch")
    with open("results/dryrun_torch/olmo.json", "w") as f:
        json.dump(rec, f)
    with open("results/dryrun_torch/skipped.json", "w") as f:
        json.dump({**rec, "cell": "x", "status": "skipped"}, f)
    t = roofline_terms(rec)
    bound = max(t["compute_s"], t["memory_s"], t["collective_s"])
    want = (f"roofline.{rec['cell']}", f"{bound * 1e6:.0f}",
            f"dominant={t['dominant']};frac={t['roofline_frac']:.3f};"
            f"useful/counted={t['model_flops_ratio']:.2f}")
    assert run.roofline_rows() == [want]
    _stub(monkeypatch, "port", [])
    assert run.main(["--only", "exp01"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == ",".join(want)
    assert run.roofline_rows(str(tmp_path / "none"))[0][0] == "roofline.SKIPPED"


def test_real_run_of_exp01_exp02_exp12_fast(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.experiments.run", "--only", "exp01,exp02,exp12",
         "--fast"], capture_output=True, text=True, env=env, cwd=tmp_path, timeout=240)
    assert proc.returncode == 0, (proc.stdout[-1500:], proc.stderr[-3000:])
    lines = proc.stdout.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    names = [ln.split(",")[0] for ln in lines[1:]]
    assert [n for n in names if n.startswith("exp12.")] == [
        "exp12.alloc_release", "exp12.match_prefix", "exp12.scatter_read", "exp12.engine_loop"]
    assert any(n.startswith("exp01.") for n in names) and any(
        n.startswith("exp02.") for n in names)
    assert not any(n.endswith(".FAILED") for n in names)
    assert names[-1] == "roofline.SKIPPED"
    assert os.listdir(tmp_path) == []  # nothing written: no BENCH_*.json
