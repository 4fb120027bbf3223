"""The port stands alone: no JAX, nothing of ``repro``, no CPU pretence.

* importing every module of ``repro_torch`` in a fresh interpreter leaves
  jax, jaxlib, ml_dtypes, triton and repro out of ``sys.modules``;
* no file of ``src/repro_torch`` or ``chip_smoke.py`` imports them at all;
* no class of the port shares its name with a class of ``repro`` (the
  linter resolves classes by bare name, so a twin named ``BelugaPool`` or
  ``GlobalIndex`` would hide the reference's lock graph);
* ``chip_smoke.py`` on a host without a GPU, and alone in a directory,
  exits non-zero and never prints its ``"ok": true`` line.
"""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "ml_dtypes", "triton", "repro"}


def _sources() -> list[Path]:
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["OMP_NUM_THREADS"] = "1"  # keep the subprocess off the other test workers' cores
    return env


def test_import_pulls_in_no_jax_repro_or_triton():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"print(sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_source_imports_jax_or_repro():
    bad = []
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_no_class_name_shared_with_repro_core():
    def class_names(root: Path) -> set[str]:
        return {
            node.name
            for p in root.rglob("*.py")
            for node in ast.walk(ast.parse(p.read_text()))
            if isinstance(node, ast.ClassDef)
        }

    assert not class_names(PORT) & class_names(REPO / "src" / "repro" / "core")


def _run_smoke(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "chip_smoke.py"], env=_env(), cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    for cwd in (REPO, tmp_path):
        if cwd == tmp_path:  # nothing of the repo beside the script
            shutil.copy(REPO / "chip_smoke.py", tmp_path)
        out = _run_smoke(cwd)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
