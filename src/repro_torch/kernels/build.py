"""Build the CUDA kernels at first use and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o build/kernels/<name>-<hash>.so csrc/<name>.cu

into ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), with ``csrc/`` on the include path for the headers the
sources share (``hopper_common.cuh``). The file name carries a hash of the
source and of the headers it includes, so an edited source or header is
rebuilt; ``ptxas``'s report (registers, shared memory, spills)
is kept beside the library as ``<name>-<hash>.log``. ``build_all`` starts
one ``nvcc`` per source, all at once. A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-I", str(CSRC),
]

_LIBS: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def tool(name: str) -> str:
    """A CUDA toolkit program (nvcc, cuobjdump): on PATH or under $CUDA_HOME/bin."""
    found = shutil.which(name)
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", name)
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found (on PATH or under $CUDA_HOME/bin)")
    return path


def sass(name: str) -> str:
    """``cuobjdump -sass`` of the built library ``name``: the instructions
    the card runs (chip_smoke.py checks the flash library for HGMMA and
    UTMALDG there)."""
    out = subprocess.run([tool("cuobjdump"), "-sass", str(build_all([name])[name])],
                         capture_output=True, text=True, check=True, timeout=120)
    return out.stdout


def digest(src: str) -> str:
    """A hash of a source's text and of every ``csrc/`` header it includes."""
    h = hashlib.sha1(src.encode())
    for header in re.findall(r'^#include "([\w.]+)"', src, re.M):
        h.update((CSRC / header).read_bytes())
    return h.hexdigest()[:12]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{digest((CSRC / f'{name}.cu').read_text())}.so"


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Compile every named source whose library is missing, in parallel."""
    names = sources() if names is None else names
    out = {n: lib_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = tool("nvcc")
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(f".tmp{os.getpid()}.so")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        out[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's SMs, which size the kernels' grids."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def build_log(name: str) -> str:
    return lib_path(name).with_suffix(".log").read_text()


def patched_source(name: str, edits) -> str:
    """``csrc/<name>.cu`` with ``edits`` applied: each ``(old, new, count)``
    replaces ``old``, which must occur exactly ``count`` times, by ``new``.
    The probes in ``repro_torch.experiments`` build such copies to cut one
    part out of a kernel and time what is left."""
    src = (CSRC / f"{name}.cu").read_text()
    for old, new, count in edits:
        if src.count(old) != count:
            raise RuntimeError(f"{name}.cu no longer holds {old!r} {count}x")
        src = src.replace(old, new)
    return src


def load_variant(name: str, tag: str, edits, signatures) -> ctypes.CDLL:
    """``patched_source(name, edits)`` built into build/kernels/ as
    ``<name>_<tag>-<hash>.so`` and loaded with ``signatures``."""
    src = patched_source(name, edits)
    cu = BUILD_DIR / f"{name}_{tag}-{digest(src)}.cu"
    so = cu.with_suffix(".so")
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu.write_text(src)
        subprocess.run([tool("nvcc"), *NVCC_FLAGS, "-o", str(so), str(cu)],
                       check=True, capture_output=True, timeout=600)
    return _bind(ctypes.CDLL(str(so)), signatures)


def _bind(lib: ctypes.CDLL, signatures) -> ctypes.CDLL:
    for fn, (argtypes, restype) in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def load(name: str, signatures: dict[str, tuple[list, object]]) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed; ``signatures``
    maps each C function to its (argtypes, restype)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _bind(ctypes.CDLL(str(build_all([name])[name])), signatures)
        _LIBS[name] = lib
    return lib
