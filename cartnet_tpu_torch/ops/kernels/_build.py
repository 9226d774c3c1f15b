"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled at first
use into ``cartnet_tpu_torch/_build/lib<name>.so``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>.so csrc/<name>.cu

The ptxas report (registers, shared memory, spills) is kept beside the
library as ``<name>.log``. A library newer than its source and than every
shared header ``csrc/*.cuh`` is reused.
Nothing is built while a module is imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin): the CUDA "
                       "kernels are built from csrc/ on the machine with "
                       "the card")


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """No library yet, or one older than its source or than any shared
    header (``csrc/*.cuh``, which several sources include)."""
    lib = lib_path(name)
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    deps = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return any(built < dep.stat().st_mtime for dep in deps)


def _command(name: str, out: Path):
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names: Iterable[str]) -> None:
    """Compile every stale library, one nvcc process per source, all
    started together; raises with nvcc's output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        procs.append((name, tmp, subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if stale."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = _LOADED[name] = ctypes.CDLL(str(lib_path(name)))
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
