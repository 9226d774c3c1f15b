"""Host-side C++ (the PBC radius graph), built with g++ at first use.

``radius_graph.cpp`` has a plain C interface and is compiled into
``cartnet_tpu_torch/_build/libradius_graph.so``:

    g++ -O3 -march=native -shared -fPIC -std=c++17 -o _build/libradius_graph.so
        native/radius_graph.cpp

and loaded with ctypes (no Python headers; ctypes releases the GIL during
the call). A library newer than its source is reused. ``get_native()`` is
the loaded library or None, with one logged warning, when it cannot be
built; ``load()`` raises instead. Nothing is built while a module is
imported.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "radius_graph.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
LIB = BUILD_DIR / "libradius_graph.so"

_LIB: Optional[ctypes.CDLL] = None
_FAILED: Optional[str] = None


def build(force: bool = False) -> Path:
    """Compile the library if it is missing or older than its source;
    raises with g++'s output if the compile fails."""
    if not force and LIB.exists() and \
            LIB.stat().st_mtime >= SOURCE.stat().st_mtime:
        return LIB
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libradius_graph.so.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-o", str(tmp), str(SOURCE)]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as err:
        raise RuntimeError(f"g++ not found: {err}") from err
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{out.stderr}")
    os.replace(tmp, LIB)
    return LIB


def load() -> ctypes.CDLL:
    """The loaded library, built first if stale; raises if it cannot be."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.rg_build.restype = ctypes.c_void_p
        lib.rg_build.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_double,
                                 ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_int64)]
        lib.rg_fetch.restype = None
        lib.rg_fetch.argtypes = [ctypes.c_void_p] * 5
        lib.rg_free.restype = None
        lib.rg_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


def get_native() -> Optional[ctypes.CDLL]:
    """The library, or None (one warning a process) if it cannot be built
    or loaded."""
    global _FAILED
    if _FAILED is not None:
        return None
    try:
        return load()
    except (RuntimeError, OSError) as err:
        _FAILED = str(err)
        logging.warning("native radius graph unavailable (%s); using numpy",
                        err)
        return None


def radius_graph_pbc(lib: ctypes.CDLL, pos: np.ndarray, cell: np.ndarray,
                     radius: float, max_neighbors: int = -1
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
    """One crystal's edges through ``lib`` -> (src i32 [e], dst i32 [e],
    dist f32 [e], dir f32 [e, 3])."""
    pos = np.ascontiguousarray(pos, np.float64).reshape(-1, 3)
    cell = np.ascontiguousarray(cell, np.float64).reshape(3, 3)
    n_edges = ctypes.c_int64(0)
    graph = lib.rg_build(pos.ctypes.data, len(pos), cell.ctypes.data,
                         float(radius), int(max_neighbors),
                         ctypes.byref(n_edges))
    if not graph:
        raise MemoryError("rg_build could not allocate the edge list")
    e = n_edges.value
    try:
        src = np.empty(e, np.int32)
        dst = np.empty(e, np.int32)
        dist = np.empty(e, np.float32)
        cart_dir = np.empty((e, 3), np.float32)
    except MemoryError:
        lib.rg_free(graph)
        raise
    lib.rg_fetch(graph, src.ctypes.data, dst.ctypes.data, dist.ctypes.data,
                 cart_dir.ctypes.data)
    return src, dst, dist, cart_dir
