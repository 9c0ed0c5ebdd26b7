"""Native (C++) host oracle, loaded via ctypes.

The port's copy of ``sudoku_solver_distributed_tpu/native/``: the oracle
solver / solution counter that certifies unique-solution puzzles during
puzzle generation (models/generator.py), in C++ for speed. ``oracle.cc``
is a copy of the JAX package's source and gives the same results as the
pure-Python oracle (models/oracle.py), to which everything here gives way
when no C++ compiler exists.

Build model: ``oracle.cc`` is compiled on first use with the C++ compiler
on PATH (g++/clang++/c++) through a ``compilecache.KernelStore``: under
``<dir>/native`` when the process has a compile cache
(``compilecache.enable_persistent_cache``, the CLI's
``--compile-cache-dir``), else under ``native/_build/`` beside this file
(gitignored). The key is the source's hash; the artifact is named by the
host's fingerprint (compiler, its version, machine), and a stored library
whose bytes no longer match its record is rebuilt. A build or a load that
fails raises: only a missing compiler turns the native oracle off. No
pybind11 / setuptools involvement — the ABI is five plain C functions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from ..compilecache import KernelStore, fixed_cache_root

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "oracle.cc"
_FLAGS = ("-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_checked = False


def _compiler() -> Optional[str]:
    for cc in ("g++", "clang++", "c++"):
        path = shutil.which(cc)
        if path:
            return path
    return None


@functools.cache
def native_store() -> KernelStore:
    """The process's native-oracle store, fixed at its first use:
    ``<root>/native`` under the compile cache root, else ``_build/`` beside
    this file."""
    root = fixed_cache_root()
    return KernelStore(_HERE / "_build" if root is None else Path(root) / "native")


def _fingerprint(cc: str) -> str:
    version = subprocess.run(
        [cc, "--version"], capture_output=True, text=True, timeout=60
    ).stdout.splitlines()
    return (
        f"cc={cc};version={version[0] if version else 'unknown'};"
        f"machine={platform.machine()};format=1"
    )


def _build() -> Optional[ctypes.CDLL]:
    cc = _compiler()
    if cc is None:
        return None

    def compile(out: Path) -> str:
        cmd = [cc, *_FLAGS, "-o", str(out), str(_SRC)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(
                f"native oracle build failed ({proc.returncode}):\n"
                + proc.stderr[-4000:]
            )
        return " ".join(cmd) + "\n" + proc.stdout + proc.stderr

    key = f"liboracle-{hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]}"
    path, _ = native_store().get(
        key, _fingerprint(cc), compile,
        meta={"source": _SRC.name, "flags": " ".join(_FLAGS)},
    )
    lib = ctypes.CDLL(str(path))
    lib.ss_solve.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
    ]
    lib.ss_solve.restype = ctypes.c_int
    lib.ss_count.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
        ctypes.c_longlong,
    ]
    lib.ss_count.restype = ctypes.c_longlong
    lib.ss_count_budget.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
        ctypes.c_longlong,
        ctypes.c_longlong,
    ]
    lib.ss_count_budget.restype = ctypes.c_longlong
    lib.ss_solve_seeded.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
        ctypes.c_uint64,
        ctypes.c_longlong,
        ctypes.c_int,
    ]
    lib.ss_solve_seeded.restype = ctypes.c_int
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_checked
    if _lib is not None or _lib_checked:
        return _lib
    with _lock:
        if _lib is None and not _lib_checked:
            _lib = _build()
            _lib_checked = True
    return _lib


def available() -> bool:
    """True iff the native library is (or can be) loaded; False only when
    no C++ compiler exists."""
    return _get_lib() is not None


def _as_c_board(board: Sequence[Sequence[int]]) -> tuple:
    arr = np.ascontiguousarray(board, dtype=np.int32)
    if arr.ndim != 2 or arr.shape[0] != arr.shape[1]:
        raise ValueError("board must be square")
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _need_lib() -> ctypes.CDLL:
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native oracle unavailable")
    return lib


def native_solve(board: Sequence[Sequence[int]]) -> Optional[List[List[int]]]:
    """Solved copy of ``board`` or None if unsatisfiable.

    Bit-for-bit the same result as models.oracle.oracle_solve (same MRV
    tie-breaking, same candidate order); raises RuntimeError if the native
    library is unavailable — callers decide their own fallback.
    """
    lib = _need_lib()
    arr, ptr = _as_c_board(board)
    size = arr.shape[0]
    out = np.zeros_like(arr)
    rc = lib.ss_solve(ptr, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), size)
    if rc < 0:
        raise ValueError(f"bad board geometry: {size}×{size}")
    return out.tolist() if rc == 1 else None


def native_count_solutions(board: Sequence[Sequence[int]], limit: int = 2) -> int:
    """Number of solutions of ``board``, saturated at ``limit``."""
    lib = _need_lib()
    arr, ptr = _as_c_board(board)
    rc = lib.ss_count(ptr, arr.shape[0], limit)
    if rc < 0:
        raise ValueError(f"bad board geometry: {arr.shape[0]}×{arr.shape[0]}")
    return int(rc)


def native_count_solutions_budget(
    board: Sequence[Sequence[int]], limit: int = 2, max_nodes: int = 0
) -> Optional[int]:
    """As ``native_count_solutions`` but bounded to ``max_nodes`` search
    nodes (0 = unbounded). Returns None when the budget ran out before the
    count settled — "unknown", which certification callers must treat
    conservatively."""
    lib = _need_lib()
    arr, ptr = _as_c_board(board)
    rc = lib.ss_count_budget(ptr, arr.shape[0], limit, max_nodes)
    if rc == -2:
        return None
    if rc < 0:
        raise ValueError(f"bad board geometry: {arr.shape[0]}×{arr.shape[0]}")
    return int(rc)


def native_solve_seeded(
    board: Sequence[Sequence[int]],
    seed: int,
    *,
    max_nodes: int = 200_000,
    restarts: int = 32,
) -> Optional[List[List[int]]]:
    """Randomized-restart solve (Las Vegas): candidate values in a
    seeded-shuffled order, restarting on node-budget exhaustion.

    Deterministic in ``seed``. For generation-style inputs that are known
    satisfiable. Returns None if unsatisfiable; raises RuntimeError if
    every restart exhausted its budget."""
    lib = _need_lib()
    arr, ptr = _as_c_board(board)
    size = arr.shape[0]
    out = np.zeros_like(arr)
    rc = lib.ss_solve_seeded(
        ptr,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        size,
        seed & (2**64 - 1),
        max_nodes,
        restarts,
    )
    if rc == -1:
        raise ValueError(f"bad board geometry: {size}×{size}")
    if rc == -2:
        raise RuntimeError("seeded solve: all restarts exhausted their budget")
    return out.tolist() if rc == 1 else None


__all__ = [
    "available",
    "native_solve",
    "native_count_solutions",
    "native_count_solutions_budget",
    "native_solve_seeded",
]
