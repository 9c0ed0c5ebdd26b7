"""Cold-start compile plane: where builds go, and a verified store of them.

The port of ``sudoku_solver_distributed_tpu/compilecache/``. One
operator-chosen directory (CLI ``--compile-cache-dir`` /
``SUDOKU_COMPILE_CACHE_DIR``) holds the process's builds:

  * ``<dir>/kernels`` — the kernel library (csrc/dfs_solver.cu), in a
    ``KernelStore``: keyed by the source's hash and ``nvcc`` flags, named
    by the backend fingerprint, checked against its recorded sha256 on
    load, so a second process loads it without running ``nvcc``;
  * ``<dir>/native`` — the native oracle (native/oracle.cc), in the same
    kind of store.

A stored library is never trusted blindly: the engine verifies every warm
width by a round-trip solve before it serves, and a library that fails is
invalidated, rebuilt once and verified again, every warm width with it (a
second failure raises, and the library launches no more).
Without a cache dir, builds go to the package's gitignored build
directories through the same store.
"""

from .store import (
    KernelStore,
    backend_fingerprint,
    enable_persistent_cache,
    fixed_cache_root,
    nvcc_path,
    persistent_cache_dir,
    program_key,
)

__all__ = [
    "KernelStore",
    "backend_fingerprint",
    "enable_persistent_cache",
    "fixed_cache_root",
    "nvcc_path",
    "persistent_cache_dir",
    "program_key",
]
