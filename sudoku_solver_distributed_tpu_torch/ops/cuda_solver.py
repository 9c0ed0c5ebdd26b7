"""The DFS solver kernel for NVIDIA Hopper: build, wrapper, staging glue.

The port of ``sudoku_solver_distributed_tpu/ops/pallas_solver.py``. The
kernel (csrc/dfs_solver.cu, CUDA C++ for ``sm_90a``) runs a board's whole
DFS in one warp, the board's cells and units spread across the lanes;
``dfs_solver`` is its wrapper and ``solve_batch_cuda`` the staged-depth
glue around it, with the semantics of ``solve_batch_pallas`` and its
``_retry_overflow_deep``. Beyond the Pallas kernel it runs the JAX xla
solver's sweep knobs (``locked_candidates``, ``naked_pairs``, ``waves``,
``light_waves``), so the serving configuration runs on the card.

Differences from the Pallas path, all by design:

* The guess stack lives in a device-memory scratch slab the wrapper
  allocates, not in on-chip memory, so there is no on-chip stack budget:
  every depth stage runs the kernel (the Pallas path handed over-budget
  stages to the XLA solver).
* ``iters`` is the largest per-board step count (boards no longer step
  together) and ``idle_lane_steps`` is 0; ``lane_steps`` sums the boards'
  own steps. Per-board grid, status, guesses and validations are those of
  the lockstep solvers. ``iters`` stays on the device as a 0-dim tensor,
  so a solve syncs only for the OVERFLOW check between depth stages and
  for whatever the caller copies back.

The kernel is built from csrc/ at first use with ``nvcc`` and loaded with
ctypes (a plain C interface, so the build takes seconds, not
PyTorch-header minutes). The build goes through the process's kernel store
(compilecache/): ``<dir>/kernels`` under ``--compile-cache-dir``, else
``_build/`` beside this package; a build stored for this backend's
fingerprint is loaded without running ``nvcc``.

``dfs_solver`` runs the plain PyTorch version (ops/solver.py) for a CPU
tensor, and only then; for a CUDA tensor it launches the kernel or raises.
``dfs_solver.launches`` counts kernel launches (under a lock: the HTTP
server's handler threads launch concurrently).

``dfs_segment`` is the same for one segment of continuous batching over a
``SegmentPool``: the segment kernel and its digest kernel (K3, K3b) on a
CUDA pool, ``inject_lanes_src`` + ``run_segment`` + ``segment_digest`` of
ops/solver.py on a CPU one; ``dfs_segment.launches`` counts its launches.
The pool's state tensors are updated in place, which takes the place of
the JAX program's buffer donation: each call consumes the handle it was
given and returns the pool's next one.

A library that fails the engine's round-trip verification is rebuilt
under ``library_quarantine``: every wrapper checks the launch gate first,
so while the rebuild runs, and for good once the rebuilt library fails
too, a launch raises ``LibraryVerificationError`` instead of running.

``dfs_race`` is the frontier race of one board's seeded subtree states on
one device: the race kernel (K4, one launch: a thread block a state, and
the last block to finish folds) on a CUDA tensor, the plain lockstep race
``ops/solver.race`` on a CPU one; ``dfs_race.launches`` counts its
launches. The JAX package races in lockstep with a per-step collective
(parallel/frontier.py ``race``); the kernel's blocks run out of step, stop
once they have run more steps than the earliest solve any of them has
posted, and the fold rebuilds the lockstep result exactly. The wrapper
owns the race's three-word scratch, one per (device, stream)
(``race_scratch``), and allocates the guess-stack slab only for a board
size whose stack the library does not keep on chip
(``race_stack_in_slab``).

A race across the shards of a mesh is ``dfs_race_shards``: K4's shard
form from one library call (one launch of every shard's blocks when they
share a card, else a launch a shard), over the race's stop words
(``race_slots``, laid out by ``race_layout`` from the shards' devices: one
card, cards with peer access, or cards without). On one card and across
peers the last block across every shard folds, so the race is that one
call; otherwise (and for records gathered from other hosts) ``race_fold``
(the fold kernel) folds the records. ``dfs_race_shards.launches`` and
``race_fold.launches`` count their own launches.

``seed_frontier_cuda`` is a race's seeding BFS (the JAX package's
host-driven ``_seed_rounds`` over its jitted ``analyze`` and assign
programs): the seeding kernel (K5, one launch of one thread-block cluster
whose blocks' parts sweep a state at a time, the rounds and their
decisions on the card) on a CUDA tensor, the port's plain host rounds (``ops.solver.seed_rounds``)
on a CPU one; ``seed_frontier_cuda.launches`` counts its launches. The
wrapper reads the kernel's small header, with the solution row after it
when a state solved, in one explicit ``.cpu()``; its scratch lives per
(device, stream, box, capacity) (``seed_scratch``). A card that cannot
hold the kernel's cluster (``lib.seed_clusters``, queried at library
load) raises ``KernelLaunchError`` before any launch.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .solver import (
    RACE_META_COLS,
    RACE_ROW_EXTRA,
    RUNNING,
    SEGMENT_DIGEST_COLS,
    SegmentState,
    SolveResult,
    LoopStats,
    SOLVED,
    init_segment_state,
    fold_race,
    inject_lanes_src,
    race,
    race_runs,
    run_segment,
    seed_rounds,
    segment_digest,
    solve_flat,
    solve_staged,
    staged_depths,
    sweep_knobs,
)
from ..compilecache import (
    KernelStore,
    backend_fingerprint,
    fixed_cache_root,
    nvcc_path,
)
from .spec import BoardSpec

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "dfs_solver.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
META_COLS = 4  # status, guesses, validations, steps
# the launch's option bits (csrc/dfs_solver.cu kOpt*)
OPT_LOCKED, OPT_PAIRS, OPT_LIGHT = 1, 2, 4
_LAUNCHES_LOCK = threading.Lock()


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error: a fault of the device call,
    which a supervised engine answers from its host fallback. A library
    that fails to build or load raises a plain ``RuntimeError``."""


def _nvcc() -> str:
    found = nvcc_path()
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "DFS kernel is built from csrc/ on a machine with the CUDA toolkit"
    )


def library_key() -> str:
    """The kernel library's store key: its source's hash and the ``nvcc``
    flags (the backend fingerprint names the artifact within the key). The
    solver configuration is not part of it: the knobs are the launch's
    arguments, not compile-time constants."""
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return f"libdfs_solver-{digest.hexdigest()[:12]}"


@functools.cache
def kernel_store() -> KernelStore:
    """The process's kernel store, fixed at its first use: ``<root>/kernels``
    under the cache root of ``compilecache.enable_persistent_cache``, else
    ``_build/`` beside this package. Fixing it fixes the process's cache
    root: a later ``enable_persistent_cache`` is refused."""
    root = fixed_cache_root()
    return KernelStore(BUILD_DIR if root is None else Path(root) / "kernels")


def _nvcc_compile(out: Path) -> str:
    """Compile csrc/dfs_solver.cu into ``out``; returns the command and the
    compiler's report (``ptxas -v``: registers and spills per kernel)."""
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {SOURCE.name}:\n"
            + proc.stderr[-4000:]
        )
    return " ".join(cmd) + "\n" + proc.stdout + proc.stderr


def build(store: Optional[KernelStore] = None, compile=_nvcc_compile) -> tuple:
    """The kernel library through ``store`` (default: ``kernel_store()``):
    the stored build for this backend's fingerprint, loaded without running
    ``nvcc``, or a new build by ``compile(out)`` saved back to the store.
    Returns ``(path, source)``, ``source`` ``"aot"`` or ``"compile+save"``.
    A store directory that cannot be written raises a ``RuntimeError`` that
    names ``--compile-cache-dir``."""
    store = kernel_store() if store is None else store
    return store.get(
        library_key(), backend_fingerprint(), compile,
        meta={"source": SOURCE.name, "flags": " ".join(NVCC_FLAGS)},
    )


def build_log() -> Optional[str]:
    """The compiler's report of the process's kernel library, kept in its
    store record (``ptxas -v``: registers and spills per kernel)."""
    return kernel_store().log(library_key(), backend_fingerprint())


# the process's library: where it came from ("aot", the store, or
# "compile+save", built by this process; set by ``load_library``), the
# paths it was opened from, and the launch gate (``library_quarantine``):
# while ``error`` is set, every wrapper raises it in any thread but
# ``owner``'s
_LIBRARY = {"source": None, "opened": set()}
_GATE = {"error": None, "owner": None}
_GATE_LOCK = threading.Lock()


class LibraryVerificationError(RuntimeError):
    """The kernel library failed its round-trip verification twice: once
    as loaded and once after a rebuild. Every launch after that raises it
    (``library_quarantine``); nothing falls back to the plain version."""


def _dlopen(path: Path) -> ctypes.CDLL:
    """``ctypes.CDLL`` of ``path`` as a new image. The dynamic loader
    hands back an object it already holds for the same path name, so a
    rebuild whose bytes (hence its content-hashed name) equal the failed
    library's would run the failed image again: a path this process opened
    before is opened through a private copy, unlinked once mapped."""
    if path not in _LIBRARY["opened"]:
        _LIBRARY["opened"].add(path)
        return ctypes.CDLL(str(path))
    fd, name = tempfile.mkstemp(dir=path.parent, prefix=f".{path.stem}.",
                                suffix=".so")
    os.close(fd)
    try:
        shutil.copyfile(path, name)
        return ctypes.CDLL(name)
    finally:
        os.unlink(name)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process,
    through the process's kernel store (``build``)."""
    path, source = build()
    lib = _dlopen(path)
    lib.dfs_solver_launch.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.dfs_solver_launch.restype = ctypes.c_int
    lib.dfs_solver_meta_cols.restype = ctypes.c_int
    if lib.dfs_solver_meta_cols() != META_COLS:
        raise RuntimeError("dfs_solver library disagrees on the meta layout")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dfs_segment_launch.argtypes = [p, i] + [p] * 13 + [i] * 7 + [p]
    lib.dfs_segment_launch.restype = i
    lib.dfs_segment_digest_cols.restype = i
    if lib.dfs_segment_digest_cols() != SEGMENT_DIGEST_COLS:
        raise RuntimeError("dfs_solver library disagrees on the digest layout")
    lib.dfs_segment_warps_per_sm.argtypes = [i]
    lib.dfs_segment_warps_per_sm.restype = i
    lib.dfs_race_launch.argtypes = [p] * 9 + [i] * 6 + [p]
    lib.dfs_race_launch.restype = i
    lib.dfs_race_meta_cols.restype = i
    lib.dfs_race_row_extra.restype = i
    for fn in ("dfs_race_threads", "dfs_race_stack_on_chip", "dfs_race_states_per_sm"):
        getattr(lib, fn).argtypes = [i]
        getattr(lib, fn).restype = i
    if (lib.dfs_race_meta_cols(), lib.dfs_race_row_extra()) != (
        RACE_META_COLS, RACE_ROW_EXTRA
    ):
        raise RuntimeError("dfs_solver library disagrees on the race layout")
    lib.dfs_race_slots_alloc.argtypes = [i] + [ctypes.POINTER(ctypes.c_void_p)] * 2
    lib.dfs_race_slots_alloc.restype = i
    lib.dfs_race_max_shards.restype = i
    lib.dfs_race_peer_enable.argtypes = [i, p]
    lib.dfs_race_peer_enable.restype = i
    lib.dfs_race_shards_launch.argtypes = [i] + [p] * 11 + [i] + [p] * 2 + [i] * 6 + \
        [p, p, i]
    lib.dfs_race_shards_launch.restype = i
    lib.dfs_race_relay_serve.argtypes = [i, i, p, i, i, p, ctypes.c_uint, ctypes.c_uint,
                                         ctypes.POINTER(ctypes.c_uint),
                                         ctypes.POINTER(ctypes.c_ulonglong), p,
                                         ctypes.POINTER(i), ctypes.POINTER(i),
                                         ctypes.POINTER(i), p, ctypes.POINTER(i), i]
    lib.dfs_race_relay_serve.restype = i
    lib.dfs_race_fold_launch.argtypes = [p] * 5 + [i] * 4 + [p]
    lib.dfs_race_fold_launch.restype = i
    lib.seed_frontier_launch.argtypes = [p] * 5 + [i] * 6 + [p]
    lib.seed_frontier_launch.restype = i
    for fn in ("seed_frontier_cluster", "seed_frontier_clusters"):
        getattr(lib, fn).argtypes = [i]
        getattr(lib, fn).restype = i
    # the seeding kernel's clusters the current card holds at once, a box
    # edge each (a negative number is a cudaError): a seeding checks its own
    lib.seed_clusters = {box: lib.seed_frontier_clusters(box) for box in SEED_BOXES}
    _LIBRARY["source"] = source
    return lib


def library_source() -> Optional[str]:
    """Where the process's kernel library came from: ``"aot"`` (loaded from
    the store), ``"compile+save"`` (built and saved by this process), or
    None before it was loaded."""
    return _LIBRARY["source"]


def rebuild_library() -> ctypes.CDLL:
    """Replace the process's kernel library after it failed a verification
    solve: its stored artifact is invalidated (deleted, an error in the
    store's counters), the library is built anew and saved, and the new
    build is loaded as the process's library, as a new image even where
    its bytes equal the old build's (``_dlopen``)."""
    kernel_store().invalidate(library_key(), backend_fingerprint())
    load_library.cache_clear()
    return load_library()


def library_error() -> Optional[LibraryVerificationError]:
    """The error every launch raises, or None: the library is being
    rebuilt after a failed verification, or failed it twice."""
    return _GATE["error"]


def _check_library() -> None:
    with _GATE_LOCK:
        error, owner = _GATE["error"], _GATE["owner"]
    if error is not None and owner != threading.get_ident():
        raise error


@contextlib.contextmanager
def library_quarantine(what: str):
    """Hold every launch of the process's library while the calling thread
    rebuilds and verifies it again: the wrappers raise
    ``LibraryVerificationError`` in every other thread (those requests
    fail; none is answered by a library that solved wrong). A clean exit
    lifts the gate. An exception, the second failed verification or a
    rebuild that fails, leaves it shut for good, for every thread, and
    leaves as a ``LibraryVerificationError``."""
    error = LibraryVerificationError(
        f"the kernel library failed its round-trip verification ({what}) "
        f"and is being rebuilt"
    )
    with _GATE_LOCK:
        _GATE.update(error=error, owner=threading.get_ident())
    try:
        yield
    except BaseException as exc:
        failed = exc if isinstance(exc, LibraryVerificationError) else (
            LibraryVerificationError(
                f"the kernel library failed its round-trip verification "
                f"({what}) and its rebuild failed: {exc}"
            )
        )
        with _GATE_LOCK:
            _GATE.update(error=failed, owner=None)
        if failed is exc:
            raise
        raise failed from exc
    with _GATE_LOCK:
        _GATE.update(error=None, owner=None)


def segment_warps_per_sm(size: int) -> int:
    """Warps of the segment kernel for ``size``×``size`` boards that one SM
    of the current CUDA device holds at once (its occupancy)."""
    warps = load_library().dfs_segment_warps_per_sm(round(size ** 0.5))
    if warps < 0:
        raise RuntimeError(f"no segment kernel occupancy for size {size}")
    return warps


def race_states_per_sm(size: int) -> int:
    """Race states (one thread block each) for ``size``×``size`` boards
    that one SM of the current CUDA device holds at once (the race
    kernel's occupancy at the full stack depth)."""
    states = load_library().dfs_race_states_per_sm(round(size ** 0.5))
    if states < 0:
        raise RuntimeError(f"no race kernel occupancy for size {size}")
    return states


def _dfs_solver_plain(boards: torch.Tensor, spec: BoardSpec, depth: int,
                      max_iters: int, **sweeps):
    """The plain PyTorch version of the kernel on the same (B, C) layout:
    ops/solver.solve_flat under the same ``sweeps`` knobs. Returns (grid,
    meta) like the kernel, with every board's step count set to the
    batch's."""
    B = boards.shape[0]
    N = spec.size
    res, _ = solve_flat(
        boards.reshape(B, N, N), spec, depth, max_iters,
        **sweep_knobs(spec, **sweeps),
    )
    steps = torch.full_like(res.status, res.iters)
    meta = torch.stack([res.status, res.guesses, res.validations, steps], dim=1)
    return res.grid.reshape(B, spec.cells), meta


def dfs_solver(boards: torch.Tensor, spec: BoardSpec, depth: int,
               max_iters: int, *, locked_candidates: bool = False,
               waves: int = 1, light_waves: bool = False,
               naked_pairs: bool | None = None, packed: bool | None = None):
    """Solve (B, C) int32 boards with a guess stack of ``depth`` frames and
    at most ``max_iters`` steps per board, under ``ops.solver.solve_batch``'s
    sweep knobs. Returns ``(grid, meta)``: the (B, C) int32 final grids
    and the (B, 4) int32 [status, guesses, validations, steps] per board.
    ``packed`` selects only the plain version's form of the locked pass
    (the results are the same); it is checked, not sent to the kernel.

    A CUDA tensor launches the kernel on the current stream (no sync);
    a CPU tensor runs the plain version. Nothing else is accepted. While
    ``library_quarantine`` holds the library, it raises instead."""
    _check_library()
    sweeps = dict(
        locked_candidates=locked_candidates, waves=waves,
        light_waves=light_waves, naked_pairs=naked_pairs, packed=packed,
    )
    knobs = sweep_knobs(spec, **sweeps)
    if not isinstance(boards, torch.Tensor):
        raise TypeError("dfs_solver takes a torch.Tensor")
    if boards.dtype != torch.int32:
        raise TypeError(f"dfs_solver takes int32 boards, got {boards.dtype}")
    if boards.dim() != 2 or boards.shape[1] != spec.cells:
        raise ValueError(
            f"dfs_solver takes (B, {spec.cells}) boards, got "
            f"{tuple(boards.shape)}"
        )
    if depth < 1 or max_iters < 0:
        raise ValueError(f"bad depth {depth} / max_iters {max_iters}")
    if boards.device.type == "cpu":
        return _dfs_solver_plain(boards, spec, depth, max_iters, **sweeps)
    if boards.device.type != "cuda":
        raise ValueError(f"dfs_solver runs on cuda or cpu, not {boards.device}")
    if not boards.is_contiguous():
        raise ValueError("dfs_solver takes contiguous boards")
    if boards.shape[0] == 0:
        return boards.clone(), boards.new_empty((0, META_COLS))
    return _launch(
        load_library(), boards, spec, depth, max_iters, knobs["waves"],
        _options(knobs),
    )


def _options(knobs: dict) -> int:
    """The launch's ``OPT_*`` bits for ``sweep_knobs``' output."""
    locked, pairs = knobs["locked"], knobs["naked_pairs"]
    pairs = pairs or pairs is None  # None follows locked, as in analyze
    return (
        (OPT_LOCKED if locked else 0)
        | (OPT_PAIRS if locked and pairs else 0)
        | (OPT_LIGHT if knobs["light_waves"] else 0)
    )


def _launch(lib: ctypes.CDLL, boards: torch.Tensor, spec: BoardSpec,
            depth: int, max_iters: int, waves: int = 1, options: int = 0):
    """Allocate the outputs and the guess-stack slab for (B, C) boards on a
    CUDA device, launch ``lib``'s kernel on the current stream with
    ``waves`` sweeps a step and the ``OPT_*`` bits ``options``, and count
    the launch in ``dfs_solver.launches``."""
    B, C = boards.shape
    dev = boards.device
    grid = torch.empty((B, C), dtype=torch.int32, device=dev)
    meta = torch.empty((B, META_COLS), dtype=torch.int32, device=dev)
    stack_grid = torch.empty((B, depth, C), dtype=torch.int8, device=dev)
    stack_cell = torch.empty((B, depth), dtype=torch.int32, device=dev)
    stack_mask = torch.empty((B, depth), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dfs_solver_launch(
            boards.data_ptr(), grid.data_ptr(), meta.data_ptr(),
            stack_grid.data_ptr(), stack_cell.data_ptr(),
            stack_mask.data_ptr(), B, spec.box, depth, max_iters, waves,
            options, stream,
        )
    if err != 0:
        raise KernelLaunchError(f"dfs_solver launch failed: cudaError {err}")
    with _LAUNCHES_LOCK:
        dfs_solver.launches += 1
    return grid, meta


dfs_solver.launches = 0


class SegmentPool:
    """A handle on a lane pool: the ``SegmentState`` tensors of W lanes of
    one board size, on the CPU or a CUDA device. A segment
    (``dfs_segment``) updates a CUDA pool's tensors in place and consumes
    the handle it is given: it returns the pool's next handle (the
    generation after), and any later use of the old one raises, as a
    donated state's buffers are dead after a JAX call."""

    def __init__(self, state: SegmentState, spec: BoardSpec, *, _shared=None):
        self.state = state
        self.spec = spec
        # shared by every handle of the pool: its current generation and
        # the segment kernel's per-lane scratch
        self._shared = _shared if _shared is not None else {
            "generation": 0, "lane_steps": None,
        }
        self.generation = self._shared["generation"]

    @classmethod
    def fresh(cls, boards: torch.Tensor, spec: BoardSpec, depth) -> "SegmentPool":
        """A pool with lane i starting on ``boards[i]`` ((W, N, N), on
        their device) and a ``depth``-frame stack (a staged depth
        collapses to its largest stage)."""
        return cls(init_segment_state(boards, spec, depth), spec)

    @property
    def width(self) -> int:
        return self.state.grid.shape[0]

    @property
    def donated(self) -> bool:
        return self.generation != self._shared["generation"]

    def check_live(self) -> None:
        if self.donated:
            raise RuntimeError(
                "segment pool state was already donated to an earlier "
                "dispatch — a failed or superseded segment must rebuild the "
                "pool (new_segment_pool), never reuse a donated handle"
            )

    def _next(self, state: SegmentState) -> "SegmentPool":
        self._shared["generation"] += 1
        return SegmentPool(state, self.spec, _shared=self._shared)


def _dfs_segment_plain(state: SegmentState, boards: torch.Tensor,
                       src: torch.Tensor, seg_iters: int, spec: BoardSpec,
                       prefix_gather: bool, **sweeps):
    """The plain PyTorch version of the segment kernels: ops/solver's
    ``inject_lanes_src``, ``run_segment`` and ``segment_digest`` on
    (n, C) boards. Returns (state, digest, block)."""
    N = spec.size
    state = inject_lanes_src(
        state, boards.reshape(-1, N, N), src.to(torch.int32), spec
    )
    entry_running = state.status == RUNNING
    state, stats = run_segment(state, seg_iters, spec, **sweeps)
    digest, block = segment_digest(state, entry_running, stats, prefix_gather)
    return state, digest, block


def dfs_segment(pool: SegmentPool, boards: torch.Tensor, src: torch.Tensor,
                seg_iters: int, *, prefix_gather: bool,
                locked_candidates: bool = False, waves: int = 1,
                light_waves: bool = False, naked_pairs: bool | None = None,
                packed: bool | None = None):
    """One segment of continuous batching over ``pool``: lanes restart from
    rows of the (n, C) int32 ``boards`` or from the pad board as the (W,)
    int32 source map ``src`` says (``ops.solver.align_src_boards``), every
    lane steps while RUNNING for at most ``seg_iters`` steps under
    ``ops.solver.solve_batch``'s sweep knobs, and the segment's digest and
    solution block are built (``ops.solver.segment_digest``, in the form
    ``prefix_gather`` picks). Returns ``(pool', digest, block)``: the
    pool's next handle (``pool`` is consumed), the (W, 8) int32 digest and
    the (W, C) int32 block, tensors of their own.

    A CUDA pool launches the segment kernel and its digest kernel on the
    current stream (no sync); a CPU pool runs the plain version. Nothing
    else is accepted. While ``library_quarantine`` holds the library, it
    raises instead."""
    _check_library()
    pool.check_live()
    spec = pool.spec
    sweeps = dict(
        locked_candidates=locked_candidates, waves=waves,
        light_waves=light_waves, naked_pairs=naked_pairs, packed=packed,
    )
    knobs = sweep_knobs(spec, **sweeps)
    state = pool.state
    W, C = state.grid.shape
    dev = state.grid.device
    for name, t in (("boards", boards), ("src", src)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise TypeError(f"dfs_segment takes {name} as an int32 tensor")
        if t.device != dev:
            raise ValueError(f"dfs_segment: {name} lies on {t.device}, the pool on {dev}")
    if boards.dim() != 2 or boards.shape[1] != C or boards.shape[0] < 1:
        raise ValueError(
            f"dfs_segment takes (n >= 1, {C}) boards, got {tuple(boards.shape)}"
        )
    if tuple(src.shape) != (W,):
        raise ValueError(f"dfs_segment takes a ({W},) source map, got {tuple(src.shape)}")
    if seg_iters < 0:
        raise ValueError(f"bad seg_iters {seg_iters}")
    if dev.type == "cpu":
        state, digest, block = _dfs_segment_plain(
            state, boards, src, seg_iters, spec, prefix_gather, **sweeps
        )
        return pool._next(state), digest, block
    if dev.type != "cuda":
        raise ValueError(f"dfs_segment runs on cuda or cpu, not {dev}")
    digest, block = _launch_segment(
        load_library(), pool, boards, src, seg_iters, knobs["waves"],
        _options(knobs), prefix_gather,
    )
    return pool._next(state), digest, block


def _launch_segment(lib: ctypes.CDLL, pool: SegmentPool, boards: torch.Tensor,
                    src: torch.Tensor, seg_iters: int, waves: int,
                    options: int, prefix_gather: bool):
    """Allocate the digest and the solution block, launch ``lib``'s segment
    kernels over the CUDA ``pool`` on the current stream, and count the
    launch in ``dfs_segment.launches``."""
    st = pool.state
    W, C = st.grid.shape
    D = st.stack_mask.shape[1]
    dev = st.grid.device
    tensors = (boards, src, *st)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("dfs_segment takes contiguous tensors")
    scratch = pool._shared["lane_steps"]
    if scratch is None:
        scratch = pool._shared["lane_steps"] = torch.empty(
            (W,), dtype=torch.int32, device=dev
        )
    digest = torch.empty((W, SEGMENT_DIGEST_COLS), dtype=torch.int32, device=dev)
    block = torch.empty((W, C), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dfs_segment_launch(
            boards.data_ptr(), boards.shape[0], src.data_ptr(),
            *(t.data_ptr() for t in st), digest.data_ptr(), block.data_ptr(),
            scratch.data_ptr(), W, pool.spec.box, D, int(seg_iters), waves,
            options, int(bool(prefix_gather)), stream,
        )
    if err != 0:
        raise KernelLaunchError(f"dfs_segment launch failed: cudaError {err}")
    with _LAUNCHES_LOCK:
        dfs_segment.launches += 1
    return digest, block


dfs_segment.launches = 0


def _dfs_race_plain(states: torch.Tensor, spec: BoardSpec, depth: int,
                    max_iters: int, **sweeps):
    """The plain PyTorch version of the race kernel on the same (M, C)
    layout: ops/solver.race, the lockstep race, under the same ``sweeps``
    knobs. Returns (row, fold, meta) like the kernels; ``meta`` is each
    state's search as the lockstep loop cut it."""
    M = states.shape[0]
    N = spec.size
    knobs = sweep_knobs(spec, **sweeps)
    return race(states.reshape(M, N, N), spec, max_iters, depth, **knobs)


def dfs_race(states: torch.Tensor, spec: BoardSpec, depth: int,
             max_iters: int, *, locked_candidates: bool = False,
             waves: int = 1, naked_pairs: bool | None = None,
             packed: bool | None = None):
    """Race (M, C) int32 seeded states of one board to the first solution:
    the JAX package's lockstep frontier race on one device, each state with
    a guess stack of ``depth`` frames and at most ``max_iters`` steps, under
    ``ops.solver.solve_batch``'s sweep knobs (no light waves: the race has
    none). Returns ``(row, fold, meta)``: the packed (C + 3,) int32 row
    [solution, found, validations, undecided]; the (M, 2) int32 [status,
    validations] of every state after the race; and the (M, 4) int32 run
    record of ``ops.solver.RACE_META_COLS``. ``row`` and ``fold`` are the
    lockstep race's exactly. ``meta`` says where each state's search
    stopped: in lockstep for the plain version, at each block's own pace
    for the kernel, whose blocks stop once they have run more steps than
    the earliest solve they have seen (``ops.solver.fold_race`` maps either
    to ``row`` and ``fold``).

    A CUDA tensor launches the race kernel (K4, which folds in the same
    launch) on the current stream (no sync); a CPU tensor runs the plain
    version. Nothing else is accepted. ``dfs_race.launches`` counts
    launches. While ``library_quarantine`` holds the library, it raises
    instead."""
    _check_library()
    sweeps = dict(
        locked_candidates=locked_candidates, waves=waves,
        naked_pairs=naked_pairs, packed=packed,
    )
    knobs = sweep_knobs(spec, **sweeps)
    if not isinstance(states, torch.Tensor):
        raise TypeError("dfs_race takes a torch.Tensor")
    if states.dtype != torch.int32:
        raise TypeError(f"dfs_race takes int32 states, got {states.dtype}")
    if states.dim() != 2 or states.shape[1] != spec.cells or states.shape[0] < 1:
        raise ValueError(
            f"dfs_race takes (M >= 1, {spec.cells}) states, got "
            f"{tuple(states.shape)}"
        )
    if depth < 1 or max_iters < 0:
        raise ValueError(f"bad depth {depth} / max_iters {max_iters}")
    if states.device.type == "cpu":
        return _dfs_race_plain(states, spec, depth, max_iters, **sweeps)
    if states.device.type != "cuda":
        raise ValueError(f"dfs_race runs on cuda or cpu, not {states.device}")
    if not states.is_contiguous():
        raise ValueError("dfs_race takes contiguous states")
    return _launch_race(
        load_library(), states, spec, depth, max_iters, knobs["waves"],
        _options(knobs),
    )


# The race's three-word scratch (and a race across shards' words) when no
# race runs: the stop step 0xffffffff (no solve posted), the ticket count 0
# and the last step 0. A race leaves it so.
RACE_SCRATCH_IDLE = (-1, 0, 0)
_RACE_SCRATCH: dict = {}
_RACE_SCRATCH_LOCK = threading.Lock()


def race_scratch(device: torch.device, stream: int) -> torch.Tensor:
    """The race kernel's (3,) int32 scratch for the CUDA stream handle
    ``stream`` on ``device``: allocated and set idle (``RACE_SCRATCH_IDLE``)
    at the first race there, on that stream, and handed back to every later
    one. Races on one stream run in order, each leaving it idle for the
    next; races on two streams may run at once, so they never share one."""
    key = (device, stream)
    with _RACE_SCRATCH_LOCK:
        scratch = _RACE_SCRATCH.get(key)
        if scratch is None:
            scratch = _RACE_SCRATCH[key] = torch.tensor(
                RACE_SCRATCH_IDLE, dtype=torch.int32, device=device
            )
    return scratch


def race_stack_in_slab(lib, box: int) -> bool:
    """Whether ``lib``'s race kernel keeps the guess stack of boards with
    box edge ``box`` in a device slab the wrapper allocates; otherwise it
    lives in the kernel's shared memory and no slab is passed."""
    on_chip = lib.dfs_race_stack_on_chip(box)
    if on_chip not in (0, 1):
        raise ValueError(f"the race kernel takes no box edge {box}")
    return on_chip == 0


def _launch_race(lib: ctypes.CDLL, states: torch.Tensor, spec: BoardSpec,
                 depth: int, max_iters: int, waves: int, options: int,
                 slab: Optional[bool] = None,
                 scratch: Optional[torch.Tensor] = None):
    """Allocate the race's outputs for (M, C) states on a CUDA device,
    launch ``lib``'s race kernel on the current stream with the stream's
    scratch (``race_scratch``), and count the launch in
    ``dfs_race.launches``. A search never holds more than C - 1 frames, so
    the stack is ``min(depth, C)`` frames deep. ``slab`` (default:
    ``race_stack_in_slab``) allocates the (M, D, C) stack slab; it comes
    from PyTorch's caching allocator (0.8 GB for 2048 25x25 states), which
    hands the same block back to the next race of the same rung. A
    ``scratch`` given takes the place of the stream's own."""
    M, C = states.shape
    dev = states.device
    depth = min(depth, C)
    if slab is None:
        slab = race_stack_in_slab(lib, spec.box)

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    grid, meta = empty(M, C), empty(M, RACE_META_COLS)
    fold, row = empty(M, 2), empty(C + RACE_ROW_EXTRA)
    stack = (
        (empty(M, depth, C, dtype=torch.int8), empty(M, depth), empty(M, depth))
        if slab else ()
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if scratch is None:
            scratch = race_scratch(dev, stream)
        err = lib.dfs_race_launch(
            states.data_ptr(), grid.data_ptr(), meta.data_ptr(),
            fold.data_ptr(), row.data_ptr(),
            *([t.data_ptr() for t in stack] if slab else [None] * 3),
            scratch.data_ptr(), M, spec.box, depth, max_iters, waves, options,
            stream,
        )
    if err != 0:
        raise KernelLaunchError(f"dfs_race launch failed: cudaError {err}")
    with _LAUNCHES_LOCK:
        dfs_race.launches += 1
    return row, fold, meta


dfs_race.launches = 0


# -- a race across the shards of a mesh ---------------------------------------

_RACE_SLOTS: dict = {}
# a slot with no step posted
RACE_SLOT_IDLE = 0xFFFFFFFF
# where the shards of a race keep its stop, by the library's layout number
# (csrc/dfs_solver.cu kLayoutDevice, kLayoutPeer, kLayoutHost)
RACE_LAYOUTS = ("device", "peer", "host")


def race_layout(devices, can_access_peer) -> str:
    """Where a race across shards on ``devices`` (one a shard, in shard
    order) keeps its stop, from the topology alone: ``"device"`` when every
    shard lies on one card (one stop word there, polled by every block);
    ``"peer"`` when every two of the cards report peer access
    (``can_access_peer(a, b)`` on device indices, as
    ``torch.cuda.can_device_access_peer``): a stop word on each card, posted
    to over NVLink; else ``"host"``: slots in mapped host memory, relayed
    into each shard's word. Chosen once, when the race's words are
    allocated (``race_slots``), never as a recovery from an error."""
    cards = list(dict.fromkeys(torch.device(d).index or 0 for d in devices))
    if len(cards) == 1:
        return "device"
    if all(can_access_peer(a, b) for a in cards for b in cards if a != b):
        return "peer"
    return "host"


@dataclass(frozen=True)
class RaceSlots:
    """The stop of races across one set of shards, laid out as ``layout``
    says (``race_layout``). ``words``: a (3,) int32 tensor a shard, [stop
    step, tickets, last step], idle (``RACE_SCRATCH_IDLE``)
    between races: one tensor for every shard under ``"device"``, each on
    its shard's card under ``"peer"`` and ``"host"``. Under ``"host"`` also
    the race's slots, one word a shard of page-locked host memory mapped
    into every device, at device address ``address`` and host address
    ``host`` (0 under the other layouts). ``lock`` is held by a race over
    them while it enqueues its launches (and the fold kernel), so races
    over one set of words run one after another; the race's last block
    (and the fold kernel, for the slots) sets them idle again."""

    layout: str
    words: tuple
    lock: threading.Lock
    address: int = 0
    host: int = 0

    @property
    def n(self) -> int:
        return len(self.words)

    def idle(self) -> None:
        """Set every word and slot idle from the host, for a race whose
        last block or fold never ran. The caller first waits for that
        race's shard launches to end: a launch still running could post
        again."""
        idle = torch.tensor(RACE_SCRATCH_IDLE, dtype=torch.int32)
        for word in {id(w): w for w in self.words}.values():
            word.copy_(idle)
            if word.device.type == "cuda":
                torch.cuda.synchronize(word.device)
        if self.host:
            slots = (ctypes.c_uint32 * self.n).from_address(self.host)
            slots[:] = [RACE_SLOT_IDLE] * self.n


def race_slots(devices, key) -> RaceSlots:
    """The stop of races across the shards on ``devices`` (one a shard, in
    shard order) that ``key`` names (the shards' (device, stream) pairs):
    allocated at the first race over those shards, idle, and kept for the
    process. Its layout is chosen there from the topology (``race_layout``
    over ``torch.cuda.can_device_access_peer``). Under ``"peer"`` the
    library enables peer access between every two of the cards; a failure
    raises ``KernelLaunchError``, and nothing falls back to host memory."""
    with _RACE_SCRATCH_LOCK:
        entry = _RACE_SLOTS.get(key)
        if entry is None:
            entry = _RACE_SLOTS[key] = _alloc_race_slots(
                load_library(), [torch.device(d) for d in devices],
                torch.cuda.can_device_access_peer)
    return entry


_RELAY_WORDS: list = []


def race_relay_words() -> tuple:
    """The process's words of the race's relay across hosts
    (parallel/relay.py): two 64-bit words of page-locked host memory
    mapped into every device, [race, step] in their halves, idle (no
    race) at allocation: the outbox, which the race kernel posts into when
    a solve lowers its stop word, and the inbox, which the relay thread
    writes another host's post into and the kernel reads in turns.
    Allocated at the first such race and kept for the process:
    ``(device address, host address)`` of the outbox; the inbox follows
    it, 8 bytes on."""
    with _RACE_SCRATCH_LOCK:
        if not _RELAY_WORDS:
            out, hp = ctypes.c_void_p(), ctypes.c_void_p()
            err = load_library().dfs_race_slots_alloc(4, ctypes.byref(out), ctypes.byref(hp))
            if err != 0:
                raise KernelLaunchError(f"the relay's words: dfs_race_slots_alloc "
                                        f"failed: cudaError {err}")
            _RELAY_WORDS.append((int(out.value), int(hp.value)))
    return _RELAY_WORDS[0]


def race_relay_serve(*args) -> int:
    """One round of the relay thread's service of a race on a card, in
    the library (``dfs_race_relay_serve``, without the interpreter's lock;
    ``args`` as its C arguments, parallel/relay.py's ``RaceRelay``):
    0 (the round's time passed, or the race was closed), 1 (this host's
    post sent), 2 (another host's post written into the inbox), 3 (a
    peer's datagram of another race, for the caller), 4 (a stranger's
    datagram), 5 (every shard's end event has completed), or -errno."""
    return int(load_library().dfs_race_relay_serve(*args))


def _alloc_race_slots(lib, devices: list, can_access_peer) -> RaceSlots:
    if len(devices) > lib.dfs_race_max_shards():
        raise ValueError(f"a race across shards takes at most "
                         f"{lib.dfs_race_max_shards()} shards, not {len(devices)}")
    layout = race_layout(devices, can_access_peer)
    cards = list(dict.fromkeys(devices))
    if layout == "peer":
        index = [d.index or 0 for d in cards]
        err = lib.dfs_race_peer_enable(len(index), (ctypes.c_int * len(index))(*index))
        if err != 0:
            raise KernelLaunchError(
                f"peer access between cards {index} was reported but could not "
                f"be enabled: cudaError {err}"
            )
    own = {d: torch.tensor(RACE_SCRATCH_IDLE, dtype=torch.int32, device=d) for d in cards}
    for d in cards:
        if d.type == "cuda":  # the words are set before any shard's stream runs
            torch.cuda.synchronize(d)
    address = host = 0
    if layout == "host":
        out, hp = ctypes.c_void_p(), ctypes.c_void_p()
        err = lib.dfs_race_slots_alloc(len(devices), ctypes.byref(out), ctypes.byref(hp))
        if err != 0:
            raise KernelLaunchError(f"dfs_race_slots_alloc failed: cudaError {err}")
        address, host = int(out.value), int(hp.value)
    return RaceSlots(layout, tuple(own[d] for d in devices), threading.Lock(),
                     address, host)


def dfs_race_shards(states: list, spec: BoardSpec, depth: int, max_iters: int,
                    *, streams: Optional[list] = None, slots: Optional[RaceSlots] = None,
                    fold: bool = False, clock: Optional[torch.Tensor] = None,
                    relay=None, locked_candidates: bool = False, waves: int = 1,
                    naked_pairs: bool | None = None, packed: bool | None = None):
    """A race across shards: shard i's (M, C) int32 ``states[i]`` raced,
    each state stopping once it has run more steps than the earliest solve
    any shard has posted. With ``fold``, returns ``(row, fold, meta)`` as
    ``dfs_race`` over every shard's states in state order. Without it,
    returns one ``(meta, grid)`` a shard, the (M, 4) run records of
    ``ops.solver.RACE_META_COLS`` and the (M, C) grids the runs stopped on,
    which ``race_fold`` over every shard's, in state order, folds.

    CUDA tensors (shard i's on its device, with ``streams[i]`` its stream
    and ``slots`` the race's ``race_slots``) launch the shard form of the
    race kernel (``dfs_race_shard_kernel``) from one library call, each
    state stopping on the race's stop words: under the ``"device"``
    layout one launch of every shard's blocks on shard 0's stream, else one
    launch a shard on its stream, enqueued microseconds apart; each launch
    counts in ``dfs_race_shards.launches``. Under the ``"device"`` and
    ``"peer"`` layouts every shard writes its records into one (n M, 4)
    tensor on shard 0's device, and with ``fold`` the last block across
    every shard folds them there: the race is this one call, with no copy
    and no other launch. Under ``"host"`` only the records come back
    (``fold`` raises). Shard 0's stream waits for every shard's launch,
    and every shard's stream for shard 0's, so what the race wrote is ready
    on any of them. ``clock`` (a diagnostic, off on every path of the
    program): an (n M, 3) int64 tensor on shard 0's device, which the
    launch fills with each state's block's globaltimer readings in ns (its
    card's timer), [start, end of its search, end]. CPU tensors run the plain lockstep race of
    each shard's own states (``ops.solver.race_runs``), and with ``fold``
    ``fold_race`` over every shard's records. Nothing else is accepted.

    ``relay`` (a race whose records are gathered from other hosts: the
    multi-host serving loop's ``parallel.relay.RaceLink``; no ``fold``):
    each state also stops at a step another host posted for this race, and
    this host's solves are posted for the other hosts. On CUDA the launch
    (the kernel's relay instance) reads the
    mapped word at device address ``relay.inbox`` in turns and posts into
    the one at ``relay.outbox``, both tagged with ``relay.tag``; on the
    CPU each shard's plain race polls ``relay.stop_step`` once a step and
    ``relay.post``s its solve step."""
    _check_library()
    sweeps = dict(
        locked_candidates=locked_candidates, waves=waves,
        naked_pairs=naked_pairs, packed=packed,
    )
    knobs = sweep_knobs(spec, **sweeps)
    if not states or depth < 1 or max_iters < 0:
        raise ValueError(f"bad shards / depth {depth} / max_iters {max_iters}")
    M = states[0].shape[0] if isinstance(states[0], torch.Tensor) else 0
    for t in states:
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise TypeError("dfs_race_shards takes int32 states as torch.Tensors")
        if t.dim() != 2 or t.shape != (M, spec.cells) or M < 1:
            raise ValueError(
                f"dfs_race_shards takes equal (M >= 1, {spec.cells}) shards, got "
                f"{[tuple(x.shape) for x in states]}"
            )
    if fold and slots is not None and slots.layout == "host":
        raise ValueError("under the 'host' layout no launch folds: race_fold "
                         "folds the records")
    if fold and relay is not None:
        raise ValueError("a race with a relay across hosts folds every host's "
                         "records: race_fold folds them")
    kinds = {t.device.type for t in states}
    if kinds == {"cpu"}:
        N = spec.size
        runs = []
        for t in states:
            meta, grid = race_runs(t.reshape(M, N, N), spec, max_iters, depth,
                                   stop=relay.stop_step if relay is not None else None,
                                   **knobs)
            solved = meta[:, 0] == SOLVED
            if relay is not None and bool(solved.any()):
                relay.post(int(meta[solved, 1].min()))
            runs.append((meta, grid))
        if not fold:
            return runs
        meta = torch.cat([m for m, _ in runs])
        row, folded = fold_race(meta, torch.cat([g for _, g in runs]), spec,
                                knobs["waves"])
        return row, folded, meta
    if kinds != {"cuda"}:
        raise ValueError(f"dfs_race_shards runs on cuda or cpu, not {kinds}")
    if not all(t.is_contiguous() for t in states):
        raise ValueError("dfs_race_shards takes contiguous states")
    if slots is None or streams is None or len(streams) != len(states) \
            or slots.n != len(states):
        raise ValueError("dfs_race_shards on CUDA takes the race's slots and a "
                         "stream a shard")
    if clock is not None and (clock.dtype != torch.int64
                              or clock.shape != (len(states) * M, 3)
                              or clock.device != states[0].device
                              or not clock.is_contiguous()):
        raise ValueError("dfs_race_shards takes an (n M, 3) int64 clock on shard 0's device")
    return _launch_race_shards(
        load_library(), states, spec, depth, max_iters, knobs["waves"],
        _options(knobs), slots, streams, fold, clock, relay,
    )


def _launch_race_shards(lib: ctypes.CDLL, states: list, spec: BoardSpec,
                        depth: int, max_iters: int, waves: int, options: int,
                        slots: RaceSlots, streams: list, fold: bool,
                        clock: Optional[torch.Tensor] = None, relay=None):
    """Allocate the race's outputs (each shard's grids, and its stack slab
    off chip, on its device and stream; under the ``"device"`` and
    ``"peer"`` layouts the records of every shard, and with ``fold`` the
    row and fold, on shard 0's stream), launch the shards' race kernels
    from one library call over ``slots`` (one launch under ``"device"``,
    else one a shard), join the shards' streams both ways and count the
    launches in ``dfs_race_shards.launches``."""
    n = len(states)
    M, C = states[0].shape
    depth = min(depth, C)
    slab = race_stack_in_slab(lib, spec.box)
    across = slots.layout != "host"
    primary = states[0].device

    def empty(dev, *shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    with torch.cuda.device(primary), torch.cuda.stream(streams[0]):
        records = empty(primary, n * M, RACE_META_COLS) if across else None
        row, folded = (empty(primary, C + RACE_ROW_EXTRA), empty(primary, n * M, 2)) \
            if fold else (None, None)
    outs, keep = [], []
    ptr = ctypes.c_void_p * n
    arrays = {k: ptr() for k in ("grid", "meta", "sg", "sc", "sm", "words", "stream")}
    devices = (ctypes.c_int * n)()
    for i, (t, stream) in enumerate(zip(states, streams)):
        dev = t.device
        # memory the one launch of the "device" layout writes, on its stream
        own = streams[0] if slots.layout == "device" else stream
        with torch.cuda.device(dev), torch.cuda.stream(own):
            grid = empty(dev, M, C)
            meta = records[i * M:(i + 1) * M] if across else empty(dev, M, RACE_META_COLS)
            stack = (
                (empty(dev, M, depth, C, dtype=torch.int8), empty(dev, M, depth),
                 empty(dev, M, depth))
                if slab else ()
            )
        outs.append((meta, grid))
        keep.append(stack)
        arrays["grid"][i] = grid.data_ptr()
        arrays["meta"][i] = meta.data_ptr()
        for k, tensor in zip(("sg", "sc", "sm"), stack):
            arrays[k][i] = tensor.data_ptr()
        arrays["words"][i] = slots.words[i].data_ptr()
        arrays["stream"][i] = stream.cuda_stream
        devices[i] = dev.index or 0
    inputs = ptr(*(t.data_ptr() for t in states))
    err = lib.dfs_race_shards_launch(
        n, inputs, arrays["grid"], arrays["meta"], arrays["sg"], arrays["sc"],
        arrays["sm"], arrays["words"],
        folded.data_ptr() if fold else None, row.data_ptr() if fold else None,
        slots.address or None, clock.data_ptr() if clock is not None else None,
        RACE_LAYOUTS.index(slots.layout), devices, arrays["stream"], M, spec.box, depth,
        max_iters, waves, options,
        *((relay.inbox, relay.outbox, relay.tag) if relay is not None else (None, None, 0)),
    )
    if err != 0:
        raise KernelLaunchError(f"dfs_race_shards launch failed: cudaError {err}")
    with _LAUNCHES_LOCK:
        dfs_race_shards.launches += 1 if slots.layout == "device" else n
    # the race's last block may run on any shard's stream and read every
    # shard's grids: each stream waits for the whole race before its
    # memory is handed out again
    for stream in streams[1:]:
        streams[0].wait_stream(stream)
    for stream in streams[1:]:
        stream.wait_stream(streams[0])
    return (row, folded, records) if fold else outs


dfs_race_shards.launches = 0


def race_fold(meta: torch.Tensor, grid: torch.Tensor, spec: BoardSpec,
              waves: int, *, slots: Optional[int] = None, n_slots: int = 0):
    """The fold of a race across shards whose launches did not fold, over
    every shard's run records gathered in global state order on one device
    (every host's, on the multi-host loop; every card's, under the
    ``"host"`` layout): (M, 4) ``meta`` and (M, C) ``grid``. Returns
    ``(row, fold)`` as ``dfs_race``: the packed (C + 3,) row and each
    state's (M, 2) [status, validations] after the lockstep race.

    CUDA tensors launch the fold kernel (``race_fold_kernel``, one block
    that finds t* in the records, then folds them in one pass) on the
    current stream, which also sets the race's ``n_slots`` slots idle, and
    count it in ``race_fold.launches``; CPU tensors run
    ``ops.solver.fold_race``. Nothing else is accepted."""
    _check_library()
    for name, t in (("meta", meta), ("grid", grid)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise TypeError(f"race_fold takes {name} as an int32 tensor")
    M = meta.shape[0]
    if tuple(meta.shape) != (M, RACE_META_COLS) or tuple(grid.shape) != (M, spec.cells) \
            or M < 1:
        raise ValueError(
            f"race_fold takes (M, {RACE_META_COLS}) meta and (M, {spec.cells}) "
            f"grids, got {tuple(meta.shape)} and {tuple(grid.shape)}"
        )
    if meta.device != grid.device:
        raise ValueError("race_fold: meta and grid lie on different devices")
    if meta.device.type == "cpu":
        return fold_race(meta, grid, spec, waves)
    if meta.device.type != "cuda":
        raise ValueError(f"race_fold runs on cuda or cpu, not {meta.device}")
    if not (meta.is_contiguous() and grid.is_contiguous()):
        raise ValueError("race_fold takes contiguous tensors")
    return _launch_race_fold(load_library(), meta, grid, spec, waves, slots, n_slots)


def _launch_race_fold(lib: ctypes.CDLL, meta: torch.Tensor, grid: torch.Tensor,
                      spec: BoardSpec, waves: int, slots: Optional[int],
                      n_slots: int):
    M, C = grid.shape
    dev = grid.device
    fold = torch.empty((M, 2), dtype=torch.int32, device=dev)
    row = torch.empty((C + RACE_ROW_EXTRA,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dfs_race_fold_launch(
            meta.data_ptr(), grid.data_ptr(), fold.data_ptr(), row.data_ptr(),
            slots, int(n_slots) if slots else 0, M, spec.box, int(waves), stream,
        )
    if err != 0:
        raise KernelLaunchError(f"race_fold launch failed: cudaError {err}")
    with _LAUNCHES_LOCK:
        race_fold.launches += 1
    return row, fold


race_fold.launches = 0


# -- the frontier race's seeding --------------------------------------------

# count, first solved, rounds, analyzed, outcome; the solved state's row follows
SEED_HEADER_COLS = 5
# a state's verdict and MRV cell, MRV mask, and its first row among its
# part's rows if the round keeps the live states and if it splits them
SEED_INFO_COLS = 4
SEED_BOXES = (2, 3, 4, 5)  # the box edges the seeding kernel is built for
# a seeding's outcome, by the kernel's number (csrc/dfs_solver.cu kSeed*)
SEED_OUTCOMES = ("target", "solved", "dead", "rounds")
_SEED_SCRATCH: dict = {}
_SEED_SCRATCH_LOCK = threading.Lock()


def _seed_frontier_plain(states: torch.Tensor, spec: BoardSpec, target: int,
                         max_rounds: int, locked: bool, check=None):
    """The plain version of the seeding kernel on the same (M, C) layout:
    the host rounds ``ops.solver.seed_rounds``, ``check`` called before
    each. Returns ``(states, solved, None)`` as the kernel's wrapper, with
    no header."""
    N, C = spec.size, spec.cells
    out, solved = seed_rounds(states.reshape(-1, N, N).numpy().copy(), spec, target,
                              max_rounds, locked, check)
    out = torch.from_numpy(np.ascontiguousarray(out, np.int32).reshape(len(out), C))
    if solved is not None:
        solved = torch.from_numpy(np.array(solved, np.int32).reshape(C))
    return out, solved, None


def seed_frontier_cuda(states: torch.Tensor, spec: BoardSpec, target: int,
                       max_rounds: int, locked: bool = False, check=None):
    """Expand (M, C) int32 states of one board into at least ``target``
    disjoint states, round for round as ``ops.solver.seed_rounds`` (the
    JAX package's host seeding): every state analyzed, the first
    solved one returned, singles assigned everywhere, dead states dropped,
    MRV splits until ``target``, padding with the instantly-UNSAT board
    when the batch dies or ``max_rounds`` run out. ``locked`` analyzes
    with locked candidates and naked pairs, as ``analyze(locked=True)``.
    ``check`` (a caller's deadline, raising when it has passed) is called
    before every round of the plain version, and before and after the
    kernel's launch.

    Returns ``(states, solved, header)``: the (K, C) int32 seeded states on
    the input's device; the (C,) int32 solution on the host when a state
    solved, else None; and the kernel's header as a dict (``count``,
    ``first``: the solved state's index or -1, ``rounds``, ``analyzed``:
    states swept in all, ``outcome``: one of ``SEED_OUTCOMES``), None from
    the plain version.

    A CUDA tensor launches the seeding kernel (K5, one cluster, one
    launch) on the current stream and waits for its header and the
    solution row after it (one ``.cpu()``, the seeding's one sync); a CPU
    tensor runs the plain version. Nothing else is accepted.
    ``seed_frontier_cuda.launches`` counts launches. While
    ``library_quarantine`` holds the library, it raises instead."""
    _check_library()
    if not isinstance(states, torch.Tensor):
        raise TypeError("seed_frontier_cuda takes a torch.Tensor")
    if states.dtype != torch.int32:
        raise TypeError(f"seed_frontier_cuda takes int32 states, got {states.dtype}")
    if states.dim() != 2 or states.shape[1] != spec.cells or states.shape[0] < 1:
        raise ValueError(
            f"seed_frontier_cuda takes (M >= 1, {spec.cells}) states, got "
            f"{tuple(states.shape)}"
        )
    if target < 1 or max_rounds < 0:
        raise ValueError(f"bad target {target} / max_rounds {max_rounds}")
    if states.device.type == "cpu":
        return _seed_frontier_plain(states, spec, target, max_rounds, locked, check)
    if states.device.type != "cuda":
        raise ValueError(f"seed_frontier_cuda runs on cuda or cpu, not {states.device}")
    if not states.is_contiguous():
        raise ValueError("seed_frontier_cuda takes contiguous states")
    if check is not None:
        check()
    out = _launch_seed(load_library(), states, spec, target, max_rounds, locked)
    if check is not None:
        check()
    return out


def seed_capacity(M: int, target: int, spec: BoardSpec) -> int:
    """Rows of the seeding's two state buffers: the input, or a split of
    fewer than ``target`` states into at most N children each, rounded up
    to a power of two so that seedings share their scratch."""
    need = max(M, target * spec.size)
    return 1 << (need - 1).bit_length()


def seed_scratch(device: torch.device, stream: int, box: int, cap: int) -> tuple:
    """The seeding kernel's scratch for the CUDA stream handle ``stream``
    on ``device``: (cap, C) int32 state rows and (cap, ``SEED_INFO_COLS``)
    int32 state records, allocated at the first seeding of that box edge and capacity
    there and handed back to every later one. Seedings on one stream run
    in order and read nothing of it across launches; seedings on two
    streams may run at once, so they never share one."""
    key = (device, stream, box, cap)
    with _SEED_SCRATCH_LOCK:
        scratch = _SEED_SCRATCH.get(key)
        if scratch is None:
            C = box ** 4
            scratch = _SEED_SCRATCH[key] = (
                torch.empty((cap, C), dtype=torch.int32, device=device),
                torch.empty((cap, SEED_INFO_COLS), dtype=torch.int32, device=device),
            )
    return scratch


def _seed_launch(lib: ctypes.CDLL, states: torch.Tensor, spec: BoardSpec,
                 target: int, max_rounds: int, locked: bool) -> tuple:
    """Launch ``lib``'s seeding kernel on (M, C) CUDA states on the current
    stream and count it in ``seed_frontier_cuda.launches``; no sync.
    Returns the launch's device buffers ``(out, header)``: the (cap, C)
    seeded states and the ``SEED_HEADER_COLS + C`` header (the solution
    row after the header's words). Raises ``KernelLaunchError``, counting
    nothing, when the card holds no cluster of the kernel for this box
    edge (``lib.seed_clusters``, from library load) or the launch fails."""
    M, C = states.shape
    clusters = lib.seed_clusters.get(spec.box, 0)
    if clusters < 1:
        raise KernelLaunchError(
            f"seed_frontier: the card holds no cluster of the {spec.size}x{spec.size} "
            f"seeding kernel (" + (f"cudaError {-clusters}" if clusters < 0
                                   else "cudaOccupancyMaxActiveClusters 0") + ")")
    dev = states.device
    cap = seed_capacity(M, target, spec)
    out = torch.empty((cap, C), dtype=torch.int32, device=dev)
    header = torch.empty((SEED_HEADER_COLS + C,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        nxt, info = seed_scratch(dev, stream, spec.box, cap)
        err = lib.seed_frontier_launch(
            states.data_ptr(), out.data_ptr(), nxt.data_ptr(), info.data_ptr(),
            header.data_ptr(), M, cap, spec.box, int(target), int(max_rounds),
            (OPT_LOCKED | OPT_PAIRS) if locked else 0, stream,
        )
    if err != 0:
        raise KernelLaunchError(f"seed_frontier launch failed: cudaError {err}")
    with _LAUNCHES_LOCK:
        seed_frontier_cuda.launches += 1
    return out, header


def _launch_seed(lib: ctypes.CDLL, states: torch.Tensor, spec: BoardSpec,
                 target: int, max_rounds: int, locked: bool):
    """``_seed_launch``, then its header and solution row read in one
    copy: ``seed_frontier_cuda``'s result on the card."""
    out, header = _seed_launch(lib, states, spec, target, max_rounds, locked)
    header = header.cpu()
    count, first, rounds, analyzed, outcome = header[:SEED_HEADER_COLS].tolist()
    solved = header[SEED_HEADER_COLS:] if first >= 0 else None
    return out[:count], solved, {
        "count": count, "first": first, "rounds": rounds, "analyzed": analyzed,
        "outcome": SEED_OUTCOMES[outcome],
    }


seed_frontier_cuda.launches = 0


def lockstep_stats(steps: torch.Tensor) -> LoopStats:
    """The lockstep loop's LoopStats of one flat stage from each board's
    own step count (K1's ``steps`` column), by ``lockstep_loop``. 0-dim
    int64 tensors on the steps' device: no sync."""
    B = steps.shape[0]
    if B == 0:
        zero = steps.new_zeros((), dtype=torch.int64)
        return LoopStats(zero, zero)
    return lockstep_loop(steps.to(torch.int64).sum(),
                         steps.amax().to(torch.int64), B)


def lockstep_loop(own, turns, width: int) -> LoopStats:
    """The LoopStats of a lockstep loop over ``width`` lanes that turned
    ``turns`` times (its longest lane's steps) while its lanes stepped
    ``own`` times in all: the loop sweeps every lane each turn, and a lane
    is idle in the turns after it stopped. Python ints, which do not wrap,
    or int64 tensors alike."""
    lane = turns * width
    return LoopStats(lane, lane - own)


def solve_stage_lockstep(grid: torch.Tensor, spec: BoardSpec, depth: int,
                         max_iters: int, **sweeps):
    """``solve_stage`` with the lockstep loop's LoopStats, as a shard of
    the JAX package's mesh programs counts them: on a CUDA tensor K1
    (``dfs_solver``) and ``lockstep_stats`` of its per-board steps; on a
    CPU tensor the plain flat solve (``ops.solver.solve_flat``), whose
    loop counts them itself. Returns (SolveResult, LoopStats); nothing is
    read back on CUDA."""
    if grid.device.type == "cpu":
        _check_library()
        return solve_flat(grid.to(torch.int32), spec, depth, max_iters,
                          **sweep_knobs(spec, **sweeps))
    B = grid.shape[0]
    N = spec.size
    out, meta = dfs_solver(
        grid.reshape(B, spec.cells).contiguous(), spec, depth, max_iters,
        **sweeps,
    )
    status = meta[:, 0]
    steps = meta[:, 3]
    res = SolveResult(
        grid=out.reshape(B, N, N),
        solved=status == SOLVED,
        status=status,
        guesses=meta[:, 1],
        validations=meta[:, 2],
        iters=steps.amax() if B else steps.new_zeros(()),
    )
    return res, lockstep_stats(steps)


def solve_stage(grid: torch.Tensor, spec: BoardSpec, depth: int,
                max_iters: int, **sweeps):
    """One flat-depth stage of a (B, N, N) batch through ``dfs_solver``
    (``sweeps``: its sweep knobs). Nothing is read back: the step counters
    stay on the device as 0-dim tensors."""
    B = grid.shape[0]
    N = spec.size
    out, meta = dfs_solver(
        grid.reshape(B, spec.cells).contiguous(), spec, depth, max_iters,
        **sweeps,
    )
    status = meta[:, 0]
    steps = meta[:, 3]
    res = SolveResult(
        grid=out.reshape(B, N, N),
        solved=status == SOLVED,
        status=status,
        guesses=meta[:, 1],
        validations=meta[:, 2],
        iters=steps.amax() if B else steps.new_zeros(()),
    )
    return res, LoopStats(steps.sum(), 0)


def solve_batch_cuda(
    grid,
    spec: BoardSpec,
    *,
    max_depth=None,
    max_iters: int = 4096,
    return_stats: bool = False,
    **sweeps,
):
    """Solve a (B, N, N) batch with the DFS kernel.

    ``grid`` is a tensor, which is solved on its own device (the plain
    version runs for a CPU tensor), or an array, which goes to CUDA: with
    no GPU that raises. ``max_depth`` stages the stack depth exactly as ``ops.solver.
    solve_batch`` does (None → the spec's full depth; a tuple → OVERFLOW
    boards rerun deeper, with every other lane a pad board, and their
    counters accumulate). ``sweeps`` are ``solve_batch``'s sweep knobs
    (``locked_candidates``, ``waves``, ``light_waves``, ``naked_pairs``,
    ``packed``). Results agree with the plain ``solve_batch`` board for
    board in grid, status, guesses and validations. ``iters`` is a 0-dim
    tensor; the LoopStats of ``return_stats`` are ints."""
    if not isinstance(grid, torch.Tensor):
        grid = torch.as_tensor(np.asarray(grid), device="cuda")
    res, stats = solve_staged(
        grid.to(torch.int32),
        spec,
        staged_depths(max_depth, spec),
        lambda g, d: solve_stage(g, spec, d, max_iters, **sweeps),
    )
    if not return_stats:
        return res
    return res, LoopStats(int(stats.lane_steps), int(stats.idle_lane_steps))
