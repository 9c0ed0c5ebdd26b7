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
owns the race's two-word scratch, one per (device, stream)
(``race_scratch``), and allocates the guess-stack slab only for a board
size whose stack the library does not keep on chip
(``race_stack_in_slab``).
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
    inject_lanes_src,
    race,
    run_segment,
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


# The race's two-word scratch when no race runs: the stop step 0xffffffff
# (no solve posted) and the ticket count 0. A race leaves it so.
RACE_SCRATCH_IDLE = (-1, 0)
_RACE_SCRATCH: dict = {}
_RACE_SCRATCH_LOCK = threading.Lock()


def race_scratch(device: torch.device, stream: int) -> torch.Tensor:
    """The race kernel's (2,) int32 scratch for the CUDA stream handle
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
