"""Serving engine: bucketed batch solving behind the DFS kernel.

The port of the closed-loop bucket slice of
``sudoku_solver_distributed_tpu/engine.py``: request boards are padded into
a small set of batch buckets and solved in one device call through the
CUDA kernel (ops/cuda_solver.py), and the per-board validation sweeps are
folded into host-side counters. Boards still RUNNING at the step budget
rerun once at ``deep_retry_factor ×`` the budget, with their counters
accumulated, rather than being misreported as unsolvable.

The solver runs the serving configuration of ``ops.SERVING_CONFIG`` unless
the caller overrides it: locked-candidate eliminations, and on 9×9 three
sweeps a step. A width-1 bucket sweeps once a step (``waves`` applies to
wider buckets), as in the JAX engine, so one request's work counters
depend on how many requests shared its device call.

Single-board solves go through the request coalescer
(parallel/coalescer.py) by default, and it serves them open loop, as the
JAX engine does: continuous batching over a lane pool as wide as the
largest bucket, in bounded segments of the segment kernel
(``dispatch_segment`` / ``finalize_segment``, ops/cuda_solver.dfs_segment),
with finished lanes answered and freed lanes refilled at every segment
boundary. The pool runs the flat (largest) depth, and a pool wider than
one lane sweeps ``waves`` times a step, so a board's counters are those
of the flat solve at that depth. ``continuous=False`` keeps the
closed-loop coalescer, where concurrent requests share one bucketed call:
a dispatch enqueues the first depth stage and the copy of its rows into
pinned host memory and returns without waiting for the device;
finalizing waits on that copy's CUDA event, then runs whatever the rows
ask for — a deeper depth stage for OVERFLOW boards, the deep retry for
RUNNING ones — on a stream of its own, so it never waits for a later
batch's launch.

The engine runs on the GPU unless the caller passes ``device="cpu"``; with
no GPU and no such request the constructor raises. On the CPU the kernel
wrappers run their plain PyTorch versions (the tests' configuration).

Supervision (serving/health.py) and the engine-seam fault injector
(utils/faults.py) attach as ``supervisor`` and ``fault_injector``, both
None by default. Every device call — a bucket call of the DFS kernel
(``_dispatch_padded``/``_finalize_padded``) and a segment
(``dispatch_segment``/``finalize_segment``) — then runs inside a watchdog
token, with the injector's hooks at the launch and at the fetch, and
``solve_one``/``solve_one_supervised`` answer from the host oracle while
the breaker is open and verify every device answer host-side.

Observability (obs/): every finalized bucket call and every segment
records one device-cost sample in ``self.cost`` (obs/cost.py, the
``engine.cost`` block of ``/metrics``); the request span of the calling
thread (obs/trace.current_trace) gets the ``device`` stage of a direct
call and the ``verify`` stage of the supervised answer check;
``health()`` and ``warm_info()`` are the ``engine`` block of
``/metrics``. ``arm_device_trace`` / ``profile_dir`` capture
``torch.profiler`` traces of the warm-up and of bucket calls
(utils/profiling.device_trace).

Warm-up is tiered, as in the JAX engine (``warmup``): tier 0 (the
smallest bucket, the coalescer's batch-cap width and one segment over the
serving pool) flips ``warmed``, then the rest of the ladder widens, inline
or in a background thread, under an optional budget; ``fully_warmed``
flips when every bucket ran. While part of the ladder is cold, bucket
choice prefers the warm widths and ``solve_batch_np`` tiles over the
largest one. ``solve_batch_np_supervised`` is the batch path under the
supervisor's degraded-serving contract (``/solve_batch``).

The frontier race (``frontier_mesh``, parallel/frontier.py): with it,
``solve_one`` answers the easy mass of boards from a short probe (K1 at the
escalation budget, or with ``frontier_handoff`` one K3 segment whose
state seeds the race) and races the rest across their own subtrees on the
race's mesh (the race kernel, K4: one launch on one device, its shard form
on each shard of a mesh and the fold kernel), inline in the calling
thread, as the JAX engine routes them. A race that fails with a device fault is answered from
the bucket path (``frontier_fallbacks``); any other failure reaches the
caller.

The compile plane (compilecache/): the process's kernel library is built
into, and loaded from, a kernel store (``<dir>/kernels`` with
``compile_cache_dir``, else ``_build/``), so a second process loads it
without running ``nvcc``; every warm width's warm-up launch is a
round-trip verification of that library, as the JAX engine verifies an
AOT artifact before it serves (``_verified``). A library that fails twice
stops launching for good and the engine stops being ready. ``solve_batch_resumable_np`` is the batch
path with crash durability: K3 segments in bounded chunks with an atomic
snapshot between them (utils/checkpoint.py).

The mesh plane (``mesh=``, parallel/mesh.py and shard.py): with a mesh,
the bucket ladder rounds to mesh-divisible widths, a bucket call is one
K1 launch a shard, a segment one K3 + K3b launch a shard over a lane pool
split across the shards, every shard at the engine's ``waves`` (as the JAX
mesh programs run), the race spans the shards, warm-up verifies the
library on every shard, and ``mesh_info()`` is the ``engine.mesh`` block
of ``/metrics``. ``mesh="auto"`` (the CLI's default) builds it from every
visible CUDA device, or the virtual mesh ``SUDOKU_VIRTUAL_MESH`` names,
when it has at least two shards. A multi-host leader's bucket calls and
races ride the serving loop instead (``mesh_runner``,
``frontier_runner``: parallel/serving_loop.py).

Not in this slice (each raises ``NotImplementedError`` when asked for):
a choice of backend (the engine always runs the kernel), a solver
configuration preset.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .models.oracle import oracle_is_valid_solution
from .obs.cost import CostAccounting
from .obs.trace import current_trace
from .ops.config import (
    CONTINUOUS_SERVING,
    SEGMENT_PIPELINE,
    SERVING_CONFIG,
    resolved_segment_shape,
    segment_prefix_gather,
)
from .ops.cuda_solver import (
    KernelLaunchError,
    SegmentPool,
    dfs_segment,
    LibraryVerificationError,
    kernel_store,
    library_error,
    library_quarantine,
    library_source,
    lockstep_loop,
    rebuild_library,
    solve_stage,
)
from .ops.propagate import analyze
from .ops.solver import (
    OVERFLOW,
    RUNNING,
    SOLVED,
    LoopStats,
    pad_board,
    staged_depths,
    unsat_pad,
)
from .ops.spec import SPEC_9, BoardSpec
from .serving.admission import DeadlineExceeded
from .utils.faults import InjectedEngineFault
from .utils.profiling import annotate, device_trace

logger = logging.getLogger(__name__)

DEFAULT_BUCKETS = (1, 8, 64, 512, 4096)

# constructor sentinel: "use ops.SERVING_CONFIG for this board size" —
# distinct from an explicit None, which means the spec's full flat depth
_AUTO = object()

# SolverEngine knobs of the JAX package that this port does not have yet.
# Passing one with a value other than None/False raises instead of being
# ignored.
_UNPORTED = frozenset(("backend", "solver_config"))


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the caller's choice, else CUDA.
    Raises when CUDA is wanted and there is none — never a silent CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch solver on the CPU"
        )
    return dev


class SolveStarved(RuntimeError):
    """A supervised solve's future outlived its bound (``_await_result``):
    a hung device call ahead of it in the coalescer. A device fault."""


def device_fault(exc: BaseException) -> bool:
    """Whether ``exc`` is a fault of a device call, which a supervised
    solve or batch answers from the host fallback: an injected fault, a
    kernel launch's CUDA error, a CUDA error that torch raised (out of
    memory included), a solve starved behind a hung device call, or a
    failure of the multi-host serving loop's collective path
    (``ServingLoopError``: a dead loop, a failed collective, no result in
    time). A kernel library that fails to build or load, and any other
    error, is not one: it fails the request."""
    from .parallel.serving_loop import ServingLoopError

    if isinstance(exc, (InjectedEngineFault, KernelLaunchError, SolveStarved,
                        ServingLoopError, torch.cuda.OutOfMemoryError)):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    return isinstance(exc, RuntimeError) and "CUDA error" in str(exc)


class _Inflight(NamedTuple):
    """A dispatched bucket: the first depth stage's rows on their way to
    the host, and what finalizing needs to run the later stages."""

    host: torch.Tensor                 # (B, C+4) rows (C+6 on a mesh); pinned on CUDA
    ready: Optional[torch.cuda.Event]  # recorded after the copy; None on CPU
    dev: torch.Tensor                  # (B, N, N) the padded boards, on device
    boards: np.ndarray                 # the padded boards, on the host
    n: int                             # real (unpadded) rows
    iters: int                         # the call's step budget
    sweeps: dict                       # the call's sweep knobs
    token: Optional[int] = None        # the supervisor's token, if any
    t0: Optional[float] = None         # dispatch time (None: warm-up, deep retry)
    # (stage, start, end) timing events of each device stage run, on the
    # one-card CUDA path only (else None): the cost plane's ``gpu_s``
    timed: Optional[list] = None
    # each depth stage run's loop counts on one device, an int64 pair
    # [the boards' own steps summed, the stage's turns] copied to the host
    # with its rows (``_stage_rows``); None on a mesh or the multi-host
    # fan-out, whose rows carry the shards' LoopStats
    loops: Optional[list] = None


class _SegmentHandle(NamedTuple):
    """A dispatched segment: the pool's next handle (available at dispatch,
    so the segment loop can chain segment N+1 before reading N), the device
    outputs and their host copies, and the accounting ``finalize_segment``
    needs. On the pipelined arm ``host`` holds the digest and ``block`` is
    the device solution block fetched in phase 2; on the full-row arm
    ``host`` holds the (W, C+7) rows and ``block`` is None."""

    state: SegmentPool
    host: torch.Tensor                 # pinned on CUDA
    ready: Optional[torch.cuda.Event]  # recorded after the copy; None on CPU
    block: Optional[torch.Tensor]
    t0: float
    width: int
    injected: int
    pipelined: bool
    boundary_host_s: float
    token: Optional[int] = None        # the supervisor's token, if any
    shards: int = 1                    # the mesh's shards (1: one device)


class SolverEngine:
    """Batched sudoku solving in fixed-width buckets through the DFS kernel.

    Args:
      spec: board geometry (default classic 9×9).
      buckets: ascending batch widths; a request of B boards runs in the
        smallest bucket ≥ B (or tiles over the largest).
      max_depth: guess-stack depth. Unspecified → the staged depth of
        ops.SERVING_CONFIG; explicit None → the spec's full flat depth.
      max_iters: step budget per device call (None → ops.SERVING_CONFIG).
      deep_retry_factor: budget multiplier of the one rerun given to boards
        still RUNNING at ``max_iters``.
      device: "cuda" (default) or "cpu".
      locked_candidates / waves / naked_pairs: the solver's sweep knobs
        (None → ops.SERVING_CONFIG; ``naked_pairs`` then follows the
        config, else ``locked_candidates``). ``waves`` applies to buckets
        wider than 1.
      coalesce: route ``solve_one``/``solve_one_async`` through the
        request coalescer so concurrent requests share one device call
        (default on); False gives every request its own call.
      coalesce_max_wait_s / coalesce_quiescence_s / coalesce_burst_wait_s
        / coalesce_inflight_depth / coalesce_max_batch: the coalescer's
        wait budgets, pipeline depth and batch cap
        (parallel/coalescer.BatchCoalescer).
      coalesce_adaptive: scale the three wait budgets with the measured
        arrival rate (serving/load.AdaptiveWaitPolicy); the configured
        values become caps.
      continuous: serve the coalesced path open loop (continuous
        batching, the segment kernel over a lane pool). None → on when
        ``coalesce`` is (ops.config.CONTINUOUS_SERVING); True needs
        ``coalesce``; False keeps the closed-loop coalescer. Answers are
        the same boards either way; the counters are those of the flat
        depth (and, above one lane, ``waves`` sweeps a step).
      segment_iters: steps per segment (None → ops.config.SEGMENT per
        board size).
      segment_pipeline: the pipelined segment boundary (None → on with
        ``continuous``): the host reads a digest per boundary and the
        segment loop overlaps boundary work with the next segment; False reads
        the full rows every segment, strictly serially.
      deep_lane_cap: with continuous batching, the most lanes boards
        resident past a few boundaries may hold while requests queue; the
        overage is evicted to the deep retry. 0 = no cap.
      frontier_mesh: route single-board solves through the frontier race
        (parallel/frontier.race_mesh): ``"auto"`` or True races across the
        engine's mesh, or on its device (a CPU engine runs the plain
        race); a ``Mesh``, a sequence of devices (each once) or one device
        races there; None (default) keeps the bucket path.
      frontier_states_per_device: states the race seeds a shard (at
        least; padded to shards × this × 2^k).
      frontier_route: ``"auto"`` answers a board from a probe at
        ``frontier_escalate_iters`` steps and races only boards the probe
        left RUNNING (or OVERFLOWed); ``"always"`` races every board.
      frontier_handoff: seed an escalated race from the probe's
        unexplored subtrees instead of the board's root.
      compile_cache_dir: root of the compile plane (compilecache/): the
        process's kernel library is built into, and loaded from, the
        kernel store under ``<dir>/kernels`` (first wins: a process whose
        store is already fixed keeps it, with a warning). None (default):
        the store is ``_build/`` beside the package. Either way every warm
        width's warm-up launch verifies the library by a round-trip solve
        before it serves; a library that fails is invalidated, rebuilt
        once and verified again at every warm width, and a second failure
        raises, stops the library's launches and the engine's readiness.
      aot_artifacts: with ``compile_cache_dir``, keep the store there
        (default True). False keeps the build directory (``_build/``).
      mesh: the mesh plane: ``"auto"`` (a mesh over every visible CUDA
        device, or the virtual mesh ``SUDOKU_VIRTUAL_MESH`` names, when it
        has at least ``ops.config.MESH_SERVING["auto_min_devices"]``
        shards of the engine's device type), a ``parallel.mesh.Mesh``, or
        None (default). Bucket widths round up to mesh-divisible
        multiples (``requested_buckets`` keeps the asked-for ladder).
      bucket_multiple: round the ladder to multiples of this instead (the
        multi-host CLI passes the global shard count).
      sharding: a raw ``parallel.mesh.data_sharding(mesh)``: bucket calls
        split over its mesh without the mesh plane (the ladder must
        divide it; the closed loop). Exclusive with an explicit ``mesh``.
    """

    def __init__(
        self,
        spec: BoardSpec = SPEC_9,
        *,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        max_depth=_AUTO,
        max_iters: Optional[int] = None,
        deep_retry_factor: int = 16,
        device=None,
        locked_candidates: Optional[bool] = None,
        waves: Optional[int] = None,
        naked_pairs: Optional[bool] = None,
        coalesce: bool = True,
        coalesce_max_wait_s: float = 0.002,
        coalesce_quiescence_s: float = 0.001,
        coalesce_burst_wait_s: Optional[float] = None,
        coalesce_inflight_depth: int = 2,
        coalesce_max_batch: Optional[int] = None,
        coalesce_adaptive: bool = False,
        continuous: Optional[bool] = None,
        segment_iters: Optional[int] = None,
        segment_pipeline: Optional[bool] = None,
        deep_lane_cap: int = 0,
        frontier_mesh=None,
        frontier_states_per_device: int = 64,
        frontier_route: str = "auto",
        frontier_escalate_iters: int = 512,
        frontier_handoff: bool = False,
        compile_cache_dir: Optional[str] = None,
        aot_artifacts: bool = True,
        mesh=None,
        bucket_multiple: Optional[int] = None,
        sharding=None,
        **unported,
    ):
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError(f"SolverEngine got an unexpected argument {name!r}")
            if value is not None and value is not False:
                raise NotImplementedError(
                    f"SolverEngine({name}=...) is not ported yet"
                )
        self.spec = spec
        self.device = resolve_device(device)
        # the mesh plane: resolved before the bucket ladder, whose widths
        # round to mesh-divisible multiples so every batch splits over
        # every shard
        mesh = self._resolve_mesh(mesh, sharding, device)
        self.mesh = mesh
        # the mesh the bucket programs shard over: the mesh plane's, or a
        # raw ``sharding=``'s (which keeps the caller's ladder and the
        # closed loop, as the JAX engine keeps them)
        self._shard_mesh = mesh if mesh is not None else (
            sharding.mesh if sharding is not None else None
        )
        if self._shard_mesh is not None:
            self.device = self._shard_mesh.primary
        if mesh is not None:
            from .parallel.mesh import data_sharding

            sharding = data_sharding(mesh)
        self.sharding = sharding
        # the multi-host leader's fan-out hooks (parallel/serving_loop.py,
        # wired by the CLI): a callable (padded boards, iters) -> host rows
        # that bucket dispatches ride, and a callable board -> (solution,
        # info) that races ride; ``frontier_loop`` is the loop itself, for
        # health. None: this engine's own programs.
        self.mesh_runner = None
        self.frontier_runner = None
        self.frontier_loop = None
        # the compile plane: the kernel store the process's library comes
        # from, verified by every warm width's launch
        self.compile_cache_dir = compile_cache_dir
        # warm_info reports the store's counters (``aot``) where the JAX
        # engine does: with a cache dir and its AOT artifacts on
        self._report_aot = bool(compile_cache_dir and aot_artifacts)
        if self._report_aot:
            from .compilecache import enable_persistent_cache

            enable_persistent_cache(compile_cache_dir)
        self._store = kernel_store()
        # each verified width's round trip by name, run again on a rebuild
        self._round_trips: dict = {}
        self.frontier_mesh = frontier_mesh
        # the mesh the race runs on (None: no local race) and its first
        # device, where the race folds
        self.race_mesh = self._race_mesh(frontier_mesh)
        self.frontier_device = (
            self.race_mesh.primary if self.race_mesh is not None else None
        )
        self.frontier_states_per_device = frontier_states_per_device
        if frontier_route not in ("auto", "always"):
            raise ValueError(
                f"frontier_route must be 'auto' or 'always', got "
                f"{frontier_route!r}"
            )
        self.frontier_route = frontier_route
        self.frontier_escalate_iters = frontier_escalate_iters
        self.frontier_handoff = bool(frontier_handoff)
        buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.requested_buckets = buckets
        if mesh is not None or bucket_multiple:
            from .ops.config import mesh_serving_config

            fill = mesh_serving_config()["min_per_device_fill"]
            mult = int(bucket_multiple or mesh.size * fill)
            buckets = tuple(sorted({-(-b // mult) * mult for b in buckets}))
            if buckets != self.requested_buckets:
                logger.info(
                    "mesh serving: bucket ladder %s rounded to mesh-divisible "
                    "%s (multiple %d)", self.requested_buckets, buckets, mult,
                )
        elif sharding is not None:
            bad = [b for b in buckets if b % sharding.mesh.size]
            if bad:
                raise ValueError(
                    f"buckets {bad} do not divide the {sharding.mesh.size}-shard "
                    "mesh of sharding= (the mesh plane, mesh=, rounds them)"
                )
        self.buckets = buckets
        # mesh dispatch counters (under _lock): how many sharded dispatches
        # ran and how the last one landed (parallel/shard.split_evidence),
        # the mesh_info() / /metrics evidence
        self.mesh_dispatches = 0
        self.mesh_runner_dispatches = 0
        self._mesh_last_split: dict = {}
        self._mesh_min_devices: Optional[int] = None
        cfg = SERVING_CONFIG.get(spec.size, {})
        if max_depth is _AUTO:
            max_depth = cfg.get("max_depth")
        self.max_depth = max_depth
        self._depths = staged_depths(max_depth, spec)
        if max_iters is None:
            max_iters = cfg.get("max_iters", 4096)
        self.max_iters = max_iters
        self.deep_retry_factor = deep_retry_factor
        if locked_candidates is None:
            locked_candidates = cfg.get("locked_candidates", True)
        self.locked_candidates = bool(locked_candidates)
        if waves is None:
            waves = cfg.get("waves", 1)
        if int(waves) < 1:
            raise ValueError(f"waves must be >= 1, got {waves}")
        self.waves = int(waves)
        if naked_pairs is None:
            naked_pairs = cfg.get("naked_pairs", self.locked_candidates)
        self.naked_pairs = bool(naked_pairs)
        self.coalesce = coalesce
        self.coalesce_max_wait_s = coalesce_max_wait_s
        self.coalesce_quiescence_s = coalesce_quiescence_s
        self.coalesce_burst_wait_s = coalesce_burst_wait_s
        self.coalesce_inflight_depth = coalesce_inflight_depth
        self.coalesce_max_batch = coalesce_max_batch
        self.coalesce_adaptive = coalesce_adaptive
        self.segment_shape = resolved_segment_shape(spec.size, segment_iters)
        self.segment_iters = self.segment_shape["k"]
        raw_sharding = sharding is not None and mesh is None
        if continuous is None:
            continuous = (
                CONTINUOUS_SERVING["default_on"] and coalesce and not raw_sharding
            )
        elif continuous and not coalesce:
            raise ValueError(
                "continuous batching rides the coalesced serving path — it "
                "cannot be enabled with coalesce=False"
            )
        elif continuous and raw_sharding:
            raise ValueError(
                "continuous batching with a raw sharding= needs the mesh "
                "plane (mesh=) — the lane-pool state has no sharded segment "
                "program to ride otherwise"
            )
        self.continuous = bool(continuous)
        if segment_pipeline is None:
            segment_pipeline = SEGMENT_PIPELINE["default_on"] and self.continuous
        elif segment_pipeline and not self.continuous:
            raise ValueError(
                "segment_pipeline=True needs continuous batching — the "
                "pipelined boundary is the continuous path's segment seam"
            )
        self.segment_pipeline = bool(segment_pipeline)
        self.deep_lane_cap = int(deep_lane_cap)
        # segments resume mid-search, so the pool runs the largest stage's
        # depth: a staged depth's shallow first stage cannot apply
        self._depth_flat = max(self._depths)
        # the mesh programs (parallel/shard.py): one K1 launch a shard a
        # bucket call, one K3 + K3b launch a shard a segment, each shard at
        # the engine's ``waves`` whatever its width, as the JAX mesh
        # programs run
        self._mesh_program = self._segment_mesh_program = None
        if self._shard_mesh is not None:
            from .parallel.shard import (
                make_packed_serving_program,
                make_segment_serving_program,
            )

            knobs = dict(
                max_depth=self.max_depth,
                locked_candidates=self.locked_candidates,
                waves=self.waves,
                naked_pairs=self.naked_pairs,
            )
            self._mesh_program = make_packed_serving_program(
                self._shard_mesh, spec, **knobs
            )
            if mesh is not None:
                self._segment_mesh_program = make_segment_serving_program(
                    mesh, spec, **dict(knobs, max_depth=self._depth_flat),
                )
        self._coalescer = None
        self._coalescer_init_lock = threading.Lock()
        # the stream finalizing runs later depth stages and deep retries
        # on (None on the CPU): off the dispatcher's stream, so they never
        # queue behind the next batch's launch
        self._side_stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )
        # the streams a segment's solution block is fetched on and the
        # refill stack is pre-staged on: off the segment stream, so neither
        # waits for a segment queued after the one it serves
        self._fetch_stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )
        self._stage_stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )
        # the digest columns of the full-row arm's rows, made once: a list
        # index on a CUDA tensor would copy it from pageable memory and
        # wait for the stream at every segment
        self._row_cols = torch.tensor([1, 0, 2, 3, 4, 6, 7], device=self.device)
        self._lock = threading.Lock()
        # cumulative engine effort, the analog of the reference's
        # `validations` counter: one unit per analysis sweep per board
        self.validations = 0
        self.solved_puzzles = 0
        # /solve requests answered by the bucket path because the race
        # failed with a device fault, and auto-routed requests whose probe
        # escalated them to the race: /metrics health signals
        self.frontier_fallbacks = 0
        self.frontier_escalations = 0
        # tiered warm-up (``warmup``): ``warmed`` flips once tier 0 ran
        # (the node is servable), ``fully_warmed`` once every bucket did.
        # While a warm-up has left part of the ladder cold, bucket choice
        # prefers warm widths (``_tiling_active``)
        self.warmed = False
        self.fully_warmed = False
        self._warm_skipped: list = []  # buckets a warm-up budget cut off
        self._warmup_started = False
        self._warm_thread: Optional[threading.Thread] = None
        # the segment pool's width once its warm segment ran (None before):
        # with the warm buckets, the widths whose first launch the
        # supervisor's watchdog no longer excuses (``_watched_widths``)
        self._pool_warm_width: Optional[int] = None
        # failure-domain supervision (serving/health.EngineSupervisor sets
        # itself here) and the engine-seam fault injector
        # (utils/faults.EngineFaultInjector); None costs nothing
        self.supervisor = None
        self.fault_injector = None
        # device cost accounting (obs/cost.py): one sample per finalized
        # bucket call and per segment, never per request — the /metrics
        # "engine.cost" block
        self.cost = CostAccounting()
        # warm-up record per width ({warm, source, compile_s}), the order
        # warm-up ran them, and the distinct (variant, width) launch shapes
        # seen: the /metrics "engine.warm" block (warm_info)
        self._warm_state: dict = {}
        self._warm_order: list = []
        self._programs: set = set()
        # torch.profiler captures (utils/profiling.device_trace): with
        # ``profile_dir`` set every bucket call is traced; armed by
        # ``arm_device_trace``, the first warm-up and the next N bucket
        # calls are. One capture per process at a time: a call that finds
        # the mutex held runs untraced.
        self.profile_dir: Optional[str] = None
        self._profile_mutex = threading.Lock()
        self.device_trace_dir: Optional[str] = None
        self._device_trace_budget = 0
        self._device_trace_captured = 0
        self._warmup_trace_done = False

    def _resolve_mesh(self, mesh, sharding, device):
        """The mesh plane from ``mesh=``: ``"auto"`` is ``default_mesh()``
        (every visible CUDA device, or the virtual mesh
        ``SUDOKU_VIRTUAL_MESH`` names) when it has at least
        ``auto_min_devices`` shards of the engine's device type, else no
        mesh; a ``Mesh`` is itself; None is no mesh. ``sharding=`` and an
        explicit mesh are mutually exclusive, and ``"auto"`` yields to a
        raw ``sharding=``, as in the JAX engine."""
        from .parallel.mesh import Mesh, default_mesh, virtual_mesh_setting

        if sharding is not None and not hasattr(sharding, "mesh"):
            raise TypeError(
                "sharding= takes a parallel.mesh.data_sharding(mesh) descriptor"
            )
        if mesh is None:
            return None
        if isinstance(mesh, str):
            if mesh != "auto":
                raise ValueError(f"mesh must be 'auto', a Mesh or None, got {mesh!r}")
            from .ops.config import mesh_serving_config

            if sharding is not None:
                return None
            setting = virtual_mesh_setting()
            if setting is not None:
                if setting[1].type != self.device.type:
                    return None
            elif self.device.type != "cuda":
                return None
            found = default_mesh()
            if found.size < mesh_serving_config()["auto_min_devices"]:
                return None
            return found
        if sharding is not None:
            raise ValueError(
                "mesh= and sharding= are mutually exclusive — the mesh plane "
                "derives its own data-axis sharding"
            )
        if not isinstance(mesh, Mesh) or "data" not in mesh.axis_names:
            raise ValueError(
                "mesh= must be a 1-D parallel.mesh.Mesh with a 'data' axis, "
                f"got {mesh!r}"
            )
        if device is not None and torch.device(device).type != mesh.primary.type:
            raise ValueError(
                f"device={device!r} and a mesh on {mesh.primary} disagree"
            )
        return mesh

    def _race_mesh(self, mesh):
        """``frontier_mesh`` as the race's mesh (None: no local race):
        ``"auto"`` or True races over the engine's mesh, or its device."""
        if mesh is None or mesh is False:
            return None
        from .parallel.frontier import race_mesh

        if mesh is True or mesh == "auto":
            return self._shard_mesh if self._shard_mesh is not None else race_mesh(self.device)
        return race_mesh(mesh)

    @property
    def frontier_enabled(self) -> bool:
        """True when single-board solves route through the frontier race
        (a local mesh, or the multi-host serving loop's ``frontier_runner``)."""
        return self.race_mesh is not None or self.frontier_runner is not None

    @property
    def coalescer(self):
        """The engine's request coalescer, created (threads started) on
        first use. One per engine: the shared queue IS the batching."""
        if self._coalescer is None:
            with self._coalescer_init_lock:
                if self._coalescer is None:
                    from .parallel.coalescer import BatchCoalescer

                    wait_policy = None
                    if self.coalesce_adaptive:
                        from .serving.load import AdaptiveWaitPolicy

                        wait_policy = AdaptiveWaitPolicy(
                            max_wait_s=self.coalesce_max_wait_s,
                            quiescence_s=self.coalesce_quiescence_s,
                            burst_wait_s=self.coalesce_burst_wait_s,
                        )
                    self._coalescer = BatchCoalescer(
                        self,
                        max_wait_s=self.coalesce_max_wait_s,
                        quiescence_s=self.coalesce_quiescence_s,
                        burst_wait_s=self.coalesce_burst_wait_s,
                        inflight_depth=self.coalesce_inflight_depth,
                        max_batch=self.coalesce_max_batch,
                        wait_policy=wait_policy,
                        continuous=self.continuous,
                        deep_lane_cap=self.deep_lane_cap,
                    )
        return self._coalescer

    def close(self) -> None:
        """Drain and stop the coalescer (futures resolve before return)
        and the supervisor's watchdog when one is attached. Safe on an
        engine that never coalesced; idempotent."""
        if self._coalescer is not None:
            self._coalescer.close()
        if self.supervisor is not None:
            self.supervisor.close()

    # -- internals ---------------------------------------------------------
    def _warm_widths(self) -> list:
        """The bucket widths whose warm-up launch ran, as the JAX engine
        reads them: what tiling may use while the ladder is cold."""
        with self._lock:
            return sorted(
                b for b, st in self._warm_state.items() if st.get("warm")
            )

    def _watched_widths(self) -> list:
        """The widths whose first launch has run: the warm buckets, and the
        segment pool's width once its warm segment ran. The supervisor's
        watchdog excuses a first launch at any other width."""
        widths = set(self._warm_widths())
        with self._lock:
            if self._pool_warm_width is not None:
                widths.add(self._pool_warm_width)
        return sorted(widths)

    def _tiling_active(self) -> bool:
        """True while a tiered warm-up has left part of the ladder cold
        (mid-background widening, or cut off by a warm-up budget): bucket
        choice then prefers warm widths, and oversize batches tile over
        the largest warm width. Engines that never called ``warmup`` (or
        finished it) choose as before."""
        return self._warmup_started and not self.fully_warmed

    def _bucket_for(self, n: int) -> int:
        # widths the supervisor quarantined (hung/failed calls) are routed
        # around — the next covering width serves instead; if EVERY
        # covering width is quarantined the original choice stands (the
        # caller's failure handling / fallback is the backstop)
        quarantined = (
            self.supervisor.quarantined_widths()
            if self.supervisor is not None
            else ()
        )
        if self._tiling_active():
            for b in self._warm_widths():
                if n <= b and b not in quarantined:
                    return b
            # wider than every warm width: the cold ladder serves (a
            # direct dispatch cannot tile; solve_batch_np bounds its
            # chunks by the largest warm width instead)
        for b in self.buckets:
            if n <= b and b not in quarantined:
                return b
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _device_batch(self, boards: np.ndarray) -> torch.Tensor:
        """Host boards → the engine's device, without a host sync on CUDA
        (a copy from pageable memory would wait for the stream)."""
        return self._host_batch(boards).to(self.device, non_blocking=True)

    def _host_batch(self, boards: np.ndarray) -> torch.Tensor:
        """Host boards as an int32 tensor, pinned on CUDA so that their copy
        to the card does not wait."""
        t = torch.from_numpy(np.ascontiguousarray(boards, dtype=np.int32))
        return t.pin_memory() if self.device.type == "cuda" else t

    def _stage_event(self) -> torch.cuda.Event:
        """A timing event recorded on the current stream: the start of a
        device stage the cost plane times (``gpu_s``)."""
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    @property
    def _times_stages(self) -> bool:
        """Whether bucket calls time their device stages with CUDA events:
        on one card. The mesh's shards run on streams of their own and the
        multi-host fan-out on other hosts, so neither records ``gpu_s``;
        nor does the CPU."""
        return self.device.type == "cuda" and self._mesh_program is None

    def _sweeps(self, width: int) -> dict:
        """The sweep knobs of a ``width``-board call: a single board sweeps
        once a step — extra sweeps only amortize a step's machinery over a
        batch — and wider buckets run ``self.waves``. The mesh programs run
        ``self.waves`` at every width, as the JAX mesh programs do."""
        return dict(
            locked_candidates=self.locked_candidates,
            waves=1 if width == 1 and self._shard_mesh is None else self.waves,
            naked_pairs=self.naked_pairs,
        )

    def _stage_rows(self, dev: torch.Tensor, depth: int, iters: int,
                    sweeps: dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """One depth stage on one device: the packed (B, C+4) int32 rows
        [grid | solved | status | guesses | validations] and the stage's
        loop counts, an int64 pair [Σ the boards' own steps, the most
        steps of any board] (``solve_stage``'s LoopStats and ``iters``),
        which ``_loop_stats`` turns into lockstep counts on the host.
        Built on the device, so no host sync."""
        res, stats = solve_stage(dev, self.spec, depth, iters, **sweeps)
        B = dev.shape[0]
        rows = torch.cat(
            [
                res.grid.reshape(B, -1),
                res.solved[:, None].to(torch.int32),
                res.status[:, None],
                res.guesses[:, None],
                res.validations[:, None],
            ],
            dim=1,
        )
        own = torch.as_tensor(stats.lane_steps, device=dev.device)
        turns = torch.as_tensor(res.iters, device=dev.device)
        return rows, torch.stack([own, turns])

    def _loop_stats(self, call: _Inflight, rows: np.ndarray) -> LoopStats:
        """A finished call's LoopStats, lockstep counts on every path: on a
        mesh or the multi-host fan-out the shards' sums in its rows' two
        trailing columns (``parallel/shard.py``); on one device, from its
        depth stages' loop counts (``call.loops``), as a lockstep loop
        over the call's width that turned as often as its stages' longest
        boards stepped. Python ints, which do not wrap (a 4096-wide stage
        of 2**20 steps is 2**32 lane-steps)."""
        if call.loops is None:
            C = self.spec.cells
            return LoopStats(int(rows[0, C + 4]), int(rows[0, C + 5]))
        own = turns = 0
        for pair in call.loops:
            o, t = pair.tolist()
            own, turns = own + o, turns + t
        return lockstep_loop(own, turns, call.boards.shape[0])

    def _note_program(self, name: str, width: int) -> None:
        """Record a distinct (variant, width) launch shape, counted by
        ``warm_info()["programs"]``."""
        key = (name, int(width))
        if key not in self._programs:
            with self._lock:
                self._programs.add(key)

    def _launch(self, boards: np.ndarray, n: int, iters: int,
                token: Optional[int] = None,
                t0: Optional[float] = None) -> _Inflight:
        """Enqueue the first depth stage of the padded ``boards`` and the
        copy of its rows to the host; no host sync. On one card the stage
        is timed by CUDA events, from just before the boards' copy to the
        card to the rows' copy back (``ready``)."""
        timed = [] if self._times_stages else None
        with annotate("engine.h2d"):
            src = self._host_batch(boards)
            start = self._stage_event() if timed is not None else None
            dev = src.to(self.device, non_blocking=True)
        with annotate("engine.launch"):
            self._note_program("solve", boards.shape[0])
            sweeps = self._sweeps(boards.shape[0])
            if self._mesh_program is not None:
                # one K1 launch a shard, the rows gathered in global order
                rows = self._mesh_program.dispatch(dev, iters)
                self._note_split(self._mesh_program)
                loops = None
            else:
                rows, loop = self._stage_rows(dev, self._depths[0], iters, sweeps)
                loops = [self._pinned_copy(loop)]
            host, ready = self._to_host(rows, timing=start is not None)
        if timed is not None:
            timed.append(("first", start, ready))
        return _Inflight(host, ready, dev, boards, n, iters, sweeps, token, t0,
                         timed, loops)

    def _note_split(self, program) -> None:
        """Count one sharded dispatch and how it landed (the mesh_info()
        evidence)."""
        from .parallel.shard import split_evidence

        split = split_evidence(program)
        with self._lock:
            self.mesh_dispatches += 1
            self._mesh_last_split = split
            ndev = split.get("devices", 1)
            if self._mesh_min_devices is None or ndev < self._mesh_min_devices:
                self._mesh_min_devices = ndev

    @staticmethod
    def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
        """A device tensor's copy into pinned host memory, enqueued on the
        current stream without a host sync (it may be read once an event
        recorded after it has completed); a CPU tensor as it is."""
        if t.device.type == "cpu":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    @staticmethod
    def _to_host(t: torch.Tensor, timing: bool = False):
        """``(host, ready)``: ``_pinned_copy`` of a device tensor with the
        event recorded after it (a timing event with ``timing``), without a
        host sync; a CPU tensor as it is, with no event."""
        if t.device.type == "cpu":
            return t, None
        host = SolverEngine._pinned_copy(t)
        ready = torch.cuda.Event(enable_timing=timing)
        ready.record(torch.cuda.current_stream(t.device))
        return host, ready

    def _follow_up(self):
        """Context for finalizing's device work (a deeper depth stage, the
        deep retry): the engine's side stream on CUDA, nothing on the CPU.
        Entered only around that work, so a call that needs none switches
        no stream."""
        if self._side_stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._side_stream)

    def _wait_rows(self, call: _Inflight) -> np.ndarray:
        """The host rows of a launched call once every depth stage ran:
        waits for the first stage's copy, then reruns the boards that hit
        OVERFLOW at each deeper stage — every other lane a pad board, as
        ``ops.solver.solve_staged`` does — taking their grid and status and
        accumulating their guesses and validations, on the side stream
        (``_follow_up``). Each rerun's loop counts join ``call.loops``; on
        one card each rerun is timed by CUDA events into ``call.timed``,
        read after the wait it already makes."""
        with annotate("engine.wait"):
            if call.ready is not None:
                call.ready.synchronize()
        with annotate("engine.rows"):
            rows = call.host.numpy().copy()
        if call.dev is None:
            return rows  # the multi-host fan-out's rows, every stage run
        if self._mesh_program is not None:
            # each shard reruns its own OVERFLOW boards, as each shard of
            # the JAX program runs its staged solve
            with annotate("engine.rerun"), self._follow_up():
                return self._mesh_program.restage(rows, call.dev, call.iters)
        C = self.spec.cells
        for depth in self._depths[1:]:
            with annotate("engine.rows"):
                need = rows[:, C + 1] == OVERFLOW
                if not need.any():
                    continue
            with annotate("engine.rerun"), self._follow_up():
                dev = call.dev
                start = self._stage_event() if call.timed is not None else None
                g2 = torch.where(
                    torch.as_tensor(need).to(dev.device)[:, None, None],
                    dev,
                    pad_board(self.spec, dev.device),
                )
                r2, loop = self._stage_rows(g2, depth, call.iters, call.sweeps)
                call.loops.append(self._pinned_copy(loop))
                host, done = self._to_host(r2, timing=start is not None)
                if done is not None:
                    done.synchronize()
                r2 = host.numpy()
                if start is not None:
                    call.timed.append(("rerun", start, done))
                rows[need, : C + 2] = r2[need, : C + 2]
                rows[need, C + 2: C + 4] += r2[need, C + 2: C + 4]
        return rows

    def _dispatch_padded(self, boards: np.ndarray) -> _Inflight:
        """Pad ≤bucket boards into their bucket and enqueue one device call.
        Returns as soon as the work is enqueued (no host sync), so a caller
        (the coalescer's dispatcher thread) can stack batch N+1 while batch
        N runs; ``_finalize_padded`` takes the handle.

        The supervised seam (serving/health.py): a watchdog token opens
        here and closes in ``_finalize_padded``, so the supervisor bounds
        the wall time of the whole dispatch→fetch span; the engine-seam
        fault injector (utils/faults.py) plugs in at the same two points.

        With a device trace armed (``arm_device_trace``) or ``profile_dir``
        set, the launch runs inside a ``torch.profiler`` capture when the
        profile mutex is free; such a capture waits for the call's device
        work before it stops."""
        n = boards.shape[0]
        sup = self.supervisor
        token = None
        try:
            with annotate("engine.pad"):
                bucket = self._bucket_for(n)
                if sup is not None:
                    token = sup.call_started(bucket)
                # the dispatch anchor rides the handle: _finalize_padded
                # bills the whole dispatch→fetch span to the cost plane
                t0 = time.monotonic()
                inj = self.fault_injector
                if inj is not None:
                    inj.on_device_call(bucket)  # may raise (fail-next-N)
                if n < bucket:
                    # Pad with COPIES of a real row, not empty boards: a
                    # block of boards runs until its slowest board
                    # finishes, and a copy of boards[0] adds no step to the
                    # call by construction.
                    pad = np.broadcast_to(boards[0], (bucket - n, *boards.shape[1:]))
                    boards = np.concatenate([boards, pad], axis=0)
            if self.mesh_runner is not None:
                return self._run_on_mesh_runner(boards, n, self.max_iters, token, t0)
            trace_dir = self._take_trace_dir()
            if trace_dir is None:
                return self._launch(boards, n, self.max_iters, token, t0)
            try:
                with device_trace(trace_dir), annotate(f"solve_bucket_{bucket}"):
                    return self._launch(boards, n, self.max_iters, token, t0)
            finally:
                self._profile_mutex.release()
        except BaseException:
            if token is not None:
                sup.call_finished(token, ok=False)
            raise

    def _run_on_mesh_runner(self, boards: np.ndarray, n: int, iters: int,
                            token: Optional[int] = None,
                            t0: Optional[float] = None) -> _Inflight:
        """The multi-host leader's bucket call: the padded batch rides the
        serving loop's fan-out (``mesh_runner``), which every host's shards
        join; its rows come back on the host with every depth stage run."""
        rows = np.asarray(self.mesh_runner(boards, int(iters)), np.int32)
        with self._lock:
            self.mesh_runner_dispatches += 1
        return _Inflight(torch.from_numpy(rows.copy()), None, None, boards, n,
                         iters, self._sweeps(boards.shape[0]), token, t0)

    def _take_trace_dir(self) -> Optional[str]:
        """The directory this bucket call's profiler capture goes to, with
        the profile mutex held (the caller releases it), or None: an armed
        device-trace capture spends one of its budgeted calls; else
        ``profile_dir``; else nothing, and nothing is held."""
        if self.device_trace_dir is None and self.profile_dir is None:
            return None
        if not self._profile_mutex.acquire(blocking=False):
            return None
        with self._lock:
            if self.device_trace_dir is not None and self._device_trace_budget > 0:
                self._device_trace_budget -= 1
                self._device_trace_captured += 1
                return self.device_trace_dir
        if self.profile_dir is not None:
            return self.profile_dir
        self._profile_mutex.release()
        return None

    def _finalize_padded(self, call: _Inflight) -> np.ndarray:
        """Wait for a ``_dispatch_padded`` call (its later depth stages
        included) and rerun the boards still RUNNING at the budget once at
        ``deep_retry_factor ×`` it, in the smallest covering bucket,
        accumulating their guesses and validations. Returns the packed
        (n, C+4) host rows [grid | solved | status | guesses |
        validations]; a mesh's carry the shards' LoopStats after them, the
        JAX layout, which every result reader slices off. The call, and the
        deep retry apart, each record one cost sample. The dispatch's
        supervision token closes here however the fetch ends."""
        sup = self.supervisor
        try:
            rows = self._finalize_padded_inner(call)
        except BaseException:
            if sup is not None:
                sup.call_finished(call.token, ok=False)
            raise
        if sup is not None:
            sup.call_finished(call.token, ok=True)
        return rows

    def _finalize_padded_inner(self, call: _Inflight) -> np.ndarray:
        C = self.spec.cells
        n = call.n
        inj = self.fault_injector
        if inj is not None:
            # before the event wait: an injected delay reads as a hang,
            # not as slow device time
            inj.on_fetch(call.boards.shape[0])
        rows = self._wait_rows(call)
        if inj is not None:
            rows = inj.corrupt(call.boards.shape[0], rows)
        with annotate("engine.cost"):
            # the cost sample, before the deep-retry merge can overwrite
            # a mesh's LoopStats columns of capped rows: the whole
            # dispatch→fetch wall, the real fill, this call's counters
            self._record_call_cost(
                call.boards.shape[0], n, time.monotonic() - call.t0,
                *self._loop_stats(call, rows), gpu_s=self._gpu_s(call.timed),
            )
            running = rows[:n, C + 1] == RUNNING
            capped = np.flatnonzero(running) if running.any() else None
        if capped is not None:
            with annotate("engine.deep_retry"), self._follow_up():
                self._deep_retry(call, rows, capped)
        return rows[:n]

    def _deep_retry(self, call: _Inflight, rows: np.ndarray,
                    capped: np.ndarray) -> None:
        """Rerun the ``capped`` rows of a finished call once at
        ``deep_retry_factor ×`` its budget, in the smallest covering
        bucket, and merge them into ``rows``, accumulating their guesses
        and validations. The retry records its own cost sample."""
        C = self.spec.cells
        sub = call.boards[capped]
        bucket2 = self._bucket_for(len(capped))
        if len(capped) < bucket2:
            sub = np.concatenate(
                [
                    sub,
                    np.broadcast_to(
                        sub[0], (bucket2 - len(capped), *sub.shape[1:])
                    ),
                ],
                axis=0,
            )
        t_deep = time.monotonic()
        deep_iters = self.max_iters * self.deep_retry_factor
        # the deep retry is a collective too on the multi-host leader: it
        # rides the loop as the first pass did
        retry = (
            self._run_on_mesh_runner(sub, len(capped), deep_iters)
            if self.mesh_runner is not None
            else self._launch(sub, len(capped), deep_iters)
        )
        deep = self._wait_rows(retry)
        # the deep retry is its own device call: its own sample
        gpu_s = self._gpu_s(retry.timed)
        self._record_call_cost(
            sub.shape[0], len(capped), time.monotonic() - t_deep,
            *self._loop_stats(retry, deep), deep_retry=True,
            gpu_s=None if gpu_s is None else {"deep_retry": sum(gpu_s.values())},
        )
        first = rows[capped].copy()
        rows[capped] = deep[: len(capped)]
        rows[capped, C + 2] += first[:, C + 2]
        rows[capped, C + 3] += first[:, C + 3]

    @staticmethod
    def _gpu_s(timed: Optional[list]) -> Optional[dict]:
        """Device-clock seconds of a call's timed stages, by stage, or None
        where the call was not timed. Every event has completed by now
        (the call's waits came after them), so no host sync."""
        if timed is None:
            return None
        out: dict = {}
        for stage, start, end in timed:
            out[stage] = out.get(stage, 0.0) + 1e-3 * start.elapsed_time(end)
        return out

    def _record_call_cost(self, bucket: int, n: int, device_s: float,
                          lane: int, idle: int, deep_retry: bool = False,
                          gpu_s: Optional[dict] = None) -> None:
        """Fold one finalized device call into the cost plane
        (obs/cost.py), splitting the pad rows as the JAX engine does:
        those short of the requested ladder width bill the coalescer, the
        extra width the mesh rounding added bills the mesh. ``gpu_s``: the
        call's device-clock seconds by stage, on one card."""
        req_cover = next((w for w in self.requested_buckets if w >= n), None)
        if req_cover is not None and req_cover <= bucket:
            pad_coalesce, pad_mesh = req_cover - n, bucket - req_cover
        else:
            # the rounded width is narrower than any requested cover (or n
            # overflows the ladder): everything bills the coalescer
            pad_coalesce, pad_mesh = bucket - n, 0
        self.cost.record_call(
            bucket=bucket,
            boards=n,
            pad_coalesce=pad_coalesce,
            pad_mesh=pad_mesh,
            device_s=device_s,
            lane_steps=lane,
            idle_lane_steps=idle,
            deep_retry=deep_retry,
            gpu_s=gpu_s,
        )

    def _solve_padded(self, boards: np.ndarray) -> np.ndarray:
        """Solve ≤bucket boards: ``_dispatch_padded`` then
        ``_finalize_padded`` in the calling thread. The caller's request
        span (when one is open: the ``--no-coalesce`` /solve path)
        accumulates the call's wall time as its ``device`` stage here;
        coalesced requests are stamped by the coalescer's threads."""
        tr = current_trace()
        if tr is None:
            return self._finalize_padded(self._dispatch_padded(boards))
        t0 = time.monotonic()
        try:
            rows = self._finalize_padded(self._dispatch_padded(boards))
        finally:
            tr.mark("device", time.monotonic() - t0)
        tr.bucket = self._bucket_for(boards.shape[0])
        return rows

    # -- continuous batching: the segment seam ---------------------------------
    @property
    def continuous_active(self) -> bool:
        """Whether the coalesced path serves open loop: the flag, unless the
        multi-host ``mesh_runner`` fan-out is wired (that path speaks the
        closed loop's (boards, iters) protocol), as in the JAX engine."""
        return self.continuous and self.mesh_runner is None

    def segment_pool_width(self) -> int:
        """The lane pool's width: the bucket covering the coalescer's
        batch cap (the largest bucket by default)."""
        cap = min(self.coalesce_max_batch or self.buckets[-1], self.buckets[-1])
        return self._bucket_for(cap)

    def new_segment_pool(self, width: int) -> SegmentPool:
        """A fresh pool on the engine's device, every lane on the
        instantly-UNSAT pad board (dead after one sweep, then free), with
        the flat depth's stack. Its state stays on the device; segments
        update it in place."""
        if self._segment_mesh_program is not None:
            # one pool a shard, each on its device and stream
            return self._segment_mesh_program.new_pool(width)
        N = self.spec.size
        boards = pad_board(self.spec, self.device).expand(width, N, N)
        return SegmentPool.fresh(boards, self.spec, self._depth_flat)

    def dispatch_segment(
        self,
        state: SegmentPool,
        boards,
        inject=None,
        *,
        src=None,
        seg_iters: Optional[int] = None,
        injected: Optional[int] = None,
        pipelined: bool = False,
        boundary_host_s: float = 0.0,
    ) -> _SegmentHandle:
        """Enqueue one segment over the pool ``state`` and the copy of its
        boundary bytes to pinned host memory, without a host sync; return
        the handle ``finalize_segment`` takes. The handle's ``state`` is the
        pool's next handle: ``state`` is consumed (its tensors are updated
        in place), and dispatching it again raises RuntimeError.

        Injection: ``src`` is the per-lane source map into ``boards`` of
        ``ops.solver.inject_lanes_src`` (-1 keep, -2 pad re-seed, else a
        row); a row-aligned ``inject`` mask (row i into lane i) converts to
        it, on both arms. ``boards`` is a host array or a device tensor
        (the segment loop reuses an idle pair and the prestager places refills
        ahead). ``seg_iters`` overrides the segment's step budget;
        ``injected`` counts the real requests boarding (None: the lanes
        with ``src >= 0``). ``pipelined`` marks a speculative dispatch
        issued before the previous segment's digest was read;
        ``boundary_host_s`` is the host gap since that digest arrived. The
        pipelined arm copies the (W, 8) digest and keeps the solution
        block on the device for ``finalize_segment``'s phase 2; the other
        arm copies the full (W, C+7) rows.

        The supervised seam, as ``_dispatch_padded``: a watchdog token opens
        here (at ``budget_scale=2.0`` for a speculative dispatch, whose
        dispatch-to-fetch span covers the segment ahead of it) and closes
        in ``finalize_segment`` or ``abandon_segment``."""
        state.check_live()
        width = state.width
        sup = self.supervisor
        token = (
            sup.call_started(width, budget_scale=2.0 if pipelined else 1.0)
            if sup is not None else None
        )
        try:
            t0 = time.monotonic()
            inj = self.fault_injector
            if inj is not None:
                inj.on_device_call(width)  # may raise (fail-next-N)
            self._note_program("segment", width)
            if not isinstance(boards, torch.Tensor):
                boards = self._device_batch(boards)
            boards = boards.reshape(boards.shape[0], -1)
            if src is None:
                if inject is None:
                    raise ValueError("dispatch_segment takes an inject mask or src")
                mask = np.asarray(
                    inject.cpu() if isinstance(inject, torch.Tensor) else inject
                ).astype(bool)
                src = np.where(mask, np.arange(width, dtype=np.int32), np.int32(-1))
            if isinstance(src, torch.Tensor):
                if injected is None:
                    # counted on the caller's tensor, not the device copy:
                    # a host src needs no device round trip to count
                    injected = int((src >= 0).sum())
                src_dev = src.to(self.device, torch.int32)
            else:
                src_np = np.asarray(src, np.int32)
                if injected is None:
                    # real requests only: -2 pad re-seeds are not injections
                    injected = int((src_np >= 0).sum())
                src_dev = self._device_batch(src_np)
            nxt, digest, block = self._segment_kernels(
                state, boards, src_dev,
                int(seg_iters) if seg_iters else self.segment_iters,
            )
            shards = 1
            if isinstance(digest, list):
                # the mesh: one digest and block a shard, gathered in lane
                # order; _segment_rows sums the shards' LoopStats columns
                shards = len(digest)
                out, block = self._mesh_segment_out(nxt, digest, block)
                self._note_split(self._segment_mesh_program)
            elif self.segment_pipeline:
                out = digest
            else:
                # [grid | solved | status | guesses | validations | board_iters
                #  | lane_steps | idle_lane_steps], the JAX full-row layout
                out = torch.cat(
                    [nxt.state.grid, digest.index_select(1, self._row_cols)], 1
                )
                block = None
            host, ready = self._to_host(out)
        except BaseException:
            if sup is not None:
                sup.call_finished(token, ok=False)
            raise
        return _SegmentHandle(
            state=nxt, host=host, ready=ready, block=block, t0=t0,
            width=width, injected=int(injected), pipelined=bool(pipelined),
            boundary_host_s=float(boundary_host_s), token=token, shards=shards,
        )

    def _mesh_segment_out(self, nxt, digests: list, blocks: list):
        """A mesh segment's boundary bytes on the first shard's device:
        the shards' digests in lane order (pipelined arm; the blocks stay
        on their shards, read shard by shard in phase 2), or the full rows
        [grid | digest columns] built on each shard's stream before its
        next segment can move the pool, then gathered (the other arm)."""
        from .parallel.shard import on_shard, to_primary

        mesh = self.mesh
        if self.segment_pipeline:
            out = torch.cat([to_primary(mesh, i, d) for i, d in enumerate(digests)])
            return out, blocks
        rows = []
        for i, (pool, d) in enumerate(zip(nxt.shards, digests)):
            with on_shard(mesh, i):
                cols = self._row_cols.to(d.device)
                rows.append(torch.cat([pool.state.grid, d.index_select(1, cols)], 1))
        return torch.cat([to_primary(mesh, i, r) for i, r in enumerate(rows)]), None

    def finalize_segment(self, handle: _SegmentHandle, *, active):
        """Wait for a dispatched segment's boundary bytes and return
        ``(rows, device_s)``: the (W, C+7) packed host rows and the
        dispatch-to-fetch wall time.

        Pipelined arm, the two-phase fetch: phase 1 is the digest; when a
        lane's ``fetch_slot`` is set (it solved in this segment), phase 2
        reads the solution block — its prefix up to the largest slot when
        the block is prefix-gathered, else the whole (small) block — on a
        stream of its own, so it does not wait for a segment queued after
        this one. Grid columns of the other lanes are zero (the segment loop
        reads grids only of lanes that solved).

        The segment records one cost sample (``cost.note_segment``): the
        dispatch-to-fetch time, ``active`` (the (W,) mask of lanes holding
        a request at fetch time: the fill and the boards resolved), the
        boards injected, the digest's lane_steps / idle_lane_steps
        columns, the boundary host time and the bytes fetched.

        The dispatch's supervision token closes here; the fault injector's
        delay runs before the event wait and its poison applies to the
        assembled rows, so a lane that solved carries the poisoned grid."""
        sup = self.supervisor
        try:
            inj = self.fault_injector
            if inj is not None:
                inj.on_fetch(handle.width)  # may sleep (watchdog food)
            rows, fetch_bytes = self._segment_rows(handle)
            if inj is not None:
                rows = inj.corrupt(handle.width, rows)
        except BaseException:
            if sup is not None:
                sup.call_finished(handle.token, ok=False)
            raise
        if sup is not None:
            sup.call_finished(handle.token, ok=True)
        device_s = time.monotonic() - handle.t0
        C = self.spec.cells
        act = np.asarray(active, bool)
        self.cost.note_segment(
            width=handle.width,
            active=int(act.sum()),
            injected=handle.injected,
            resolved=int(((rows[:, C + 1] != RUNNING) & act).sum()),
            device_s=device_s,
            lane_steps=int(rows[0, C + 5]),
            idle_lane_steps=int(rows[0, C + 6]),
            pipelined=handle.pipelined,
            boundary_host_s=handle.boundary_host_s,
            fetch_bytes=fetch_bytes,
        )
        return rows, device_s

    def _segment_rows(self, handle: _SegmentHandle):
        """Wait for a segment's boundary bytes and assemble its (W, C+7)
        host rows (``finalize_segment``'s fetch). Returns ``(rows,
        fetch_bytes)``: the bytes copied to the host, digest and solution
        rows on the pipelined arm, the full rows on the other."""
        if handle.ready is not None:
            handle.ready.synchronize()
        host = handle.host.numpy()
        if handle.shards > 1:
            return self._mesh_segment_rows(handle, host)
        if handle.block is None:
            return host.copy(), host.nbytes
        C = self.spec.cells
        width = handle.width
        rows = np.zeros((width, C + 7), np.int32)
        rows[:, C] = host[:, 1]        # solved
        rows[:, C + 1] = host[:, 0]    # status
        rows[:, C + 2] = host[:, 2]    # guesses
        rows[:, C + 3] = host[:, 3]    # validations
        rows[:, C + 4] = host[:, 4]    # board_iters
        rows[:, C + 5] = host[:, 6]    # lane_steps
        rows[:, C + 6] = host[:, 7]    # idle_lane_steps
        slots = host[:, 5]
        lanes = np.nonzero(slots >= 0)[0]
        fetch_bytes = host.nbytes
        if lanes.size:
            n = (
                int(slots[lanes].max()) + 1
                if segment_prefix_gather(width, C) else width
            )
            grids = self._fetch_rows(handle.block, n)
            fetch_bytes += grids.nbytes
            rows[lanes, :C] = grids[slots[lanes]]
        return rows, fetch_bytes

    def _mesh_segment_rows(self, handle: _SegmentHandle, host: np.ndarray):
        """``_segment_rows`` of a mesh segment: each shard's LoopStats
        columns summed into the call's totals on every row (the JAX
        program's ``psum``), and on the pipelined arm each shard's newly
        solved grids read from its own block at its own slots."""
        C = self.spec.cells
        width, n_shards = handle.width, handle.shards
        w = width // n_shards
        host = host.copy()
        fetch_bytes = host.nbytes
        first = np.arange(n_shards) * w
        if handle.block is None:
            for c in (C + 5, C + 6):
                host[:, c] = int(host[first, c].astype(np.int64).sum())
            return host, fetch_bytes
        for c in (6, 7):
            host[:, c] = int(host[first, c].astype(np.int64).sum())
        rows = np.zeros((width, C + 7), np.int32)
        rows[:, C] = host[:, 1]        # solved
        rows[:, C + 1] = host[:, 0]    # status
        rows[:, C + 2] = host[:, 2]    # guesses
        rows[:, C + 3] = host[:, 3]    # validations
        rows[:, C + 4] = host[:, 4]    # board_iters
        rows[:, C + 5] = host[:, 6]    # lane_steps
        rows[:, C + 6] = host[:, 7]    # idle_lane_steps
        prefix = segment_prefix_gather(width, C)
        for i, block in enumerate(handle.block):
            slots = host[i * w:(i + 1) * w, 5]
            lanes = np.nonzero(slots >= 0)[0]
            if not lanes.size:
                continue
            n = int(slots[lanes].max()) + 1 if prefix else w
            if block.device == self.device or block.device.type == "cpu":
                grids = self._fetch_rows(block, n)
            else:
                grids = block[:n].cpu().numpy()
            fetch_bytes += grids.nbytes
            rows[i * w + lanes, :C] = grids[slots[lanes]]
        return rows, fetch_bytes

    def _fetch_rows(self, block: torch.Tensor, n: int) -> np.ndarray:
        """The first ``n`` rows of a finished segment's solution block, read
        on the fetch stream (the caller has waited for the segment)."""
        if self._fetch_stream is None:
            return block[:n].numpy()
        with torch.cuda.stream(self._fetch_stream):
            host = torch.empty((n, block.shape[1]), dtype=block.dtype,
                               pin_memory=True)
            host.copy_(block[:n], non_blocking=True)
        self._fetch_stream.synchronize()
        return host.numpy()

    def abandon_segment(self, handle: _SegmentHandle) -> None:
        """Discard a dispatched segment that will never be fetched (the
        pipelined segment loop drops its speculative dispatch when the
        segment ahead failed; the pool is rebuilt either way). Closes the
        supervision token WITHOUT feeding the breaker in either direction:
        an unfetched segment proves nothing about the device, and counting
        the failure that caused the abandonment again would double-step
        the breaker toward LOST."""
        if self.supervisor is not None:
            self.supervisor.call_abandoned(handle.token)

    def run_segment_supervised(
        self,
        state: SegmentPool,
        boards,
        inject,
        *,
        active,
        seg_iters: Optional[int] = None,
        injected: Optional[int] = None,
        boundary_host_s: float = 0.0,
    ):
        """One segment, dispatched and fetched: ``dispatch_segment`` then
        ``finalize_segment``, on either arm (``inject`` is the row-aligned
        mask). Returns ``(state, rows, device_s)``: the pool's next
        handle, the (W, C+7) host rows and the dispatch-to-fetch wall
        time. The supervisor's token spans the dispatch and the fetch."""
        handle = self.dispatch_segment(
            state, boards, inject, seg_iters=seg_iters, injected=injected,
            boundary_host_s=boundary_host_s,
        )
        rows, device_s = self.finalize_segment(handle, active=active)
        return handle.state, rows, device_s

    def _stage_boards(self, boards: np.ndarray):
        """``(tensor, ready)``: host boards copied to the device on the
        staging stream, with the event after the copy (None on the CPU).
        The injection prestager's placement, off the segment stream."""
        if self._stage_stream is None:
            return self._device_batch(boards), None
        with torch.cuda.stream(self._stage_stream):
            t = self._device_batch(boards)
            ready = torch.cuda.Event()
            ready.record(self._stage_stream)
        return t, ready

    def _claim_staged(self, staged) -> torch.Tensor:
        """A ``_stage_boards`` result made safe for the current stream: the
        stream waits for the copy, and the allocator learns the tensor is
        used there."""
        t, ready = staged
        if ready is not None:
            stream = torch.cuda.current_stream(t.device)
            stream.wait_event(ready)
            t.record_stream(stream)
        return t

    def _segment_kernels(self, state: SegmentPool, boards: torch.Tensor,
                         src: torch.Tensor, seg_iters: int):
        """One launch of the segment kernels over the pool ``state`` with
        the engine's sweeps for its width and, on the pipelined arm, the
        prefix-gathered solution block where the width takes it; returns
        ``dfs_segment``'s ``(pool, digest, block)``. No token, no hook:
        the seam is the caller's."""
        width = state.width
        prefix = self.segment_pipeline and segment_prefix_gather(width, self.spec.cells)
        if self._segment_mesh_program is not None:
            return self._segment_mesh_program(
                state, boards, src, seg_iters, prefix_gather=prefix
            )
        return dfs_segment(
            state, boards, src, seg_iters, prefix_gather=prefix,
            **self._sweeps(width),
        )

    def _warm_segment_program(self) -> None:
        """Before serving: one trivial segment over a fresh all-pad pool at
        the serving width, so the first request pays neither the kernel
        build nor its first launch at that width. It calls the segment
        kernels directly, outside the supervised seam (no token, no
        injector hook), as the JAX engine's warm-up calls its program.
        The segment is the library's round-trip verification on the
        segment kernels (``_segment_round_trip``, ``_verified``)."""
        if not self.continuous_active:
            return
        w = self.segment_pool_width()
        self._note_program("segment", w)
        boards = torch.zeros((1, self.spec.cells), dtype=torch.int32,
                             device=self.device)
        self._verified(f"dfs_segment over {w} lanes",
                       lambda: self._segment_round_trip(w, boards))
        with self._lock:
            self._pool_warm_width = w

    def _segment_round_trip(self, w: int, boards: torch.Tensor):
        """The segment warm-up, a verification: the empty board injected
        into lane 0 of a fresh ``w``-lane pool, one segment of the warm-up
        budget (``max_iters``); returns its (status, grid)."""
        src = torch.full((w,), -1, dtype=torch.int32, device=self.device)
        if self._segment_mesh_program is not None:
            # the empty board into every shard's first lane: each shard's
            # device verifies the library, each its own result
            ws = w // self.mesh.size
            src[::ws] = 0
            _, digests, blocks = self._segment_kernels(
                self.new_segment_pool(w), boards, src, self.max_iters
            )
            out = []
            for digest, block in zip(digests, blocks):
                digest = digest.cpu().numpy()
                slot = int(digest[0, 5])
                out.append((int(digest[0, 0]),
                            block[slot].cpu().numpy() if slot >= 0 else None))
            return out
        src[0] = 0
        _, digest, block = self._segment_kernels(
            self.new_segment_pool(w), boards, src, self.max_iters
        )
        digest = digest.cpu().numpy()
        slot = int(digest[0, 5])
        grid = block[slot].cpu().numpy() if slot >= 0 else None
        return int(digest[0, 0]), grid

    def _account_coalesced(self, rows: np.ndarray) -> None:
        """Fold one coalesced batch's work into the engine counters — the
        same accounting ``solve_batch_np`` does for its callers."""
        C = self.spec.cells
        with self._lock:
            self.validations += int(rows[:, C + 3].sum())
            self.solved_puzzles += int(rows[:, C].sum())

    def _row_result(self, row: np.ndarray, routed: str = "coalesced"):
        """One packed host row → the (solution | None, info) contract of
        ``solve_one``. ``capped`` keeps the not-finished ≠ proven-UNSAT
        distinction (the deep retry already ran in _finalize_padded)."""
        C = self.spec.cells
        N = self.spec.size
        solved = bool(row[C])
        info = {
            "validations": int(row[C + 3]),
            "guesses": int(row[C + 2]),
            "capped": int(row[C + 1] == RUNNING),
            "routed": routed,
        }
        solution = row[:C].reshape(N, N).tolist() if solved else None
        return solution, info

    # -- public API --------------------------------------------------------
    def ready(self) -> bool:
        """Would ``/readyz`` pass: warm AND — when a supervisor is
        attached — not LOST. The one readiness predicate (the JAX engine's):
        a LOST node still answers correctly from the oracle, but should not
        be sent traffic."""
        sup = self.supervisor
        return bool(
            self.warmed and library_error() is None
            and not (sup is not None and sup.is_lost)
        )

    @property
    def backend(self) -> str:
        """What runs the search: ``"cuda"``, the hand-written kernels
        (csrc/dfs_solver.cu), or ``"plain"``, their plain PyTorch versions
        on the CPU. The JAX engine names its XLA or Pallas program here."""
        return "cuda" if self.device.type == "cuda" else "plain"

    def arm_device_trace(self, log_dir: str, calls: int = 4) -> None:
        """Arm the ``torch.profiler`` capture (CLI ``--device-trace-dir``):
        the next warm-up and the next ``calls`` bucket calls each write a
        trace into ``log_dir``. A later call resets the budget; the
        warm-up capture stays once per process."""
        with self._lock:
            self.device_trace_dir = log_dir
            self._device_trace_budget = max(0, int(calls))

    def health(self) -> dict:
        """Operator-facing engine health, the ``engine`` block of
        ``/metrics``, keyed as the JAX engine's: the frontier route's
        switches and counters (``frontier_fallbacks`` counts requests the
        bucket path answered after a race's device fault), the ``mesh``
        block with a mesh (``mesh_info``), and the serving loop's
        ``frontier_loop_*`` health on a multi-host leader. ``backend`` names what
        runs the search (``"cuda"`` / ``"plain"``, the JAX engine's
        ``"xla"`` / ``"pallas"``).

        ``cost`` is the device cost plane (obs/cost.py). Its lane counters
        are lockstep counts on every path, as the JAX engine's: a bucket
        call's ``lane_steps`` is its width times the most steps of any of
        its boards (summed over its depth stages) and ``idle_lane_steps``
        that less Σ the boards' own steps (``lockstep_loop``). On the
        card, where the DFS kernel runs each board on its own warp,
        ``lane_util_pct`` is the straggler occupancy: the share of
        warp-steps that did work while each call's deepest board ran. Its
        plain version steps every board alike, so idle is 0 on the CPU.
        ``gpu_s`` / ``gpu_s_by_stage`` are the one-card bucket calls'
        device time by CUDA events, beside the host-clock ``device_s``.
        The segment counters of the continuous block (``cost.continuous``)
        come from the segment digest and equal the JAX engine's on the
        same workload."""
        out = {
            "backend": self.backend,
            "frontier_enabled": self.frontier_enabled,
            "frontier_route": self.frontier_route,
            "frontier_handoff": self.frontier_handoff,
            "frontier_fallbacks": self.frontier_fallbacks,
            "frontier_escalations": self.frontier_escalations,
            "coalesce": self.coalesce,
            "continuous": {
                "enabled": self.continuous_active,
                "configured": self.continuous,
                "segment_iters": self.segment_iters,
                "pipeline": self.segment_pipeline,
            },
            "warmed": self.warmed,
            "fully_warmed": self.fully_warmed,
            "warm": self.warm_info(),
        }
        out["cost"] = self.cost.snapshot(warm_info=out["warm"])
        mesh = self.mesh_info()
        if mesh is not None:
            # the mesh plane: topology and batch-split evidence, the
            # /metrics "engine.mesh" block
            out["mesh"] = mesh
        if self.supervisor is not None:
            # the one-word summary; the full state machine is the /metrics
            # top-level "health" block (supervisor.snapshot())
            out["supervisor"] = self.supervisor.state
        if self._coalescer is not None:
            out["coalescer"] = self._coalescer.stats()
        loop = self.frontier_loop
        if loop is None:
            # a bare bound FrontierServingLoop.solve as the runner
            loop = getattr(self.frontier_runner, "__self__", None)
        if loop is not None and hasattr(loop, "health"):
            for k, v in loop.health().items():
                out[f"frontier_loop_{k}"] = v
        return out

    def mesh_info(self) -> Optional[dict]:
        """The ``engine.mesh`` block of ``GET /metrics``, keyed as the JAX
        engine's: the mesh's shards, the bucket ladder it rounded, each
        bucket's rows a shard, and the batch-split evidence (dispatches,
        the fan-out's, and how the last one landed). ``device_kinds`` names
        the shards' devices (``torch.cuda.get_device_name``, or ``cpu``).
        None when the engine has no mesh."""
        if self.mesh is None:
            return None
        n_dev = int(self.mesh.size)
        with self._lock:
            last_split = dict(self._mesh_last_split)
            dispatches = self.mesh_dispatches
            runner_dispatches = self.mesh_runner_dispatches
            min_devices = self._mesh_min_devices
        return {
            "devices": n_dev,
            "axis": "data",
            "device_kinds": sorted({
                torch.cuda.get_device_name(d) if d.type == "cuda" else d.type
                for d in self.mesh.distinct_devices
            }),
            "buckets_requested": list(self.requested_buckets),
            "buckets": list(self.buckets),
            "per_device_fill": {str(b): b // n_dev for b in self.buckets},
            "dispatches": dispatches,
            "runner_dispatches": runner_dispatches,
            "last_split": last_split,
            "min_devices_seen": min_devices,
        }

    def _tier0_buckets(self) -> list:
        """The widths one ``/solve`` needs warm first: the smallest bucket
        and, with an explicit coalescer batch cap, the width its batches
        dispatch at (the JAX engine's tier 0)."""
        tier = {self.buckets[0]}
        if self.coalesce and self.coalesce_max_batch:
            cap = min(self.coalesce_max_batch, self.buckets[-1])
            for b in self.buckets:
                if cap <= b:
                    tier.add(b)
                    break
        return sorted(tier)

    def warm_info(self) -> dict:
        """Per-width warm state (the ``/metrics`` ``engine.warm`` block),
        keyed as the JAX engine's: which widths ran their verified warm-up
        launch, from what ``source`` (the library's: ``"aot"``, loaded from
        the store, or ``"compile+save"``; ``"plain"`` on the CPU, which
        loads none) and how long it took (``compile_s``: the kernel
        library's build and load are in the first), the order, the
        distinct (variant, width) launch shapes seen, the torch.profiler
        capture state when a device trace is armed, and with a cache dir
        the kernel store's counters (``aot``: loaded, saved, errors), as
        the JAX engine reports its AOT store's. ``solver_loop``
        describes the kernels, which have no lockstep compaction
        schedule."""
        with self._lock:
            out = {
                "warmed": self.warmed,
                "fully_warmed": self.fully_warmed,
                "tier0": self._tier0_buckets(),
                "buckets": {
                    str(b): dict(self._warm_state.get(b) or {"warm": False})
                    for b in self.buckets
                },
                "order": list(self._warm_order),
                "skipped": list(self._warm_skipped),
                "programs": len(self._programs),
                "solver_loop": {"backend": self.backend},
            }
            if self.device_trace_dir is not None:
                out["device_trace"] = {
                    "dir": self.device_trace_dir,
                    "warmup_traced": self._warmup_trace_done,
                    "captured_calls": self._device_trace_captured,
                    "calls_remaining": self._device_trace_budget,
                }
        if self._report_aot:
            out["aot"] = self._store.stats()
        mesh = self.mesh_info()
        if mesh is not None:
            out["mesh"] = mesh
        return out

    def warmup(self, *, budget_s: Optional[float] = None,
               background: bool = False) -> None:
        """Warm the serving widths, tiered, so requests pay neither the
        kernel build nor a width's first launch.

        Tier 0 runs first and is budget-exempt: the smallest bucket, the
        coalescer's batch-cap width (``_tier0_buckets``) and one segment
        over the serving pool (``_warm_segment_program``) — what one
        ``/solve`` needs. ``warmed`` flips there: the node is servable.
        The rest of the ladder then widens (``_warm_widen``), inline by
        default, so a bare ``warmup()`` returns fully warm, or in an
        ``engine-warmup`` daemon thread with ``background=True``. The CLI
        runs the whole blocking ``warmup()`` in a thread of its own, so the
        node binds before tier 0; ``background=True`` is for a caller that
        wants the engine servable on return, as the JAX package's benchmark
        drives its engine (the port's benchmark, ROADMAP Queue 1 item 3).

        ``budget_s`` bounds the widening: buckets that would start past it
        are skipped (``warm_info()["skipped"]``), ``fully_warmed`` stays
        False, and oversize batches tile over the largest warm width
        (``_bucket_for`` / ``solve_batch_np``). A later ``warmup()``
        resumes where the budget cut off.

        As in the JAX engine's ``_warm_bucket``, each width runs the bucket
        path's inner launch and wait (``_launch``, ``_wait_rows``)
        directly, outside the supervised seam: no watchdog token, no
        injector hook, no quarantine routing. A width already warm is
        skipped, so the supervisor's rebuild (``warmup()`` on a LOST
        engine) relaunches only the segment warm-up. The counters are not
        touched.

        Each width's warm-up time (the kernel library's build and load
        included, the first time in a process) is recorded for
        ``warm_info()``. With a device trace armed, the process's first
        tier 0 runs inside one ``torch.profiler`` capture. A library that
        failed its verification twice (``_verified``) is never warmed
        again: this raises its error."""
        error = library_error()
        if error is not None:
            raise error
        deadline = None if budget_s is None else time.monotonic() + budget_s
        with self._lock:
            self._warmup_started = True
            trace_warm = (
                self.device_trace_dir is not None and not self._warmup_trace_done
            )
        trace_warm = trace_warm and self._profile_mutex.acquire(blocking=False)
        try:
            with contextlib.ExitStack() as stack:
                if trace_warm:
                    with self._lock:
                        self._warmup_trace_done = True
                    stack.enter_context(device_trace(self.device_trace_dir))
                    stack.enter_context(annotate("warmup"))
                for b in self._tier0_buckets():
                    self._warm_bucket(b)
                self._warm_probe_programs()
                self._warm_segment_program()
        finally:
            if trace_warm:
                self._profile_mutex.release()
        with self._lock:
            self.warmed = True
        if background:
            t = threading.Thread(
                target=self._warm_widen, args=(deadline,),
                name="engine-warmup", daemon=True,
            )
            self._warm_thread = t
            t.start()
            return
        self._warm_widen(deadline)

    def _warm_widen(self, deadline: Optional[float]) -> None:
        """Widen past tier 0: the remaining buckets, ascending, then the
        frontier race's rungs. Runs inline or as the background warm
        thread; a budget cut and a failure both leave the engine serving,
        tier-0 warm, the cold widths tiled over or launched on demand. A
        library that fails its verification twice is the exception: the
        engine stops serving (``_verified``) and the error is raised."""
        try:
            for b in self.buckets:
                if deadline is not None and time.monotonic() > deadline:
                    with self._lock:
                        self._warm_skipped = [
                            x for x in self.buckets
                            if not self._warm_state.get(x, {}).get("warm")
                        ]
                        skipped = list(self._warm_skipped)
                    logger.info(
                        "warm-up budget exhausted — skipping buckets %s "
                        "(serving tiles over the warm widths)", skipped,
                    )
                    return
                self._warm_bucket(b)
            if self.frontier_enabled:
                if deadline is not None and time.monotonic() > deadline:
                    with self._lock:
                        self._warm_skipped = ["frontier"]
                    return
                self._warm_frontier()
            with self._lock:
                self._warm_skipped = []
                self.fully_warmed = True
        except LibraryVerificationError:
            raise  # the engine is no longer ready; say so in this thread
        except Exception:  # noqa: BLE001 — a failed widening must not kill serving
            logger.exception(
                "warm-up widening failed — cold widths launch on demand"
            )

    def _warm_probe_programs(self) -> None:
        """Tier-0 companion of an auto-routed frontier engine: the probe
        runs before every routing decision. The K1 probe is the bucket
        path's launch at the smallest width, warm with tier 0; the handoff
        probe is its own launch shape (one segment over a one-lane pool),
        so it runs once here on the empty board. No counter moves."""
        if not (self.frontier_enabled and self.frontier_route == "auto"):
            return
        if self.frontier_handoff and self.frontier_runner is None:
            N = self.spec.size
            self._note_program("quick_state", 1)
            self._quick_state(np.zeros((N, N), np.int32))

    def _warm_frontier(self) -> None:
        """The race's first rungs before serving: the seeding on the race
        mesh's first device (one seeding kernel launch on a card, the host
        ops on the CPU), then a race over ``states_per_device × {1, 2, 4}``
        instantly-unsat pad states (each dies in one step, so no solution
        and no counter), as the JAX engine warms its racer. Larger rungs
        launch on first use."""
        if self.race_mesh is None:
            return  # the multi-host loop warmed its race at its start
        from .parallel import frontier

        C = self.spec.cells
        target = self.race_mesh.size * self.frontier_states_per_device
        frontier.warm_seeding(self.spec, target, self.locked_candidates,
                              self.race_mesh.primary)
        pad = torch.from_numpy(unsat_pad(self.spec)).reshape(1, C)
        for mult in (1, 2, 4):
            # every shard races its slice: each shard's launch is warm
            row, _, _ = frontier.race_on_mesh(
                pad.expand(target * mult, C), self.race_mesh,
                self.spec, self._depth_flat, frontier.DEFAULT_MAX_ITERS,
                locked_candidates=self.locked_candidates, waves=self.waves,
                naked_pairs=self.naked_pairs,
            )
            row.cpu()  # the race has run

    def _warm_bucket(self, b: int) -> None:
        """One launch and wait of the bucket path at width ``b``, recorded
        warm; nothing when ``b`` is warm already (the segment pool's warm
        launch does not count: its width may equal a bucket's)."""
        with self._lock:
            if self._warm_state.get(b, {}).get("warm"):
                return
        N, C = self.spec.size, self.spec.cells
        t0 = time.perf_counter()

        def launch():
            rows = self._wait_rows(
                self._launch(np.zeros((b, N, N), np.int32), b, self.max_iters)
            )
            if self._shard_mesh is not None:
                # every shard's first board: each device of the mesh
                # verifies the library on its own result
                ws = b // self._shard_mesh.size
                return [(int(r[C + 1]), r[:C]) for r in rows[::ws]]
            return int(rows[0, C + 1]), rows[0, :C]

        source = self._verified(f"dfs_solver at width {b}", launch)
        with self._lock:
            self._warm_state[b] = {
                "warm": True,
                "source": source,
                "compile_s": round(time.perf_counter() - t0, 3),
            }
            self._warm_order.append(b)

    def _verified(self, what: str, launch) -> str:
        """Run one warm-up launch as the library's round-trip verification,
        ``launch()`` → (status, grid) of the empty board it solved, as the
        JAX engine's ``_verify_aot``: the board must come back SOLVED with
        a grid the host oracle accepts. Returns the width's warm
        ``source``: where the library came from (``library_source``),
        ``"plain"`` on the CPU.

        A library that fails is invalidated in the store and rebuilt under
        ``library_quarantine`` (every other thread's launch raises
        meanwhile), then this width and every width verified before are
        verified again on the new library. A second failure, or a rebuild
        that fails, raises ``LibraryVerificationError``: the library
        launches no more, and the engine is no longer warm or ready.
        Nothing falls back to the plain version."""
        if not self._round_trips_ok(launch()):
            logger.warning(
                "the kernel library failed its round-trip verification (%s) — "
                "invalidating and rebuilding it", what,
            )
            with self._lock:
                again = [(what, launch), *self._round_trips.items()]
            try:
                with library_quarantine(what):
                    rebuild_library()
                    for name, check in again:
                        if not self._round_trips_ok(check()):
                            raise LibraryVerificationError(
                                f"the kernel library failed its round-trip "
                                f"verification twice ({what}, then {name} "
                                f"on a fresh build): the empty board did not "
                                f"come back solved and valid"
                            )
            except BaseException:
                with self._lock:
                    self.warmed = self.fully_warmed = False
                raise
        with self._lock:
            self._round_trips[what] = launch
        return library_source() or "plain"

    def _round_trips_ok(self, result) -> bool:
        """A launch's verification: one (status, grid), or a list of them,
        one for each shard of a mesh, every one of which must pass."""
        results = result if isinstance(result, list) else [result]
        return all(self._round_trip_ok(*r) for r in results)

    def _round_trip_ok(self, status: int, grid) -> bool:
        N = self.spec.size
        return status == SOLVED and oracle_is_valid_solution(
            np.asarray(grid).reshape(N, N).tolist()
        )

    def solve_batch_np(
        self, boards: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, dict]:
        """Solve (B, N, N) boards.

        Returns (solutions, solved_mask, info). Rows of unsolved boards hold
        the partial/original grid. Tiles over the largest bucket.
        ``info["capped"]`` counts boards whose search exhausted even the
        deep-retry budget: for those "not solved" means "not finished",
        not "proven unsatisfiable".

        While a tiered warm-up has left the ladder cold, the chunks are
        bounded by the largest warm width instead."""
        boards = np.asarray(boards, np.int32)
        B = boards.shape[0]
        N = self.spec.size
        C = self.spec.cells
        cap = self.buckets[-1]
        if self._tiling_active():
            warm = self._warm_widths()
            if warm:
                cap = warm[-1]
        chunks = [self._solve_padded(boards[lo: lo + cap])
                  for lo in range(0, B, cap)]
        with annotate("engine.merge"):
            packed = np.concatenate(chunks, axis=0)
            solutions = packed[:, :C].reshape(B, N, N)
            solved_mask = packed[:, C].astype(bool)
            validations = int(packed[:, C + 3].sum())
            guesses = int(packed[:, C + 2].sum())
            capped = int((packed[:, C + 1] == RUNNING).sum())
            with self._lock:
                self.validations += validations
                self.solved_puzzles += int(solved_mask.sum())
            return solutions, solved_mask, {
                "validations": validations,
                "guesses": guesses,
                "capped": capped,
            }

    def solve_batch_resumable_np(
        self,
        boards: np.ndarray,
        checkpoint_path: str,
        *,
        chunk_iters: int = 256,
        max_iters: int = 65536,
        keep_checkpoint: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray, dict]:
        """``solve_batch_np`` with crash durability: the solve advances in
        bounded chunks (one K3 segment each on the card) with an atomic .npz
        snapshot between chunks (utils/checkpoint.py), and a re-run with the
        same ``checkpoint_path`` resumes bit-exact from the snapshot instead
        of restarting. It runs the engine's serving configuration
        (``locked_candidates``, ``waves``, ``naked_pairs``, ``max_depth``)
        on the engine's device.

        Returns (solutions, solved_mask, info) like ``solve_batch_np``. The
        snapshot carries the per-board counters, so a resumed run folds the
        batch's whole effort (pre-kill and post-resume) into this engine's
        counters, once: the killed process's counters died with it."""
        from .utils.checkpoint import solve_batch_resumable

        boards = np.asarray(boards, np.int32)
        # the mesh plane splits only a mesh-divisible batch; another runs
        # on the first shard's device (an explicit sharding= caller sized
        # its batch), as in the JAX engine
        sharding = self.sharding
        if self.mesh is not None and boards.shape[0] % self.mesh.size:
            sharding = None
        res = solve_batch_resumable(
            boards,
            self.spec,
            checkpoint_path=checkpoint_path,
            chunk_iters=chunk_iters,
            max_iters=max_iters,
            max_depth=self.max_depth,
            keep_checkpoint=keep_checkpoint,
            locked=self.locked_candidates,
            waves=self.waves,
            naked_pairs=self.naked_pairs,
            device=self.device,
            sharding=sharding,
        )
        solved_mask = res.solved.cpu().numpy()
        validations = int(res.validations.sum())
        guesses = int(res.guesses.sum())
        with self._lock:
            self.validations += validations
            self.solved_puzzles += int(solved_mask.sum())
        return (
            res.grid.cpu().numpy(),
            solved_mask,
            {"validations": validations, "guesses": guesses},
        )

    def solve_batch_np_supervised(
        self, boards: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, dict]:
        """``solve_batch_np`` under the degraded-serving contract (the
        ``/solve_batch`` entry point): with a supervisor attached, an open
        breaker answers every board from the supervised host-oracle
        fallback, and a device fault mid-batch (``device_fault``) falls
        back the same way, instead of a whole-batch error. Any other
        exception (a kernel library that does not build, a programming
        error) propagates: the batch fails, it is not moved to the host.

        ``info`` gains ``degraded_boards`` (per-board bools, the HTTP
        body's flags) and ``degraded`` (any board: the ``X-Degraded``
        header). Without a supervisor this is ``solve_batch_np``."""
        boards = np.asarray(boards, np.int32)
        B = boards.shape[0]
        sup = self.supervisor
        if sup is None:
            return self.solve_batch_np(boards)
        if sup.should_fallback():
            return self._fallback_batch(sup, boards)
        try:
            sols, mask, info = self.solve_batch_np(boards)
        except Exception as e:  # noqa: BLE001 — re-raised unless a device fault
            if not device_fault(e):
                raise
            logger.exception(
                "batch device path failed — answering per board from the "
                "supervised oracle fallback"
            )
            return self._fallback_batch(sup, boards)
        info["degraded_boards"] = [False] * B
        info["degraded"] = False
        return sols, mask, info

    def _fallback_batch(self, sup, boards: np.ndarray):
        """Answer a whole batch from the supervised host oracle, board by
        board (bounded by the fallback's semaphore). A board that runs past
        the per-solve budget stays unsolved and counts as capped ("not
        finished"), never a whole-batch error."""
        B = boards.shape[0]
        solutions = boards.copy()
        mask = np.zeros((B,), bool)
        capped = 0
        for i in range(B):
            try:
                sol, _info = sup.fallback_solve(boards[i])
            except Exception:  # noqa: BLE001 — budget trip or oracle failure
                capped += 1
                continue
            if sol is not None:
                solutions[i] = np.asarray(sol, np.int32)
                mask[i] = True
        with self._lock:
            self.solved_puzzles += int(mask.sum())
        return solutions, mask, {
            "validations": 0,
            "guesses": 0,
            "capped": capped,
            "degraded_boards": [True] * B,
            "degraded": True,
            "routed": "oracle-fallback",
        }

    def _probe_quick(self, arr: np.ndarray):
        """The auto-route probe: one K1 call at the smallest covering width
        with ``frontier_escalate_iters`` steps, padded with copies of the
        board, at the staged depth and the width's sweeps (one a step at
        width 1), straight to the kernel (no coalescer, no token).

        Returns (solution | None, info) when the probe FINISHED (solved,
        or proved unsatisfiable), or None when the board was still RUNNING
        at the budget or OVERFLOWed: the deep-search tail that escalates to
        the race (``solve_one``)."""
        bucket = self._bucket_for(1)
        boards = arr[None]
        if bucket > 1:
            # copies of the probe board, not empty boards: a block runs
            # until its slowest board finishes, and a copy adds no step
            boards = np.concatenate(
                [boards, np.broadcast_to(arr, (bucket - 1, *arr.shape))]
            )
        tr = current_trace()
        t_dev = time.monotonic()
        try:
            row = self._wait_rows(
                self._launch(boards, 1, self.frontier_escalate_iters)
            )[0]
        finally:
            if tr is not None:
                tr.mark("device", time.monotonic() - t_dev)
        C = self.spec.cells
        status = int(row[C + 1])
        validations = int(row[C + 3])
        if status in (RUNNING, OVERFLOW):
            # RUNNING: out of probe steps. OVERFLOW: the probe's stack
            # overflowed, which is no answer either; the race runs the
            # full-depth stack. Both escalate; the probe's sweeps are billed
            with self._lock:
                self.validations += validations
                self.frontier_escalations += 1
            return None
        solved = bool(row[C])
        with self._lock:
            self.validations += validations
            self.solved_puzzles += int(solved)
        info = {
            "validations": validations,
            "guesses": int(row[C + 2]),
            "routed": "bucket-quick",
        }
        N = self.spec.size
        return (row[:C].reshape(N, N).tolist() if solved else None), info

    def _quick_state(self, arr: np.ndarray):
        """The handoff probe's device work: one segment of
        ``frontier_escalate_iters`` steps over a one-lane pool holding the
        board, at the flat depth and one sweep a step (K3/K3b on the card),
        which leaves the lane's whole search state in the pool. Returns
        ``(packed, pool)``: the host row [grid (C), status, guesses,
        validations], fetched in one copy, with ``finalize_status``
        applied to the status (a segment has no closing analysis), and the
        pool, whose state stays on the device."""
        C = self.spec.cells
        dev = self._device_batch(arr[None])
        pool = SegmentPool.fresh(dev, self.spec, self._depth_flat)
        keep = torch.full((1,), -1, dtype=torch.int32, device=self.device)
        pool, _, _ = dfs_segment(
            pool, dev.reshape(1, C), keep, self.frontier_escalate_iters,
            prefix_gather=False, locked_candidates=self.locked_candidates,
            waves=1, naked_pairs=self.naked_pairs,
        )
        st = pool.state
        packed = torch.cat(
            [st.grid[0], st.status, st.guesses, st.validations]
        ).cpu().numpy()
        if packed[C] == RUNNING:
            # finalize_status: a board completed on the budget's last step
            # reads RUNNING until one more analysis
            N = self.spec.size
            grid = torch.from_numpy(packed[:C].reshape(1, N, N).copy())
            if bool(analyze(grid, self.spec).solved[0]):
                packed[C] = SOLVED
        return packed, pool

    def _probe_quick_state(self, arr: np.ndarray):
        """Handoff variant of ``_probe_quick`` (``frontier_handoff``).

        Returns ("done", (solution | None, info)) when the probe answered
        the request, or ("escalate", seed_states) with the probe's
        unexplored subtrees (parallel/frontier.state_handoff_frontier) for
        the race to continue from."""
        self._note_program("quick_state", 1)
        tr = current_trace()
        t_dev = time.monotonic()
        try:
            packed, pool = self._quick_state(arr)
        finally:
            if tr is not None:
                tr.mark("device", time.monotonic() - t_dev)
        C = self.spec.cells
        status = int(packed[C])
        validations = int(packed[C + 2])
        if status in (RUNNING, OVERFLOW):
            # the same escalation contract as _probe_quick; the stack is
            # fetched only here, on the rare deep path
            from .parallel.frontier import state_handoff_frontier

            seeds = state_handoff_frontier(pool.state, self.spec)
            with self._lock:
                self.validations += validations
                self.frontier_escalations += 1
            return "escalate", seeds
        solved = status == SOLVED
        with self._lock:
            self.validations += validations
            self.solved_puzzles += int(solved)
        info = {
            "validations": validations,
            "guesses": int(packed[C + 1]),
            "routed": "bucket-quick",
        }
        N = self.spec.size
        solution = packed[:C].reshape(N, N).tolist() if solved else None
        return "done", (solution, info)

    def _frontier_raw(self, arr: np.ndarray, seed_states=None, deadline_s=None):
        """Run the race without serving-stats side effects;
        ``_frontier_solve`` wraps it with the counter accounting.

        Supervision and cost, as in the JAX engine: the race opens a
        watchdog token under the width 0 (it is not a bucket call, but a
        hung race must trip the same breaker) with an 8× budget, since a
        healthy race runs far past one bucket call, and folds its wall
        time into ``cost.note_frontier``. A ``DeadlineExceeded`` abandons
        the token without feeding the breaker either way."""
        from .parallel.frontier import frontier_solve

        sup = self.supervisor
        token = (
            sup.call_started(0, budget_scale=8.0) if sup is not None else None
        )
        t0 = time.monotonic()
        try:
            if self.frontier_runner is not None:
                # the multi-host race: the loop's round trip is this
                # request's device stage
                tr = current_trace()
                t_dev = time.monotonic()
                try:
                    solution, info = self.frontier_runner(arr)
                finally:
                    if tr is not None:
                        tr.mark("device", time.monotonic() - t_dev)
            else:
                solution, info = frontier_solve(
                    arr,
                    self.race_mesh,
                    self.spec,
                    states_per_device=self.frontier_states_per_device,
                    max_depth=self.max_depth,
                    locked=self.locked_candidates,
                    waves=self.waves,
                    naked_pairs=self.naked_pairs,
                    initial_states=seed_states,
                    deadline_s=deadline_s,
                )
        except DeadlineExceeded:
            if sup is not None:
                sup.call_abandoned(token)
            raise
        except BaseException:
            if sup is not None:
                sup.call_finished(token, ok=False)
            raise
        if sup is not None:
            sup.call_finished(token, ok=True)
        self.cost.note_frontier(
            device_s=time.monotonic() - t0, escalated=seed_states is not None
        )
        return solution, dict(info, frontier=True)

    def _frontier_solve(self, arr: np.ndarray, seed_states=None, deadline_s=None):
        solution, info = self._frontier_raw(arr, seed_states, deadline_s)
        with self._lock:
            self.validations += info["validations"]
            if solution is not None:
                self.solved_puzzles += 1
        return solution, info

    def solve_one(
        self,
        board: Sequence[Sequence[int]],
        *,
        frontier: Optional[bool] = None,
        deadline_s: Optional[float] = None,
    ) -> Tuple[Optional[List[List[int]]], dict]:
        """Solve a single board; returns (solution | None, info).

        Without the frontier race this is the bucket path: coalesced with
        concurrent requests when enabled, else a direct width-1 call. With
        it (``frontier_mesh``), an ``"auto"`` route first probes the board
        (``_probe_quick``, or ``_probe_quick_state`` with the handoff) and
        races only what the probe left unfinished; ``"always"`` and an
        explicit ``frontier=True`` race at once; ``frontier=False`` forces
        the bucket path (the P2P worker's per-cell tasks and the host APIs
        use it, as in the JAX package).

        ``deadline_s`` (absolute monotonic) bounds the race's leg: a request
        that expires after its probe, or mid-seeding, raises
        ``DeadlineExceeded`` (the 429 path); a race already dispatched
        runs to completion. A deadline that guards the bucket route's
        queue rides ``solve_one_async``.

        A race that fails with a device fault (``device_fault``) is
        answered from the bucket path and counted in
        ``frontier_fallbacks``; any other failure reaches the caller. The
        JAX engine sends every race failure to the bucket path: here a
        fallback must never hide the kernel.

        With a supervisor attached the bucket path is the degraded-mode
        seam (``_supervised_answer``)."""
        arr = np.asarray(board, np.int32)
        use_frontier = (
            self.frontier_enabled
            if frontier is None
            else (frontier and self.frontier_enabled)
        )
        seed_states = None
        if use_frontier and frontier is None and self.frontier_route == "auto":
            if self.frontier_handoff and self.frontier_runner is None:
                outcome, payload = self._probe_quick_state(arr)
                if outcome == "done":
                    return payload
                seed_states = payload  # the race continues the probe's search
            else:
                probed = self._probe_quick(arr)
                if probed is not None:
                    return probed
        if use_frontier:
            if deadline_s is not None and time.monotonic() > deadline_s:
                # the escalation boundary: the race leg has not started
                raise DeadlineExceeded(
                    "deadline expired before the frontier race"
                )
            try:
                solution, info = self._frontier_solve(
                    arr, seed_states, deadline_s
                )
            except DeadlineExceeded:
                raise
            except Exception as exc:  # noqa: BLE001 — re-raised unless a device fault
                if not device_fault(exc):
                    raise
                logger.exception(
                    "frontier race failed on the device — serving this "
                    "request from the bucket path"
                )
                with self._lock:
                    self.frontier_fallbacks += 1
            else:
                if solution is None and info.get("capped"):
                    # a race whose every subtree OVERFLOWed or was still
                    # RUNNING at max_iters has NOT proven the board
                    # unsolvable
                    logger.warning(
                        "solve_one: frontier race budget/stack exhausted — "
                        "board not finished, NOT proven unsolvable"
                    )
                return solution, info
        return self._solve_one_bucket(arr)

    def _solve_one_bucket(self, arr: np.ndarray):
        """The single-board bucket path, under ``_supervised_answer`` when
        a supervisor is attached."""
        sup = self.supervisor
        if sup is None:
            return self._solve_one_bucket_direct(arr)
        return self._supervised_answer(
            sup, arr, lambda: self._solve_one_bucket_direct(arr)
        )

    def _solve_one_bucket_direct(self, arr: np.ndarray):
        if self.coalesce:
            solution, info = self._await_result(self.coalescer.submit(arr))
        else:
            solutions, solved_mask, info = self.solve_batch_np(arr[None])
            solution = solutions[0].tolist() if solved_mask[0] else None
        if solution is None and info.get("capped"):
            # the HTTP surface answers the reference's "No solution found"
            # body either way; the not-finished-vs-proven-UNSAT distinction
            # lives here
            logger.warning(
                "solve_one: iteration budget exhausted (deep retry "
                "included) — board not finished, NOT proven unsolvable"
            )
        return solution, info

    def _await_result(self, fut):
        """``fut.result()`` — BOUNDED when a supervisor is attached: a
        hung device call blocks the coalescer's thread in a CUDA event wait
        that nothing can interrupt, and an untimed wait would pin this
        handler thread just as permanently. The bound is past the
        watchdog's hang declaration by construction, so a trip has already
        rerouted serving when it fires; the starved future is cancelled
        (the coalescer's ``_resolve`` then skips it) and the raise sends
        THIS request to the fallback."""
        sup = self.supervisor
        if sup is None:
            return fut.result()
        timeout = 2.0 * sup.watchdog_budget_s + 5.0
        try:
            return fut.result(timeout=timeout)
        except FuturesTimeout:
            fut.cancel()
            raise SolveStarved(
                f"supervised solve starved past {timeout:.1f}s "
                "(hung device call ahead of it?)"
            ) from None

    def _supervised_answer(self, sup, arr: np.ndarray, call, deadline_s=None):
        """The degraded-serving contract, in one place (applied by
        ``solve_one`` and ``solve_one_supervised``): an open breaker answers
        from the host-oracle fallback before the device is touched (the
        fallback honors ``deadline_s`` while queued on its semaphore —
        queue wait only, like the coalescer); a device failure mid-call
        falls back instead of erroring the request (the seam already fed
        the breaker); and every device answer is verified host-side so a
        poisoned kernel can never emit a silent wrong answer — a corrupted
        grid OR a false UNSAT claim. ``DeadlineExceeded`` always
        propagates: a shed request stays shed.

        Only a device fault (``device_fault``: an injected fault, a launch's
        CUDA error, a CUDA error or out-of-memory raised by torch, a solve
        starved behind a hung device call) falls back. Any other error (a
        kernel library that does not build or load, a programming error)
        fails the request. This departs from the JAX engine, whose seam
        falls back on any exception: here a fallback must never hide the
        kernel."""
        if sup.should_fallback():
            return sup.fallback_solve(arr, deadline_s=deadline_s)
        try:
            solution, info = call()
        except DeadlineExceeded:
            raise
        except Exception as exc:
            if not device_fault(exc):
                raise
            logger.exception(
                "device path failed — answering from the host-oracle "
                "fallback"
            )
            return sup.fallback_solve(arr)
        tr = current_trace()
        if solution is not None:
            t_v = time.monotonic()
            ok = sup.check_solution(arr, solution)
            if tr is not None:
                # the host-side verification stage of this request's span
                tr.mark("verify", time.monotonic() - t_v)
            if not ok:
                # the device call "succeeded" but the answer is wrong: the
                # poisoned-kernel failure mode — never serve it
                logger.error(
                    "device answer failed host-side verification — "
                    "poisoned kernel? answering from the fallback"
                )
                sup.record_failure(None, "bad-result")
                return sup.fallback_solve(arr)
        if solution is None and not info.get("capped"):
            # the device claims PROVEN unsatisfiable (capped answers claim
            # only "not finished" and are exempt): cross-check — a kernel
            # clearing the solved flag is as wrong as one corrupting the
            # grid, and must trip the breaker too
            t_v = time.monotonic()
            alt, alt_info = sup.verify_unsat(arr)
            if tr is not None:
                tr.mark("verify", time.monotonic() - t_v)
            if alt is not None:
                sup.record_failure(None, "bad-result")
                return alt, alt_info
        return solution, info

    def solve_one_supervised(
        self,
        board: Sequence[Sequence[int]],
        *,
        deadline_s: Optional[float] = None,
    ) -> Tuple[Optional[List[List[int]]], dict]:
        """``solve_one_async(...).result()`` with the supervisor's
        degraded-serving contract applied in the CALLING thread — the
        serving entry point ``net/node.py`` uses for /solve requests.

        Without a supervisor this is exactly that await. With one, the
        ``_supervised_answer`` contract applies (open breaker → bounded
        host-oracle fallback; a device fault OR a starved future — a
        hung segment ahead of this request — falls back instead of
        erroring or pinning the handler thread; answers are verified
        host-side). ``DeadlineExceeded`` always propagates (the 429 path),
        and the fallback honors an already-expired deadline. The inline
        routes (``coalesce=False``, and a frontier engine's) are supervised
        inside ``solve_one``, once: its bucket path is the seam, and a race
        that fails on the device already falls back there."""
        sup = self.supervisor
        if sup is None:
            return self.solve_one_async(board, deadline_s=deadline_s).result()
        arr = np.asarray(board, np.int32)
        inline = not self.coalesce or self.frontier_enabled
        if deadline_s is not None and time.monotonic() > deadline_s and (
            sup.should_fallback() or inline
        ):
            raise DeadlineExceeded("deadline expired before the solve started")
        if not inline:
            return self._supervised_answer(
                sup, arr,
                lambda: self._await_result(self.coalescer.submit(arr, deadline_s)),
                deadline_s=deadline_s,
            )
        return self.solve_one(arr, deadline_s=deadline_s)

    def solve_one_async(
        self,
        board: Sequence[Sequence[int]],
        *,
        frontier: Optional[bool] = None,
        deadline_s: Optional[float] = None,
    ) -> Future:
        """``solve_one`` returning a ``concurrent.futures.Future``.

        With the coalescer on, a bucket-path request is enqueued and the
        call returns at once; concurrent requests share one device call.
        Frontier-routed requests (and engines without the coalescer) run
        inline in the calling thread: the race occupies the device by
        design and must not stall the bucket pipeline behind it.

        ``deadline_s`` (absolute ``time.monotonic()``, from the admission
        layer — serving/admission.py): a coalesced request still queued
        past it is dropped at batch formation and the future raises
        DeadlineExceeded; the inline path checks it once before solving
        (work already started is never abandoned — the deadline guards
        queue wait, not service time)."""
        arr = np.asarray(board, np.int32)
        use_frontier = (
            self.frontier_enabled
            if frontier is None
            else (frontier and self.frontier_enabled)
        )
        if self.coalesce and not use_frontier:
            return self.coalescer.submit(arr, deadline_s)
        fut: Future = Future()
        try:
            if deadline_s is not None and time.monotonic() > deadline_s:
                raise DeadlineExceeded(
                    "deadline expired before the solve started"
                )
            fut.set_result(
                self.solve_one(arr, frontier=frontier, deadline_s=deadline_s)
            )
        except BaseException as e:  # noqa: BLE001 — deliver through the future
            fut.set_exception(e)
        return fut
