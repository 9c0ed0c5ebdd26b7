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
(parallel/coalescer.py, closed loop) by default, so concurrent requests
share one bucketed call. A dispatch enqueues the first depth stage and
the copy of its rows into pinned host memory and returns without waiting
for the device; finalizing waits on that copy's CUDA event, then runs
whatever the rows ask for — a deeper depth stage for OVERFLOW boards, the
deep retry for RUNNING ones — on a stream of its own, so it never waits
for a later batch's launch.

The engine runs on the GPU unless the caller passes ``device="cpu"``; with
no GPU and no such request the constructor raises. On the CPU the kernel
wrapper runs its plain PyTorch version (the tests' configuration).

Not in this slice (each raises ``NotImplementedError`` when asked for):
a choice of backend (the engine always runs the kernel), continuous
batching, the mesh and the frontier race, AOT/compile caches and
supervision.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from concurrent.futures import Future
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .ops.config import SERVING_CONFIG
from .ops.cuda_solver import solve_stage
from .ops.solver import OVERFLOW, RUNNING, pad_board, staged_depths
from .ops.spec import SPEC_9, BoardSpec
from .serving.admission import DeadlineExceeded

logger = logging.getLogger(__name__)

DEFAULT_BUCKETS = (1, 8, 64, 512, 4096)

# constructor sentinel: "use ops.SERVING_CONFIG for this board size" —
# distinct from an explicit None, which means the spec's full flat depth
_AUTO = object()

# SolverEngine knobs of the JAX package that this port does not have yet.
# Passing one with a value other than None/False raises instead of being
# ignored (``continuous=None`` and ``continuous=False`` both mean the
# closed loop this engine runs).
_UNPORTED = frozenset((
    "backend", "mesh", "bucket_multiple", "sharding", "frontier_mesh",
    "frontier_states_per_device", "frontier_route",
    "frontier_escalate_iters", "frontier_handoff", "continuous",
    "segment_iters", "segment_pipeline", "deep_lane_cap",
    "compile_cache_dir", "aot_artifacts", "solver_config",
))


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


class _Inflight(NamedTuple):
    """A dispatched bucket: the first depth stage's rows on their way to
    the host, and what finalizing needs to run the later stages."""

    host: torch.Tensor                 # (B, C+4) rows; pinned on CUDA
    ready: Optional[torch.cuda.Event]  # recorded after the copy; None on CPU
    dev: torch.Tensor                  # (B, N, N) the padded boards, on device
    boards: np.ndarray                 # the padded boards, on the host
    n: int                             # real (unpadded) rows
    iters: int                         # the call's step budget
    sweeps: dict                       # the call's sweep knobs


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
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
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
        self._coalescer = None
        self._coalescer_init_lock = threading.Lock()
        # the stream finalizing runs later depth stages and deep retries
        # on (None on the CPU): off the dispatcher's stream, so they never
        # queue behind the next batch's launch
        self._side_stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )
        self._lock = threading.Lock()
        # cumulative engine effort, the analog of the reference's
        # `validations` counter: one unit per analysis sweep per board
        self.validations = 0
        self.solved_puzzles = 0
        self.warmed = False

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
                    )
        return self._coalescer

    def close(self) -> None:
        """Drain and stop the coalescer (futures resolve before return).
        Safe on an engine that never coalesced; idempotent."""
        if self._coalescer is not None:
            self._coalescer.close()

    # -- internals ---------------------------------------------------------
    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _device_batch(self, boards: np.ndarray) -> torch.Tensor:
        """Host boards → the engine's device, without a host sync on CUDA
        (a copy from pageable memory would wait for the stream)."""
        t = torch.from_numpy(np.ascontiguousarray(boards, dtype=np.int32))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _sweeps(self, width: int) -> dict:
        """The sweep knobs of a ``width``-board call: a single board sweeps
        once a step — extra sweeps only amortize a step's machinery over a
        batch — and wider buckets run ``self.waves``."""
        return dict(
            locked_candidates=self.locked_candidates,
            waves=1 if width == 1 else self.waves,
            naked_pairs=self.naked_pairs,
        )

    def _stage_rows(self, dev: torch.Tensor, depth: int, iters: int,
                    sweeps: dict) -> torch.Tensor:
        """One depth stage on the device: the packed (B, C+4) int32 rows
        [grid | solved | status | guesses | validations] (the JAX engine's
        row layout without its two cost-accounting columns)."""
        res, _ = solve_stage(dev, self.spec, depth, iters, **sweeps)
        B = dev.shape[0]
        return torch.cat(
            [
                res.grid.reshape(B, -1),
                res.solved[:, None].to(torch.int32),
                res.status[:, None],
                res.guesses[:, None],
                res.validations[:, None],
            ],
            dim=1,
        )

    def _launch(self, boards: np.ndarray, n: int, iters: int) -> _Inflight:
        """Enqueue the first depth stage of the padded ``boards`` and the
        copy of its rows to the host; no host sync."""
        dev = self._device_batch(boards)
        sweeps = self._sweeps(boards.shape[0])
        rows = self._stage_rows(dev, self._depths[0], iters, sweeps)
        if rows.device.type == "cpu":
            return _Inflight(rows, None, dev, boards, n, iters, sweeps)
        host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
        host.copy_(rows, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(rows.device))
        return _Inflight(host, ready, dev, boards, n, iters, sweeps)

    def _follow_up(self):
        """Context for finalizing's device work: the engine's side stream
        on CUDA, nothing on the CPU."""
        if self._side_stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._side_stream)

    def _wait_rows(self, call: _Inflight) -> np.ndarray:
        """The host rows of a launched call once every depth stage ran:
        waits for the first stage's copy, then reruns the boards that hit
        OVERFLOW at each deeper stage — every other lane a pad board, as
        ``ops.solver.solve_staged`` does — taking their grid and status and
        accumulating their guesses and validations."""
        if call.ready is not None:
            call.ready.synchronize()
        rows = call.host.numpy().copy()
        C = self.spec.cells
        for depth in self._depths[1:]:
            need = rows[:, C + 1] == OVERFLOW
            if not need.any():
                continue
            dev = call.dev
            g2 = torch.where(
                torch.as_tensor(need).to(dev.device)[:, None, None],
                dev,
                pad_board(self.spec, dev.device),
            )
            r2 = self._stage_rows(g2, depth, call.iters, call.sweeps).cpu().numpy()
            rows[need, : C + 2] = r2[need, : C + 2]
            rows[need, C + 2:] += r2[need, C + 2:]
        return rows

    def _dispatch_padded(self, boards: np.ndarray) -> _Inflight:
        """Pad ≤bucket boards into their bucket and enqueue one device call.
        Returns as soon as the work is enqueued (no host sync), so a caller
        (the coalescer's dispatcher thread) can stack batch N+1 while batch
        N runs; ``_finalize_padded`` takes the handle."""
        n = boards.shape[0]
        bucket = self._bucket_for(n)
        if n < bucket:
            # Pad with COPIES of a real row, not empty boards: a block of
            # boards runs until its slowest board finishes, and a copy of
            # boards[0] adds no step to the call by construction.
            pad = np.broadcast_to(boards[0], (bucket - n, *boards.shape[1:]))
            boards = np.concatenate([boards, pad], axis=0)
        return self._launch(boards, n, self.max_iters)

    def _finalize_padded(self, call: _Inflight) -> np.ndarray:
        """Wait for a ``_dispatch_padded`` call (its later depth stages
        included) and rerun the boards still RUNNING at the budget once at
        ``deep_retry_factor ×`` it, in the smallest covering bucket,
        accumulating their guesses and validations. Returns the packed
        (n, C+4) host rows."""
        C = self.spec.cells
        n = call.n
        with self._follow_up():
            rows = self._wait_rows(call)
            running = rows[:, C + 1] == RUNNING
            if running[:n].any():
                capped = np.flatnonzero(running[:n])
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
                deep = self._wait_rows(
                    self._launch(
                        sub, len(capped), self.max_iters * self.deep_retry_factor
                    )
                )
                first = rows[capped].copy()
                rows[capped] = deep[: len(capped)]
                rows[capped, C + 2] += first[:, C + 2]
                rows[capped, C + 3] += first[:, C + 3]
        return rows[:n]

    def _solve_padded(self, boards: np.ndarray) -> np.ndarray:
        return self._finalize_padded(self._dispatch_padded(boards))

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
        """Would ``/readyz`` pass: warm."""
        return bool(self.warmed)

    def warmup(self) -> None:
        """Run every bucket width once (empty boards) before serving, so the
        first request pays neither the kernel build nor the first launch.
        The counters are not touched."""
        N = self.spec.size
        for b in self.buckets:
            self._solve_padded(np.zeros((b, N, N), np.int32))
        self.warmed = True

    def solve_batch_np(
        self, boards: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, dict]:
        """Solve (B, N, N) boards.

        Returns (solutions, solved_mask, info). Rows of unsolved boards hold
        the partial/original grid. Tiles over the largest bucket.
        ``info["capped"]`` counts boards whose search exhausted even the
        deep-retry budget: for those "not solved" means "not finished",
        not "proven unsatisfiable"."""
        boards = np.asarray(boards, np.int32)
        B = boards.shape[0]
        N = self.spec.size
        C = self.spec.cells
        cap = self.buckets[-1]
        packed = np.concatenate(
            [self._solve_padded(boards[lo: lo + cap]) for lo in range(0, B, cap)],
            axis=0,
        )
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

    def solve_one(
        self,
        board: Sequence[Sequence[int]],
        *,
        deadline_s: Optional[float] = None,
    ) -> Tuple[Optional[List[List[int]]], dict]:
        """Solve a single board through the bucket path: coalesced with
        concurrent requests when enabled, else a direct width-1 call.
        Returns (solution | None, info).

        ``deadline_s`` has the JAX engine's meaning: it bounds the
        frontier route, which this package does not have yet, so on the
        bucket route it changes nothing. A deadline that guards the queue
        rides ``solve_one_async``."""
        del deadline_s  # the bucket route has no frontier leg to bound
        arr = np.asarray(board, np.int32)
        if self.coalesce:
            solution, info = self.coalescer.submit(arr).result()
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

    def solve_one_async(
        self,
        board: Sequence[Sequence[int]],
        *,
        deadline_s: Optional[float] = None,
    ) -> Future:
        """``solve_one`` returning a ``concurrent.futures.Future``.

        With the coalescer on, the request is enqueued and the call returns
        at once; concurrent requests share one device call. Without it, the
        solve runs inline in the calling thread.

        ``deadline_s`` (absolute ``time.monotonic()``, from the admission
        layer — serving/admission.py): a coalesced request still queued
        past it is dropped at batch formation and the future raises
        DeadlineExceeded; the inline path checks it once before solving
        (work already started is never abandoned — the deadline guards
        queue wait, not service time)."""
        arr = np.asarray(board, np.int32)
        if self.coalesce:
            return self.coalescer.submit(arr, deadline_s)
        fut: Future = Future()
        try:
            if deadline_s is not None and time.monotonic() > deadline_s:
                raise DeadlineExceeded(
                    "deadline expired before the solve started"
                )
            fut.set_result(self.solve_one(arr))
        except BaseException as e:  # noqa: BLE001 — deliver through the future
            fut.set_exception(e)
        return fut
