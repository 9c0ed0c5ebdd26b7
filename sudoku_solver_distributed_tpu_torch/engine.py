"""Serving engine: bucketed batch solving behind the DFS kernel.

The port of the closed-loop bucket slice of
``sudoku_solver_distributed_tpu/engine.py``: request boards are padded into
a small set of batch buckets and solved in one device call through the
CUDA kernel (ops/cuda_solver.solve_batch_cuda), and the per-board
validation sweeps are folded into host-side counters. Boards still RUNNING
at the step budget rerun once at ``deep_retry_factor ×`` the budget, with
their counters accumulated, rather than being misreported as unsolvable.

The engine runs on the GPU unless the caller passes ``device="cpu"``; with
no GPU and no such request the constructor raises. On the CPU the kernel
wrapper runs its plain PyTorch version (the tests' configuration).

Not in this slice (each raises ``NotImplementedError`` when asked for):
a choice of backend (the engine always runs the kernel), the request
coalescer and continuous batching, the mesh and the frontier race,
AOT/compile caches, supervision, and the serving config's
locked-candidate / naked-pair / multi-wave sweeps.
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .ops.config import SERVING_CONFIG
from .ops.cuda_solver import solve_batch_cuda
from .ops.solver import RUNNING
from .ops.spec import SPEC_9, BoardSpec

logger = logging.getLogger(__name__)

DEFAULT_BUCKETS = (1, 8, 64, 512, 4096)

# constructor sentinel: "use ops.SERVING_CONFIG for this board size" —
# distinct from an explicit None, which means the spec's full flat depth
_AUTO = object()

# SolverEngine knobs of the JAX package that this port does not have yet.
# Passing one with a value other than None/False raises instead of being
# ignored.
_UNPORTED = frozenset((
    "backend", "mesh", "bucket_multiple", "sharding", "frontier_mesh",
    "frontier_states_per_device", "frontier_route",
    "frontier_escalate_iters", "frontier_handoff", "coalesce_max_wait_s",
    "coalesce_quiescence_s", "coalesce_burst_wait_s",
    "coalesce_inflight_depth", "coalesce_max_batch", "coalesce_adaptive",
    "continuous", "segment_iters", "segment_pipeline", "deep_lane_cap",
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
      locked_candidates / waves / naked_pairs: the JAX serving solver's
        extra sweeps; the kernel runs singles-only, one sweep per step, so
        only False / 1 / False are accepted.
      coalesce: False (the request coalescer is not ported yet).
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
        coalesce: bool = False,
        **unported,
    ):
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError(f"SolverEngine got an unexpected argument {name!r}")
            if value is not None and value is not False:
                raise NotImplementedError(
                    f"SolverEngine({name}=...) is not ported yet"
                )
        if locked_candidates:
            raise NotImplementedError(
                "locked_candidates is not ported yet: the kernel runs "
                "singles-only analysis"
            )
        if waves not in (None, 1):
            raise NotImplementedError(
                "waves is not ported yet: the kernel runs one sweep per step"
            )
        if naked_pairs:
            raise NotImplementedError("naked_pairs is not ported yet")
        if coalesce:
            raise NotImplementedError(
                "the request coalescer is not ported yet; use coalesce=False"
            )
        self.spec = spec
        self.device = resolve_device(device)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        cfg = SERVING_CONFIG.get(spec.size, {})
        if max_depth is _AUTO:
            max_depth = cfg.get("max_depth")
        self.max_depth = max_depth
        if max_iters is None:
            max_iters = cfg.get("max_iters", 4096)
        self.max_iters = max_iters
        self.deep_retry_factor = deep_retry_factor
        self._lock = threading.Lock()
        # cumulative engine effort, the analog of the reference's
        # `validations` counter: one unit per analysis sweep per board
        self.validations = 0
        self.solved_puzzles = 0
        self.warmed = False

    # -- internals ---------------------------------------------------------
    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _device_batch(self, boards: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(
            np.ascontiguousarray(boards, dtype=np.int32), device=self.device
        )

    def _run(self, grid: torch.Tensor, max_iters: int) -> torch.Tensor:
        """One device call: the packed (B, C+4) int32 rows [grid | solved |
        status | guesses | validations] (the JAX engine's row layout
        without its two cost-accounting columns), so the host pays one
        device→host copy per call."""
        B = grid.shape[0]
        res = solve_batch_cuda(
            grid, self.spec, max_depth=self.max_depth, max_iters=max_iters
        )
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

    def _dispatch_padded(self, boards: np.ndarray):
        """Pad ≤bucket boards into their bucket and launch one device call.
        Returns the handle ``_finalize_padded`` takes."""
        n = boards.shape[0]
        bucket = self._bucket_for(n)
        if n < bucket:
            # Pad with COPIES of a real row, not empty boards: a block of
            # boards runs until its slowest board finishes, and a copy of
            # boards[0] adds no step to the call by construction.
            pad = np.broadcast_to(boards[0], (bucket - n, *boards.shape[1:]))
            boards = np.concatenate([boards, pad], axis=0)
        packed = self._run(self._device_batch(boards), self.max_iters)
        return packed, boards, n

    def _finalize_padded(self, packed, boards: np.ndarray, n: int) -> np.ndarray:
        """Fetch a ``_dispatch_padded`` call (the one device→host copy of
        the bucket path) and rerun the boards still RUNNING at the budget
        once at ``deep_retry_factor ×`` it, in the smallest covering bucket,
        accumulating their guesses and validations. Returns the packed
        (n, C+4) host rows."""
        packed = packed.cpu().numpy().copy()
        C = self.spec.cells
        running = packed[:, C + 1] == RUNNING
        if running[:n].any():
            capped = np.flatnonzero(running[:n])
            sub = boards[capped]
            bucket2 = self._bucket_for(len(capped))
            if len(capped) < bucket2:
                sub = np.concatenate(
                    [
                        sub,
                        np.broadcast_to(
                            sub[0], (bucket2 - len(capped), *boards.shape[1:])
                        ),
                    ],
                    axis=0,
                )
            deep = self._run(
                self._device_batch(sub), self.max_iters * self.deep_retry_factor
            ).cpu().numpy()
            first = packed[capped].copy()
            packed[capped] = deep[: len(capped)]
            packed[capped, C + 2] += first[:, C + 2]
            packed[capped, C + 3] += first[:, C + 3]
        return packed[:n]

    def _solve_padded(self, boards: np.ndarray) -> np.ndarray:
        return self._finalize_padded(*self._dispatch_padded(boards))

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
            boards = self._device_batch(np.zeros((b, N, N), np.int32))
            self._run(boards, self.max_iters).cpu()
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
        self, board: Sequence[Sequence[int]]
    ) -> Tuple[Optional[List[List[int]]], dict]:
        """Solve a single board through the bucket path; returns
        (solution | None, info)."""
        arr = np.asarray(board, np.int32)
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
