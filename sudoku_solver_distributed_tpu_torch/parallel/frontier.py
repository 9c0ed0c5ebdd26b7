"""The search-frontier race: one hard board raced across its own subtrees.

The port of ``sudoku_solver_distributed_tpu/parallel/frontier.py`` on one
device. A host-side seeding pass expands the board into many disjoint
subtrees (k-way splits on minimum-remaining-values cells, after
propagating singles), and the race runs every subtree's DFS until any
subtree solves: the first solution found by the lowest-index state wins,
and "not found" with no subtree left undecided is a proof that the board
has no solution.

The JAX package races in lockstep across a mesh, with a one-scalar
``psum`` after every step for the early exit. Here the race runs on one
CUDA device through the race kernel (ops/cuda_solver.dfs_race, K4, one
launch: a thread block per state, each stopping once it has run more steps
than the earliest solve posted so far, and a fold by the last block that
rebuilds the lockstep result exactly); on the CPU
the wrapper runs the plain lockstep race (ops/solver.race). Seeding runs
on the host, on CPU tensors, as the JAX package seeds on its CPU backend:
it is a handful of tiny analyze/split rounds with a host decision between
each.

Not in this slice: a race across more than one device (the multi-GPU
slice) and the multi-host ``FrontierServingLoop``.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..obs.trace import current_trace
from ..ops.cuda_solver import dfs_race
from ..ops.encode import mask_to_value
from ..ops.propagate import analyze
from ..ops.spec import SPEC_9, BoardSpec
from ..serving.admission import DeadlineExceeded

# shared by frontier_solve and the engine's warm-up, as in the JAX package
DEFAULT_MAX_ITERS = 65536


def _unsat_pad(spec: BoardSpec) -> np.ndarray:
    """A trivially contradictory board — frontier padding that dies in one step."""
    board = np.zeros((spec.size, spec.size), np.int32)
    board[0, 0] = 1
    board[0, 1] = 1
    return board


def race_device(mesh=None) -> torch.device:
    """The one device a race runs on, from the engine's ``frontier_mesh``
    or ``frontier_solve``'s ``mesh``: None means CUDA (raising without
    one), a device or its name means that device, and a sequence must hold
    exactly one. A race across more devices is the multi-GPU slice's."""
    if isinstance(mesh, (list, tuple)):
        if len(mesh) != 1:
            raise NotImplementedError(
                f"a frontier race across {len(mesh)} devices is not ported "
                "yet: the race runs on one device"
            )
        mesh = mesh[0]
    from ..engine import resolve_device

    return resolve_device(mesh)


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def state_handoff_frontier(state, spec: BoardSpec) -> np.ndarray:
    """Decompose a single-board DFS end state into its unexplored subtrees.

    The probe→race handoff: for a depth-``d`` state the unexplored region
    of the root's solution space is, for each stack level ``k < d``, the
    pre-guess snapshot ``stack_grid[k]`` with ``stack_cell[k]`` set to each
    still-untried candidate in ``stack_mask[k]``, and the current ``grid``
    (the active path's subtree, still mid-search). These boards are
    pairwise disjoint and, with the regions the probe already refuted,
    cover the root's space, so the race's verdict over them is a verdict
    for the root.

    ``state`` has the fields of ``ops.solver._State`` / ``SegmentState``
    for one board (numpy arrays or tensors, batch axis first). Returns
    (M, N, N) int32 with M ≥ 1."""
    N = spec.size
    depth = int(_np(state.depth)[0])
    boards = []
    stack_grid = _np(state.stack_grid)[0].astype(np.int32)
    stack_cell = _np(state.stack_cell)[0]
    stack_mask = _np(state.stack_mask)[0]
    for k in range(min(depth, stack_mask.shape[0])):
        mask = int(stack_mask[k])
        if mask == 0:
            continue
        i, j = divmod(int(stack_cell[k]), N)
        base = stack_grid[k].reshape(N, N)
        while mask:
            bit = mask & -mask
            mask &= ~bit
            child = base.copy()
            child[i, j] = bit.bit_length()
            boards.append(child)
    boards.append(_np(state.grid)[0].reshape(N, N).astype(np.int32))
    return np.stack(boards)


def seed_frontier(
    board: np.ndarray,
    spec: BoardSpec = SPEC_9,
    *,
    target: int = 64,
    max_rounds: Optional[int] = None,
    locked: bool = False,
    initial_states: Optional[np.ndarray] = None,
    deadline_s: Optional[float] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Expand one board into ≥``target`` disjoint speculative states.

    Host-driven BFS on CPU tensors: analyze all current states, drop
    contradictions, assign every forced single, and once no single is left
    k-way split each state on its MRV cell (one child per candidate value,
    so the children partition the parent's solution space exactly). Stops
    early if propagation alone solves the board.

    ``initial_states`` starts the expansion from these (M, N, N) states
    instead of the root board (the probe→race handoff,
    ``state_handoff_frontier``). ``deadline_s`` (absolute monotonic) is
    checked at every round boundary: a request that expires mid-seeding
    raises ``DeadlineExceeded``.

    Returns (states, solved): states is (M, N, N) with M ≥ target unless
    the search space is exhausted (then padded with instantly-unsat
    boards); solved is the solution if one fell out during seeding, else
    None. The JAX package pads every round's batch to a power of two so
    its jitted analysis sees few shapes; PyTorch runs eagerly and the
    analysis is per-board, so the port analyzes the batch as it is."""
    if max_rounds is None:
        # each round either assigns singles (≤ cells of them) or splits
        max_rounds = spec.cells + 16
    if initial_states is not None:
        states = np.asarray(initial_states, np.int32)
    else:
        states = np.asarray(board, np.int32)[None]
    return _seed_rounds(states, spec, target, max_rounds, locked, deadline_s)


def _seed_rounds(states, spec, target, max_rounds, locked, deadline_s=None):
    for _ in range(max_rounds):
        if deadline_s is not None and time.monotonic() > deadline_s:
            raise DeadlineExceeded("deadline expired during frontier seeding")
        a = analyze(torch.from_numpy(np.ascontiguousarray(states)), spec,
                    locked=locked)
        solved = a.solved.numpy()
        if solved.any():
            return states, states[int(np.argmax(solved))]
        live = ~a.contradiction.numpy()
        if not live.any():
            # unsat root: hand back dead boards; the race reports UNSAT
            break
        assign = a.assign.numpy()
        if (assign[live] != 0).any():
            # propagate singles everywhere before splitting
            filled = mask_to_value(a.assign, spec).numpy()
            states = np.where((states == 0) & (assign != 0), filled, states)
            states = states[live]
            continue
        states = states[live]
        if len(states) >= target:
            return states, None
        # k-way split every state on its MRV cell
        cand = a.cand.numpy()[live].reshape(len(states), -1)
        pc = sum((cand >> k) & 1 for k in range(spec.size))
        pc = np.where(cand != 0, pc, 10**6)
        cells = pc.argmin(axis=1)
        children = []
        for s_idx, cell in enumerate(cells):
            mask = int(cand[s_idx, cell])
            if mask == 0:  # fully filled (would have been solved): keep as-is
                children.append(states[s_idx])
                continue
            i, j = divmod(int(cell), spec.size)
            while mask:
                bit = mask & -mask
                mask &= ~bit
                child = states[s_idx].copy()
                child[i, j] = bit.bit_length()
                children.append(child)
        states = np.stack(children)
        if len(states) >= target:
            # the overshoot (up to target × N children) is not analyzed
            # again: the race propagates and solves them anyway
            return states, None

    if len(states) < target:
        pad = np.broadcast_to(
            _unsat_pad(spec), (target - len(states), spec.size, spec.size)
        )
        states = np.concatenate([states, pad], axis=0)
    return states, None


def warm_seeding(spec: BoardSpec, target: int, locked: bool = False) -> None:
    """Run one seeding round's analysis and assignment at every power-of-two
    batch up to ``pow2(target)``, so a server's first frontier-routed
    request pays no first-call costs of the CPU ops (the JAX package
    compiles its seeding programs here)."""
    m = 1
    while True:
        z = torch.zeros((m, spec.size, spec.size), dtype=torch.int32)
        mask_to_value(analyze(z, spec, locked=locked).assign, spec)
        if m >= target:
            break
        m *= 2


def bucket_states(states: np.ndarray, spec: BoardSpec,
                  states_per_device: int) -> np.ndarray:
    """Pad the seeded states with instantly-unsat boards up to
    ``states_per_device × 2^k``, the smallest such count that holds them
    all. No seeded state is ever dropped: each covers a disjoint slice of
    the search space. The geometric rungs keep the set of race shapes
    small (the engine warms the first three)."""
    bucket = max(states_per_device, 1)
    while bucket < len(states):
        bucket *= 2
    if len(states) < bucket:
        pad = np.broadcast_to(
            _unsat_pad(spec), (bucket - len(states), spec.size, spec.size)
        )
        states = np.concatenate([states, pad], axis=0)
    return states


def frontier_solve(
    board,
    mesh=None,
    spec: BoardSpec = SPEC_9,
    *,
    states_per_device: int = 64,
    max_iters: int = DEFAULT_MAX_ITERS,
    max_depth=None,
    locked: bool = False,
    waves: int = 1,
    naked_pairs: Optional[bool] = None,
    packed: Optional[bool] = None,
    initial_states: Optional[np.ndarray] = None,
    deadline_s: Optional[float] = None,
) -> Tuple[Optional[list], dict]:
    """Solve one (hard) board by racing its search subtrees on one device.

    ``mesh`` names the device (``race_device``: None → CUDA). Returns
    (solution | None, info). info carries ``validations`` (the sweeps of
    every state), ``seeded`` (the states raced, padding included) and
    ``handoff`` (whether ``initial_states`` seeded it), and, when no
    solution was found, ``capped``: True when some subtree OVERFLOWed its
    stack or was still RUNNING at ``max_iters`` (the board is NOT proven
    unsolvable), False for a proof.

    A staged (tuple) ``max_depth`` collapses to its deepest stage: the
    race runs one flat search per subtree. ``initial_states`` seeds the
    race from these states instead of expanding ``board`` from its root;
    "not found" then means "not in THESE subtrees", so callers pass a
    covering set of the unexplored space. ``deadline_s`` (absolute
    monotonic) cancels with ``DeadlineExceeded`` at the seeding round
    boundaries and once more before the race dispatches; a race already
    dispatched runs to completion.

    Seeding is stamped on the calling thread's request span as its
    ``coalesce`` stage (this route's batch formation), the race as its
    ``device`` stage (dispatch → the packed row on the host)."""
    dev = race_device(mesh)
    if isinstance(max_depth, (tuple, list)):
        max_depth = max(max_depth)
    depth = spec.max_depth if max_depth is None else int(max_depth)
    board = np.asarray(board, np.int32)
    tr = current_trace()
    t_seed = time.monotonic()
    states, early = seed_frontier(
        board, spec, target=states_per_device, locked=locked,
        initial_states=initial_states, deadline_s=deadline_s,
    )
    if tr is not None:
        tr.mark("coalesce", time.monotonic() - t_seed)
    if early is not None:
        return early.tolist(), {
            "validations": 0,
            "seeded": len(states),
            "handoff": initial_states is not None,
        }
    states = bucket_states(states, spec, states_per_device)
    if deadline_s is not None and time.monotonic() > deadline_s:
        raise DeadlineExceeded(
            "deadline expired before the frontier race dispatched"
        )
    t_dev = time.monotonic()
    M, C = len(states), spec.cells
    flat = torch.from_numpy(np.ascontiguousarray(states.reshape(M, C)))
    row, _, _ = dfs_race(
        flat.to(dev), spec, depth, max_iters, locked_candidates=locked,
        waves=waves, naked_pairs=naked_pairs, packed=packed,
    )
    packed_row = row.cpu().numpy()  # the race's one device→host fetch
    if tr is not None:
        tr.mark("device", time.monotonic() - t_dev)
    found, validations = bool(packed_row[C]), int(packed_row[C + 1])
    info = {
        "validations": validations,
        "seeded": M,
        "handoff": initial_states is not None,
    }
    if not found:
        info["capped"] = bool(packed_row[C + 2])
        return None, info
    return packed_row[:C].reshape(spec.size, spec.size).tolist(), info
