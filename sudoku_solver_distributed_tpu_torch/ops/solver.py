"""Batched DFS sudoku solver in plain PyTorch — the kernel's reference.

The port of the closed loop of ``sudoku_solver_distributed_tpu/ops/solver.py``
with its sweep knobs: locked-candidate eliminations (``locked_candidates``,
``naked_pairs``, ``packed``) and ``waves - 1`` extra propagation sweeps per
step (``waves``, ``light_waves``). It is the plain version of the CUDA
kernel in csrc/dfs_solver.cu: the same inputs and knobs give the same
grid, status, guesses and validations per board. The kernel wrapper
(ops/cuda_solver.py) runs it for CPU tensors only; tests and
``chip_smoke.py`` hold the kernel against it.

Every board runs the same step each iteration: one fused analysis, then
one of {assign every forced single, branch on the minimum-remaining-values
cell, backtrack}, then the extra sweeps. Recursion is an explicit guess
stack of fixed depth D (OVERFLOW when a branch would exceed it); per-board
status lanes (RUNNING / SOLVED / UNSAT / OVERFLOW) mask finished boards
out.

The JAX loop shrinks the batch as boards finish (its compaction ladder);
that changes the schedule and nothing a board computes, because a board's
step depends only on its own row and a finished row is a fixed point. So
this module runs one flat loop.

``_step`` updates the stack tensors of the state it is given in place (a
(B, D, C) int8 stack copied every step would be D× the step's traffic), so
a state is consumed by stepping it.

The segment API at the end (``SegmentState``, ``inject_lanes_src``,
``run_segment``, ``segment_digest``) is the open loop of continuous
batching: a lane pool advanced in bounded segments, with new boards
injected into freed lanes between them. It is the plain version of the
segment kernel (csrc/dfs_solver.cu ``dfs_segment_kernel``). A board's
trajectory and counters do not depend on how its steps are cut into
segments or on what runs in the other lanes, since a step is
elementwise over the board axis and a finished row is a fixed point.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .encode import mask_to_value, popcount
from .propagate import analyze
from .spec import BoardSpec

RUNNING = 0
SOLVED = 1
UNSAT = 2
OVERFLOW = 3  # guess stack exhausted (fixed depth; see BoardSpec.max_depth)

_INT32_MAX = 2**31 - 1


class SolveResult(NamedTuple):
    grid: torch.Tensor         # (B, N, N) int32 — solution where solved
    solved: torch.Tensor       # (B,) bool
    status: torch.Tensor       # (B,) int32 — SOLVED / UNSAT / OVERFLOW / RUNNING
    guesses: torch.Tensor      # (B,) int32 — speculative branches taken
    validations: torch.Tensor  # (B,) int32 — analysis sweeps while RUNNING
    # steps of the loop (summed over depth stages); the kernel route keeps
    # it on the device as a 0-dim tensor, read with int()
    iters: int | torch.Tensor


class LoopStats(NamedTuple):
    """Work counters of a solve: ``lane_steps`` counts board-lanes swept
    (each step adds the batch width), ``idle_lane_steps`` the subset that
    were already finished when the step ran."""

    lane_steps: int
    idle_lane_steps: int


class _State(NamedTuple):
    grid: torch.Tensor         # (B, C) int32, flattened boards
    stack_grid: torch.Tensor   # (B, D, C) int8 — snapshot at each guess
    stack_cell: torch.Tensor   # (B, D) int32 — flat cell index guessed at
    stack_mask: torch.Tensor   # (B, D) int32 — candidate bits not yet tried
    depth: torch.Tensor        # (B,) int32
    status: torch.Tensor       # (B,) int32
    guesses: torch.Tensor      # (B,) int32
    validations: torch.Tensor  # (B,) int32
    iters: int                 # steps taken


def init_state(
    grid: torch.Tensor, spec: BoardSpec, max_depth: int | None = None
) -> _State:
    """Fresh solver state for a (B, N, N) batch, on the batch's device."""
    B = grid.shape[0]
    C = spec.cells
    D = max_depth if max_depth is not None else spec.max_depth
    dev = grid.device

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return _State(
        grid=grid.to(torch.int32).reshape(B, C).clone(),
        stack_grid=zeros(B, D, C, dtype=torch.int8),
        stack_cell=zeros(B, D),
        stack_mask=zeros(B, D),
        depth=zeros(B),
        status=zeros(B),
        guesses=zeros(B),
        validations=zeros(B),
        iters=0,
    )


def state_from_numpy(fields, device="cpu") -> _State:
    """A port ``_State`` from the fields of a JAX ``_State`` held as numpy
    arrays (a NamedTuple or a mapping with the same field names), so a
    search stopped mid-way in the JAX package continues here — stack and
    counters included."""
    if hasattr(fields, "_asdict"):
        fields = fields._asdict()
    dtypes = {"stack_grid": torch.int8}
    out = {}
    for name in _State._fields:
        if name == "iters":
            out[name] = int(fields[name])
            continue
        arr = torch.as_tensor(fields[name].copy())
        out[name] = arr.to(device=device, dtype=dtypes.get(name, torch.int32))
    return _State(**out)


def _mrv_cell(grid: torch.Tensor, cand: torch.Tensor, spec: BoardSpec):
    """Minimum-remaining-values branching cell per board: the empty cell
    with the fewest candidates, lowest flat index on ties. Returns (cell,
    mask) — (B,) int64 indices and that cell's candidate bitmask."""
    C = grid.shape[1]
    key = torch.where(
        grid == 0, popcount(cand, spec), torch.full_like(grid, _INT32_MAX)
    )
    min_key = key.min(dim=1, keepdim=True).values
    iota = torch.arange(C, device=grid.device).expand_as(key)
    cell = torch.where(key == min_key, iota, C).min(dim=1).values
    b = torch.arange(grid.shape[0], device=grid.device)
    return cell, cand[b, cell]


def _step(
    state: _State,
    spec: BoardSpec,
    locked: bool = False,
    waves: int = 1,
    light_waves: bool = False,
    naked_pairs: bool | None = None,
    packed: bool | None = None,
) -> _State:
    B, C = state.grid.shape
    D = state.stack_mask.shape[1]
    N = spec.size
    dev = state.grid.device
    b = torch.arange(B, device=dev)
    grid = state.grid

    a = analyze(
        grid.reshape(B, N, N), spec, locked=locked, naked_pairs=naked_pairs,
        packed=packed,
    )
    cand = a.cand.reshape(B, C)
    assign = a.assign.reshape(B, C)
    contra, solved = a.contradiction, a.solved
    running = state.status == RUNNING

    new_status = torch.where(running & solved, SOLVED, state.status)
    act = running & ~solved  # boards that still need work this step

    # path 1: assign all singles (≥1 forced cell, no contradiction)
    has_single = (assign != 0).any(dim=1)
    do_assign = act & ~contra & has_single
    assigned_grid = torch.where(assign != 0, mask_to_value(assign, spec), grid)

    # path 2: branch on the MRV cell (no contradiction, no singles)
    do_branch = act & ~contra & ~has_single
    mrv_cell, mrv_mask = _mrv_cell(grid, cand, spec)
    guess_bit = mrv_mask & -mrv_mask
    overflow = do_branch & (state.depth >= D)
    do_branch = do_branch & (state.depth < D)
    new_status = torch.where(overflow, OVERFLOW, new_status)
    iota_c = torch.arange(C, device=dev)
    branched_grid = torch.where(
        iota_c[None, :] == mrv_cell[:, None],
        mask_to_value(guess_bit, spec)[:, None],
        grid,
    )

    # path 3: backtrack (contradiction)
    do_bt = act & contra
    top = (state.depth - 1).clamp(0, D - 1).long()
    top_mask = state.stack_mask[b, top]
    top_cell = state.stack_cell[b, top]
    top_grid = state.stack_grid[b, top].to(torch.int32)  # (B, C)
    empty_stack = state.depth == 0
    exhausted = top_mask == 0
    # pop: the top frame has no untried candidate → drop it; the grid stays
    # contradictory and the next step backtracks again
    bt_pop = do_bt & ~empty_stack & exhausted
    # retry: restore the snapshot, take the next untried bit at the same cell
    bt_retry = do_bt & ~empty_stack & ~exhausted
    retry_bit = top_mask & -top_mask
    retry_grid = torch.where(
        iota_c[None, :] == top_cell[:, None].long(),
        mask_to_value(retry_bit, spec)[:, None],
        top_grid,
    )
    new_status = torch.where(do_bt & empty_stack, UNSAT, new_status)

    new_grid = grid
    new_grid = torch.where(do_assign[:, None], assigned_grid, new_grid)
    new_grid = torch.where(do_branch[:, None], branched_grid, new_grid)
    new_grid = torch.where(bt_retry[:, None], retry_grid, new_grid)

    # stack updates, in place: one frame per board
    push_slot = state.depth.clamp(0, D - 1).long()
    state.stack_grid[b, push_slot] = torch.where(
        do_branch[:, None], grid.to(torch.int8), state.stack_grid[b, push_slot]
    )
    state.stack_cell[b, push_slot] = torch.where(
        do_branch, mrv_cell.to(torch.int32), state.stack_cell[b, push_slot]
    )
    state.stack_mask[b, push_slot] = torch.where(
        do_branch, mrv_mask & ~guess_bit, state.stack_mask[b, push_slot]
    )
    state.stack_mask[b, top] = torch.where(
        bt_retry, top_mask & ~retry_bit, state.stack_mask[b, top]
    )

    one = torch.ones_like(state.depth)
    zero = torch.zeros_like(state.depth)
    validations = state.validations + torch.where(running, one, zero)

    # Extra propagation sweeps: re-analyze the merged grid and assign its
    # forced singles, ``waves - 1`` times. Forced moves only, so the DFS
    # tree is unchanged. A board that contradicted, solved or has no
    # single passes through; every board still RUNNING pays the sweep's
    # validation whether it assigns or not.
    still_running = new_status == RUNNING
    for _ in range(waves - 1):
        aw = analyze(
            new_grid.reshape(B, N, N), spec, locked=locked and not light_waves,
            naked_pairs=naked_pairs, packed=packed,
        )
        assign_w = aw.assign.reshape(B, C)
        w = (
            still_running
            & ~aw.contradiction
            & ~aw.solved
            & (assign_w != 0).any(dim=1)
        )
        new_grid = torch.where(
            w[:, None] & (assign_w != 0),
            mask_to_value(assign_w, spec),
            new_grid,
        )
        validations = validations + torch.where(still_running, one, zero)

    return _State(
        grid=new_grid,
        stack_grid=state.stack_grid,
        stack_cell=state.stack_cell,
        stack_mask=state.stack_mask,
        depth=state.depth
        + torch.where(do_branch, one, zero)
        - torch.where(bt_pop, one, zero),
        status=new_status,
        guesses=state.guesses + torch.where(do_branch, one, zero),
        validations=validations,
        iters=state.iters + 1,
    )


def step(state: _State, spec: BoardSpec, **sweeps) -> _State:
    """One solver step over the batch (consumes ``state``'s stack).
    ``sweeps`` are ``_step``'s knobs: locked, waves, light_waves,
    naked_pairs, packed."""
    return _step(state, spec, **sweeps)


def finalize_status(state: _State, spec: BoardSpec) -> _State:
    """Flip RUNNING → SOLVED for boards completed on the very last step.

    ``_step`` judges solved-ness from the grid before that step's
    assignments, so a board finished exactly at the step cap would read
    RUNNING while holding a complete valid grid; one more analysis closes
    the gap."""
    B = state.grid.shape[0]
    N = spec.size
    a = analyze(state.grid.reshape(B, N, N), spec)
    status = torch.where(
        (state.status == RUNNING) & a.solved, SOLVED, state.status
    )
    return state._replace(status=status)


def run_loop(state: _State, spec: BoardSpec, max_iters: int, **sweeps):
    """Step until no board is RUNNING or the state has taken ``max_iters``
    steps, then finalize. ``sweeps`` are ``_step``'s knobs. Returns
    (state, LoopStats)."""
    lane = 0
    idle = torch.zeros((), dtype=torch.int64, device=state.grid.device)
    while state.iters < max_iters:
        running = state.status == RUNNING
        if not bool(running.any()):
            break
        lane += state.grid.shape[0]
        idle = idle + (~running).sum()
        state = _step(state, spec, **sweeps)
    return finalize_status(state, spec), LoopStats(lane, int(idle))


def sweep_knobs(spec: BoardSpec, locked_candidates=False, waves=1,
                light_waves=False, naked_pairs=None, packed=None) -> dict:
    """``solve_batch``'s sweep knobs as ``_step`` keywords, checked: waves
    >= 1, and the packed locked pass only for N <= 16 (``analyze``
    raises the same ValueError)."""
    if int(waves) < 1:
        raise ValueError(f"waves must be >= 1, got {waves}")
    if packed and spec.size > 16:
        raise ValueError(
            f"packed bitplane analysis needs N <= 16 (a value mask must fit "
            f"one 16-bit plane); got N={spec.size}"
        )
    return dict(
        locked=bool(locked_candidates), waves=int(waves),
        light_waves=bool(light_waves), naked_pairs=naked_pairs, packed=packed,
    )


def pad_board(spec: BoardSpec, device=None) -> torch.Tensor:
    """An instantly-UNSAT (N, N) board (two equal clues in one row): the
    stand-in for lanes a staged retry must not re-solve. It dies in one
    step without pushing a frame."""
    g = torch.zeros((spec.size, spec.size), dtype=torch.int32, device=device)
    g[0, 0] = 1
    g[0, 1] = 1
    return g


def merge_retry_result(
    need: torch.Tensor, res: SolveResult, r2: SolveResult
) -> SolveResult:
    """Merge a deeper-stage rerun ``r2`` over the lanes ``need`` of ``res``:
    retried lanes take the rerun's grid/status, work counters accumulate
    across stages, and ``iters`` always sums."""
    return SolveResult(
        grid=torch.where(need[:, None, None], r2.grid, res.grid),
        solved=torch.where(need, r2.solved, res.solved),
        status=torch.where(need, r2.status, res.status),
        guesses=torch.where(need, res.guesses + r2.guesses, res.guesses),
        validations=torch.where(
            need, res.validations + r2.validations, res.validations
        ),
        iters=res.iters + r2.iters,
    )


def staged_depths(max_depth, spec: BoardSpec) -> tuple:
    """``max_depth`` as a tuple of stage depths: None → the spec's full
    depth, an int → one stage, a tuple → itself."""
    if max_depth is None:
        return (spec.max_depth,)
    if isinstance(max_depth, (tuple, list)):
        return tuple(int(d) for d in max_depth)
    return (int(max_depth),)


def solve_staged(grid, spec: BoardSpec, depths, solve_stage):
    """The staged-depth contract shared by the plain solver and the kernel
    wrapper: the batch runs at ``depths[0]``; after each stage, if any board
    hit OVERFLOW, the batch reruns at the next depth with every other lane
    replaced by the instantly-UNSAT pad board, and the rerun is merged over
    the OVERFLOW lanes (``merge_retry_result``). ``solve_stage(grid,
    depth)`` returns (SolveResult, LoopStats) for one flat depth."""
    grid = grid.to(torch.int32)
    res, stats = solve_stage(grid, depths[0])
    for d in depths[1:]:
        need = res.status == OVERFLOW
        if not bool(need.any()):
            continue
        g2 = torch.where(
            need[:, None, None], grid, pad_board(spec, grid.device)
        )
        r2, s2 = solve_stage(g2, d)
        res = merge_retry_result(need, res, r2)
        stats = LoopStats(
            stats.lane_steps + s2.lane_steps,
            stats.idle_lane_steps + s2.idle_lane_steps,
        )
    return res, stats


def solve_flat(grid, spec: BoardSpec, depth: int, max_iters: int, **sweeps):
    """One flat-depth stage: a (B, N, N) batch stepped to the end from a
    fresh state with a ``depth``-frame stack, under ``_step``'s ``sweeps``
    knobs. Returns (SolveResult, LoopStats)."""
    B = grid.shape[0]
    N = spec.size
    state, stats = run_loop(
        init_state(grid, spec, depth), spec, max_iters, **sweeps
    )
    return SolveResult(
        grid=state.grid.reshape(B, N, N),
        solved=state.status == SOLVED,
        status=state.status,
        guesses=state.guesses,
        validations=state.validations,
        iters=state.iters,
    ), stats


def solve_batch(
    grid: torch.Tensor,
    spec: BoardSpec,
    *,
    max_iters: int = 4096,
    max_depth=None,
    locked_candidates: bool = False,
    waves: int = 1,
    light_waves: bool = False,
    naked_pairs: bool | None = None,
    packed: bool | None = None,
    return_stats: bool = False,
):
    """Solve a (B, N, N) batch to completion, proven unsatisfiability, the
    stack's depth (OVERFLOW) or ``max_iters`` steps (RUNNING).

    ``max_depth`` may be a tuple to stage the stack depth (see
    ``solve_staged``): e.g. ``(32, 81)`` runs the common case with a
    shallow stack and keeps the full-depth guarantee. The sweep knobs have
    the JAX package's meanings: ``locked_candidates`` adds locked-set
    eliminations to every analysis (``naked_pairs`` None follows it;
    ``packed`` picks the plain bitplane form), ``waves`` runs ``waves -
    1`` extra propagation sweeps per step (``light_waves``: without the
    eliminations). ``max_iters`` caps steps, not sweeps; ``validations``
    counts sweeps. Runs on the batch's device with plain tensor
    operations; matches the JAX package's ``solve_batch`` with the same
    knobs per board."""
    sweeps = sweep_knobs(
        spec, locked_candidates, waves, light_waves, naked_pairs, packed
    )
    res, stats = solve_staged(
        grid,
        spec,
        staged_depths(max_depth, spec),
        lambda g, d: solve_flat(g, spec, d, max_iters, **sweeps),
    )
    return (res, stats) if return_stats else res


# -- segments: the open loop of continuous batching ---------------------------


class SegmentState(NamedTuple):
    """A lane pool's resumable solver state: the per-board fields of
    ``_State`` plus ``board_iters``, the steps each lane has taken while
    RUNNING since it was injected (the segment loop caps a lane's budget from
    it; the closed loop's batch-wide ``iters`` means nothing once lanes
    enter mid-flight)."""

    grid: torch.Tensor         # (B, C) int32
    stack_grid: torch.Tensor   # (B, D, C) int8
    stack_cell: torch.Tensor   # (B, D) int32
    stack_mask: torch.Tensor   # (B, D) int32
    depth: torch.Tensor        # (B,) int32
    status: torch.Tensor       # (B,) int32
    guesses: torch.Tensor      # (B,) int32
    validations: torch.Tensor  # (B,) int32
    board_iters: torch.Tensor  # (B,) int32


def init_segment_state(grid: torch.Tensor, spec: BoardSpec,
                       max_depth=None) -> SegmentState:
    """A fresh lane pool for a (B, N, N) batch on its device. A staged
    depth collapses to its largest stage: segments resume mid-search, so
    only the full-depth stack is meaningful."""
    if isinstance(max_depth, (tuple, list)):
        max_depth = max(max_depth)
    st = init_state(grid, spec, max_depth)
    return SegmentState(
        *st[:-1], board_iters=torch.zeros_like(st.guesses)
    )


def segment_state_from_numpy(fields, device="cpu") -> SegmentState:
    """A port ``SegmentState`` from the fields of a JAX ``SegmentState``
    held as numpy arrays (a NamedTuple or a mapping), so a pool stopped
    mid-search in the JAX package resumes here."""
    if hasattr(fields, "_asdict"):
        fields = fields._asdict()
    return SegmentState(**{
        name: torch.as_tensor(fields[name].copy()).to(
            device=device,
            dtype=torch.int8 if name == "stack_grid" else torch.int32,
        )
        for name in SegmentState._fields
    })


def inject_lanes(state: SegmentState, boards: torch.Tensor,
                 inject: torch.Tensor, spec: BoardSpec) -> SegmentState:
    """Lanes where ``inject`` is nonzero restart from the same row of the
    (B, N, N) ``boards`` (fresh state, zeroed stack); the others pass
    through with their search intact."""
    fresh = init_segment_state(boards, spec, state.stack_mask.shape[1])
    m = inject.to(torch.bool)

    def merge(f, s):
        return torch.where(m.reshape(-1, *([1] * (s.dim() - 1))), f, s)

    return SegmentState(*(merge(f, s) for f, s in zip(fresh, state)))


def align_src_boards(boards: torch.Tensor, src: torch.Tensor,
                     spec: BoardSpec) -> tuple:
    """A per-lane source map as lane-aligned injection: ``(aligned,
    inject)``, the (B, N, N) board each lane would restart from and the
    (B,) int32 mask of lanes that do. ``src[i] >= 0`` takes row
    ``src[i]`` of ``boards`` (clamped to its rows), ``-1`` leaves the lane
    alone, ``-2`` restarts it from the instantly-UNSAT pad board."""
    src = src.to(torch.int64)
    aligned = boards[src.clamp(0, boards.shape[0] - 1)]
    aligned = torch.where(
        (src == -2)[:, None, None], pad_board(spec, boards.device), aligned
    )
    return aligned, (src != -1).to(torch.int32)


def inject_lanes_src(state: SegmentState, boards: torch.Tensor,
                     src: torch.Tensor, spec: BoardSpec) -> SegmentState:
    """``inject_lanes`` driven by a per-lane source map into a stack of
    boards (``align_src_boards``): which queued board lands in which
    freed lane is known only at the boundary, so the stack can be placed
    on the device ahead of it and only ``src`` is sent then."""
    aligned, inject = align_src_boards(boards, src, spec)
    return inject_lanes(state, aligned, inject, spec)


def run_segment(state: SegmentState, seg_iters: int, spec: BoardSpec, *,
                locked_candidates: bool = False, waves: int = 1,
                light_waves: bool = False, naked_pairs: bool | None = None,
                packed: bool | None = None) -> tuple:
    """Advance the pool by at most ``seg_iters`` lockstep steps of the
    flat loop, stopping early when no lane is RUNNING. Finished lanes are
    stepped as fixed points and billed as idle in the returned
    ``LoopStats``. There is no ``finalize_status`` at the end: a lane
    completed on the last step reads RUNNING and pays its discovery sweep
    at the top of the next segment, as the closed loop pays it, which is
    what keeps per-board validations the same however the steps are cut.
    Consumes ``state``'s stack. Returns (state, LoopStats)."""
    sweeps = sweep_knobs(spec, locked_candidates, waves, light_waves,
                         naked_pairs, packed)
    lane = idle = 0
    for _ in range(int(seg_iters)):
        running = state.status == RUNNING
        n_running = int(running.sum())
        if n_running == 0:
            break
        lane += state.grid.shape[0]
        idle += state.grid.shape[0] - n_running
        core = _step(_State(*state[:-1], iters=0), spec, **sweeps)
        state = SegmentState(
            *core[:-1], board_iters=state.board_iters + running.to(torch.int32)
        )
    return state, LoopStats(lane, idle)


# Columns of the per-lane segment digest, the (B, 8) int32 block the host
# reads at every boundary in place of the full rows: status, solved,
# guesses, validations, board_iters, fetch_slot (the lane's row in the
# solution block if it solved in this segment, else -1), and the
# segment's lane_steps and idle_lane_steps on every row.
SEGMENT_DIGEST_COLS = 8


def segment_digest(state: SegmentState, entry_running: torch.Tensor,
                   stats: LoopStats, prefix_gather: bool = True) -> tuple:
    """The digest and the solution block of a finished segment.

    ``entry_running`` is the RUNNING mask at segment entry, after
    injection, so a lane's solution is fetched once, at the boundary
    after the segment it solved in. With ``prefix_gather`` the block is
    the grid with newly solved rows first, in lane order, then the rest
    (a stable sort on ``~newly_solved``) and ``fetch_slot`` is a lane's
    row there: the host reads ``block[:max(fetch_slot) + 1]``. Without it
    the block is the grid with every other row zeroed and ``fetch_slot``
    is the lane index. Both outputs are new tensors, never views of the
    pool's grid, since a later segment updates the pool while the host
    has yet to read this block. Returns (digest, block)."""
    B = state.grid.shape[0]
    dev = state.grid.device
    newly = (state.status == SOLVED) & entry_running
    lanes = torch.arange(B, dtype=torch.int32, device=dev)
    if prefix_gather:
        order = torch.argsort((~newly).to(torch.int32), stable=True)
        gathered = state.grid[order]
        pos = torch.empty_like(lanes)
        pos[order] = lanes
        fetch_slot = torch.where(newly, pos, -1)
    else:
        gathered = torch.where(newly[:, None], state.grid, 0)
        fetch_slot = torch.where(newly, lanes, -1)
    digest = torch.stack(
        [
            state.status,
            (state.status == SOLVED).to(torch.int32),
            state.guesses,
            state.validations,
            state.board_iters,
            fetch_slot.to(torch.int32),
            torch.full_like(lanes, int(stats.lane_steps)),
            torch.full_like(lanes, int(stats.idle_lane_steps)),
        ],
        dim=1,
    )
    return digest, gathered


# -- the frontier race: one board's disjoint subtrees raced to a solution -----

# Columns of a race's packed row after its C solution cells: found, the
# validations summed over every state, and undecided (some state still
# RUNNING or OVERFLOWed, so "not found" is a budget verdict, not a proof).
RACE_ROW_EXTRA = 3
# Columns of a race's per-state run record: the status the state's search
# stopped in, the steps it took, its validations then, and whether a
# closing analysis finds a state stopped RUNNING complete.
RACE_META_COLS = 4


def race(states: torch.Tensor, spec: BoardSpec, max_iters: int,
         max_depth: int | None = None, **sweeps):
    """The lockstep race of the JAX package's ``parallel/frontier.py``
    (``_make_racer``'s ``race``) on one device: the (M, N, N) states step
    together while no state is SOLVED, some state is RUNNING and fewer than
    ``max_iters`` steps ran; then ``finalize_status``. ``sweeps`` are
    ``_step``'s knobs. Returns ``(row, fold, meta)``: the packed (C + 3,)
    int32 row ``race_row``; the (M, 2) [status, validations] of every state
    after the race; and the (M, 4) run record of ``RACE_META_COLS``, each
    state's search as the lockstep loop left it (steps counted while the
    state was RUNNING, status before the closing analysis), which
    ``fold_race`` turns into the same row and fold."""
    M = states.shape[0]
    st = init_state(states, spec, max_depth)
    steps = torch.zeros((M,), dtype=torch.int32, device=states.device)
    while st.iters < max_iters:
        running = st.status == RUNNING
        if not bool(running.any()):
            break
        steps += running.to(torch.int32)
        st = _step(st, spec, **sweeps)
        if bool((st.status == SOLVED).any()):
            break
    done = finalize_status(st, spec)
    complete = ((st.status == RUNNING) & (done.status == SOLVED)).to(torch.int32)
    meta = torch.stack([st.status, steps, st.validations, complete], dim=1)
    fold = torch.stack([done.status, done.validations], dim=1)
    return race_row(done.grid, fold, spec), fold, meta


def race_row(grid: torch.Tensor, fold: torch.Tensor, spec: BoardSpec) -> torch.Tensor:
    """The race's packed row from the (M, C) grids and the (M, 2) [status,
    validations] after it: the lowest-index SOLVED state's grid (zeros when
    none), found, the validations' int32 sum and undecided."""
    status = fold[:, 0]
    solved = status == SOLVED
    found = bool(solved.any())
    solution = grid[int(torch.argmax(solved.to(torch.int32)))] if found else \
        torch.zeros((spec.cells,), dtype=torch.int32, device=grid.device)
    total = fold[:, 1].to(torch.int64).sum()
    total = ((total + 2**31) % 2**32 - 2**31).to(torch.int32)  # int32 wrap
    undecided = ((status == RUNNING) | (status == OVERFLOW)).any()
    return torch.cat([
        solution.to(torch.int32),
        torch.tensor([int(found)], dtype=torch.int32, device=grid.device),
        total.reshape(1),
        undecided.to(torch.int32).reshape(1),
    ])


def fold_race(meta: torch.Tensor, grid: torch.Tensor, spec: BoardSpec,
              waves: int) -> tuple:
    """The lockstep race's outcome from each state's own run (the plain
    version of the fold that csrc/dfs_solver.cu's race kernel runs in its
    last block).

    ``meta`` is the (M, 4) run record of ``RACE_META_COLS`` and ``grid``
    the (M, C) grids the runs stopped on. A state's run may stop anywhere
    from where the lockstep race would cut it to its own end: the race
    kernel's blocks run out of step and each stops once it has run more
    steps than the earliest solve it has seen. The fold needs t*, the step the lockstep
    loop stops after: the earliest step any state solves at, else the last
    step any state ran. Then:

    * a state that ended (SOLVED, UNSAT, OVERFLOW) at or before t* keeps its
      status and validations;
    * any other state was RUNNING through t*, so it has t* × ``waves``
      validations (every step of a running state runs ``waves`` sweeps);
      ``finalize_status`` flips it to SOLVED exactly when its grid was
      complete after step t*: it solved at step t* + 1, or its run stopped
      at t* and the closing analysis (``complete``) found it complete.

    Returns ``(row, fold)`` as ``race``."""
    status, steps, vals, complete = meta.unbind(1)
    solved = status == SOLVED
    t_star = steps[solved].min() if bool(solved.any()) else steps.max()
    ended = (status != RUNNING) & (steps <= t_star)
    flip = ~ended & (
        (solved & (steps == t_star + 1))
        | ((status == RUNNING) & (steps == t_star) & (complete != 0))
    )
    final_status = torch.where(
        ended, status, torch.where(flip, SOLVED, RUNNING)
    ).to(torch.int32)
    final_vals = torch.where(ended, vals, t_star * int(waves)).to(torch.int32)
    fold = torch.stack([final_status, final_vals], dim=1)
    return race_row(grid, fold, spec), fold
