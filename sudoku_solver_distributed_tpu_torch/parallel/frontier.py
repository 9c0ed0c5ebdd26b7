"""The search-frontier race: one hard board raced across its own subtrees.

The port of ``sudoku_solver_distributed_tpu/parallel/frontier.py`` on one
device. A host-side seeding pass expands the board into many disjoint
subtrees (k-way splits on minimum-remaining-values cells, after
propagating singles), and the race runs every subtree's DFS until any
subtree solves: the first solution found by the lowest-index state wins,
and "not found" with no subtree left undecided is a proof that the board
has no solution.

The JAX package races in lockstep across a mesh, with a one-scalar
``psum`` after every step for the early exit; the lowest-rank device's
lowest-index solution wins. Here the race runs on a mesh of CUDA shards
(parallel/mesh.py), each racing its slice of the padded states:

  * on one shard, one launch of the race kernel (ops/cuda_solver.dfs_race,
    K4: a thread block a state, each stopping once it has run more steps
    than the earliest solve posted so far, and a fold by the last block
    that rebuilds the lockstep result exactly);
  * on several, K4's shard form (``dfs_race_shards``) from one library
    call: one launch of every shard's states when the shards share a
    card, else one launch a card on its shard's stream, stopping on a stop
    word in device memory that every state polls at every step boundary
    (one word on one card; a word a card, posted to over NVLink, across
    cards with peer access),
    and folded in place by the last block across every shard: the race
    is that one call. Across cards without peer access the shards relay
    the stop through slots in mapped host memory, and the fold kernel
    (``race_fold``) folds their records gathered on the first shard's
    device. The winner is the global lowest index; validations and
    undecided sum over every state, as the JAX race's.

On the CPU the wrappers run the plain lockstep race (ops/solver.race, and
per shard ``race_runs`` then ``fold_race``). Seeding runs where the race
does, on its mesh's first device: on a card one launch of the seeding
kernel (ops/cuda_solver.seed_frontier_cuda, K5: every round and its
decision on the card, the host reading one small header), on the CPU its
plain version, the host rounds (ops/solver.seed_rounds), as the JAX
package seeds on its CPU backend with a host decision between rounds. The states are padded to
``n_shards × states_per_device × 2^k``, as the JAX race pads, so the
port's race equals the JAX race on a mesh of the same size (pad states
bill their validations). On a one-card mesh the seeded states stay on the
card from the seeding to the race.

A race across hosts is the multi-host serving loop's
(parallel/serving_loop.py): every host races its slice of the states on
its own shards, the hosts' solves reach each other's shards while they
run through the relay (parallel/relay.py: a post of any host stops every
host's shards, as the JAX race's per-step ``psum`` does), and the fold
runs over every host's gathered records.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..obs.trace import current_trace
from ..ops.cuda_solver import (
    dfs_race,
    dfs_race_shards,
    race_fold,
    race_slots,
    seed_frontier_cuda,
)
from ..ops.encode import mask_to_value
from ..ops.propagate import analyze
from ..ops.solver import unsat_pad
from ..ops.spec import SPEC_9, BoardSpec
from ..serving.admission import DeadlineExceeded
from .mesh import Mesh, default_mesh
from .shard import to_primary

# shared by frontier_solve and the engine's warm-up, as in the JAX package
DEFAULT_MAX_ITERS = 65536


def race_mesh(mesh=None) -> Mesh:
    """The mesh a race runs on, from the engine's ``frontier_mesh`` or
    ``frontier_solve``'s ``mesh``: a ``Mesh`` is itself, None is
    ``default_mesh()`` (every visible CUDA device; raises without one), a
    sequence of devices is the mesh over them (each once), and a device or
    its name is the one-shard mesh on it."""
    if isinstance(mesh, Mesh):
        return mesh
    if mesh is None:
        return default_mesh()
    if isinstance(mesh, (list, tuple)):
        return Mesh(mesh)
    from ..engine import resolve_device

    return Mesh([resolve_device(mesh)])


def race_device(mesh=None) -> torch.device:
    """The first device of the race's mesh (``race_mesh``): where its
    packed row is folded."""
    return race_mesh(mesh).primary


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
    device=None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Expand one board into ≥``target`` disjoint speculative states.

    A BFS in rounds: analyze all current states, drop contradictions,
    assign every forced single, and once no single is left k-way split
    each state on its MRV cell (one child per candidate value, so the
    children partition the parent's solution space exactly). Stops early
    if propagation alone solves the board.

    ``device`` is where it runs (the engine's ``resolve_device``: None is
    CUDA, and raises without a card): on a card one launch of the seeding
    kernel, on the CPU its plain version, the host rounds (both through
    ``seed_frontier_cuda``). Both give the same states.

    ``initial_states`` starts the expansion from these (M, N, N) states
    instead of the root board (the probe→race handoff,
    ``state_handoff_frontier``). ``deadline_s`` (absolute monotonic) is
    checked at every round boundary on the CPU, and before and after the
    kernel's launch on a card: a request that expires mid-seeding raises
    ``DeadlineExceeded``.

    Returns (states, solved) as numpy arrays: states is (M, N, N) with M ≥
    target unless the search space is exhausted (then padded with
    instantly-unsat boards); solved is the solution if one fell out during
    seeding, else None. The JAX package pads every round's batch to a
    power of two so its jitted analysis sees few shapes; the port analyzes
    the batch as it is."""
    from ..engine import resolve_device

    states, solved = _seed(board, spec, target, max_rounds, locked, initial_states,
                           deadline_s, resolve_device(device))
    return states.cpu().numpy(), solved


def _seed(board, spec, target, max_rounds, locked, initial_states, deadline_s,
          device: torch.device):
    """``seed_frontier`` on ``device``, its states left there: ((M, N, N)
    int32 tensor, numpy solution or None)."""
    if max_rounds is None:
        # each round either assigns singles (≤ cells of them) or splits
        max_rounds = spec.cells + 16
    if initial_states is not None:
        states = np.asarray(initial_states, np.int32)
    else:
        states = np.asarray(board, np.int32)[None]
    N = spec.size
    flat = torch.from_numpy(np.ascontiguousarray(states.reshape(len(states), -1)))
    states, solved, _ = seed_frontier_cuda(flat.to(device), spec, target, max_rounds,
                                           locked, lambda: _check_deadline(deadline_s))
    if solved is not None:
        solved = solved.numpy().reshape(N, N)
    return states.reshape(-1, N, N), solved


def _check_deadline(deadline_s: Optional[float]) -> None:
    if deadline_s is not None and time.monotonic() > deadline_s:
        raise DeadlineExceeded("deadline expired during frontier seeding")


def warm_seeding(spec: BoardSpec, target: int, locked: bool = False,
                 device=None) -> None:
    """Warm a server's first frontier-routed seeding on ``device`` (as
    ``seed_frontier``'s): on a card one seeding kernel launch at ``target``
    (the empty board; its scratch is allocated there); on the CPU one
    round's analysis and assignment at every power-of-two batch up to
    ``pow2(target)``, so the first request pays no first-call costs of the
    CPU ops (the JAX package compiles its seeding programs here)."""
    from ..engine import resolve_device

    device = resolve_device(device)
    if device.type != "cpu":
        flat = torch.zeros((1, spec.cells), dtype=torch.int32, device=device)
        seed_frontier_cuda(flat, spec, target, spec.cells + 16, locked)
        return
    m = 1
    while True:
        z = torch.zeros((m, spec.size, spec.size), dtype=torch.int32)
        mask_to_value(analyze(z, spec, locked=locked).assign, spec)
        if m >= target:
            break
        m *= 2


def bucket_states(states, spec: BoardSpec,
                  states_per_device: int, n_shards: int = 1) -> torch.Tensor:
    """Pad the seeded (M, N, N) states (a tensor, or an array) with
    instantly-unsat boards up to ``n_shards × states_per_device × 2^k``,
    the smallest such count whose shards' equal slices hold them all (the
    JAX race's padding). No seeded state is ever dropped: each covers a
    disjoint slice of the search space. The geometric rungs keep the set
    of race shapes small (the engine warms the first three). Returns an
    int32 tensor where the states lie."""
    states = torch.as_tensor(states, dtype=torch.int32)
    per = -(-len(states) // n_shards)
    bucket = max(states_per_device, 1)
    while bucket < per:
        bucket *= 2
    total = n_shards * bucket
    if len(states) < total:
        pad = torch.from_numpy(unsat_pad(spec)).to(states.device)
        states = torch.cat([states, pad.expand(total - len(states), spec.size, spec.size)])
    return states


def mesh_race_slots(mesh: Mesh):
    """The stop of races across ``mesh``'s CUDA shards: ``race_slots`` over
    its devices, keyed by the shards' (device, stream) pairs; its
    ``layout`` says where the stop lives."""
    key = tuple((d, s.cuda_stream) for d, s in zip(mesh.devices, mesh.streams))
    return race_slots(mesh.devices, key)


def _idle_after(slots, ends, relay=None) -> None:
    """A race that raised before its last block or its fold ran (a shard's
    launch failed, a copy ran out of memory, ``gather`` timed out) may have
    left the steps it posted in its stop words and slots, and the next race
    over them would stop at them, short of its own first solve. Wait for
    its shard launches to end (``ends``: an event a shard recorded after
    its launch, or the shards' streams before any), then set the words and
    slots idle from the host. A race with a relay across hosts also closes
    its link, so the relay delivers nothing more into the inbox; what the
    inbox and outbox hold is tagged with this race, which no later race
    honours, so they are idle for the next."""
    try:
        for end in ends:
            end.synchronize()
    finally:
        slots.idle()
        if relay is not None:
            relay.close()


def race_on_mesh(states, mesh: Mesh, spec: BoardSpec, depth: int,
                 max_iters: int, *, locked_candidates: bool = False,
                 waves: int = 1, naked_pairs: Optional[bool] = None,
                 packed: Optional[bool] = None, gather=None, relay=None) -> tuple:
    """Race (M, N, N) (or (M, C)) states whose count divides the mesh,
    shard ``i`` taking the ``i``-th equal slice: a tensor (on one shard
    without ``gather`` moved to the shard's device if it lies elsewhere,
    otherwise through the host), or an array. Returns ``(row, fold,
    meta)`` as ``dfs_race``, on the mesh's first device: the packed (C +
    3,) row, each state's [status, validations] after the lockstep race,
    and each state's run record.

    One shard: one launch of K4, which folds itself. Several on CUDA: K4's
    shard form from one library call over the race's stop
    (``mesh_race_slots``): one launch on shard 0's stream when the shards
    share a card, else one a shard on its stream. Under its
    ``"device"`` and ``"peer"`` layouts the last block across every shard
    folds in place, so the race is that call: no copy of records, no
    other launch, no host sync. Under ``"host"`` (cards without peer
    access) each shard's records and grids are copied to shard 0's device
    and the fold kernel runs there on shard 0's stream, setting the slots
    idle. Every shard's launch waits for the previous race over the mesh,
    and the race holds the stop's lock while it enqueues, so races over
    one mesh never share its words. A race that raises before its last
    block or fold runs waits for its shard launches and sets the words
    idle itself. On the CPU: the plain race of each shard's states
    (``race_runs``) and ``fold_race`` over them all.

    ``gather`` (the multi-host serving loop's): a callable ``(meta, grid)
    -> (meta, grid)`` that turns this host's run records into every
    host's, in global state order, before the fold; with it every local
    shard races in K4's shard form (even one), stopping on this host's
    stop and (with ``relay``) on any other host's solve, the records go
    through ``gather`` and the fold kernel, and the returned ``meta`` is
    every host's. ``relay`` (with ``gather``; the
    serving loop's ``parallel.relay.RaceLink``): every local shard also
    stops at a step another host posted for this race, and this host's
    solves are posted to the other hosts, while the race runs; the link
    learns when this host's race ended (``local_done``), before the
    gather."""
    M, C = len(states), spec.cells
    flat = torch.as_tensor(states, dtype=torch.int32).reshape(M, C)
    knobs = dict(locked_candidates=locked_candidates, waves=waves,
                 naked_pairs=naked_pairs, packed=packed)
    n = mesh.size
    if M % n:
        raise ValueError(f"{M} race states do not divide the {n}-shard mesh")
    if relay is not None and gather is None:
        raise ValueError("a relay across hosts comes with the hosts' gather")
    if n == 1 and gather is None:
        return dfs_race(flat.to(mesh.primary).contiguous(), spec, depth, max_iters,
                        **knobs)
    flat = flat.cpu().contiguous()
    per = M // n
    if mesh.primary.type == "cpu":
        runs = dfs_race_shards(
            [flat[i * per:(i + 1) * per].contiguous() for i in range(n)], spec,
            depth, max_iters, relay=relay, **knobs,
        )
        if relay is not None:
            relay.local_done()
        meta = torch.cat([m for m, _ in runs])
        grid = torch.cat([g for _, g in runs])
        if gather is not None:
            meta, grid = gather(meta, grid)
        row, fold = race_fold(meta, grid, spec, waves)
        return row, fold, meta
    slots = mesh_race_slots(mesh)
    fused = gather is None and slots.layout != "host"
    host = flat.pin_memory()
    s0 = mesh.streams[0]
    with slots.lock:
        # the previous race over this mesh has ended on shard 0's stream
        if len(mesh.distinct_devices) == 1:
            # shards that share a card: one copy of every state, a shard a
            # slice of it
            with torch.cuda.device(mesh.primary), torch.cuda.stream(s0):
                states_dev = host.to(mesh.primary, non_blocking=True)
            parts = [states_dev[i * per:(i + 1) * per] for i in range(n)]
            for stream in mesh.streams[1:]:
                stream.wait_stream(s0)
        else:
            parts = []
            for i, (dev, stream) in enumerate(zip(mesh.devices, mesh.streams)):
                stream.wait_stream(s0)
                with torch.cuda.device(dev), torch.cuda.stream(stream):
                    parts.append(host[i * per:(i + 1) * per].to(dev, non_blocking=True))
        ends = []
        try:
            out = dfs_race_shards(parts, spec, depth, max_iters,
                                  streams=list(mesh.streams), slots=slots,
                                  fold=fused, relay=relay, **knobs)
            ends = [stream.record_event() for stream in mesh.streams]
            if relay is not None:
                relay.local_done(ends)
            if fused:
                row, fold, meta = out
            else:
                with torch.cuda.device(mesh.primary), torch.cuda.stream(s0):
                    meta = torch.cat([to_primary(mesh, i, m, s0)
                                      for i, (m, _) in enumerate(out)])
                    grid = torch.cat([to_primary(mesh, i, g, s0)
                                      for i, (_, g) in enumerate(out)])
                    if gather is not None:
                        meta, grid = gather(meta, grid)
                    row, fold = race_fold(meta, grid, spec, waves,
                                          slots=slots.address or None,
                                          n_slots=n if slots.address else 0)
        except BaseException:
            _idle_after(slots, ends or mesh.streams, relay)
            raise
    caller = torch.cuda.current_stream(mesh.primary)
    caller.wait_stream(s0)
    for t in (row, fold, meta):
        t.record_stream(caller)
    return row, fold, meta


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
    hosts=None,
) -> Tuple[Optional[list], dict]:
    """Solve one (hard) board by racing its search subtrees across a mesh.

    ``mesh`` names the shards (``race_mesh``: None → every CUDA device; a
    device → one shard on it). The board is seeded to at least ``n_shards
    × states_per_device`` states, padded to ``n_shards ×
    states_per_device × 2^k`` (``bucket_states``) and raced
    (``race_on_mesh``). Returns (solution | None, info). info carries
    ``validations`` (the sweeps of every state), ``seeded`` (the states
    raced, padding included) and ``handoff`` (whether ``initial_states``
    seeded it), and, when no solution was found, ``capped``: True when
    some subtree OVERFLOWed its stack or was still RUNNING at
    ``max_iters`` (the board is NOT proven unsolvable), False for a
    proof.

    A staged (tuple) ``max_depth`` collapses to its deepest stage: the
    race runs one flat search per subtree. ``initial_states`` seeds the
    race from these states instead of expanding ``board`` from its root;
    "not found" then means "not in THESE subtrees", so callers pass a
    covering set of the unexplored space. ``deadline_s`` (absolute
    monotonic) cancels with ``DeadlineExceeded`` at the seeding round
    boundaries and once more before the race dispatches; a race already
    dispatched runs to completion.

    Seeding runs on the mesh's first device (``seed_frontier``'s), and on a
    one-shard mesh its states stay there for the race. It is stamped on
    the calling thread's request span as its ``coalesce`` stage (this
    route's batch formation), the race as its ``device`` stage (dispatch →
    the packed row on the host).

    ``hosts`` (the multi-host serving loop's): ``(rank, world, gather,
    relay)``. Every host seeds the same states
    and pads them for ``world × mesh`` shards; this host races its
    ``rank``-th slice on its mesh, stopping on any host's solve through
    ``relay`` (``race_on_mesh``'s), and ``gather`` collects every host's
    run records before the fold, so every host reads the same row."""
    mesh = race_mesh(mesh)
    rank, world, gather, relay = hosts if hosts is not None else (0, 1, None, None)
    n_shards = mesh.size * world
    if isinstance(max_depth, (tuple, list)):
        max_depth = max(max_depth)
    depth = spec.max_depth if max_depth is None else int(max_depth)
    board = np.asarray(board, np.int32)
    tr = current_trace()
    t_seed = time.monotonic()
    states, early = _seed(
        board, spec, n_shards * states_per_device, None, locked, initial_states,
        deadline_s, mesh.primary,
    )
    if tr is not None:
        tr.mark("coalesce", time.monotonic() - t_seed)
    if early is not None:
        return early.tolist(), {
            "validations": 0,
            "seeded": len(states),
            "handoff": initial_states is not None,
        }
    states = bucket_states(states, spec, states_per_device, n_shards)
    if deadline_s is not None and time.monotonic() > deadline_s:
        raise DeadlineExceeded(
            "deadline expired before the frontier race dispatched"
        )
    t_dev = time.monotonic()
    M, C = len(states), spec.cells
    per_host = M // world
    row, _, _ = race_on_mesh(
        states[rank * per_host:(rank + 1) * per_host], mesh, spec, depth,
        max_iters, locked_candidates=locked, waves=waves,
        naked_pairs=naked_pairs, packed=packed, gather=gather, relay=relay,
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
