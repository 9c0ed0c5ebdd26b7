"""Checkpoint / resume for long-running batch solves.

The port of ``sudoku_solver_distributed_tpu/utils/checkpoint.py``. The DFS
solver's whole search state — grids, guess stacks, depths, statuses,
counters — is explicit (ops/solver ``_State``), so checkpointing is exact:
a restored solve continues bit for bit where it left off, including the
step budget already spent.

``solve_batch_resumable`` is the host driver: it advances the batch in
bounded chunks and writes an atomic .npz snapshot between chunks; on a
restart with the same path it resumes from the snapshot instead of the
original boards. The snapshot format is the JAX package's, key for key and
dtype for dtype (``grid`` ... ``iters``, ``__format__``, ``__box__``,
``__boards_sha256__``, ``__config_json__``), so a snapshot one package
writes resumes in the other.

A chunk on a CUDA device is one launch of the segment kernels (K3 and its
digest, ops/cuda_solver.dfs_segment) over a pool built from the state with
every lane kept (source map all -1): each RUNNING lane steps at most
``min(chunk_iters, max_iters - iters)`` steps. The JAX chunk is a lockstep
``while_loop``, in which every RUNNING board has stepped exactly ``iters``
times; so lanes start the segment with ``board_iters = iters``, and after
it ``iters`` is the largest lane count, the number of times the JAX loop
would have turned. On a CPU tensor the chunk is the same segment's plain
version (``run_segment``).
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.cuda_solver import SegmentPool, dfs_segment
from ..ops.solver import (
    RUNNING,
    SOLVED,
    SegmentState,
    SolveResult,
    _State,
    finalize_status,
    init_state,
    state_from_numpy,
)
from ..ops.spec import BoardSpec, spec_for_size

_FORMAT = 1
_FIELDS = (
    "grid",
    "stack_grid",
    "stack_cell",
    "stack_mask",
    "depth",
    "status",
    "guesses",
    "validations",
    "iters",
)


def boards_fingerprint(boards: np.ndarray) -> np.ndarray:
    """Identity of the request batch, stored in the snapshot so a stale
    checkpoint can never be resumed against different boards."""
    digest = hashlib.sha256(
        np.ascontiguousarray(np.asarray(boards, np.int32)).tobytes()
    ).digest()
    return np.frombuffer(digest, np.uint8)


def config_blob(
    locked: bool, waves: int, naked_pairs, max_depth
) -> np.ndarray:
    """Canonical encoding of the solver knobs that shape the search
    trajectory (the JAX package's bytes). Stored in the snapshot so a
    resume under a different configuration, which would continue a
    different search, is refused like a board mismatch."""
    blob = json.dumps(
        {
            "locked": bool(locked),
            "waves": int(waves),
            "naked_pairs": None if naked_pairs is None else bool(naked_pairs),
            "max_depth": None if max_depth is None else int(max_depth),
        },
        sort_keys=True,
    ).encode()
    return np.frombuffer(blob, np.uint8)


def save_solver_state(
    path: str,
    state: _State,
    spec: BoardSpec,
    boards_hash: Optional[np.ndarray] = None,
    config: Optional[np.ndarray] = None,
) -> None:
    """Atomically snapshot a solver state to ``path`` (.npz), in the JAX
    package's layout: int8 ``stack_grid``, int32 everything else, a 0-dim
    int32 ``iters``."""
    arrays = {
        f: getattr(state, f).cpu().numpy().astype(
            np.int8 if f == "stack_grid" else np.int32, copy=False
        )
        for f in _FIELDS[:-1]
    }
    arrays["iters"] = np.asarray(state.iters, np.int32)
    arrays["__format__"] = np.int64(_FORMAT)
    arrays["__box__"] = np.int64(spec.box)
    if boards_hash is not None:
        arrays["__boards_sha256__"] = np.asarray(boards_hash, np.uint8)
    if config is not None:
        arrays["__config_json__"] = np.asarray(config, np.uint8)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)  # atomic publish: no torn snapshots on crash
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_solver_state(
    path: str,
) -> Tuple[_State, BoardSpec, Optional[np.ndarray], Optional[np.ndarray]]:
    """Restore a snapshot written by ``save_solver_state`` (either
    package's). Returns (state, spec, boards_hash, config), the state's
    tensors on the CPU; boards_hash/config are None for snapshots saved
    without them."""
    with np.load(path) as z:
        if int(z["__format__"]) != _FORMAT:
            raise ValueError(
                f"unsupported checkpoint format {int(z['__format__'])}"
            )
        spec = BoardSpec(box=int(z["__box__"]))
        state = state_from_numpy({f: z[f] for f in _FIELDS})
        boards_hash = (
            np.asarray(z["__boards_sha256__"])
            if "__boards_sha256__" in z
            else None
        )
        config = (
            np.asarray(z["__config_json__"])
            if "__config_json__" in z
            else None
        )
    C = spec.cells
    if state.grid.ndim != 2 or state.grid.shape[1] != C:
        raise ValueError(
            f"checkpoint grid shape {tuple(state.grid.shape)} does not match "
            f"{spec.size}×{spec.size} boards"
        )
    return state, spec, boards_hash, config


def _pool(state: _State, spec: BoardSpec, device) -> SegmentPool:
    """A segment pool holding ``state`` on ``device``: every lane starts
    the next segment having stepped ``state.iters`` times."""
    fields = [t.to(device).contiguous() for t in state[:-1]]
    board_iters = torch.full((fields[0].shape[0],), int(state.iters),
                             dtype=torch.int32, device=device)
    return SegmentPool(SegmentState(*fields, board_iters=board_iters), spec)


def solve_batch_resumable(
    grid,
    spec: Optional[BoardSpec] = None,
    *,
    checkpoint_path: str,
    chunk_iters: int = 256,
    max_iters: int = 65536,
    max_depth: Optional[int] = None,
    keep_checkpoint: bool = False,
    sharding=None,
    locked: bool = False,
    waves: int = 1,
    naked_pairs: bool | None = None,
    device=None,
) -> SolveResult:
    """Solve a batch with periodic checkpoints; resume if one exists.

    Semantics match ops.solver.solve_batch at the flat depth. The
    checkpoint is deleted on completion unless ``keep_checkpoint``; a run
    that stops at ``max_iters`` with boards still RUNNING leaves it as the
    resume point. A checkpoint records the request batch's sha256 and the
    solver configuration and refuses to resume different boards, another
    geometry or another configuration.

    ``device``: where the chunks run, CUDA by default (the segment
    kernels; raises without a GPU) or ``"cpu"`` (their plain version).
    ``sharding`` (a batch split across devices) is the multi-GPU slice's
    and raises ``NotImplementedError``. Returns the result's tensors on
    ``device``; ``iters`` is an int."""
    if sharding is not None:
        raise NotImplementedError(
            "solve_batch_resumable(sharding=...) is not ported yet"
        )
    from ..engine import resolve_device

    dev = resolve_device(device)
    grid = np.asarray(grid, np.int32)
    if spec is None:
        spec = spec_for_size(grid.shape[-1])
    if isinstance(max_depth, (tuple, list)):
        # staged depth is a batch-engine shape; the chunked loop is flat,
        # so only the deepest stage's guarantee applies
        max_depth = max(max_depth)
    fingerprint = boards_fingerprint(grid)
    cfg_blob = config_blob(locked, waves, naked_pairs, max_depth)

    if os.path.exists(checkpoint_path):
        state, ck_spec, ck_hash, ck_cfg = load_solver_state(checkpoint_path)
        if ck_spec != spec:
            raise ValueError(
                f"checkpoint at {checkpoint_path} is for a "
                f"{ck_spec.size}×{ck_spec.size} solve, not {spec.size}×{spec.size}"
            )
        if state.grid.shape[0] != grid.shape[0]:
            raise ValueError(
                f"checkpoint batch {state.grid.shape[0]} != request batch "
                f"{grid.shape[0]}"
            )
        if ck_hash is not None and not np.array_equal(ck_hash, fingerprint):
            raise ValueError(
                f"checkpoint at {checkpoint_path} belongs to a different "
                f"board batch — refusing to resume (delete the stale "
                f"snapshot or use a distinct path per batch)"
            )
        if ck_cfg is not None and not np.array_equal(ck_cfg, cfg_blob):
            raise ValueError(
                f"checkpoint at {checkpoint_path} was written under solver "
                f"configuration {bytes(ck_cfg).decode()} but this resume "
                f"requests {bytes(cfg_blob).decode()} — refusing: resuming "
                f"under a different configuration would continue a "
                f"DIFFERENT search trajectory and void the bit-for-bit "
                f"guarantee (ADVICE r3)"
            )
    else:
        state = init_state(torch.from_numpy(grid), spec, max_depth)

    iters = int(state.iters)
    pool = _pool(state, spec, dev)
    keep = torch.full((pool.width,), -1, dtype=torch.int32, device=dev)
    no_boards = torch.zeros((1, spec.cells), dtype=torch.int32, device=dev)
    sweeps = dict(locked_candidates=locked, waves=waves, naked_pairs=naked_pairs)
    while True:
        seg_iters = max(0, min(chunk_iters, max_iters - iters))
        pool, digest, _ = dfs_segment(
            pool, no_boards, keep, seg_iters, prefix_gather=False, **sweeps
        )
        digest = digest.cpu().numpy()
        if len(digest):
            iters = max(iters, int(digest[:, 4].max()))
        done = not bool((digest[:, 0] == RUNNING).any())
        if done:
            break
        save_solver_state(
            checkpoint_path, _State(*pool.state[:-1], iters=iters), spec,
            fingerprint, config=cfg_blob,
        )
        if iters >= max_iters:
            # budget exhausted with boards still RUNNING: the snapshot just
            # written is the resume point — a re-run with a larger
            # max_iters continues from here instead of iteration 0
            break

    state = finalize_status(_State(*pool.state[:-1], iters=iters), spec)
    if done and not keep_checkpoint and os.path.exists(checkpoint_path):
        os.unlink(checkpoint_path)

    B, N = grid.shape[0], spec.size
    return SolveResult(
        grid=state.grid.reshape(B, N, N),
        solved=state.status == SOLVED,
        status=state.status,
        guesses=state.guesses,
        validations=state.validations,
        iters=iters,
    )
