"""Data-parallel batch solving over a device mesh.

The port of ``sudoku_solver_distributed_tpu/parallel/shard.py``. A batch
is split on its leading axis into one row block a shard (parallel/mesh.py),
each shard's block runs through the kernels on that shard's device and
stream, and the results come back in global row order on the mesh's first
device. The JAX programs' ``psum``-reduced counters (``solved``,
``validations``, ``guesses``, ``lane_steps``, ``idle_lane_steps``) are
explicit sums over the shards here.

  * ``make_sharded_solver``: the library surface, ``fn(grids) ->
    (solutions, solved, stats)`` for any batch width: a batch that does not
    divide the mesh is padded with instantly-UNSAT boards, masked out of
    every per-board count.
  * ``make_packed_serving_program``: the engine's bucket program, one K1
    launch a shard, giving the packed rows ``[grid | solved | status |
    guesses | validations | lane_steps | idle_lane_steps]``; the two
    trailing columns are the call's totals, summed over the shards and
    broadcast to every row, as the JAX program broadcasts its ``psum``.
  * ``make_segment_serving_program``: the engine's continuous-batching
    segment over a lane pool split across the shards (a ``MeshSegmentPool``
    of one ``SegmentPool`` a shard): one K3 + K3b launch a shard.

Each factory is memoized on the mesh and every knob, as in the JAX
package, so the engine and the multi-host serving loop (serving_loop.py)
share one program. A shard runs the mesh program's ``waves`` at every
width: the JAX mesh programs do not drop to one sweep a step for a
one-board shard, as the single-device engine does for a one-board bucket.

A shard's loop ends when its own boards are done, so the lockstep
``lane_steps`` and ``idle_lane_steps`` are counted per shard
(``ops.cuda_solver.solve_stage_lockstep``) and summed: the totals of the
JAX mesh, which differ from one device's over the same batch.

``split_evidence`` reports how a program's last call landed: the shard
count and the rows a shard.
"""

from __future__ import annotations

import contextlib
from functools import lru_cache
from typing import List, Optional

import numpy as np
import torch

from ..ops.cuda_solver import SegmentPool, dfs_segment, solve_stage_lockstep
from ..ops.solver import OVERFLOW, pad_board, staged_depths
from ..ops.spec import SPEC_9, BoardSpec
from .mesh import Mesh

def mesh_batch_multiple(mesh: Mesh) -> int:
    """The batch-width divisor a ``data``-sharded program needs: one row
    block a shard."""
    return int(mesh.size)


def pad_to_mesh(grids, mesh: Mesh, spec: BoardSpec):
    """Pad a (B, N, N) batch up to the next mesh-divisible width with
    instantly-UNSAT boards (``ops.solver.pad_board``, dead after one
    sweep). Returns ``(padded, mask)``: tensors on the batch's device (a
    host array goes to the mesh's first device), the int32 mask 1 for
    real rows, so counters multiplied by it never see a pad row."""
    if not isinstance(grids, torch.Tensor):
        grids = torch.as_tensor(np.asarray(grids, np.int32), device=mesh.primary)
    grids = grids.to(torch.int32)
    B = int(grids.shape[0])
    n = mesh_batch_multiple(mesh)
    Bp = -(-B // n) * n
    mask = torch.zeros((Bp,), dtype=torch.int32, device=grids.device)
    mask[:B] = 1
    if Bp == B:
        return grids, mask
    pad = pad_board(spec, grids.device).expand(Bp - B, spec.size, spec.size)
    return torch.cat([grids, pad], 0), mask


def shard_bounds(B: int, mesh: Mesh) -> List[slice]:
    """The row block of each shard of a mesh-divisible batch of ``B``."""
    n = mesh.size
    if B % n:
        raise ValueError(f"a batch of {B} rows does not divide the {n}-shard mesh")
    w = B // n
    return [slice(i * w, (i + 1) * w) for i in range(n)]


@contextlib.contextmanager
def on_shard(mesh: Optional[Mesh], i: int, *inputs: torch.Tensor):
    """Run the block on shard ``i``: its device and, on CUDA, its stream,
    ordered after the work the calling thread has enqueued on that device;
    ``inputs`` on that device are marked in use by the stream (the
    allocator must not hand their memory out again before it finishes).
    An input on another device is copied in the block with ``.to``, which
    orders itself after both devices' current streams. A CPU shard runs
    the block as it is, and so does a None mesh (one device, the calling
    thread's stream)."""
    if mesh is None or mesh.streams[i] is None:
        yield
        return
    dev, stream = mesh.devices[i], mesh.streams[i]
    stream.wait_stream(torch.cuda.current_stream(dev))
    for t in inputs:
        if t.device == dev:
            t.record_stream(stream)
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        yield


def to_primary(mesh: Mesh, i: int, t: torch.Tensor,
               stream: Optional[torch.cuda.Stream] = None) -> torch.Tensor:
    """A tensor shard ``i`` produced on its stream, made usable on
    ``stream`` (default: the calling thread's current stream) of the
    mesh's first device, copied there when it lies elsewhere. No host
    sync."""
    own = mesh.streams[i]
    if own is None:
        return t
    prim = mesh.primary
    target = stream if stream is not None else torch.cuda.current_stream(prim)
    if t.device == prim:
        target.wait_stream(own)
        t.record_stream(target)
        return t
    # a copy across devices orders itself after both devices' current
    # streams: put the shard's work under the source's current stream
    src = torch.cuda.current_stream(t.device)
    src.wait_stream(own)
    t.record_stream(src)
    with torch.cuda.device(prim), torch.cuda.stream(target):
        return t.to(prim, non_blocking=True)


def join_shards(mesh: Optional[Mesh]) -> None:
    """Order the calling thread's current stream of every mesh device after
    all the shards' streams (the shards' last work is done for it); a None
    mesh has nothing to order."""
    if mesh is None:
        return
    for dev, stream in zip(mesh.devices, mesh.streams):
        if stream is not None:
            torch.cuda.current_stream(dev).wait_stream(stream)


def _scalar_sum(values, device) -> torch.Tensor:
    """Σ of per-shard LoopStats scalars (ints, or 0-dim tensors on any
    device) as a 0-dim int64 tensor on ``device``."""
    total = torch.zeros((), dtype=torch.int64, device=device)
    for v in values:
        if isinstance(v, torch.Tensor):
            total = total + v.to(device=device, dtype=torch.int64)
        else:
            total = total + int(v)
    return total


def _host_int(v) -> int:
    """A LoopStats scalar (an int, or a 0-dim tensor on any device) as a
    host int, fetched explicitly; ``restage`` reads it after the stage's
    rows came back, so the shard's stream has already finished it."""
    return int(torch.as_tensor(v).cpu())


def _split(B: int, mesh: Mesh) -> dict:
    """A call's split, a new dict: a program is shared between threads,
    which read its ``last_split`` whole or not at all."""
    return {"devices": int(mesh.size), "rows_per_device": int(B // mesh.size)}


def split_evidence(program) -> dict:
    """How a mesh program's last call landed: ``{"devices": shards,
    "rows_per_device": rows a shard}``. Anything else (a host array, a
    single-device output) reads as one device holding all its rows."""
    last = getattr(program, "last_split", None)
    if last:
        return dict(last)
    return {"devices": 1, "rows_per_device": int(np.shape(program)[0])}


def _sweeps(locked_candidates, waves, naked_pairs, solver_overrides) -> dict:
    overrides = dict(solver_overrides)
    unknown = set(overrides) - {"packed"}
    if unknown:
        raise NotImplementedError(
            f"solver overrides {sorted(unknown)} are not ported: the kernels "
            "have no lockstep compaction schedule"
        )
    return dict(
        locked_candidates=bool(locked_candidates), waves=int(waves),
        naked_pairs=naked_pairs, packed=overrides.get("packed"),
    )


class PackedServingProgram:
    """The engine's bucket program over a mesh (``make_packed_serving_program``).

    ``dispatch(boards, iters)`` enqueues the first depth stage of a
    mesh-divisible (B, N, N) batch, one K1 launch a shard, and returns the
    (B, C+6) int32 rows on the mesh's first device without a host sync;
    ``restage(rows, boards, iters)`` takes those rows on the host and reruns,
    shard by shard, each shard's OVERFLOW boards at every deeper stage
    with its other rows the pad board, as ``ops.solver.solve_staged`` runs
    inside each shard of the JAX program (their counters accumulate, and
    the shard's rerun adds its LoopStats to the call's totals). Calling the
    program does both and returns the host rows."""

    def __init__(self, mesh: Mesh, spec: BoardSpec, *, max_depth,
                 locked_candidates: bool, waves: int, naked_pairs,
                 solver_overrides: tuple = ()):
        self.mesh = mesh
        self.spec = spec
        self.depths = staged_depths(max_depth, spec)
        self.sweeps = _sweeps(locked_candidates, waves, naked_pairs, solver_overrides)
        self.last_split: dict = {}

    def _shard_rows(self, i: int, boards: torch.Tensor, depth: int, iters: int):
        """Shard ``i``'s stage rows (w, C+4) and its (lane, idle) scalars,
        on its own stream."""
        spec = self.spec
        dev = self.mesh.devices[i]
        with on_shard(self.mesh, i, boards):
            part = boards.to(dev, non_blocking=True)
            res, stats = solve_stage_lockstep(part, spec, depth, iters, **self.sweeps)
            w = part.shape[0]
            rows = torch.cat(
                [
                    res.grid.reshape(w, spec.cells),
                    res.solved[:, None].to(torch.int32),
                    res.status[:, None],
                    res.guesses[:, None],
                    res.validations[:, None],
                ],
                dim=1,
            )
        return rows, stats

    def _assemble(self, shard_out, device) -> torch.Tensor:
        rows = torch.cat(
            [to_primary(self.mesh, i, r) for i, (r, _) in enumerate(shard_out)], 0
        )
        B = rows.shape[0]
        for _, stats in shard_out:
            for v in stats:
                if isinstance(v, torch.Tensor) and v.device.type == "cuda":
                    v.record_stream(torch.cuda.current_stream(v.device))
        lane = _scalar_sum([s.lane_steps for _, s in shard_out], device)
        idle = _scalar_sum([s.idle_lane_steps for _, s in shard_out], device)
        return torch.cat(
            [
                rows,
                lane.to(torch.int32).reshape(1, 1).expand(B, 1),
                idle.to(torch.int32).reshape(1, 1).expand(B, 1),
            ],
            dim=1,
        )

    def dispatch(self, boards, iters: int) -> torch.Tensor:
        if not isinstance(boards, torch.Tensor):
            boards = torch.as_tensor(np.asarray(boards, np.int32), device=self.mesh.primary)
        bounds = shard_bounds(boards.shape[0], self.mesh)
        out = [
            self._shard_rows(i, boards[sl], self.depths[0], int(iters))
            for i, sl in enumerate(bounds)
        ]
        self.last_split = _split(boards.shape[0], self.mesh)
        return self._assemble(out, self.mesh.primary)

    def restage(self, rows: np.ndarray, boards: torch.Tensor, iters: int) -> np.ndarray:
        C = self.spec.cells
        for depth in self.depths[1:]:
            for i, sl in enumerate(shard_bounds(rows.shape[0], self.mesh)):
                need = rows[sl, C + 1] == OVERFLOW
                if not need.any():
                    continue
                part = boards[sl]
                g2 = torch.where(
                    torch.as_tensor(need).to(part.device)[:, None, None],
                    part,
                    pad_board(self.spec, part.device),
                )
                r2, stats = self._shard_rows(i, g2, depth, int(iters))
                r2 = to_primary(self.mesh, i, r2).cpu().numpy()
                blk = rows[sl]
                blk[need, : C + 2] = r2[need, : C + 2]
                blk[need, C + 2: C + 4] += r2[need, C + 2: C + 4]
                rows[sl] = blk
                rows[:, C + 4] += _host_int(stats.lane_steps)
                rows[:, C + 5] += _host_int(stats.idle_lane_steps)
        return rows

    def __call__(self, boards, iters: int) -> np.ndarray:
        if not isinstance(boards, torch.Tensor):
            boards = torch.as_tensor(np.asarray(boards, np.int32), device=self.mesh.primary)
        rows = self.dispatch(boards, iters).cpu().numpy()
        return self.restage(rows, boards, iters)


@lru_cache(maxsize=None)
def make_packed_serving_program(
    mesh: Mesh,
    spec: BoardSpec,
    *,
    max_depth,
    locked_candidates: bool,
    waves: int,
    naked_pairs,
    solver_overrides: tuple = (),
) -> PackedServingProgram:
    """The engine's packed-row bucket program over ``mesh``: one K1 launch
    a shard, rows ``[grid | solved | status | guesses | validations |
    lane_steps | idle_lane_steps]`` in global row order, the two trailing
    columns the call's totals summed over the shards (the cost plane reads
    row 0, as on one device), the step budget an argument of each call.
    ``solver_overrides`` is the engine's resolved solver dict as a sorted
    item tuple; the kernels take ``packed`` only. Memoized on every knob:
    the engine and the multi-host serving loop share one program."""
    return PackedServingProgram(
        mesh, spec, max_depth=max_depth, locked_candidates=locked_candidates,
        waves=waves, naked_pairs=naked_pairs, solver_overrides=solver_overrides,
    )


def make_sharded_solver(
    mesh: Mesh,
    spec: BoardSpec = SPEC_9,
    *,
    max_depth: Optional[int] = None,
    max_iters: int = 4096,
    locked_candidates: bool = True,
    waves: int = 3,
    naked_pairs: Optional[bool] = None,
    packed: Optional[bool] = None,
):
    """Build a mesh-sharded batch solver.

    Returns ``fn(grids) -> (solutions, solved, stats)`` for a (B, N, N)
    batch of ANY width B: a batch that does not divide the mesh is padded
    with instantly-UNSAT boards up to the next mesh-divisible width, and
    the outputs are sliced back to B rows. ``solutions`` (B, N, N) and
    ``solved`` (B,) are tensors on the mesh's first device; ``stats`` sums
    over the shards the per-board ``solved``, ``validations`` and
    ``guesses`` (pad rows masked out) and the shards' lockstep
    ``lane_steps`` and ``idle_lane_steps`` (pad lanes ride along, each
    dead after one sweep), as Python ints.

    ``locked_candidates``/``waves`` default to the JAX package's measured
    serving winners; ``max_depth`` may be staged (a tuple), as in
    ``ops.solver.solve_batch``."""
    program = make_packed_serving_program(
        mesh, spec, max_depth=max_depth, locked_candidates=locked_candidates,
        waves=waves, naked_pairs=naked_pairs,
        solver_overrides=(("packed", packed),) if packed is not None else (),
    )

    def fn(grids):
        if not isinstance(grids, torch.Tensor):
            grids = torch.as_tensor(np.asarray(grids, np.int32), device=mesh.primary)
        B = int(grids.shape[0])
        padded, mask = pad_to_mesh(grids, mesh, spec)
        rows = program(padded, max_iters)
        C = spec.cells
        real = mask.cpu().numpy() > 0
        stats = {
            "solved": int(rows[real, C].sum()),
            "validations": int(rows[real, C + 3].sum()),
            "guesses": int(rows[real, C + 2].sum()),
            "lane_steps": int(rows[0, C + 4]),
            "idle_lane_steps": int(rows[0, C + 5]),
        }
        dev = grids.device
        solutions = torch.as_tensor(rows[:B, :C].reshape(B, spec.size, spec.size)).to(dev)
        solved = torch.as_tensor(rows[:B, C] > 0).to(dev)
        return solutions, solved, stats

    return fn


class MeshSegmentPool:
    """A lane pool split across a mesh: one ``SegmentPool`` a shard, lane
    ``j`` of shard ``i`` the pool's lane ``i * w + j``. A segment consumes
    the handle it is given and returns the pool's next one, as a
    ``SegmentPool`` does."""

    def __init__(self, shards: list, mesh: Mesh, spec: BoardSpec, *, _shared=None):
        self.shards = shards
        self.mesh = mesh
        self.spec = spec
        self._shared = _shared if _shared is not None else {"generation": 0}
        self.generation = self._shared["generation"]

    @property
    def width(self) -> int:
        return sum(p.width for p in self.shards)

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

    def _next(self, shards: list) -> "MeshSegmentPool":
        self._shared["generation"] += 1
        return MeshSegmentPool(shards, self.mesh, self.spec, _shared=self._shared)


class SegmentServingProgram:
    """The engine's segment program over a mesh
    (``make_segment_serving_program``): ``new_pool(width)`` builds a
    ``MeshSegmentPool``, and a call runs one segment, one K3 + K3b launch
    a shard on its stream, returning the pool's next handle and each
    shard's (w, 8) digest and (w, C) solution block (on the shard's
    device). A shard's lanes take their boards from the whole ``boards``
    (the source map of ``ops.solver.inject_lanes_src`` names global rows),
    and each shard's loop exits when its own lanes are done."""

    def __init__(self, mesh: Mesh, spec: BoardSpec, *, max_depth,
                 locked_candidates: bool, waves: int, naked_pairs,
                 solver_overrides: tuple = ()):
        self.mesh = mesh
        self.spec = spec
        if isinstance(max_depth, (tuple, list)):
            max_depth = max(max_depth)
        self.depth = spec.max_depth if max_depth is None else int(max_depth)
        self.sweeps = _sweeps(locked_candidates, waves, naked_pairs, solver_overrides)
        self.last_split: dict = {}

    def new_pool(self, width: int) -> MeshSegmentPool:
        """A fresh pool of ``width`` lanes (mesh-divisible), every lane on
        the instantly-UNSAT pad board, the flat depth's stack."""
        N = self.spec.size
        shards = []
        for i, sl in enumerate(shard_bounds(int(width), self.mesh)):
            w = sl.stop - sl.start
            dev = self.mesh.devices[i]
            with on_shard(self.mesh, i):
                boards = pad_board(self.spec, dev).expand(w, N, N)
                shards.append(SegmentPool.fresh(boards, self.spec, self.depth))
        return MeshSegmentPool(shards, self.mesh, self.spec)

    def __call__(self, pool: MeshSegmentPool, boards: torch.Tensor,
                 src: torch.Tensor, seg_iters: int, *, prefix_gather: bool):
        pool.check_live()
        bounds = shard_bounds(pool.width, self.mesh)
        nxt, digests, blocks = [], [], []
        for i, sl in enumerate(bounds):
            dev = self.mesh.devices[i]
            shard = pool.shards[i]
            with on_shard(self.mesh, i, boards, src):
                b = boards.to(dev, non_blocking=True)
                s = src[sl].to(dev, non_blocking=True).contiguous()
                p2, digest, block = dfs_segment(
                    shard, b, s, seg_iters, prefix_gather=prefix_gather,
                    **self.sweeps,
                )
            nxt.append(p2)
            digests.append(digest)
            blocks.append(block)
        self.last_split = _split(pool.width, self.mesh)
        return pool._next(nxt), digests, blocks


@lru_cache(maxsize=None)
def make_segment_serving_program(
    mesh: Mesh,
    spec: BoardSpec,
    *,
    max_depth,
    locked_candidates: bool,
    waves: int,
    naked_pairs,
    solver_overrides: tuple = (),
) -> SegmentServingProgram:
    """The engine's continuous-batching segment program over ``mesh``
    (``SegmentServingProgram``), the mesh twin of one device's segment
    kernels. Either boundary arm reads it (the engine builds the full
    rows or reads the digest and the blocks): the JAX factory's
    ``pipeline`` switch picks between two programs, here the kernels are
    the same. Memoized on every knob."""
    return SegmentServingProgram(
        mesh, spec, max_depth=max_depth, locked_candidates=locked_candidates,
        waves=waves, naked_pairs=naked_pairs, solver_overrides=solver_overrides,
    )
