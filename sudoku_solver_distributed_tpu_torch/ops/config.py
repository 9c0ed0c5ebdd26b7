"""The serving solver configuration per board size.

A copy of the data in ``sudoku_solver_distributed_tpu/ops/config.py`` that
this package reads, kept here so the port imports nothing from the JAX
package. The values are the JAX package's; they are kept equal so the two
packages run the same searches.

The device kernel (ops/cuda_solver.py) and the plain solver
(ops/solver.py) run every knob here: the staged guess-stack depth, the
per-call step budget, locked-candidate eliminations, the extra
propagation sweeps per step (``waves``) and naked pairs. The segment
shape and the continuous-batching defaults below drive the open-loop
serving path (engine.dispatch_segment, parallel/coalescer.py).
"""

from __future__ import annotations

SERVING_CONFIG = {
    9: dict(
        max_depth=(32, 81),
        max_iters=4096,
        locked_candidates=True,
        waves=3,
        naked_pairs=False,
    ),
    16: dict(
        max_depth=(64, 256),
        max_iters=16384,
        locked_candidates=True,
        waves=1,
        naked_pairs=False,
    ),
    25: dict(
        max_depth=None,
        max_iters=65536,
        locked_candidates=True,
        waves=1,
        naked_pairs=False,
    ),
}


def serving_config(size: int) -> dict:
    """The serving ``solve_batch`` kwargs for an N×N board."""
    try:
        return dict(SERVING_CONFIG[size])
    except KeyError:
        raise ValueError(
            f"no serving config for size {size}; have {sorted(SERVING_CONFIG)}"
        ) from None


# The plain locked-candidate pass (ops/propagate.py) runs its row and column
# passes as two 16-bit bitplanes of one int32 lane where a value mask fits a
# plane (N <= 16). Exact either way: only the plain version's speed differs.
PACKED_DEFAULT = {9: True, 16: True, 25: False}


def packed_default(size: int) -> bool:
    """Whether the packed bitplane locked pass is on by default for N×N."""
    return bool(PACKED_DEFAULT.get(size, size <= 16))


# Continuous batching: the serving loop runs the solver in bounded
# segments of ``k`` steps over a fixed-width lane pool; between segments
# finished lanes answer and queued boards take the freed lanes. Smaller k
# refills sooner, larger k amortizes the boundary.
SEGMENT = {
    9: dict(k=8),
    16: dict(k=16),
    25: dict(k=32),
}
_SEGMENT_DEFAULT = dict(k=16)

# On for the coalesced path; ``continuous=False`` / ``--no-continuous``
# keeps the closed-loop run-to-completion coalescer.
CONTINUOUS_SERVING = dict(default_on=True)

# The pipelined segment boundary: the pool's state is updated in place,
# the host reads a per-lane digest at every boundary and solution rows
# only for lanes that solved in that segment, and the segment loop overlaps
# its boundary work with the next segment. ``segment_pipeline=False`` /
# ``--no-segment-pipeline`` reads the full rows every segment instead.
# Below ``prefix_gather_min_bytes`` of pool grid the solution block is
# the masked grid, read whole; at or above it, newly solved rows are
# gathered to the block's front and only that prefix is read.
SEGMENT_PIPELINE = dict(default_on=True, prefix_gather_min_bytes=1 << 16)


def segment_prefix_gather(width: int, cells: int) -> bool:
    """The solution block's form for a (width, cells) pool: one predicate
    for the kernel's launch and the host's fetch, so the host reads the
    block as the device built it."""
    return width * cells * 4 >= SEGMENT_PIPELINE["prefix_gather_min_bytes"]


def segment_config(size: int) -> dict:
    """The default segment shape for an N×N board."""
    return dict(SEGMENT.get(size, _SEGMENT_DEFAULT))


def resolved_segment_shape(size: int, segment_iters=None) -> dict:
    """The segment shape the continuous serving loop runs: ``{"k": k}``,
    ``segment_iters`` when given, else the size's default."""
    k = segment_iters if segment_iters is not None else segment_config(size)["k"]
    if int(k) < 1:
        raise ValueError(f"segment_iters must be >= 1, got {k}")
    return {"k": int(k)}
