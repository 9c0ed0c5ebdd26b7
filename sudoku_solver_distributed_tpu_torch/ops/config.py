"""The serving solver configuration per board size.

A copy of the data in ``sudoku_solver_distributed_tpu/ops/config.py`` that
this package reads, kept here so the port imports nothing from the JAX
package. The values are the JAX package's; they are kept equal so the two
packages run the same searches.

The device kernel (ops/cuda_solver.py) and the plain solver
(ops/solver.py) run every knob here: the staged guess-stack depth, the
per-call step budget, locked-candidate eliminations, the extra
propagation sweeps per step (``waves``) and naked pairs.
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
