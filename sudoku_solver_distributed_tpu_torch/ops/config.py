"""The serving solver configuration per board size.

A copy of the data in ``sudoku_solver_distributed_tpu/ops/config.py`` that
this package reads, kept here so the port imports nothing from the JAX
package. The values are the JAX package's; they are kept equal so the two
packages run the same searches.

The port's device kernel (ops/cuda_solver.py) runs singles-only analysis
with one sweep per step, so of these knobs it reads ``max_depth`` (the
staged guess-stack depth) and ``max_iters`` (the per-call step budget).
``locked_candidates``/``waves``/``naked_pairs`` are the JAX serving
solver's sweeps; the port raises where a caller asks for them.
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
