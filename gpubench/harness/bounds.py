"""The yardstick's peaks and the least time of the batch kernel (K1).

A frozen copy of the arithmetic of ``chip_smoke._bound_ms``, so that a
change to the program cannot change the bound it is held to.

Peaks of one NVIDIA H100 SXM at its 700 W limit:
  HBM3 bandwidth 3.35 TB/s (NVIDIA H100 Tensor Core GPU data sheet);
  int32 lanes: 132 SMs x 64 INT32 units x 1.98 GHz boost clock (NVIDIA
  H100 Tensor Core GPU Architecture white paper).

Integer operations per cell per analysis sweep: the cheapest path a cell
takes through one sweep's singles analysis (a filled cell: load, zero and
range compares, shift, box index and three unit updates = 21 for the value
masks, then a load and a compare each for the candidates and the singles),
25 in all; an empty cell costs about twice that, so the count keeps the
bound a lower bound. A sweep with the locked-candidate pass adds 12 a cell
(the OR into its row and column segment, the pointing and claiming masks
of the two segments, the cell's own elimination). Loop and address
arithmetic are not counted.
"""

from __future__ import annotations

SM_CLOCK_HZ = 1.98e9
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * SM_CLOCK_HZ
OPS_PER_CELL_SWEEP = 25
OPS_PER_CELL_LOCKED = 12
# K1's per-board output: status, guesses, validations, steps
META_COLS = 4


def k1_bound_s(sweeps: int, boards: int, cells: int, locked: bool) -> tuple:
    """``(seconds, by)``: the least time of K1 launches that ran ``sweeps``
    analysis sweeps (summed over boards) over ``boards`` boards in all: the
    larger of the sweeps' integer operations over the int32 rate and the
    bytes (each board read once, its grid and meta written once) over the
    HBM rate; ``by`` names the larger."""
    per_cell = OPS_PER_CELL_SWEEP + (OPS_PER_CELL_LOCKED if locked else 0)
    ops_s = sweeps * cells * per_cell / INT32_OPS_PER_S
    bytes_s = boards * (2 * cells + META_COLS) * 4 / HBM_BYTES_PER_S
    return max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"
