"""Run phase 11 of ``chip_smoke.py`` alone on one GPU: the frontier race.

    python3 tools/chip_phase11.py

Builds the kernel library, then runs ``chip_smoke.phase_frontier``: the race
kernel against the plain race, the race's timing, the ``--frontier`` nodes
(a deep board's ``/solve`` beside the bucket path's) and (e) the seeding
kernel against the host rounds, with its time, rounds and states analyzed
per set. Prints the phase's log lines, the card's name and power limit, and
last one ``{"frontier": {...}}`` JSON object. Fails, as the smoke does, on
any disagreement, and exits non-zero without a result when no CUDA device
is available. About a minute after the build.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_phase11: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
    from sudoku_solver_distributed_tpu_torch.models import oracle_is_valid_solution
    from sudoku_solver_distributed_tpu_torch.net.cli import build_node, build_parser
    from sudoku_solver_distributed_tpu_torch.ops import cuda_solver as cs
    from sudoku_solver_distributed_tpu_torch.ops.config import serving_config
    from sudoku_solver_distributed_tpu_torch.ops.spec import spec_for_size

    t0 = time.time()
    cs.load_library()
    card = chip_smoke.card_name_and_power_limit()
    chip_smoke.log(f"card: {card}")
    out = chip_smoke.phase_frontier(
        cs, build_parser, build_node, spec_for_size,
        chip_smoke.node_config(SolverEngine, spec_for_size, serving_config),
        oracle_is_valid_solution, chip_smoke.SYMMETRY_SEED,
    )
    chip_smoke.log(f"phase 11 alone: {time.time() - t0:.1f} s")
    print(json.dumps({"frontier": dict(out, card=card)}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
