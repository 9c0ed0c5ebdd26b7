#!/usr/bin/env python3
"""The benchmark of sudoku_solver_distributed_tpu_torch on NVIDIA cards.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` once, from the root of a checkout, on
the cards of the machine it starts on, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones, read
from a torch.profiler trace of the window), ``device``, with ``--trace 1``
``breakdown``, then ``context`` and last ``checks``, each number the
correctness check compared beside its limit (also the last lines on
standard error). Exits non-zero with no result line when the machine lacks
the cards, when the program is missing, or when the process holds a JAX
module once the window has closed.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from gpubench.harness.runner import NoChip, cache_env, measure

    os.environ.update(cache_env(ROOT))
    try:
        return measure(args.workload, args.seed, args.seconds, bool(args.trace),
                       t_process=T_PROCESS)
    except NoChip as exc:
        print(f"gpubench: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
