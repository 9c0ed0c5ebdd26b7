"""Where the seeding kernel's rounds go on one GPU, phase by phase.

    python3 tools/seed_phases.py [SOURCE_dfs_solver.cu ...]

Copies each source (default: this checkout's ``csrc/dfs_solver.cu``; any
other must lie inside the checkout, as ``tools/dfs_solver_ab.py``'s OTHER
does) with ``clock64()`` stamps that block 0's thread 0 takes in
``seed_frontier_kernel``: at the top of each round, around the round's
first cluster barrier and around its last. The copy is built with
``cuda_solver.NVCC_FLAGS`` (``tools/dfs_solver_ab.build_other``) and seeds
phase 11 (e)'s sets ten times each through ``cuda_solver._seed_launch``.
Per set it prints the medians, in microseconds a round at the card's
maximum SM clock (``chip_smoke.SM_CLOCK_HZ``), of: the sweeps (block 0's
share of the batch loaded and swept, and its words published), the first
barrier, the decision and the rows, and the last barrier. A round that
ends the seeding at its decision adds only its first two phases. Block 0
holds the batch's first states, so its sweeps are the round's longest or
close to it. Prints the card's name and power limit and last one JSON
object; exits non-zero without a result when no CUDA device is available.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PHASES = ("sweeps", "first barrier", "decision and rows", "last barrier")
SETS = ("9x9 deep #0 @64", "9x9 deep #0 @64 unlocked", "README @512", "9x9 deep #0 @512")


def instrument(source: str) -> str:
    """``source`` with the stamps and a ``seed_phases_read`` entry point:
    four cycle sums and the round count, copied out after a launch."""
    def insert(text, at, what):
        return text[:at] + what + text[at:]

    kernel = source.index("seed_frontier_kernel(const int32_t*")
    head = source.rindex("template <int BOX>", 0, kernel)
    declare = source.index("  int outcome = kSeedRounds", kernel)
    top = source.index("    analyzed += M;\n", declare) + len("    analyzed += M;\n")
    first = source.index("    cluster.sync();\n", top)
    last = source.index("    M = total;\n    cluster.sync();\n", first) + len("    M = total;\n")
    done = source.index("  int count = M;\n", last)
    end = source.index('}  // extern "C"')
    stamp = "if (prof) { const long long c = clock64(); acc[{k}] += c - at; at = c; }\n"
    out = source
    # from the end backwards, so the earlier offsets hold
    out = insert(out, end, "int seed_phases_read(unsigned long long* out) {\n"
                 "  return (int)cudaMemcpyFromSymbol(out, seed_phases, sizeof(seed_phases));\n}\n\n")
    out = insert(out, done, "  if (prof) {\n    for (int k = 0; k < 4; ++k) seed_phases[k] = acc[k];\n"
                 "    seed_phases[4] = rounds;\n  }\n")
    out = insert(out, last + len("    cluster.sync();\n"), "    " + stamp.replace("{k}", "3"))
    out = insert(out, last, "    " + stamp.replace("{k}", "2"))
    out = insert(out, first + len("    cluster.sync();\n"), "    " + stamp.replace("{k}", "1"))
    out = insert(out, first, "    " + stamp.replace("{k}", "0"))
    out = insert(out, top, "    if (prof) at = clock64();\n")
    out = insert(out, declare, "  const bool prof = rank == 0 && threadIdx.x == 0;\n"
                 "  unsigned long long acc[4] = {0, 0, 0, 0};\n  long long at = 0;\n")
    return insert(out, head, "__device__ unsigned long long seed_phases[5];\n\n")


def phases(cs, smoke, ab, source: Path) -> dict:
    import torch

    from sudoku_solver_distributed_tpu_torch.ops.spec import spec_for_size
    from sudoku_solver_distributed_tpu_torch.parallel import frontier as F

    copy = cs.BUILD_DIR / f"seed_phases_{source.stem}.cu"
    cs.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    copy.write_text(instrument(source.read_text()))
    lib, _ = ab.build_other(cs, copy)
    lib.seed_phases_read.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * 5)()
    count0 = cs.seed_frontier_cuda.launches
    out = {}
    for name, states, spec, target, locked in ab.seed_timing_sets(smoke, F, spec_for_size):
        if name not in SETS and not name.startswith(("16x16", "25x25", "4x4")):
            continue
        flat = torch.as_tensor(states.reshape(len(states), -1), device="cuda").contiguous()
        runs = []
        for _ in range(10):
            cs._seed_launch(lib, flat, spec, target, spec.cells + 16, locked)
            torch.cuda.synchronize()
            smoke.check(lib.seed_phases_read(buf) == 0, "seed_phases_read failed")
            runs.append(list(buf))
        rounds = runs[0][4]
        us = {p: statistics.median(r[k] for r in runs) / rounds / smoke.SM_CLOCK_HZ * 1e6
              for k, p in enumerate(PHASES)}
        out[name] = {"rounds": rounds, "us_a_round": us, "sum_us": sum(us.values())}
        smoke.log(f"{source.name} {name}: {rounds} rounds; us a round (clock64 at "
                  f"{smoke.SM_CLOCK_HZ / 1e9:g} GHz, medians of 10): "
                  + ", ".join(f"{p} {v:.2f}" for p, v in us.items())
                  + f"; sum {out[name]['sum_us']:.2f}")
    cs.seed_frontier_cuda.launches = count0
    return out


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("seed_phases: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    import chip_smoke as smoke
    import dfs_solver_ab as ab
    from sudoku_solver_distributed_tpu_torch.ops import cuda_solver as cs

    sources = [Path(a).resolve() for a in argv] or [cs.SOURCE]
    for source in sources:
        if not source.is_relative_to(ROOT):
            print(f"seed_phases: {source} lies outside {ROOT}", file=sys.stderr)
            return 2
    cs.load_library()
    result = {str(s.relative_to(ROOT)): phases(cs, smoke, ab, s) for s in sources}
    card = smoke.card_name_and_power_limit()
    smoke.log(card)
    print(json.dumps({"card": card, "phases": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
