"""Time the race's relay across hosts against another tree of the port, on one GPU.

    python3 tools/race_relay_ab.py OTHER_TREE

OTHER_TREE is a whole tree of the port inside this checkout, for example
the parent commit unpacked with ``git archive`` into a gitignored
directory such as ``_archive/parent``. The two trees run in turns (other,
this, this with the loop's relay dropped, the same, this, other: the
third arm tells the relay thread's cost from the rest of the tree's),
each ``chip_smoke.RELAY_SETS`` through two ranks of
its own multi-host serving loop on cuda:0 (``chip_smoke.relay_run``: gloo,
2 virtual shards a rank, ``RELAY_RACES`` races a set, the first not
counted; two ranks on one card are two CUDA contexts, whose kernels
time-slice). For each set and tree: every counted race's t*, each rank's
steps past it (from the gathered records), the relay's latency where one
relayed (µs, host clock: from the sender seeing its post to the receiver's
inbox written), each rank's race (``race_on_mesh``, host ms from the
call to its folded row after a sync, the gather included), each rank's
gather (host ms) and the leader's whole request (``loop.solve``: broadcast, seeding, race, gather,
fold; host ms). Both trees must give every race the same answer. Then,
for each set, µs a step of the rank that did not solve, alone on the card
(``chip_smoke.relay_us_a_step``, this tree), to put the latency in steps,
and ``ptxas -v``'s registers of ``dfs_race_shard_kernel`` for each tree's
build.

Prints one line per set and turn, the card's name and power limit, and last
one JSON object. Exits non-zero without a result when no CUDA device is
available.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_BUILD_LOG = ("from sudoku_solver_distributed_tpu_torch.ops import cuda_solver as cs; "
              "cs.load_library(); print(cs.build_log())")


def build_log(tree: Path) -> str:
    """The ``nvcc`` report of ``tree``'s kernel library (built, or loaded
    from its store)."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    return subprocess.run([sys.executable, "-c", _BUILD_LOG], cwd=tree, env=env,
                          capture_output=True, text=True, check=True, timeout=600).stdout


def main(argv) -> int:
    import argparse

    import numpy as np
    import torch

    parser = argparse.ArgumentParser(
        description="Time the race's relay across hosts against another tree.")
    parser.add_argument("other", help="the other tree of the port, inside the checkout")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("race_relay_ab: no CUDA device is available", file=sys.stderr)
        return 2
    other = Path(args.other).resolve()
    if not other.is_relative_to(ROOT):
        print(f"race_relay_ab: {other} lies outside {ROOT}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke

    arms = {"other": (other, True), "this": (ROOT, True), "this_relay_off": (ROOT, False)}
    order = ("other", "this", "this_relay_off", "this_relay_off", "this", "other")
    turns = [(label, smoke.relay_run(str(arms[label][0]), relay=arms[label][1]))
             for label in order]
    out = {}
    for name in turns[0][1]:
        rec = out[name] = {}
        for label in arms:
            races = [r for t, run in turns if t == label for r in run[name]["races"]]
            rec[label] = {
                "t_star": [r["t_star"] for r in races],
                "past_by_rank": [r["past_by_rank"] for r in races],
                "latency_us": [r["latency_us"] for r in races],
                "race_ms_by_rank": [r["race_ms"] for r in races],
                "leader_race_ms_median": statistics.median(r["race_ms"][0] for r in races),
                "gather_ms_by_rank": [r["gather_ms"] for r in races],
                "leader_gather_ms_median": statistics.median(r["gather_ms"][0] for r in races),
                "solve_ms": [r["solve_ms"] for r in races],
                "leader_solve_ms_median": statistics.median(r["solve_ms"] for r in races),
                "answers": [r["answer"] for r in races],
            }
        smoke.check(all(a == rec["other"]["answers"][0]
                        for arm in rec.values() for a in arm["answers"]),
                    f"{name}: the arms' races answer differently")
        first = turns[0][1][name]
        board, size, spd = first["board"], first["size"], first["states_per_shard"]
        rec["us_a_step"] = smoke.relay_us_a_step(np.asarray(board, np.int32), size, spd,
                                                 1 - first["races"][0]["solver_rank"])
        for label in arms:
            r = rec[label]
            r["latency_steps"] = [None if x is None else x / rec["us_a_step"]
                                  for x in r["latency_us"]]
            smoke.log(f"relay {name} {label}: t* {r['t_star']}, steps past t* by rank "
                      f"{r['past_by_rank']}; relay latency {r['latency_us']} us, "
                      f"{[x and round(x, 1) for x in r['latency_steps']]} steps "
                      f"({rec['us_a_step']:.3f} us a step); the leader's race median "
                      f"{r['leader_race_ms_median']:.3f} ms of "
                      f"{[round(x[0], 3) for x in r['race_ms_by_rank']]}, its gather "
                      f"median {r['leader_gather_ms_median']:.3f} ms; its whole "
                      f"request median {r['leader_solve_ms_median']:.3f} ms of "
                      f"{[round(x, 3) for x in r['solve_ms']]}")
            del r["answers"]
    ptxas = {
        "this": smoke.ptxas_report(build_log(ROOT), "ptxas this"),
        "other": smoke.ptxas_report(build_log(other), "ptxas other"),
    }
    card = smoke.card_name_and_power_limit()
    smoke.log(card)
    shard = {k: {n: v for n, v in p.items() if n.startswith("dfs_race_shard_kernel")}
             for k, p in ptxas.items()}
    print(json.dumps({"other": str(other.relative_to(ROOT)), "card": card,
                      "sets": out, "ptxas_shard_kernel": shard}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
