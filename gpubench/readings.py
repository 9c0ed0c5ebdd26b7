#!/usr/bin/env python3
"""The readings the correctness limits are set from, in one process.

    python3 gpubench/readings.py --workload <name> --seconds <s> \\
        --seeds <a,b,...> [--control-seeds <c,d,e>]

Runs the cell's window once for each seed of ``--seeds`` on the program as
the configuration builds it, then once for each seed of
``--control-seeds`` on the configuration's control (its ``control.engine``
settings over the program's: the program with a weaker guarantee), and
prints one JSON line a run with the numbers the check compared. A sound
run reads 0 in every number; the control has to read above a limit in one
of them. The benchmark's own runs never run the control. Needs the cards
the cell asks for.
"""

import argparse
import io
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _one(measure, workload, seed, seconds, overrides):
    out, err = io.StringIO(), io.StringIO()
    t = time.perf_counter()
    rc = measure(workload, seed, seconds, False, t_process=t, overrides=overrides,
                 out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    if rc != 0 or not lines:
        return {"rc": rc, "stderr": err.getvalue()[-2000:]}
    r = json.loads(lines[-1])
    return {"rc": rc, "correct": r["correct"], "attempted": r["attempted"],
            "failed": r["failed"],
            "checks": {k: v["value"] for k, v in r["checks"].items()},
            "metrics": {k: v["value"] for k, v in r["metrics"].items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from gpubench.harness.catalog import Catalog
    from gpubench.harness.runner import NoChip, cache_env, measure

    os.environ.update(cache_env(ROOT))
    control = Catalog().cell(args.workload).config["control"]["engine"]
    arms = [("program", s, {}) for s in args.seeds.split(",") if s]
    arms += [("control", s, control) for s in args.control_seeds.split(",") if s]
    try:
        for arm, seed, overrides in arms:
            row = _one(measure, args.workload, int(seed), args.seconds, overrides)
            print(json.dumps({"arm": arm, "seed": int(seed), **row}), flush=True)
    except NoChip as exc:
        print(f"readings: {exc}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
