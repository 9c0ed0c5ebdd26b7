"""Time another build of the DFS kernels against this checkout's, on one GPU.

    python3 tools/dfs_solver_ab.py OTHER_dfs_solver.cu [--arms k1,k3,race]

OTHER is a source of the same C interface (``dfs_solver_launch``,
``dfs_segment_launch`` and ``dfs_race_launch`` with the same arguments,
sweep count and option bits included, ``dfs_solver_meta_cols`` and
``dfs_segment_digest_cols``) inside this checkout: for example a commit's
``csrc/dfs_solver.cu`` unpacked with ``git archive`` into a gitignored
directory such as ``_archive/``, or a copy of this one with one constant
changed. Both sources are built with ``cuda_solver.NVCC_FLAGS``, and
``ptxas -v``'s registers and stack are printed for each. ``--arms`` picks
the arms (default all three).

The DFS kernel (K1, arm ``k1``): at every width of
``chip_smoke.timing_widths`` the two builds must return the same grid and
meta (singles configuration: one sweep a step, no option bits); then each
is timed with CUDA events in turns: other, this, this, other.

The segment kernels (K3 and its digest kernel K3b, arm ``k3``), in the 9x9
serving configuration: at every case of ``chip_smoke.segment_timing_cases``
(pools of 8, 64, 512 and 4096 lanes all injected, and 4096 with 1 and with
16 live lanes) the two builds must leave the same pool state, digest and
solution block after one k = 8 segment; then one segment at k = 8 and at
k = 0 is timed with CUDA events in turns (other, this, this, other), and K3
and K3b each on its own from torch.profiler's CUDA kernel records over as
many segments, for each build.

The race kernel (K4, arm ``race``), each set in the configuration its node
races with: at every set of ``chip_smoke.race_timing_sets`` the two builds
must return the same packed row and fold; then each build's races are timed
one by one with CUDA events in turns (other, this, this, other; the median
of every race of a build), and each build's kernels from torch.profiler's
records (a build of the warp-a-state design launches a fold kernel too).
Per set: t*, the bound and its share, microseconds per sweep of the
slowest state, and resident states per SM where a build reports them. A build whose
library does not say where its race keeps the guess stack
(``dfs_race_stack_on_chip``) gets the device slab; each build races on
a two-word scratch of its own.

Prints one line per width, case and set, the card's name and power limit,
and last one JSON object with the times. Exits non-zero without a result
when no CUDA device is available.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def build_other(cs, source: Path):
    """Build ``source`` beside the package's own library and load it with
    the same signatures. Returns the library and its build log."""
    key = hashlib.sha1(
        source.read_bytes() + " ".join(cs.NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    path = cs.BUILD_DIR / f"libdfs_solver_other_{key}.so"
    build_log = path.with_suffix(".log")
    if not path.exists():
        cs.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd = [cs._nvcc(), *cs.NVCC_FLAGS, "-o", str(path), str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {source}:\n{proc.stderr[-4000:]}")
    lib = ctypes.CDLL(str(path))
    this = cs.load_library()
    for fn in ("dfs_solver_launch", "dfs_segment_launch", "dfs_race_launch"):
        getattr(lib, fn).argtypes = getattr(this, fn).argtypes
        getattr(lib, fn).restype = ctypes.c_int
    if lib.dfs_solver_meta_cols() != cs.META_COLS:
        raise RuntimeError(f"{source} disagrees on the meta layout")
    if lib.dfs_segment_digest_cols() != cs.SEGMENT_DIGEST_COLS:
        raise RuntimeError(f"{source} disagrees on the digest layout")
    return lib, build_log


def dfs_widths(cs, this, other, smoke) -> dict:
    """K1 at each timing width, in turns."""
    import torch

    from sudoku_solver_distributed_tpu_torch.ops.spec import spec_for_size

    spec = spec_for_size(9)
    widths = {}
    for name, boards, depth in smoke.timing_widths():
        flat = torch.as_tensor(boards.reshape(len(boards), -1), device="cuda").contiguous()
        reps = 50 if len(boards) < 512 else 10

        def launch(lib):
            return cs._launch(lib, flat, spec, depth, 4096)

        grid, meta = launch(this)
        ogrid, ometa = launch(other)
        smoke.check(torch.equal(grid, ogrid) and torch.equal(meta, ometa),
                    f"width {name}: the two builds disagree")
        turns = [smoke._cuda_ms(lambda lib=lib: launch(lib), reps)
                 for lib in (other, this, this, other)]
        widths[name] = {"other_ms": (turns[0] + turns[3]) / 2,
                        "this_ms": (turns[1] + turns[2]) / 2, "turns_ms": turns}
        smoke.log(
            f"width {name} (depth {depth}): other {turns[0]:.4f}, this "
            f"{turns[1]:.4f}, this {turns[2]:.4f}, other {turns[3]:.4f} ms "
            f"(CUDA events, mean of {reps} each); slowest board "
            f"{int(meta[:, 3].max())} steps"
        )
    return widths


def segment_cases(cs, this, other, smoke) -> dict:
    """K3 + K3b at each segment timing case: outputs equal, then the two
    builds in turns at k = 8 and k = 0, and each kernel's own time."""
    import torch

    from sudoku_solver_distributed_tpu_torch.ops import solver as ts
    from sudoku_solver_distributed_tpu_torch.ops.config import (
        segment_prefix_gather,
        serving_config,
    )
    from sudoku_solver_distributed_tpu_torch.ops.spec import spec_for_size

    spec = spec_for_size(9)
    knobs = ts.sweep_knobs(spec, **smoke.sweeps_of(serving_config(9)))
    waves, options = knobs["waves"], cs._options(knobs)
    depth = smoke.flat_depth(ts, spec, serving_config)
    hard = torch.as_tensor(
        smoke.load_corpus("corpus_9x9_hard_4096.npz").reshape(4096, -1), device="cuda")
    out = {}
    for name, W, live in smoke.segment_timing_cases():
        src = smoke.segment_case_src(W, live)
        keep = torch.full_like(src, -1)
        prefix = segment_prefix_gather(W, spec.cells)
        pools, first = {}, {}
        for label, lib in (("other", other), ("this", this)):
            pool = cs.SegmentPool.fresh(ts.pad_board(spec, "cuda").expand(W, 9, 9),
                                        spec, depth)
            if live is not None:  # finish every pad lane first: one step each
                cs._launch_segment(lib, pool, hard, keep, 1, waves, options, prefix)
            first[label] = cs._launch_segment(lib, pool, hard, src, 8, waves, options,
                                              prefix)
            pools[label] = pool
        (kd, kb), (od, ob) = first["this"], first["other"]
        n_bad, err = smoke._segment_lane_diffs(pools["this"], pools["other"].state,
                                               kd, od, kb, ob)
        smoke.check(n_bad == 0, f"segment case {name}: the two builds disagree "
                                f"in {n_bad} lanes (largest difference {err})")
        reps = 50 if W < 4096 else 20
        case = out[name] = {"steps": int(first["this"][0][0, 6]) // W}
        for k in (8, 0):
            def seg(lib, k=k):
                cs._launch_segment(lib, pools["this"], hard, src, k, waves, options,
                                   prefix)

            turns = [smoke._cuda_ms(lambda lib=lib: seg(lib), reps)
                     for lib in (other, this, this, other)]
            split = {label: smoke._profiled_kernel_ms(lambda lib=lib: seg(lib), reps)
                     for label, lib in (("other", other), ("this", this))}
            case[f"k{k}"] = {"other_ms": (turns[0] + turns[3]) / 2,
                             "this_ms": (turns[1] + turns[2]) / 2,
                             "turns_ms": turns, "kernel_ms": split}
            smoke.log(
                f"segment {name} k {k}: other {turns[0]:.4f}, this {turns[1]:.4f}, "
                f"this {turns[2]:.4f}, other {turns[3]:.4f} ms (CUDA events, mean "
                f"of {reps} each); profiler, ms a segment: other "
                + ", ".join(f"{n} {v:.4f}" for n, v in split["other"].items())
                + "; this "
                + ", ".join(f"{n} {v:.4f}" for n, v in split["this"].items())
            )
    return out


def _race_times_ms(fn, reps: int, smoke) -> list:
    """Each of ``reps`` back-to-back races' device time by its own pair of
    CUDA events, queued behind a device spin (as ``chip_smoke._cuda_ms``)
    so the races run back to back."""
    import torch

    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(int(reps * 200e-6 * smoke.SM_CLOCK_HZ))
    for start, end in ev:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in ev]


def _race_t_star(meta) -> int:
    """t* from a race's run records: the earliest step a state solved at,
    else the last step any state ran (``ops/solver.fold_race``)."""
    solved = meta[:, 0] == 1
    return int(meta[solved, 1].min() if bool(solved.any()) else meta[:, 1].max())


def race_sets(cs, this, other, other_log, smoke) -> dict:
    """K4 on each set of ``chip_smoke.race_timing_sets``: outputs equal,
    then the two builds in turns, race by race, and by the profiler."""
    import statistics

    import torch

    from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
    from sudoku_solver_distributed_tpu_torch.ops.config import serving_config
    from sudoku_solver_distributed_tpu_torch.ops.spec import spec_for_size
    from sudoku_solver_distributed_tpu_torch.parallel import frontier as F

    config = smoke.node_config(SolverEngine, spec_for_size, serving_config)
    sets = smoke.race_timing_sets(
        smoke.frontier_race_sets(F, spec_for_size, smoke.SYMMETRY_SEED))
    other_kernels = ("dfs_race_kernel", "race_fold_kernel") if (
        "race_fold_kernel" in other_log) else ("dfs_race_kernel",)
    other_slab = {}
    out = {}
    for name, _, spec, states, max_iters, _ in sets:
        box = spec.box
        if box not in other_slab:
            other_slab[box] = (not hasattr(other, "dfs_race_stack_on_chip")
                               or cs.race_stack_in_slab(other, box))
        sweeps = smoke.sweeps_of(config(spec.size))
        knobs = cs.sweep_knobs(spec, **sweeps)
        waves, options = knobs["waves"], cs._options(knobs)
        flat = torch.as_tensor(states.reshape(len(states), -1), device="cuda").contiguous()
        depth = spec.max_depth
        other_scratch = torch.tensor(cs.RACE_SCRATCH_IDLE, dtype=torch.int32, device="cuda")

        def race(lib):
            if lib is this:
                return cs._launch_race(this, flat, spec, depth, max_iters, waves, options)
            return cs._launch_race(other, flat, spec, depth, max_iters, waves, options,
                                   slab=other_slab[box], scratch=other_scratch)

        (trow, tfold, tmeta), (orow, ofold, ometa) = race(this), race(other)
        smoke.check(torch.equal(trow, orow) and torch.equal(tfold, ofold),
                    f"race set {name}: the two builds disagree")
        reps = 20 if spec.size < 25 else 10
        turns = [_race_times_ms(lambda lib=lib: race(lib), reps, smoke)
                 for lib in (other, this, this, other)]
        med = {"other": statistics.median(turns[0] + turns[3]),
               "this": statistics.median(turns[1] + turns[2])}
        prof = {
            "other": smoke._profiled_kernel_ms(lambda: race(other), 10,
                                               kernels=other_kernels, min_records=5),
            "this": smoke._profiled_kernel_ms(lambda: race(this), 10,
                                              kernels=("dfs_race_kernel",),
                                              min_records=5),
        }
        bound, by = smoke._race_bound_ms(flat, tfold, spec.cells,
                                         sweeps["locked_candidates"])
        slowest = {"other": int(ometa[:, 2].max()), "this": int(tmeta[:, 2].max())}
        per_sm = {"this": cs.race_states_per_sm(spec.size),
                  "other": (other.dfs_race_states_per_sm(box)
                            if hasattr(other, "dfs_race_states_per_sm") else None)}
        rec = out[name] = {
            "states": len(states), "t_star": _race_t_star(tmeta),
            "other_ms": med["other"], "this_ms": med["this"],
            "turn_means_ms": [statistics.fmean(t) for t in turns],
            "kernel_ms": prof, "bound_ms": bound, "bound_by": by,
            "bound_share": {k: bound / v for k, v in med.items()},
            "us_per_sweep_slowest": {k: med[k] * 1e3 / max(slowest[k], 1) for k in med},
            "sweeps_slowest": slowest, "states_per_sm": per_sm,
            "stack_in_slab": {"this": cs.race_stack_in_slab(this, box),
                              "other": other_slab[box]},
        }
        smoke.log(
            f"race {name} ({len(states)} states, t* {rec['t_star']}): median other "
            f"{med['other']:.4f}, this {med['this']:.4f} ms (CUDA events, {2 * reps} "
            f"races each; turn means "
            + ", ".join(f"{x:.4f}" for x in rec["turn_means_ms"])
            + f"); bound {bound:.5f} ms by {by} (other {bound / med['other']:.2%}, this "
            f"{bound / med['this']:.2%}); us per sweep of the slowest state: other "
            f"{rec['us_per_sweep_slowest']['other']:.3f}, this "
            f"{rec['us_per_sweep_slowest']['this']:.3f}; states per SM {per_sm}; "
            f"profiler, ms a record: other "
            + ", ".join(f"{k} {v:.4f}" for k, v in prof["other"].items()
                        if k in other_kernels)
            + "; this " + f"{prof['this']['dfs_race_kernel']:.4f}"
        )
    return out


ARMS = ("k1", "k3", "race")


def main(argv) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(
        description="Time another build of the DFS kernels against this one.")
    parser.add_argument("other", help="the other dfs_solver.cu, inside the checkout")
    parser.add_argument("--arms", default=",".join(ARMS),
                        help="comma-separated arms to run (default %(default)s)")
    args = parser.parse_args(argv)
    arms = args.arms.split(",")
    if not set(arms) <= set(ARMS):
        parser.error(f"--arms takes {', '.join(ARMS)}")
    if not torch.cuda.is_available():
        print("dfs_solver_ab: no CUDA device is available", file=sys.stderr)
        return 2
    source = Path(args.other).resolve()
    if not source.is_relative_to(ROOT):
        print(f"dfs_solver_ab: {source} lies outside {ROOT}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from sudoku_solver_distributed_tpu_torch.ops import cuda_solver as cs

    this = cs.load_library()
    other, other_log = build_other(cs, source)
    ptxas = {
        "this": smoke.ptxas_report(cs.build_log(), "ptxas this"),
        "other": smoke.ptxas_report(other_log.read_text(), "ptxas other"),
    }
    occupancy = {"this": cs.segment_warps_per_sm(9)}
    smoke.log(f"dfs_segment_kernel 9x9 resident warps per SM (this build): "
              f"{occupancy['this']}")
    result = {}
    if "k1" in arms:
        result["widths"] = dfs_widths(cs, this, other, smoke)
    if "k3" in arms:
        result["segments"] = segment_cases(cs, this, other, smoke)
    if "race" in arms:
        result["races"] = race_sets(cs, this, other, other_log.read_text(), smoke)
    card = smoke.card_name_and_power_limit()
    smoke.log(card)
    print(json.dumps({"other": str(source.relative_to(ROOT)), "card": card,
                      "ptxas": ptxas, "segment_warps_per_sm": occupancy,
                      **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
