"""Time another build of the DFS kernels against this checkout's, on one GPU.

    python3 tools/dfs_solver_ab.py OTHER_dfs_solver.cu [--arms k1,k3,race,shards,seed]

OTHER is a source of the same C interface (``dfs_solver_launch``,
``dfs_segment_launch`` and ``dfs_race_launch`` with the same arguments,
sweep count and option bits included, ``dfs_solver_meta_cols`` and
``dfs_segment_digest_cols``) inside this checkout: for example a commit's
``csrc/dfs_solver.cu`` unpacked with ``git archive`` into a gitignored
directory such as ``_archive/``, or a copy of this one with one constant
changed. Both sources are built with ``cuda_solver.NVCC_FLAGS``, and
``ptxas -v``'s registers and stack are printed for each. ``--arms`` picks
the arms (default all five).

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

K4's shard form (arm ``shards``, a build that has ``dfs_race_shards_launch``): the race across 4
virtual shards of cuda:0 without a relay, one launch whose last block
folds (``cuda_solver._launch_race_shards`` with either library, over one
set of stop words), on the same sets padded for 4 shards: the two builds
must return the same row and fold; then in turns, each race alone behind
a device spin (``chip_smoke._event_ms``).

The seeding kernel (K5, arm ``seed``, a build that has
``seed_frontier_launch``), through ``cuda_solver._seed_launch`` with
either library, on phase 11 (e)'s timed sets (``seed_timing_sets``): deep
9x9 boards 0-15 at 64 states, locked and unlocked, the README at 512, deep
board 0 at 512 (solved in seeding), the two 16x16 boards of phase 11 at 64
and the first at 1024, the 25x25 board at 8, the 4x4 one-clue board at 8.
The two builds must seed the
same states, header and solution (a build from before the solution row
followed the header is read at its solved state's row); then each
build's seedings are timed one by one with CUDA events in turns (other,
this, this, other; the median of each build), with microseconds a round.
Then deep board 0 at 64 is timed the same way while a K3 segment over 4096
hard boards (512 steps) runs on another stream, a fresh segment a seeding:
a cluster launch beside a card full of K3's warps. Last, with this build,
the wrapper's one device-to-host copy (header and solution row) against a
header copy followed by the row's own copy, by host clock.

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
    if hasattr(lib, "seed_frontier_launch"):  # a build with the seeding kernel
        lib.seed_frontier_launch.argtypes = this.seed_frontier_launch.argtypes
        lib.seed_frontier_launch.restype = ctypes.c_int
        # a build of one block a seeding launches on any card
        lib.seed_clusters = ({box: 1 for box in cs.SEED_BOXES}
                             if not hasattr(lib, "seed_frontier_clusters") else
                             {box: lib.seed_frontier_clusters(box) for box in cs.SEED_BOXES})
    if hasattr(lib, "dfs_race_shards_launch"):  # a build with the shard form
        # a build before the relay across hosts takes the first 21 arguments:
        # the three trailing ones (null, null, 0 without a relay) lie past
        # them, which the C calling convention lets it ignore
        lib.dfs_race_shards_launch.argtypes = this.dfs_race_shards_launch.argtypes
        lib.dfs_race_shards_launch.restype = ctypes.c_int
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


def race_sets(cs, this, other, smoke) -> dict:
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
    # a build of the warp-a-state design (from before the library said
    # where its stack lives) folds in a kernel of its own after K4
    other_kernels = ("dfs_race_kernel",) if hasattr(other, "dfs_race_stack_on_chip") \
        else ("dfs_race_kernel", "race_fold_kernel")
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


def shard_sets(cs, this, other, smoke) -> dict:
    """K4's shard form without a relay (the race across 4 virtual shards of
    cuda:0, the one-card layout: one launch, its last block folding) on
    each set of ``chip_smoke.race_timing_sets``: outputs equal, then the
    two builds in turns, race by race, over one set of stop words."""
    import statistics

    import torch

    from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
    from sudoku_solver_distributed_tpu_torch.ops.config import serving_config
    from sudoku_solver_distributed_tpu_torch.ops.spec import spec_for_size
    from sudoku_solver_distributed_tpu_torch.parallel import frontier as F

    config = smoke.node_config(SolverEngine, spec_for_size, serving_config)
    sets = smoke.race_timing_sets(
        smoke.frontier_race_sets(F, spec_for_size, smoke.SYMMETRY_SEED))
    mesh = smoke._mesh()
    streams = list(mesh.streams)
    slots = F.mesh_race_slots(mesh)
    out = {}
    for name, _, spec, states, max_iters, _ in sets:
        sweeps = smoke.sweeps_of(config(spec.size))
        knobs = cs.sweep_knobs(spec, **sweeps)
        waves, options = knobs["waves"], cs._options(knobs)
        states = F.bucket_states(states, spec, len(states) // smoke.MESH_SHARDS,
                                 smoke.MESH_SHARDS).numpy()
        flat = torch.as_tensor(states.reshape(len(states), -1), device="cuda").contiguous()
        per = len(flat) // smoke.MESH_SHARDS
        parts = [flat[i * per:(i + 1) * per].contiguous() for i in range(smoke.MESH_SHARDS)]

        def race(lib):
            cur = torch.cuda.current_stream()
            for st in streams:
                st.wait_stream(cur)
            with slots.lock:
                out = cs._launch_race_shards(lib, parts, spec, spec.max_depth, max_iters,
                                             waves, options, slots, streams, True)
            cur.wait_stream(streams[0])
            return out

        (trow, tfold, _), (orow, ofold, _) = race(this), race(other)
        torch.cuda.synchronize()
        smoke.check(torch.equal(trow, orow) and torch.equal(tfold, ofold),
                    f"shard race set {name}: the two builds disagree")
        reps = 20 if spec.size < 25 else 10
        # each race alone behind a device spin (chip_smoke._event_ms): a race
        # across shards joins streams and takes a lock on the host, so races
        # enqueued back to back would time the host's enqueue
        turns = [smoke._event_ms(lambda lib=lib: race(lib), reps)
                 for lib in (other, this, this, other)]
        med = {"other": statistics.median(turns[0] + turns[3]),
               "this": statistics.median(turns[1] + turns[2])}
        out[name] = {"states": len(states), "other_ms": med["other"], "this_ms": med["this"],
                     "turn_means_ms": [statistics.fmean(t) for t in turns]}
        smoke.log(f"shard race {name} ({len(states)} states, {smoke.MESH_SHARDS} virtual "
                  f"shards, one launch): median other {med['other']:.4f}, this "
                  f"{med['this']:.4f} ms (CUDA events, {2 * reps} races each; turn means "
                  + ", ".join(f"{x:.4f}" for x in out[name]["turn_means_ms"]) + ")")
    return out


def seed_timing_sets(smoke, F, spec_for_size) -> list:
    """(name, states, spec, target, locked) of the seed arm: phase 11 (e)'s
    timed seedings (``chip_smoke.seeding_sets`` names them alike)."""
    import numpy as np

    spec9 = spec_for_size(9)
    deep9 = smoke.load_corpus("corpus_9x9_deep_128.npz")
    out = [(f"9x9 deep #{k} @64{'' if locked else ' unlocked'}", deep9[k][None], spec9, 64,
            locked) for locked in (True, False) for k in range(smoke.SEED_DEEP_BOARDS)]
    readme = np.asarray(smoke.README_PUZZLE, np.int32)
    out += [("README @512", readme[None], spec9, 512, True),
            ("9x9 deep #0 @512", deep9[0][None], spec9, 512, True)]
    race = smoke.frontier_race_sets(F, spec_for_size, smoke.SYMMETRY_SEED)
    for name, board, spec, _, _, target in race:
        if spec.size in (4, 16, 25):
            out.append((f"{name.split(' @')[0]} @{target}", np.asarray(board)[None], spec,
                        target, True))
    name, board, spec = next((n, b, s) for n, b, s, *_ in race if s.size == 16)
    out.append((f"{name.split(' @')[0]} @1024", np.asarray(board)[None], spec, 1024, True))
    return out


def _seed_result(cs, lib, flat, spec, target, locked):
    """One seeding by ``lib`` through the wrapper's launch step: the seeded
    states, the 5-word header and the solution (None: none solved); a
    build whose header carries no row gives its solved state's row."""
    import torch

    out, header = cs._seed_launch(lib, flat, spec, target, spec.cells + 16, locked)
    torch.cuda.synchronize()
    head = header[:cs.SEED_HEADER_COLS].cpu()
    count, first = int(head[0]), int(head[1])
    row = None
    if first >= 0:
        with_row = hasattr(lib, "seed_frontier_clusters")
        row = (header[cs.SEED_HEADER_COLS:] if with_row else out[first]).cpu()
    return out[:count].cpu(), head, row


def _k3_beside(cs, smoke):
    """A function that starts a K3 segment over 4096 hard boards (512 steps,
    9x9 serving sweeps) on a stream of its own, after the current stream's
    work; the stream is returned so the caller can wait for it."""
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
    hard = torch.as_tensor(smoke.load_corpus("corpus_9x9_hard_4096.npz"), device="cuda")
    keep = torch.full((len(hard),), -1, dtype=torch.int32, device="cuda")
    prefix = segment_prefix_gather(len(hard), spec.cells)
    side = torch.cuda.Stream()
    this = cs.load_library()

    def start():
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            pool = cs.SegmentPool.fresh(hard, spec, 81)
            cs._launch_segment(this, pool, hard.reshape(len(hard), -1), keep, 512, waves,
                               options, prefix)
        return side

    return start


def _seed_reads(cs, lib, smoke, F, spec_for_size) -> dict:
    """The wrapper's device-to-host reads, by host clock with this build:
    ``cuda_solver._launch_seed`` (the header and the solution row in one
    copy) against the launch step followed by a header copy and, when a
    state solved, a copy of its row out of the seeded states (two copies),
    in turns (two, one, one, two; 20 seedings each), on deep board 0 at 64
    (not solved) and at 512 (solved). Medians in ms."""
    import statistics
    import time

    import torch

    out = {}
    for name, states, spec, target, locked in seed_timing_sets(smoke, F, spec_for_size):
        if name not in ("9x9 deep #0 @64", "9x9 deep #0 @512"):
            continue
        flat = torch.as_tensor(states.reshape(1, -1), device="cuda").contiguous()
        rounds = spec.cells + 16

        def one():
            cs._launch_seed(lib, flat, spec, target, rounds, locked)

        def two():
            seeded, header = cs._seed_launch(lib, flat, spec, target, rounds, locked)
            first = int(header[:cs.SEED_HEADER_COLS].cpu()[1])
            if first >= 0:
                seeded[first].cpu()

        times = {"two": [], "one": []}
        for label, fn in (("two", two), ("one", one), ("one", one), ("two", two)):
            for _ in range(20):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                times[label].append((time.perf_counter() - t0) * 1e3)
        out[name] = {k: statistics.median(v) for k, v in times.items()}
        smoke.log(f"seed {name} through the wrapper (host clock, medians of 40): one copy "
                  f"{out[name]['one']:.4f} ms, two copies {out[name]['two']:.4f} ms")
    return out


def seed_sets(cs, this, other, smoke) -> dict:
    """K5 on each seed timing set: the two builds' seedings equal, then in
    turns, seeding by seeding; then deep #0 @64 beside a K3 segment."""
    import statistics

    import torch

    from sudoku_solver_distributed_tpu_torch.ops.spec import spec_for_size
    from sudoku_solver_distributed_tpu_torch.parallel import frontier as F

    count0 = cs.seed_frontier_cuda.launches
    out = {"sets": {}}
    for name, states, spec, target, locked in seed_timing_sets(smoke, F, spec_for_size):
        flat = torch.as_tensor(states.reshape(len(states), -1), device="cuda").contiguous()
        (tstates, thead, trow), (ostates, ohead, orow) = (
            _seed_result(cs, lib, flat, spec, target, locked) for lib in (this, other))
        same = (torch.equal(tstates, ostates) and torch.equal(thead, ohead)
                and (trow is None) == (orow is None)
                and (trow is None or torch.equal(trow, orow)))
        smoke.check(same, f"seed set {name}: the two builds disagree")
        rounds = int(thead[2])

        def seed(lib):
            cs._seed_launch(lib, flat, spec, target, spec.cells + 16, locked)

        reps = 20 if spec.size < 16 else 10
        turns = [_race_times_ms(lambda lib=lib: seed(lib), reps, smoke)
                 for lib in (other, this, this, other)]
        med = {"other": statistics.median(turns[0] + turns[3]),
               "this": statistics.median(turns[1] + turns[2])}
        rec = out["sets"][name] = {
            "rounds": rounds, "analyzed": int(thead[3]), "count": int(thead[0]),
            "outcome": cs.SEED_OUTCOMES[int(thead[4])], "other_ms": med["other"],
            "this_ms": med["this"], "turn_means_ms": [statistics.fmean(t) for t in turns],
            "us_per_round": {k: v * 1e3 / max(rounds, 1) for k, v in med.items()},
        }
        smoke.log(f"seed {name} ({rounds} rounds, {rec['analyzed']} states analyzed, "
                  f"{rec['outcome']}): median other {med['other']:.4f}, this "
                  f"{med['this']:.4f} ms (CUDA events, {2 * reps} seedings each; turn means "
                  + ", ".join(f"{x:.4f}" for x in rec["turn_means_ms"])
                  + f"); us a round: other {rec['us_per_round']['other']:.2f}, this "
                  f"{rec['us_per_round']['this']:.2f}")
    deep = [r for n, r in out["sets"].items() if n.startswith("9x9 deep #") and n.endswith("@64")]
    out["deep64_median"] = {k: statistics.median(r[f"{k}_ms"] for r in deep)
                            for k in ("other", "this")}
    # deep #0 @64 while a K3 segment fills the card from another stream
    name, states, spec, target, locked = seed_timing_sets(smoke, F, spec_for_size)[0]
    flat = torch.as_tensor(states.reshape(1, -1), device="cuda").contiguous()
    start_k3 = _k3_beside(cs, smoke)
    beside = {"other": [], "this": []}
    for label, lib in (("other", other), ("this", this), ("this", this), ("other", other)):
        for _ in range(5):
            side = start_k3()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            # the seeding enqueued behind a spin, off the host's clock
            torch.cuda._sleep(int(200e-6 * smoke.SM_CLOCK_HZ))
            ev[0].record()
            cs._seed_launch(lib, flat, spec, target, spec.cells + 16, locked)
            ev[1].record()
            torch.cuda.synchronize()
            beside[label].append(ev[0].elapsed_time(ev[1]))
            torch.cuda.current_stream().wait_stream(side)
    out["beside_k3"] = {k: statistics.median(v) for k, v in beside.items()}
    smoke.log(f"seed {name} beside a K3 segment (4096 hard boards, 512 steps, another "
              f"stream): median other {out['beside_k3']['other']:.4f}, this "
              f"{out['beside_k3']['this']:.4f} ms (CUDA events, 10 seedings each); alone "
              f"other {out['sets'][name]['other_ms']:.4f}, this "
              f"{out['sets'][name]['this_ms']:.4f}")
    smoke.log(f"seed deep 9x9 #0-15 @64 locked: median other {out['deep64_median']['other']:.4f}, "
              f"this {out['deep64_median']['this']:.4f} ms")
    out["reads"] = _seed_reads(cs, this, smoke, F, spec_for_size)
    cs.seed_frontier_cuda.launches = count0
    return out


ARMS = ("k1", "k3", "race", "shards", "seed")


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
        result["races"] = race_sets(cs, this, other, smoke)
    if "shards" in arms:
        if not hasattr(other, "dfs_race_shards_launch"):
            parser.error("--arms shards takes a build with dfs_race_shards_launch")
        result["shard_races"] = shard_sets(cs, this, other, smoke)
    if "seed" in arms:
        if not hasattr(other, "seed_frontier_launch"):
            parser.error("--arms seed takes a build with seed_frontier_launch")
        result["seeds"] = seed_sets(cs, this, other, smoke)
    card = smoke.card_name_and_power_limit()
    smoke.log(card)
    print(json.dumps({"other": str(source.relative_to(ROOT)), "card": card,
                      "ptxas": ptxas, "segment_warps_per_sm": occupancy,
                      **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
