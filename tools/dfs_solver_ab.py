"""Time another build of the DFS kernels against this checkout's, on one GPU.

    python3 tools/dfs_solver_ab.py OTHER_dfs_solver.cu

OTHER is a source of the same C interface (``dfs_solver_launch`` and
``dfs_segment_launch`` with the same arguments, sweep count and option bits
included, ``dfs_solver_meta_cols`` and ``dfs_segment_digest_cols``) inside
this checkout: for example a commit's ``csrc/dfs_solver.cu`` unpacked with
``git archive`` into a gitignored directory such as ``_archive/``. Both
sources are built with ``cuda_solver.NVCC_FLAGS``, and ``ptxas -v``'s
registers and stack are printed for each.

The DFS kernel (K1): at every width of ``chip_smoke.timing_widths`` the two
builds must return the same grid and meta (singles configuration: one
sweep a step, no option bits); then each is timed with CUDA events in
turns: other, this, this, other.

The segment kernels (K3 and its digest kernel K3b), in the 9x9 serving
configuration: at every case of ``chip_smoke.segment_timing_cases`` (pools
of 8, 64, 512 and 4096 lanes all injected, and 4096 with 1 and with 16 live
lanes) the two builds must leave the same pool state, digest and solution
block after one k = 8 segment; then one segment at k = 8 and at k = 0 is
timed with CUDA events in turns (other, this, this, other), and K3 and K3b
each on its own from torch.profiler's CUDA kernel records over as many
segments, for each build.

Prints one line per width and case, the card's name and power limit, and
last one JSON object with the times. Exits non-zero without a result when
no CUDA device is available.
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
    for fn in ("dfs_solver_launch", "dfs_segment_launch"):
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


def main(argv) -> int:
    import torch

    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("dfs_solver_ab: no CUDA device is available", file=sys.stderr)
        return 2
    source = Path(argv[0]).resolve()
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
    widths = dfs_widths(cs, this, other, smoke)
    segments = segment_cases(cs, this, other, smoke)
    card = smoke.card_name_and_power_limit()
    smoke.log(card)
    print(json.dumps({"other": str(source.relative_to(ROOT)), "card": card,
                      "ptxas": ptxas, "segment_warps_per_sm": occupancy,
                      "widths": widths, "segments": segments}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
