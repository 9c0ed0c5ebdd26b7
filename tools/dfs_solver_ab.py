"""Time another build of the DFS kernel against this checkout's, on one GPU.

    python3 tools/dfs_solver_ab.py OTHER_dfs_solver.cu

OTHER is a source of the same C interface (``dfs_solver_launch`` with the
same arguments, sweep count and option bits included, and
``dfs_solver_meta_cols``) inside this checkout: for example a commit's
``csrc/dfs_solver.cu`` unpacked with ``git archive`` into a gitignored
directory such as ``_archive/``. Both sources are built with
``cuda_solver.NVCC_FLAGS``, and ``ptxas -v``'s registers and stack are
printed for each. At every width of ``chip_smoke.timing_widths`` the two
builds must return the same grid and meta (singles configuration: one
sweep a step, no option bits); then each is timed with CUDA
events in turns: other, this, this, other. Prints one line per width, the
card's name and power limit, and last one JSON object with the times.
Exits non-zero without a result when no CUDA device is available.
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
    lib.dfs_solver_launch.argtypes = cs.load_library().dfs_solver_launch.argtypes
    if lib.dfs_solver_meta_cols() != cs.META_COLS:
        raise RuntimeError(f"{source} disagrees on the meta layout")
    return lib, build_log


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
    from chip_smoke import (
        _cuda_ms, card_name_and_power_limit, check, log, ptxas_report,
        timing_widths,
    )
    from sudoku_solver_distributed_tpu_torch.ops import cuda_solver as cs
    from sudoku_solver_distributed_tpu_torch.ops.spec import spec_for_size

    this = cs.load_library()
    other, other_log = build_other(cs, source)
    ptxas = {
        "this": ptxas_report(cs.build().with_suffix(".log"), "ptxas this"),
        "other": ptxas_report(other_log, "ptxas other"),
    }
    spec = spec_for_size(9)
    widths = {}
    for name, boards, depth in timing_widths():
        flat = torch.as_tensor(boards.reshape(len(boards), -1), device="cuda").contiguous()
        reps = 50 if len(boards) < 512 else 10

        def launch(lib):
            return cs._launch(lib, flat, spec, depth, 4096)

        grid, meta = launch(this)
        ogrid, ometa = launch(other)
        check(torch.equal(grid, ogrid) and torch.equal(meta, ometa),
              f"width {name}: the two builds disagree")
        turns = [_cuda_ms(lambda lib=lib: launch(lib), reps)
                 for lib in (other, this, this, other)]
        widths[name] = {"other_ms": (turns[0] + turns[3]) / 2,
                        "this_ms": (turns[1] + turns[2]) / 2, "turns_ms": turns}
        log(
            f"width {name} (depth {depth}): other {turns[0]:.4f}, this "
            f"{turns[1]:.4f}, this {turns[2]:.4f}, other {turns[3]:.4f} ms "
            f"(CUDA events, mean of {reps} each); slowest board "
            f"{int(meta[:, 3].max())} steps"
        )
    card = card_name_and_power_limit()
    log(card)
    print(json.dumps({"other": str(source.relative_to(ROOT)), "card": card,
                      "ptxas": ptxas, "widths": widths}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
