"""How often torch.profiler loses kernel records at the edges of its
capture window, three ways: the window opened straight before the counted
calls ("plain"); opened with one uncounted warm-up step of a profiler
schedule ("sched"); and opened with a 5 ms device sleep queued before the
counted calls ("sleep"), as ``chip_smoke._profiled_kernel_ms`` does. For
9x9 segment pools of 4096, 512 and 8 lanes (every lane injected, the
serving sweeps, k = 8) it opens 40 windows of 20 segments (K3 + K3b) each
way, and prints the windows whose K3 / K3b record counts are not 20 / 20.

    python3 tools/profiler_edge.py      # needs a CUDA device; ~45 s
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WINDOWS, REPS = 40, 20


def counts(prof, kernels):
    n = dict.fromkeys(kernels, 0)
    for e in prof.key_averages():
        for k in kernels:
            if k in e.key:
                n[k] += e.count
    return tuple(n.values())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profiler_edge: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile, schedule

    import chip_smoke as smoke
    from sudoku_solver_distributed_tpu_torch.ops import cuda_solver as cs
    from sudoku_solver_distributed_tpu_torch.ops import solver as ts
    from sudoku_solver_distributed_tpu_torch.ops.config import (
        segment_prefix_gather,
        serving_config,
    )
    from sudoku_solver_distributed_tpu_torch.ops.spec import spec_for_size

    kernels = smoke.SEGMENT_KERNELS

    def plain(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        return counts(prof, kernels)

    def sched(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=REPS, repeat=1)) as prof:
            for i in range(REPS + 1):
                fn()
                if i == REPS:
                    torch.cuda.synchronize()
                prof.step()
        return counts(prof, kernels)

    def sleep(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(int(5e-3 * smoke.SM_CLOCK_HZ))
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        return counts(prof, kernels)

    spec = spec_for_size(9)
    sweeps = smoke.sweeps_of(serving_config(9))
    depth = smoke.flat_depth(ts, spec, serving_config)
    hard = torch.as_tensor(
        smoke.load_corpus("corpus_9x9_hard_4096.npz").reshape(4096, -1), device="cuda")
    res = {}
    for W in (4096, 512, 8):
        src = smoke.segment_case_src(W, None)
        prefix = segment_prefix_gather(W, spec.cells)
        handle = [cs.SegmentPool.fresh(ts.pad_board(spec, "cuda").expand(W, 9, 9),
                                       spec, depth)]

        def seg():
            handle[0], _, _ = cs.dfs_segment(handle[0], hard, src, 8,
                                             prefix_gather=prefix, **sweeps)

        seg()
        for name, way in (("plain", plain), ("sched", sched), ("sleep", sleep)):
            lost = [got for got in (way(seg) for _ in range(WINDOWS))
                    if got != (REPS, REPS)]
            res[f"{W} {name}"] = lost
            print(W, name, "windows with other record counts:", len(lost), lost[:10],
                  flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
