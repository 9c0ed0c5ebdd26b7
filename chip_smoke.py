"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. Build the DFS kernel library from sudoku_solver_distributed_tpu_torch/csrc/.
2. Hold the kernel (ops/cuda_solver.solve_batch_cuda) against its plain
   PyTorch version (ops/solver.solve_batch), both on CUDA tensors, on the
   committed corpora and on degenerate boards: grid, status, guesses and
   validations must be equal per board, and every SOLVED grid must pass the
   host oracle and keep its clues.
3. Engine: SolverEngine over the (1, 8, 64, 512, 4096) buckets, warmed,
   solves the 4096-board hard corpus; prints boards/s.
4. The main path: a node and its HTTP server built by the CLI's
   construction function answer POST /solve (README puzzle + corpus
   boards, an unsolvable board, a malformed body), GET /stats, GET
   /network and an unknown path. The kernel's launch counter is set to 0
   just before and must have grown just after.
5. Timing with CUDA events after warm-up: the kernel and the plain version
   on the 4096-board corpus at the main path's first depth stage.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``. Exits non-zero without a
result when no CUDA device is available. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))

README_PUZZLE = [
    [0, 0, 0, 1, 0, 0, 0, 0, 0],
    [0, 0, 0, 3, 2, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 9, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 7, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, 0, 9, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 9, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 3],
    [0, 0, 0, 0, 0, 0, 0, 0, 0],
]

# H100 SXM rates: HBM3 at 3.35 TB/s (NVIDIA data sheet); int32 ALU rate
# = 132 SMs × 64 INT32 lanes × 1.98 GHz boost (Hopper white paper).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# Integer operations per cell per solver step, counted from the three cell
# sweeps of csrc/dfs_solver.cu along the cheapest path a cell takes (a
# filled cell: load, zero and range compares, shift, box index, three
# once/twice unit updates = 21 in the value-mask sweep, then load + compare
# in each of the other two sweeps); an empty cell costs about twice that,
# so this floor keeps bound_ms a lower bound. Loop and address arithmetic
# are not counted.
OPS_PER_CELL_STEP = 25


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def load_corpus(name: str):
    import numpy as np

    with np.load(os.path.join(ROOT, "benchmarks", name)) as d:
        return d["boards"].astype(np.int32)


def degenerate_boards():
    """Clue conflict, empty board (overflows the 32-frame stage), an
    out-of-range value, all 5s, and a solved board with one hole."""
    import numpy as np

    from sudoku_solver_distributed_tpu_torch.models import oracle_solve

    out = np.zeros((5, 9, 9), np.int32)
    out[0, 0, 0] = out[0, 0, 1] = 4
    out[2] = load_corpus("corpus_9x9_hard_4096.npz")[0]
    out[2, 4, 4] = 36
    out[3, :, :] = 5
    solved = np.asarray(oracle_solve(README_PUZZLE), np.int32)
    solved[3, 3] = 0
    out[4] = solved
    return out


def phase_parity(cs, ts, spec_for_size, SERVING_CONFIG, oracle_ok):
    import numpy as np
    import torch

    cases = [
        ("9x9 hard 4096", load_corpus("corpus_9x9_hard_4096.npz"), 9, True),
        ("9x9 deep 128", load_corpus("corpus_9x9_deep_128.npz"), 9, True),
        ("16x16 hard 256", load_corpus("corpus_16x16_hard_2048.npz")[:256], 16, True),
        ("25x25 hard 4", load_corpus("corpus_25x25_hard_512.npz")[:4], 25, True),
        ("9x9 degenerate", degenerate_boards(), 9, False),
    ]
    mismatches = 0
    max_abs_err = 0
    before = cs.dfs_solver.launches
    for name, boards, size, solvable in cases:
        spec = spec_for_size(size)
        cfg = SERVING_CONFIG[size]
        depth = (32, 81) if size == 9 else cfg["max_depth"]
        iters = 4096 if size == 9 else cfg["max_iters"]
        g = torch.as_tensor(boards, device="cuda")
        t0 = time.perf_counter()
        k = cs.solve_batch_cuda(g, spec, max_depth=depth, max_iters=iters)
        torch.cuda.synchronize()
        tk = time.perf_counter() - t0
        t0 = time.perf_counter()
        p = ts.solve_batch(g, spec, max_depth=depth, max_iters=iters)
        torch.cuda.synchronize()
        tp = time.perf_counter() - t0
        B = boards.shape[0]
        bad = torch.zeros(B, dtype=torch.bool, device="cuda")
        for f in ("grid", "status", "guesses", "validations"):
            a, b = getattr(k, f), getattr(p, f)
            bad |= (a != b).reshape(B, -1).any(dim=1)
            max_abs_err = max(
                max_abs_err, int((a.long() - b.long()).abs().max())
            )
        n_bad = int(bad.sum())
        mismatches += n_bad
        status = k.status.cpu().numpy()
        grids = k.grid.cpu().numpy()
        for i in np.flatnonzero(status == ts.SOLVED):
            clues = boards[i] != 0
            check(
                oracle_ok(grids[i].tolist())
                and (grids[i][clues] == boards[i][clues]).all(),
                f"{name}: board {i} SOLVED with an invalid grid",
            )
        if solvable:
            check(
                (status == ts.SOLVED).all(),
                f"{name}: statuses {np.bincount(status, minlength=4)}",
            )
        log(
            f"parity {name}: {n_bad} mismatching boards, kernel iters "
            f"{int(k.iters)} plain iters {p.iters}, statuses "
            f"{np.bincount(status, minlength=4).tolist()}, kernel "
            f"{tk * 1e3:.1f} ms, plain {tp * 1e3:.1f} ms (host clock)"
        )
        check(n_bad == 0, f"{name}: kernel and plain version disagree")
    check(cs.dfs_solver.launches > before, "parity phase launched no kernel")
    return mismatches, max_abs_err


def phase_engine(SolverEngine, oracle_ok):
    import numpy as np

    boards = load_corpus("corpus_9x9_hard_4096.npz")
    eng = SolverEngine(buckets=(1, 8, 64, 512, 4096))
    t0 = time.perf_counter()
    eng.warmup()
    log(f"engine warmup {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    sol, mask, info = eng.solve_batch_np(boards)
    dt = time.perf_counter() - t0
    check(mask.all(), f"engine left {int((~mask).sum())} boards unsolved")
    for i in range(0, len(boards), 97):
        check(oracle_ok(sol[i].tolist()), f"engine board {i} invalid")
    log(
        f"engine solve_batch_np 4096 hard boards: {dt * 1e3:.1f} ms, "
        f"{len(boards) / dt:.0f} boards/s (host clock, one call), "
        f"validations {info['validations']}, guesses {info['guesses']}"
    )


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(base: str, path: str, body=None):
    req = urllib.request.Request(
        base + path,
        data=body,
        headers={"Content-Type": "application/json"} if body is not None else {},
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def phase_solve_http(cs, build_parser, build_node, oracle_ok):
    """The main path: returns the kernel launches it made and the launches
    of the README /solve alone."""
    import numpy as np

    http_port, udp_port = _free_port(), _free_port()
    args = build_parser().parse_args(
        ["-p", str(http_port), "-s", str(udp_port), "-h", "1"]
    )
    node, httpd = build_node(args)
    threads = [
        threading.Thread(target=httpd.serve_forever, daemon=True),
        threading.Thread(target=node.run, daemon=True),
    ]
    for t in threads:
        t.start()
    base = f"http://127.0.0.1:{http_port}"
    try:
        cs.dfs_solver.launches = 0
        boards = [README_PUZZLE] + [
            b.tolist() for b in load_corpus("corpus_9x9_hard_4096.npz")[:4]
        ]
        per_solve = []
        for board in boards:
            n0 = cs.dfs_solver.launches
            status, body = _http(base, "/solve", json.dumps({"sudoku": board}).encode())
            per_solve.append(cs.dfs_solver.launches - n0)
            check(status == 200, f"/solve answered {status}: {body[:200]!r}")
            sol = json.loads(body)
            clues = np.asarray(board) != 0
            check(
                oracle_ok(sol) and (np.asarray(sol)[clues] == np.asarray(board)[clues]).all(),
                "/solve answer is not a solution of its board",
            )
        bad = [[0] * 9 for _ in range(9)]
        bad[0][0] = bad[0][1] = 5
        status, body = _http(base, "/solve", json.dumps({"sudoku": bad}).encode())
        check(
            status == 400
            and json.loads(body) == {"error": "No solution found", "solution": None},
            f"unsolvable /solve answered {status} {body!r}",
        )
        status, body = _http(base, "/solve", b"{not json")
        check(status == 400, f"malformed /solve answered {status}")
        status, body = _http(base, "/stats")
        stats = json.loads(body)
        check(
            status == 200 and stats["all"]["solved"] >= 5,
            f"/stats answered {status} {body!r}",
        )
        status, body = _http(base, "/network")
        check(
            status == 200 and json.loads(body) == {node.id: []},
            f"/network answered {status} {body!r}",
        )
        status, body = _http(base, "/nope")
        check(
            status == 404 and json.loads(body) == {"error": "Invalid endpoint"},
            f"GET /nope answered {status} {body!r}",
        )
        # end-to-end latency of the README /solve (host clock, warm node)
        body = json.dumps({"sudoku": README_PUZZLE}).encode()
        lat_ms = []
        for _ in range(20):
            t0 = time.perf_counter()
            status, _ = _http(base, "/solve", body)
            lat_ms.append((time.perf_counter() - t0) * 1e3)
            check(status == 200, f"/solve answered {status}")
        lat_ms.sort()
        log(
            f"/solve README puzzle x20 (host clock, HTTP/1.0 on localhost): "
            f"p50 {lat_ms[10]:.3f} ms, min {lat_ms[0]:.3f} ms, "
            f"max {lat_ms[-1]:.3f} ms"
        )
        launches = cs.dfs_solver.launches
    finally:
        node.shutdown()
        httpd.shutdown()
        httpd.server_close()
        for t in threads:
            t.join(timeout=10)
    check(launches > 0, "the /solve main path launched no kernel")
    log(f"/solve main path: {launches} kernel launches, per /solve {per_solve}")
    return launches, per_solve[0]


def _cuda_ms(fn, reps: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_timing(cs, spec_for_size):
    """Kernel vs plain on the 4096-board corpus at the main path's first
    depth stage (32 frames, 4096 steps)."""
    import torch

    spec = spec_for_size(9)
    boards = load_corpus("corpus_9x9_hard_4096.npz")
    B = boards.shape[0]
    flat = torch.as_tensor(boards.reshape(B, -1), device="cuda").contiguous()
    n0 = cs.dfs_solver.launches
    grid, meta = cs.dfs_solver(flat, spec, 32, 4096)  # warm-up
    torch.cuda.synchronize()
    kernel_ms = _cuda_ms(lambda: cs.dfs_solver(flat, spec, 32, 4096), 10)
    plain_ms = _cuda_ms(lambda: cs._dfs_solver_plain(flat, spec, 32, 4096), 1)
    # the README /solve's two device stages alone (bucket 1: one board)
    readme = torch.tensor(README_PUZZLE, dtype=torch.int32, device="cuda").reshape(1, -1)
    readme_ms = [
        _cuda_ms(lambda d=d: cs.dfs_solver(readme, spec, d, 4096), 10)
        for d in (32, 81)
    ]
    cs.dfs_solver.launches = n0  # timing launches are not main-path launches
    validations = int(meta[:, 2].sum())
    bytes_moved = flat.numel() * 4 + grid.numel() * 4 + meta.numel() * 4
    ops = validations * spec.cells * OPS_PER_CELL_STEP
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(
        f"timing 4096 hard boards, depth 32: kernel {kernel_ms:.3f} ms "
        f"(CUDA events, mean of 10), plain {plain_ms:.1f} ms (1 run); "
        f"validations {validations}, bytes {bytes_moved} -> {bytes_ms:.5f} "
        f"ms, int32 ops {ops} -> {ops_ms:.5f} ms"
    )
    log(
        f"timing README board alone: depth-32 stage {readme_ms[0]:.3f} ms, "
        f"depth-81 stage {readme_ms[1]:.3f} ms (CUDA events, mean of 10)"
    )
    return {
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "validations": validations,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
    from sudoku_solver_distributed_tpu_torch.models import oracle_is_valid_solution
    from sudoku_solver_distributed_tpu_torch.net.cli import build_node, build_parser
    from sudoku_solver_distributed_tpu_torch.ops import cuda_solver as cs
    from sudoku_solver_distributed_tpu_torch.ops import solver as ts
    from sudoku_solver_distributed_tpu_torch.ops.config import SERVING_CONFIG
    from sudoku_solver_distributed_tpu_torch.ops.spec import spec_for_size

    t_start = time.perf_counter()
    log(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
    )
    t0 = time.perf_counter()
    cs.load_library()
    log(f"build: dfs_solver library built and loaded in {time.perf_counter() - t0:.2f} s")
    for line in cs.build().with_suffix(".log").read_text().splitlines():
        if "registers" in line or "stack frame" in line:
            log(line.strip())

    mismatches, max_abs_err = phase_parity(
        cs, ts, spec_for_size, SERVING_CONFIG, oracle_is_valid_solution
    )
    phase_engine(SolverEngine, oracle_is_valid_solution)
    launches, per_readme = phase_solve_http(
        cs, build_parser, build_node, oracle_is_valid_solution
    )
    timing = phase_timing(cs, spec_for_size)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    kernel = {
        "name": "dfs_solver",
        "route": "cuda",
        "source": "sudoku_solver_distributed_tpu_torch/csrc/dfs_solver.cu",
        "replaces": "sudoku_solver_distributed_tpu/ops/pallas_solver.py:98",
        "launches": launches,
        "launches_per_readme_solve": per_readme,
        "mismatches": mismatches,
        "max_abs_err": max_abs_err,
        "ms": timing["ms"],
        "kernel_ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
    }
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
