"""Time the README /solve of two checkouts of this repository in turns.

    python3 tools/serving_ab.py OTHER_TREE [ROUNDS]

OTHER_TREE is another checkout (e.g. the parent commit unpacked with
``git archive`` into ``_archive/parent``, a gitignored directory). For each
tree, in the order other, this, this, other (ROUNDS times, default 1), a
fresh process builds the tree's kernels and, on its node built by the
tree's CLI, reads the p50 of 40 README /solve requests (host clock,
HTTP/1.0 on localhost, after 5 unrecorded) and of 40 ``engine.solve_one``
calls, for each arm the tree has: the coalescer's closed loop (the default
before continuous batching, ``--no-continuous`` since), ``--no-coalesce``,
and continuous batching (the default where the tree has it); every arm
runs with ``--no-answer-cache`` where the tree has the answer cache, so
each repeated README request reaches the kernels. It also
reads the p50 of 300 calls of ``ops.cuda_solver.solve_batch_cuda`` on the
README board and of one ``dfs_solver`` launch plus a synchronize, width 1,
the engine's sweeps. Needs a CUDA device; prints the card's name and
power limit first and one JSON line per run.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r'''
import json, socket, statistics, sys, threading, time, urllib.request
sys.path.insert(0, ".")
import numpy as np, torch
from sudoku_solver_distributed_tpu_torch.net.cli import build_node, build_parser
from sudoku_solver_distributed_tpu_torch.ops import cuda_solver as cs
from sudoku_solver_distributed_tpu_torch.ops.spec import spec_for_size

R = [[0,0,0,1,0,0,0,0,0],[0,0,0,3,2,0,0,0,0],[0,0,0,0,0,9,0,0,0],
     [0,0,0,0,0,0,0,7,0],[0,0,0,0,0,0,0,0,0],[0,0,0,9,0,0,0,0,0],
     [0,0,0,0,0,0,9,0,0],[0,0,0,0,0,0,0,0,3],[0,0,0,0,0,0,0,0,0]]


def p50(fn, n, warm=5):
    for _ in range(warm):
        fn()
    t = []
    for _ in range(n):
        a = time.perf_counter()
        fn()
        t.append((time.perf_counter() - a) * 1e3)
    return statistics.median(t)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


flags = build_parser().format_help()
continuous = "--no-continuous" in flags
nocache = ["--no-answer-cache"] if "--no-answer-cache" in flags else []
arms = [("closed loop", (["--no-continuous"] if continuous else []) + nocache),
        ("no-coalesce", ["--no-coalesce"] + nocache)]
if continuous:
    arms.append(("continuous", nocache))
out = {}
body = json.dumps({"sudoku": R}).encode()
for label, argv in arms:
    port = free_port()
    node, httpd = build_node(build_parser().parse_args(
        ["-p", str(port), "-s", str(free_port()), "-h", "1", *argv]))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    # a tree whose CLI warms in the background: measure a fully warm node
    while not getattr(node.engine, "fully_warmed", True):
        time.sleep(0.01)
    req = lambda: urllib.request.urlopen(urllib.request.Request(
        f"http://127.0.0.1:{port}/solve", data=body,
        headers={"Content-Type": "application/json"})).read()
    out[label] = {"http_p50_ms": p50(req, 40),
                  "engine_p50_ms": p50(lambda: node.engine.solve_one(R), 40)}
    httpd.shutdown()
    httpd.server_close()
    node.shutdown()
    node.engine.close()
spec = spec_for_size(9)
g = torch.as_tensor(np.asarray(R, np.int32)[None], device="cuda")
flat = g.reshape(1, 81).contiguous()
sw = dict(locked_candidates=True, waves=1, naked_pairs=False)


def batch():
    cs.solve_batch_cuda(g, spec, max_depth=(32, 81), **sw)
    torch.cuda.synchronize()


def launch():
    cs.dfs_solver(flat, spec, 32, 4096, **sw)
    torch.cuda.synchronize()


out["solve_batch_cuda_p50_ms"] = p50(batch, 300, 20)
out["dfs_solver_sync_p50_ms"] = p50(launch, 300, 20)
print("RESULT " + json.dumps(out), flush=True)
'''


def main(argv) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(argv[1])
    rounds = int(argv[2]) if len(argv) > 2 else 1
    import torch

    if not torch.cuda.is_available():
        print("serving_ab: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    trees = {"other": other, "this": ROOT}
    for _ in range(rounds):
        for name in ("other", "this", "this", "other"):
            r = subprocess.run([sys.executable, "-c", CHILD], cwd=trees[name],
                               capture_output=True, text=True, timeout=900)
            res = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
            if not res:
                print(f"{name} failed:\n{r.stderr[-3000:]}", file=sys.stderr)
                return 1
            print(json.dumps({"tree": name, **json.loads(res[0][7:])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
