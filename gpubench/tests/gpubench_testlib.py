"""Shared pieces of the benchmark's own tests (run on the CPU; the test
that needs a card decides inside itself and skips without one).

``tiny_catalog`` is a copy of the benchmark's folder beside a copy of
``BENCHMARK.json`` with one more cell, added by files and entries alone:
9x9 calls of 8 boards (a bucket width, so no pad rows hide a fault), one from the deep slot, every answer
checked. Its deep pool is the hard pool, so the plain PyTorch solver on
the CPU finishes a call in well under a second.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_TRAFFIC = {
    "entry": "solve_batch_np", "width": 8, "deep_per_call": 1, "clients": 1,
    "loop": "closed",
    "check": {"full_call_share": 1.0, "reference_hard": 8, "reference_deep": 2},
}


def cpu_engine(cell, overrides):
    """The configuration's engine on the CPU (the plain PyTorch solver)."""
    from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
    from sudoku_solver_distributed_tpu_torch.ops.spec import spec_for_size

    kwargs = dict(cell.config["engine"])
    kwargs.update(overrides)
    return SolverEngine(spec_for_size(cell.config["board_size"]), device="cpu", **kwargs)


def make_tiny_bench(tmp_path):
    root = tmp_path / "checkout"
    bench_dir = root / "gpubench"
    bench_dir.mkdir(parents=True)
    for sub in ("entries", "metrics", "configs", "traffic"):
        shutil.copytree(os.path.join(BENCH_DIR, sub), bench_dir / sub)
    os.symlink(os.path.join(BENCH_DIR, "data"), bench_dir / "data")
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        bench = json.load(f)
    for name, base in (("tiny9", "sudoku9"), ("tiny9-mesh4", "sudoku9-mesh4")):
        with open(bench_dir / "configs" / f"{base}.json", encoding="utf-8") as f:
            cfg = json.load(f)
        cfg["pools"]["deep"] = cfg["pools"]["hard"]
        (bench_dir / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "tiny.json").write_text(json.dumps(TINY_TRAFFIC))
    bench["workloads"] += [
        {"name": "tiny", "config": "tiny9", "traffic": "tiny", "chips": 1, "why": "test"},
        {"name": "tiny-mesh", "config": "tiny9-mesh4", "traffic": "tiny", "chips": 4,
         "why": "test"},
    ]
    for m in bench["per_layer"]:
        m["workloads"] = m.get("workloads", []) + ["tiny", "tiny-mesh"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, bench


def tiny_catalog(tmp_path):
    from gpubench.harness.catalog import Catalog

    root, bench = make_tiny_bench(tmp_path)
    return Catalog(bench=bench, bench_dir=str(root / "gpubench"), root=str(root))
