"""One run of one cell: set-up, the measured window, the readings, the check.

``measure`` is the whole run behind ``run.py``. It takes the function that
makes the engine as an argument, so a test can drive every other part of a
run with a broken program underneath, on the CPU.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from . import check
from .catalog import ROOT, Catalog, Cell
from .trace import WINDOW, Trace, annotate, profiled
from .traffic import load_pools

CACHE_DIR = "gpubench/.cache"      # under the checkout's root, fixed
OUT_DIR = "gpubench/out"
FORBIDDEN = ("jax", "jaxlib", "flax", "sudoku_solver_distributed_tpu")
# what the profiler's Chrome trace calls K1, the batch kernel
K1_NAME = "dfs_solver_kernel"


class NoChip(RuntimeError):
    """The machine lacks the cards a cell asks for."""


def cache_env(root: str) -> dict:
    """The build and kernel caches, at fixed paths inside the checkout."""
    base = os.path.join(root, CACHE_DIR)
    return {
        "TRITON_CACHE_DIR": os.path.join(base, "triton"),
        "TORCH_EXTENSIONS_DIR": os.path.join(base, "torch_extensions"),
        "CUDA_CACHE_PATH": os.path.join(base, "nv"),
    }


def compile_cache_dir(root: str) -> str:
    return os.path.join(root, CACHE_DIR, "compile")


@dataclass
class Context:
    """What an entry needs to run a cell."""

    cell: Cell
    catalog: Catalog
    seed: int
    seconds: float
    trace: bool
    t_process: float                 # perf_counter at process start
    make_engine: Callable            # (cell, overrides) -> engine
    overrides: dict = field(default_factory=dict)
    trace_path: Optional[str] = None

    def __post_init__(self):
        self.pools = load_pools(self.catalog, self.cell.config)

    def build_engine(self):
        return self.make_engine(self.cell, self.overrides)

    @contextlib.contextmanager
    def window(self):
        """The measured window: profiled and annotated in a traced run."""
        if not self.trace:
            yield
            return
        with profiled(self.trace_path):
            with annotate(WINDOW):
                yield

    def span(self, name: str):
        """A host span of the traced window (``trace.CALL`` around each call
        into the program, ``trace.DRAW`` around the harness's own work)."""
        return annotate(name) if self.trace else contextlib.nullcontext()


@dataclass
class Run:
    """What an entry hands back: the window's calls and the program's state
    the readers need."""

    calls: list                      # (t0, t1, boards, sweeps) per call
    window_s: float
    setup_s: float
    answers: check.Answers
    plan: object
    cells: int
    locked: bool
    devices: list                    # CUDA device indices the cell used
    cost_before: dict
    cost_after: dict
    engine: object = None
    trace: Optional[Trace] = None
    context: dict = field(default_factory=dict)


def cuda_engine(cell: Cell, overrides: dict):
    """The engine as the configuration's node builds it, on CUDA, with its
    kernel store in the checkout's fixed cache directory."""
    from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
    from sudoku_solver_distributed_tpu_torch.ops.spec import spec_for_size

    kwargs = dict(cell.config["engine"])
    kwargs.update(overrides)
    return SolverEngine(
        spec_for_size(cell.config["board_size"]),
        device="cuda",
        compile_cache_dir=compile_cache_dir(ROOT),
        **kwargs,
    )


def require_chips(n: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoChip("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < n:
        raise NoChip(f"the cell asks for {n} cards, {torch.cuda.device_count()} visible")


def forbidden_modules() -> list:
    """The JAX modules the process has loaded, by whole top-level name."""
    loaded = {m.split(".")[0] for m, mod in list(sys.modules.items()) if mod is not None}
    return sorted(loaded & set(FORBIDDEN))


def _power_limits() -> list:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def device_record(run: Run, on_chip: bool) -> dict:
    if not on_chip:
        return {"platform": "cpu", "kind": "cpu", "count": len(run.devices),
                "memory_peak_bytes": 0}
    import torch

    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(run.devices[0]),
        "count": len(run.devices),
        "memory_peak_bytes": max(
            int(torch.cuda.max_memory_allocated(d)) for d in run.devices
        ),
    }


def _free(run: Run) -> None:
    """Drop the program's state before the reference runs."""
    engine, run.engine = run.engine, None
    if engine is not None and hasattr(engine, "close"):
        engine.close()
    del engine
    import gc

    gc.collect()
    try:
        import torch

        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    except ImportError:
        pass


def measure(workload: str, seed: int, seconds: float, trace: bool, *,
            t_process: float, make_engine: Callable = cuda_engine,
            on_chip: bool = True, catalog: Optional[Catalog] = None,
            overrides: Optional[dict] = None, out=sys.stdout, err=sys.stderr) -> int:
    """Run ``workload`` once and print its result line; the exit code."""
    catalog = catalog or Catalog()
    cell = catalog.cell(workload)
    if on_chip:
        require_chips(cell.chips)
    trace_path = None
    if trace:
        os.makedirs(os.path.join(catalog.root, OUT_DIR), exist_ok=True)
        trace_path = os.path.join(catalog.root, OUT_DIR, f"{workload}.trace.json")
    ctx = Context(cell, catalog, int(seed), float(seconds), bool(trace), t_process,
                  make_engine, dict(overrides or {}), trace_path)
    run = cell.entry(ctx)
    device = device_record(run, on_chip)
    if trace:
        run.trace = Trace.load(trace_path)
        device["busy_s"] = run.trace.mean_busy_s(run.devices)
        device["window_s"] = run.trace.window_s
        run.context.update(run.trace.call_split_quantiles())
        run.context["idle_share_by_card"] = [
            100.0 * (1.0 - run.trace.busy_s(d) / run.trace.window_s) for d in run.devices
        ]
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = m.read(run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    _free(run)
    found = forbidden_modules()
    if found:
        print(f"gpubench: the run's process holds {', '.join(found)}", file=err)
        return 3
    checks, counts = check.evaluate(run.answers, run.plan, cell.traffic["check"])
    correct = check.verdict(checks, run.answers.calls)
    attempted = run.answers.calls * run.answers.width
    failed = min(attempted, checks["unsolved"] + checks["rows_missing"]
                 + checks["invalid"] + checks["mismatch"])
    result = {
        "correct": correct,
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": device,
    }
    if trace:
        result["breakdown"] = {
            "device_ops": run.trace.top_device_ops(10),
            "idle_gaps": run.trace.idle_gaps(10),
        }
    context = dict(run.context, **counts)
    if on_chip:
        context["power"] = _power_limits()
    print("gpubench context " + json.dumps(context), file=err)
    result["checks"] = check.report(checks, err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0
