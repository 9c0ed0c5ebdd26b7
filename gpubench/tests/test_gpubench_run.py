"""Whole runs of the harness on the CPU, with the card's look skipped: a
sound run comes out correct, the control and each fault the cells can have
come out not correct, the result line keeps to the contract, and no JAX
module loads. The test on the card runs the real cell and its control."""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from gpubench_testlib import ROOT, cpu_engine, tiny_catalog

from gpubench.harness import runner

CONTRACT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"}


def _run(cat, workload="tiny", *, trace=False, seconds=0.6, overrides=None, seed=2 ** 31 + 9):
    out, err = io.StringIO(), io.StringIO()
    rc = runner.measure(workload, seed, seconds, trace, t_process=time.perf_counter(),
                         make_engine=cpu_engine, on_chip=False, catalog=cat,
                         overrides=overrides, out=out, err=err)
    assert rc == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


def test_a_sound_run_is_correct_and_keeps_to_the_contract(tmp_path):
    cat = tiny_catalog(tmp_path)
    r, err = _run(cat)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r) <= CONTRACT_KEYS and list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"batch_boards_per_s", "batch_call_p50_ms", "setup_s"}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    for k in ("platform", "kind", "count", "memory_peak_bytes"):
        assert k in r["device"]
    tail = err.strip().splitlines()[-len(r["checks"]):]
    assert tail == [f"check {k} {v['value']} limit {v['limit']}" for k, v in r["checks"].items()]


def test_a_traced_run_reports_per_layer_metrics_and_a_breakdown(tmp_path):
    cat = tiny_catalog(tmp_path)
    r, _ = _run(cat, trace=True)
    assert r["correct"] is True
    assert "host_ms_per_call.batch" in r["metrics"]
    assert "busy_s" in r["device"] and r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in r["breakdown"].values())


def test_the_control_is_not_correct(tmp_path):
    cat = tiny_catalog(tmp_path)
    control = cat.cell("tiny").config["control"]["engine"]
    r, _ = _run(cat, overrides=dict(control, max_iters=4))
    assert r["correct"] is False and r["checks"]["unsolved"]["value"] > 0


def _unchanged(grid, spec, depth, iters, **_):
    from sudoku_solver_distributed_tpu_torch.ops.solver import LoopStats, SolveResult

    zero = torch.zeros(grid.shape[0], dtype=torch.int32)
    res = SolveResult(grid=grid.clone(), solved=zero.bool(), status=zero, guesses=zero,
                      validations=zero, iters=torch.tensor(iters))
    return res, LoopStats(0, 0)


def _half(real):
    """Every other board of the batch left out: the solver runs on the even
    lanes only, the odd ones come back as they went in."""
    def stage(grid, spec, depth, iters, **sweeps):
        a, sa = real(grid[0::2].contiguous(), spec, depth, iters, **sweeps)
        b, _ = _unchanged(grid[1::2], spec, depth, iters)

        def weave(x, y):
            if not x.dim():
                return x
            out = torch.empty((x.shape[0] + y.shape[0], *x.shape[1:]), dtype=x.dtype)
            out[0::2], out[1::2] = x, y
            return out

        return type(a)(*[weave(x, y) for x, y in zip(a, b)]), sa
    return stage


def _altered(real):
    def stage(grid, spec, depth, iters, **sweeps):
        res, stats = real(grid, spec, depth, iters, **sweeps)
        g = res.grid.clone()
        g[0, 0, 0] = g[0, 0, 0] % spec.size + 1
        return res._replace(grid=g), stats
    return stage


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch", "answer_altered"])
def test_a_fault_in_the_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    import sudoku_solver_distributed_tpu_torch.engine as engine_mod

    real = engine_mod.solve_stage
    stage = {"state_unchanged": _unchanged, "half_the_batch": _half(real),
             "answer_altered": _altered(real)}[fault]
    monkeypatch.setattr(engine_mod, "solve_stage", stage)
    r, _ = _run(tiny_catalog(tmp_path))
    assert r["correct"] is False
    bad = {k for k, v in r["checks"].items() if v["value"] > v["limit"]}
    assert bad & ({"invalid", "mismatch"} if fault == "answer_altered" else {"unsolved"})


def test_the_exchange_between_cards_left_out_is_not_correct(tmp_path, monkeypatch):
    import sudoku_solver_distributed_tpu_torch.parallel.shard as shard_mod

    real = shard_mod.to_primary

    def no_exchange(mesh, i, t, *a, **kw):
        got = real(mesh, i, t, *a, **kw)
        return got if i == 0 else torch.zeros_like(got)

    monkeypatch.setenv("SUDOKU_VIRTUAL_MESH", "4@cpu")
    cat = tiny_catalog(tmp_path)
    sound, _ = _run(cat, "tiny-mesh")
    assert sound["correct"] is True
    monkeypatch.setattr(shard_mod, "to_primary", no_exchange)
    r, _ = _run(cat, "tiny-mesh")
    assert r["correct"] is False and r["checks"]["unsolved"]["value"] > 0


def test_no_jax_module_loads(tmp_path):
    script = f"""
import sys, io, time
for name in ("jax", "jaxlib", "flax", "sudoku_solver_distributed_tpu"):
    sys.modules[name] = None
sys.path[:0] = [{ROOT!r}, {os.path.dirname(__file__)!r}]
import pathlib
from gpubench_testlib import cpu_engine, tiny_catalog
from gpubench.harness import runner
cat = tiny_catalog(pathlib.Path({str(tmp_path)!r}))
rc = runner.measure("tiny", 5, 0.3, True, t_process=time.perf_counter(),
                     make_engine=cpu_engine, on_chip=False, catalog=cat,
                     out=io.StringIO(), err=io.StringIO())
loaded = sorted({{m.split(".")[0] for m, mod in sys.modules.items() if mod is not None}}
                & {{"jax", "jaxlib", "flax", "sudoku_solver_distributed_tpu"}})
print(rc, loaded)
"""
    p = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "0 []"


def test_run_py_refuses_without_the_cards():
    if torch.cuda.is_available():
        pytest.skip("a card is here: the refusal is for machines without one")
    p = subprocess.run([sys.executable, os.path.join(ROOT, "gpubench", "run.py"),
                        "--workload", "sudoku9-batch-stragglers", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_on_the_card_the_cell_is_correct_and_its_control_is_not():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, "gpubench", "readings.py"),
         "--workload", "sudoku9-batch-stragglers", "--seconds", "3",
         "--seeds", "3900000001", "--control-seeds", "3900000002"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    rows = [json.loads(line) for line in p.stdout.splitlines() if line.startswith("{")]
    assert [(r["arm"], r["correct"]) for r in rows] == [("program", True), ("control", False)]
