"""The benchmark's pieces on the CPU: the catalog by name, the seeded
traffic, the plain reference, the trace reader and the contract's shape of
``BENCHMARK.json``."""

from __future__ import annotations

import json
import os
import re

import numpy as np
import pytest

from gpubench_testlib import BENCH_DIR, ROOT, tiny_catalog

from gpubench.harness.bounds import k1_bound_s
from gpubench.harness.catalog import Catalog
from gpubench.harness.trace import Trace, short_name
from gpubench.harness.traffic import BatchPlan, load_pools
from gpubench.reference.solver import solutions, valid_completions

CELLS = [w["name"] for w in Catalog().bench["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_finds_its_pieces_by_name(workload):
    cell = Catalog().cell(workload)
    assert cell.config["board_size"] in (9, 25)
    assert cell.chips == cell.config["chips"]
    assert callable(cell.entry)
    names = [m.name for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.end_to_end + cell.per_layer:
        assert callable(m.read)


@pytest.mark.parametrize("workload", CELLS)
def test_seeded_calls_repeat_and_hold_d_deep_boards(workload):
    cat = Catalog()
    cell = cat.cell(workload)
    pools = load_pools(cat, cell.config)
    seed = 2 ** 31 + 12345
    a = BatchPlan(pools, cell.traffic, seed)
    b = BatchPlan(pools, cell.traffic, seed)
    d = cell.traffic["deep_per_call"]
    buf = a.buffer()
    for k in (0, 1, 7, 40):
        ca, cb = a.call(k), b.call(k)
        assert np.array_equal(ca.boards, cb.boards)
        assert ca.gather(buf) is buf and np.array_equal(buf, ca.boards)
        assert np.array_equal(ca.deep_pos, cb.deep_pos)
        assert len(set(ca.deep_pos.tolist())) == d == len(ca.deep_idx)
        assert np.array_equal(ca.boards[ca.deep_pos], pools["deep"][ca.deep_idx])
        hard = ca.hard_idx >= 0
        assert hard.sum() == cell.traffic["width"] - d
        assert np.array_equal(ca.boards[hard], pools["hard"][ca.hard_idx[hard]])
    other = BatchPlan(pools, cell.traffic, seed + 1).call(0)
    assert not np.array_equal(other.boards, a.call(0).boards)


def test_every_seed_deals_each_deep_board_equally_often():
    cat = Catalog()
    cell = cat.cell("sudoku9-batch-stragglers")
    pools = load_pools(cat, cell.config)
    per_cycle = len(pools["deep"]) // cell.traffic["deep_per_call"]
    for seed in (1, 2 ** 33 + 7):
        plan = BatchPlan(pools, cell.traffic, seed)
        counts = np.zeros(len(pools["deep"]), int)
        for k in range(2 * per_cycle):
            np.add.at(counts, plan.call(k).deep_idx, 1)
        assert (counts == 2).all()


def test_a_negative_or_huge_seed_draws():
    cat = Catalog()
    cell = cat.cell("sudoku25-batch-stragglers")
    pools = load_pools(cat, cell.config)
    for seed in (-5, 2 ** 70 + 3):
        assert BatchPlan(pools, cell.traffic, seed).call(3).boards.shape == (512, 25, 25)


@pytest.mark.parametrize("pool,count", [
    ("corpus_9x9_hard_16384", 24), ("corpus_9x9_deep_union", 3),
    ("corpus_25x25_hard_512", 3), ("corpus_25x25_deep_anneal_32", 1),
])
def test_the_reference_solves_corpus_boards_uniquely(pool, count):
    with np.load(os.path.join(BENCH_DIR, "data", f"{pool}.npz")) as z:
        boards = z["boards"]
    idx = np.random.default_rng(7).choice(len(boards), count, replace=False)
    found = [solutions(boards[i], 2) for i in idx]
    assert all(len(f) == 1 for f in found)
    grids = np.stack([f[0] for f in found])
    assert valid_completions(boards[idx], grids).all()


def test_valid_completions_flags_broken_grids():
    with np.load(os.path.join(BENCH_DIR, "data", "corpus_9x9_hard_16384.npz")) as z:
        boards = z["boards"][:4]
    grids = np.stack([solutions(b)[0] for b in boards])
    bad = grids.copy()
    bad[0, 0, 0] = bad[0, 0, 0] % 9 + 1          # a repeated value
    clue = np.argwhere(boards[1] > 0)[0]
    bad[1] = grids[1]
    bad[1][tuple(clue)] = 0                       # out of range, clue lost
    bad[2] = boards[2]                            # unsolved
    assert valid_completions(boards, grids).all()
    assert valid_completions(boards, bad).tolist() == [False, False, False, True]


def test_added_files_alone_give_a_new_cell(tmp_path):
    cat = tiny_catalog(tmp_path)
    cell = cat.cell("tiny")
    assert cell.traffic["width"] == 8 and cell.config["name"] == "tiny9"
    assert [m.name for m in cell.per_layer][:3] == [
        "host_ms_per_call.batch", "k1_roofline.batch", "idle_share.batch"]


def _event(cat, name, ts, dur, **kw):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1,
            "tid": 7, **kw}


def test_the_trace_reader_splits_busy_idle_and_host():
    ev = [
        _event("user_annotation", "gpubench.window", 0, 1000),
        _event("user_annotation", "gpubench.call", 100, 400),
        _event("user_annotation", "gpubench.draw", 500, 500),
        _event("cpu_op", "aten::copy_", 120, 30),
        _event("kernel", "void (anonymous namespace)::dfs_solver_kernel<3>(int*)", 200, 200,
               pid=0, tid=9, args={"device": 0}),
        _event("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 400, 50,
               pid=0, tid=9, args={"device": 0}),
        _event("gpu_user_annotation", "gpubench.call", 100, 400, pid=0),
    ]
    tr = Trace(ev)
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s(0) == pytest.approx(250e-6)
    assert tr.kernel_s("dfs_solver_kernel") == pytest.approx(200e-6)
    assert tr.calls == [(100.0, 500.0)]
    assert tr.device_busy_within_s(100, 500) == pytest.approx(250e-6)
    gaps = dict(tr.idle_gaps())
    # idle 0..200 and 450..1000: outside any span, in the call, in its copy,
    # in the draw
    assert gaps == pytest.approx({"host": 100e-6, "gpubench.call": 120e-6,
                                  "aten::copy_": 30e-6, "gpubench.draw": 500e-6})
    assert tr.top_device_ops()[0] == ["dfs_solver_kernel<3>", pytest.approx(200e-6)]
    assert short_name("Memcpy HtoD (Pinned -> Device)") == "Memcpy HtoD (Pinned -> Device)"


def test_the_k1_bound_is_the_larger_of_operations_and_bytes():
    s, by = k1_bound_s(sweeps=10 ** 6, boards=4096, cells=81, locked=True)
    assert by == "operations"
    assert s == pytest.approx(10 ** 6 * 81 * 37 / (132 * 64 * 1.98e9))
    s, by = k1_bound_s(sweeps=1, boards=4096, cells=81, locked=False)
    assert by == "bytes"
    assert s == pytest.approx(4096 * (2 * 81 + 4) * 4 / 3.35e12)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_the_contract_shape():
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        bench = json.load(f)
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["gpubench"] and bench["command"][1] == "gpubench/run.py"
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    cells = bench["workloads"]
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("gpubench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        names.add(c["name"])
    pairs = set()
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m.get("workloads", [])) <= {w["name"] for w in cells}
        assert os.path.exists(os.path.join(BENCH_DIR, "metrics", f"{m['name']}.py"))
    assert len(json.dumps(bench)) < 64 * 1024
