"""The port's mesh plane held against the JAX package's, on the CPU.

The suite's conftest gives JAX an 8-device CPU mesh; the port gets
``virtual_mesh("cpu", 8)``: 8 shards on the CPU, each running the plain
versions of the kernels on its row block. The same seeded numpy inputs go
through both packages, and every comparison is exact (all values are
integers): the sharded solver's grids, flags and counters (lane_steps and
idle_lane_steps summed over the shards, as the JAX ``psum``), the mesh
engine's rounded ladder and ``mesh_info``, coalesced ``/solve`` bodies,
continuous segments over the mesh pool with the cost plane's totals, the
race across 8 shards and across 1, resumable batches moved between the
mesh and one device, the supervised mesh engine, and ``--mesh-peers`` at
``/network``.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sudoku_solver_distributed_tpu.engine import SolverEngine as JaxEngine
from sudoku_solver_distributed_tpu.models import generate_batch
from sudoku_solver_distributed_tpu.net.http_api import (
    make_http_server as jax_make_http_server,
)
from sudoku_solver_distributed_tpu.net.node import P2PNode as JaxNode
from sudoku_solver_distributed_tpu.ops import spec_for_size as jax_spec_for_size
from sudoku_solver_distributed_tpu.parallel import frontier as JF
from sudoku_solver_distributed_tpu.parallel import make_sharded_solver as jax_sharded
from sudoku_solver_distributed_tpu.parallel.mesh import default_mesh as jax_default_mesh
from sudoku_solver_distributed_tpu.utils.checkpoint import (
    solve_batch_resumable as jax_resumable,
)
from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
from sudoku_solver_distributed_tpu_torch.models import oracle_is_valid_solution
from sudoku_solver_distributed_tpu_torch.net import cli
from sudoku_solver_distributed_tpu_torch.net.http_api import make_http_server
from sudoku_solver_distributed_tpu_torch.net.node import P2PNode
from sudoku_solver_distributed_tpu_torch.ops import solver as TS
from sudoku_solver_distributed_tpu_torch.ops import spec_for_size
from sudoku_solver_distributed_tpu_torch.ops.config import mesh_serving_config
from sudoku_solver_distributed_tpu_torch.parallel import frontier as TF
from sudoku_solver_distributed_tpu_torch.parallel import shard as TSH
from sudoku_solver_distributed_tpu_torch.parallel.mesh import (
    Mesh,
    data_sharding,
    default_mesh,
    replicated,
    virtual_mesh,
)
from sudoku_solver_distributed_tpu_torch.utils import checkpoint as tck

README = [
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
SERVING = {9: dict(locked=True, waves=3, naked_pairs=False),
           16: dict(locked=True, waves=1, naked_pairs=False)}
HARD9 = np.load("benchmarks/corpus_9x9_hard_4096.npz")["boards"]
DEEP9 = np.load("benchmarks/corpus_9x9_deep_128.npz")["boards"]
DEEP16 = np.load("benchmarks/corpus_16x16_deep_anneal_64.npz")["boards"]


@pytest.fixture(scope="module")
def mesh8():
    return virtual_mesh("cpu", 8)


def _n_jax():
    return len(jax.devices())


def _unsat_board():
    board = np.zeros((9, 9), np.int32)
    board[0] = [0, 0, 2, 3, 4, 5, 6, 7, 8]
    board[1, 0] = 1
    board[2, 1] = 1
    return board


# -- the mesh ------------------------------------------------------------------


def test_mesh_shapes_and_descriptors(monkeypatch):
    m = virtual_mesh("cpu", 3)
    assert m.size == 3 and m.axis_names == ("data",) and m.virtual
    assert m.devices == (torch.device("cpu"),) * 3 and m.streams == (None,) * 3
    assert m.distinct_devices == (torch.device("cpu"),)
    assert data_sharding(m).mesh is m and data_sharding(m).axis == "data"
    assert replicated(m).mesh is m
    assert TSH.mesh_batch_multiple(m) == 3
    with pytest.raises(ValueError, match="repeat"):
        Mesh(["cpu", "cpu"])  # only virtual_mesh repeats a device
    assert Mesh(["cpu"]).size == 1
    monkeypatch.setenv("SUDOKU_VIRTUAL_MESH", "4@cpu")
    env = default_mesh()
    assert env.size == 4 and env.virtual and env.primary == torch.device("cpu")
    monkeypatch.setenv("SUDOKU_VIRTUAL_MESH", "nope")
    with pytest.raises(ValueError, match="N@device"):
        default_mesh()
    monkeypatch.delenv("SUDOKU_VIRTUAL_MESH")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            default_mesh()
    assert mesh_serving_config() == {"auto_min_devices": 2, "min_per_device_fill": 1}


def test_pad_to_mesh_masks_pad_rows(mesh8):
    boards = HARD9[:11]
    padded, mask = TSH.pad_to_mesh(boards, mesh8, spec_for_size(9))
    assert padded.shape == (16, 9, 9) and mask.tolist() == [1] * 11 + [0] * 5
    assert bool((padded[11:] == TS.pad_board(spec_for_size(9))).all())
    same, mask16 = TSH.pad_to_mesh(HARD9[:16], mesh8, spec_for_size(9))
    assert same.shape[0] == 16 and int(mask16.sum()) == 16


# -- the sharded solver ----------------------------------------------------------


@pytest.mark.parametrize("size, n, kw", [
    (9, 16, {}),
    (9, 11, {}),                               # not mesh-divisible: padded
    (9, 12, dict(max_depth=(6, 81))),          # staged: OVERFLOW reruns per shard
    (9, 8, dict(locked_candidates=False, waves=1)),
    (16, 4, dict(waves=1)),
])
def test_sharded_solver_matches_jax(mesh8, size, n, kw):
    boards = HARD9[:n] if size == 9 else generate_batch(n, 140, size=16, seed=12)
    jg, js, jst = jax_sharded(jax_default_mesh(), jax_spec_for_size(size), **kw)(boards)
    tg, ts_, tst = TSH.make_sharded_solver(mesh8, spec_for_size(size), **kw)(boards)
    assert np.array_equal(tg.numpy(), np.asarray(jg))
    assert np.array_equal(ts_.numpy(), np.asarray(js))
    assert tst == {k: int(v) for k, v in jst.items()}
    assert tst["solved"] == n and tst["lane_steps"] > 0


def test_sharded_solver_is_memoized_on_its_knobs(mesh8):
    p1 = TSH.make_packed_serving_program(mesh8, spec_for_size(9), max_depth=None,
                                         locked_candidates=True, waves=3, naked_pairs=False)
    p2 = TSH.make_packed_serving_program(mesh8, spec_for_size(9), max_depth=None,
                                         locked_candidates=True, waves=3, naked_pairs=False)
    assert p1 is p2
    rows = p1(HARD9[:16], 4096)
    assert TSH.split_evidence(p1) == {"devices": 8, "rows_per_device": 2}
    assert TSH.split_evidence(rows) == {"devices": 1, "rows_per_device": 16}


def test_packed_program_rows_match_jax(mesh8):
    """The bucket program's packed rows, LoopStats columns included (the
    shards' sums broadcast to every row, as the JAX ``psum``)."""
    from sudoku_solver_distributed_tpu.parallel.shard import (
        make_packed_serving_program as jax_program,
    )

    knobs = dict(max_depth=(32, 81), locked_candidates=True, waves=3, naked_pairs=False)
    boards = np.concatenate([HARD9[:12], DEEP9[:4]])
    jrows = np.asarray(jax_program(jax_default_mesh(), jax_spec_for_size(9), **knobs)(
        jnp.asarray(boards), jnp.int32(512)))
    trows = TSH.make_packed_serving_program(mesh8, spec_for_size(9), **knobs)(boards, 512)
    assert np.array_equal(trows, jrows)


# -- the mesh engine ---------------------------------------------------------------


def _engines(mesh8, **kw):
    return JaxEngine(mesh="auto", **kw), SolverEngine(device="cpu", mesh=mesh8, **kw)


def _mesh_info(eng):
    info = dict(eng.mesh_info())
    info.pop("device_kinds")
    return info


def test_mesh_engine_rounds_the_ladder_and_reports_as_jax(mesh8):
    jeng, teng = _engines(mesh8, buckets=(1, 8, 20), coalesce=False)
    try:
        assert teng.requested_buckets == jeng.requested_buckets == (1, 8, 20)
        assert teng.buckets == jeng.buckets == (8, 24)
        assert _mesh_info(teng) == _mesh_info(jeng)
        assert teng.mesh_info()["device_kinds"] == ["cpu"]
        for n in (16, 11, 3):
            js, jm, ji = jeng.solve_batch_np(HARD9[:n])
            ts_, tm, ti = teng.solve_batch_np(HARD9[:n])
            assert np.array_equal(ts_, js) and np.array_equal(tm, jm) and ti == ji
        assert _mesh_info(teng) == _mesh_info(jeng)
        assert teng.mesh_info()["last_split"] == {"devices": 8, "rows_per_device": 1}
        assert teng.health()["mesh"] == teng.warm_info()["mesh"] == teng.mesh_info()
        jc, tc = jeng.cost.snapshot(), teng.cost.snapshot()
        for k in ("dispatches", "boards", "lane_steps", "idle_lane_steps",
                  "pad_coalesce_pct", "pad_mesh_pct", "fill_pct"):
            assert tc[k] == jc[k], k
    finally:
        jeng.close()
        teng.close()


def test_mesh_engine_knob_rules(mesh8):
    with pytest.raises(ValueError, match="mutually exclusive"):
        SolverEngine(device="cpu", mesh=mesh8, sharding=data_sharding(mesh8))
    with pytest.raises(ValueError, match="data"):
        SolverEngine(device="cpu", mesh=object())
    with pytest.raises(TypeError, match="data_sharding"):
        SolverEngine(device="cpu", sharding=object())
    # "auto" on a CPU engine with no virtual mesh set: no mesh, as a JAX
    # engine on one device
    auto = SolverEngine(device="cpu", mesh="auto", buckets=(1, 8))
    assert auto.mesh is None and auto.mesh_info() is None and auto.buckets == (1, 8)
    assert "mesh" not in auto.health()
    # bucket_multiple alone rounds (the multi-host CLI's global count)
    mult = SolverEngine(device="cpu", bucket_multiple=4, buckets=(1, 8, 9))
    assert mult.buckets == (4, 8, 12) and mult.mesh is None
    # a raw sharding: no rounding, the closed loop, mesh-divisible ladder
    raw = SolverEngine(device="cpu", sharding=data_sharding(mesh8), buckets=(8, 16))
    assert raw.continuous is False and raw.mesh_info() is None
    sols, mask, _ = raw.solve_batch_np(HARD9[:8])
    assert mask.all() and raw._mesh_program.last_split["devices"] == 8
    with pytest.raises(ValueError, match="divide"):
        SolverEngine(device="cpu", sharding=data_sharding(mesh8), buckets=(1, 8))
    with pytest.raises(ValueError, match="mesh plane"):
        SolverEngine(device="cpu", sharding=data_sharding(mesh8), buckets=(8,),
                     continuous=True)
    for eng in (auto, mult, raw):
        eng.close()


def test_mesh_auto_reads_the_virtual_mesh(monkeypatch):
    monkeypatch.setenv("SUDOKU_VIRTUAL_MESH", "4@cpu")
    eng = SolverEngine(device="cpu", mesh="auto", buckets=(1, 8, 10), coalesce=False)
    try:
        assert eng.mesh.size == 4 and eng.buckets == (4, 8, 12)
        assert eng.mesh_info()["per_device_fill"] == {"4": 1, "8": 2, "12": 3}
    finally:
        eng.close()
    monkeypatch.setenv("SUDOKU_VIRTUAL_MESH", "1@cpu")  # below auto_min_devices
    assert SolverEngine(device="cpu", mesh="auto").mesh is None


def test_mesh_engine_16x16_matches_jax(mesh8):
    boards = generate_batch(4, 140, size=16, seed=12)
    kw = dict(spec=None, buckets=(4,), coalesce=False)
    jeng = JaxEngine(mesh="auto", spec=jax_spec_for_size(16), buckets=(4,), coalesce=False)
    teng = SolverEngine(device="cpu", mesh=mesh8, spec=spec_for_size(16), buckets=(4,),
                        coalesce=False)
    del kw
    try:
        assert teng.buckets == jeng.buckets == (max(4, _n_jax()),)
        js, jm, ji = jeng.solve_batch_np(boards)
        ts_, tm, ti = teng.solve_batch_np(boards)
        assert np.array_equal(ts_, js) and np.array_equal(tm, jm) and ti == ji
        assert tm.all()
    finally:
        jeng.close()
        teng.close()


def test_mesh_engine_verifies_every_shard_at_warmup(mesh8):
    eng = SolverEngine(device="cpu", mesh=mesh8, buckets=(8,))
    seen = []
    real = eng._round_trip_ok

    def spy(status, grid):
        seen.append(status)
        return real(status, grid)

    eng._round_trip_ok = spy
    try:
        eng.warmup()
        # the bucket launch and the pool's segment: 8 shards each
        assert seen == [TS.SOLVED] * 16 and eng.fully_warmed
        assert eng.warm_info()["buckets"]["8"]["warm"] is True
        # a shard that comes back wrong fails the launch's verification
        assert not eng._round_trips_ok([(TS.SOLVED, None)] * 0 + [(2, None)])
    finally:
        eng.close()


def _answers(eng, boards):
    futs = [eng.solve_one_async(np.asarray(b).tolist()) for b in boards]
    return [f.result(timeout=300) for f in futs]


@pytest.mark.parametrize("continuous", [True, False])
def test_coalesced_answers_on_a_mesh_match_jax(mesh8, continuous):
    """Every board submitted at once through the coalescer of a mesh engine:
    the same answers and counters as the JAX mesh engine's, and every
    dispatch split over the 8 shards."""
    kw = dict(buckets=(8, 16), coalesce=True, coalesce_max_batch=16,
              continuous=continuous, coalesce_quiescence_s=0.0)
    boards = np.concatenate([HARD9[100:110], [np.asarray(README)]])
    jeng, teng = _engines(mesh8, **kw)
    try:
        jres = [jeng.solve_one(b.tolist()) for b in boards]
        tres = _answers(teng, boards)
        for (js, ji), (ts_, ti) in zip(jres, tres):
            assert ts_ == js and ti["validations"] == ji["validations"]
            assert ti["guesses"] == ji["guesses"]
        assert teng.mesh_info()["dispatches"] >= 1
        assert teng.mesh_info()["last_split"]["devices"] == 8
    finally:
        jeng.close()
        teng.close()


def _segment_run(eng, boards, ks):
    """Inject ``boards`` into a fresh 16-lane pool and run segments of the
    budgets ``ks`` (cycled) until every lane is done: each segment's rows."""
    W = 16
    N = eng.spec.size
    inject = np.zeros((W,), np.int32)
    inject[:len(boards)] = 1
    full = np.zeros((W, N, N), np.int32)
    full[:len(boards)] = boards
    state = eng.new_segment_pool(W)
    active = inject.astype(bool)
    out = []
    for i in range(400):
        h = eng.dispatch_segment(state, full, inject, seg_iters=ks[i % len(ks)])
        rows, _ = eng.finalize_segment(h, active=active)
        out.append(rows)
        state = h.state
        inject = np.zeros_like(inject)
        if not (rows[:, eng.spec.cells + 1] == TS.RUNNING).any():
            return out
    raise AssertionError("segments did not finish")


@pytest.mark.parametrize("pipeline", [True, False])
def test_segments_on_the_mesh_pool_match_jax(mesh8, pipeline):
    """Segments over a 16-lane pool split over 8 shards: each segment's
    per-lane rows (grid of solved lanes, status, guesses, validations,
    board_iters) and the LoopStats columns (the shards' sums, as JAX's
    ``psum``), and the cost plane's continuous totals."""
    kw = dict(buckets=(16,), coalesce=True, segment_pipeline=pipeline)
    boards = np.concatenate([HARD9[:10], DEEP9[:1]])
    jeng, teng = _engines(mesh8, **kw)
    try:
        jrows = _segment_run(jeng, boards, (5, 1, 29))
        trows = _segment_run(teng, boards, (5, 1, 29))
        assert len(trows) == len(jrows)
        C = 81
        for j, t in zip(jrows, trows):
            solved = j[:, C] == 1
            assert np.array_equal(t[:, C:], j[:, C:])
            assert np.array_equal(t[solved, :C], j[solved, :C])
        jc = jeng.cost.snapshot()
        tc = teng.cost.snapshot()
        for k in ("segments", "injected", "resolved", "lane_util_pct"):
            assert tc["continuous"][k] == jc["continuous"][k], k
        for k in ("lane_steps", "idle_lane_steps"):
            assert tc[k] == jc[k], k
        assert teng.mesh_info()["dispatches"] == len(trows)
    finally:
        jeng.close()
        teng.close()


# -- the race across shards ------------------------------------------------------


RACE_BOARDS = {
    "readme": (9, README, 8),
    "unsat": (9, _unsat_board(), 4),
    "hexadoku": (16, DEEP16[0], 1),
}


@pytest.mark.parametrize("shards", [8, 1])
@pytest.mark.parametrize("name", sorted(RACE_BOARDS))
def test_race_across_shards_matches_jax(name, shards):
    size, board, spd = RACE_BOARDS[name]
    cfg = SERVING[size]
    jmesh = jax_default_mesh(jax.devices()[:shards])
    tmesh = virtual_mesh("cpu", shards) if shards > 1 else Mesh(["cpu"])
    kw = dict(states_per_device=spd, locked=cfg["locked"], waves=cfg["waves"],
              naked_pairs=cfg["naked_pairs"])
    jsol, jinfo = JF.frontier_solve(np.asarray(board), jmesh, jax_spec_for_size(size), **kw)
    tsol, tinfo = TF.frontier_solve(np.asarray(board), tmesh, spec_for_size(size), **kw)
    assert tsol == jsol and tinfo == jinfo
    if tsol is not None:
        assert oracle_is_valid_solution(tsol)
    # the row and the fold on the same padded states: the fold over the
    # shards' own runs equals one lockstep race over every state
    spec = spec_for_size(size)
    states, early = TF.seed_frontier(np.asarray(board), spec, target=shards * spd,
                                     locked=cfg["locked"], device="cpu")
    assert early is None
    states = TF.bucket_states(states, spec, spd, shards).numpy()
    assert len(states) % shards == 0
    depth = spec.max_depth
    knobs = dict(locked_candidates=cfg["locked"], waves=cfg["waves"],
                 naked_pairs=cfg["naked_pairs"])
    row, fold, meta = TF.race_on_mesh(states, tmesh, spec, depth, JF.DEFAULT_MAX_ITERS, **knobs)
    prow, pfold, _ = TS.race(torch.from_numpy(states), spec, JF.DEFAULT_MAX_ITERS, depth,
                             **TS.sweep_knobs(spec, cfg["locked"], cfg["waves"], False,
                                              cfg["naked_pairs"]))
    assert torch.equal(row, prow) and torch.equal(fold, pfold)
    racer = JF._make_racer(jmesh, jax_spec_for_size(size), JF.DEFAULT_MAX_ITERS, depth,
                           cfg["locked"], cfg["waves"], cfg["naked_pairs"])
    assert np.array_equal(row.numpy(), np.asarray(racer(jnp.asarray(states))))
    assert meta.shape == (len(states), 4)


def test_race_fold_wrapper_checks_its_inputs():
    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import (
        dfs_race_shards,
        race_fold,
    )

    spec = spec_for_size(9)
    with pytest.raises(ValueError):
        race_fold(torch.zeros((3, 4), dtype=torch.int32),
                  torch.zeros((2, 81), dtype=torch.int32), spec, 1)
    with pytest.raises(TypeError):
        race_fold(torch.zeros((3, 4)), torch.zeros((3, 81), dtype=torch.int32), spec, 1)
    with pytest.raises(ValueError):  # shards of unequal widths
        dfs_race_shards([torch.zeros((3, 81), dtype=torch.int32),
                         torch.zeros((2, 81), dtype=torch.int32)], spec, 81, 64)
    with pytest.raises(TypeError):
        dfs_race_shards([torch.zeros((3, 81))], spec, 81, 64)
    with pytest.raises(ValueError, match="divide"):
        TF.race_on_mesh(np.zeros((5, 9, 9), np.int32), virtual_mesh("cpu", 2), spec,
                        81, 64)


def test_engine_races_across_its_mesh(mesh8):
    """A mesh engine's frontier route races across its 8 shards: the JAX
    mesh engine's answers and counters, routing and warm-up included."""
    kw = dict(buckets=(8,), coalesce=False, frontier_states_per_device=4,
              frontier_route="always")
    jeng = JaxEngine(mesh="auto", frontier_mesh=jax_default_mesh(), **kw)
    teng = SolverEngine(device="cpu", mesh=mesh8, frontier_mesh="auto", **kw)
    try:
        assert teng.race_mesh is mesh8 and teng.frontier_device == torch.device("cpu")
        teng.warmup()
        for board in (README, DEEP9[5].tolist()):
            jsol, jinfo = jeng.solve_one(board)
            tsol, tinfo = teng.solve_one(board)
            assert tsol == jsol and tinfo == jinfo and tinfo["frontier"] is True
        assert teng.validations == jeng.validations
        assert teng.cost.snapshot()["frontier"]["races"] == 2
    finally:
        jeng.close()
        teng.close()


# -- resumable batches across the mesh and one device --------------------------------


CUT = 48
RESUMABLE = dict(locked=True, waves=3, naked_pairs=False, chunk_iters=16)


@pytest.fixture(scope="module")
def resumable_ref(tmp_path_factory):
    """The JAX sharded resumable solve of the batch, uncut and cut at
    ``CUT`` steps (its snapshot), on the 8-device mesh."""
    boards = np.concatenate([HARD9[:14], DEEP9[:2]])
    tmp = tmp_path_factory.mktemp("jax_resumable")
    jsharding = jax.sharding.NamedSharding(jax_default_mesh(),
                                           jax.sharding.PartitionSpec("data"))
    ref = jax_resumable(boards, jax_spec_for_size(9), checkpoint_path=str(tmp / "j.npz"),
                        sharding=jsharding, **RESUMABLE)
    jax_resumable(boards, jax_spec_for_size(9), checkpoint_path=str(tmp / "cut.npz"),
                  max_iters=CUT, sharding=jsharding, **RESUMABLE)
    return boards, ref, dict(np.load(tmp / "cut.npz"))


@pytest.mark.parametrize("first, second", [("mesh", "single"), ("single", "mesh"),
                                           ("mesh", "mesh")])
def test_resumable_batch_moves_between_mesh_and_one_device(tmp_path, mesh8, resumable_ref,
                                                           first, second):
    boards, ref, jsnap = resumable_ref
    knobs = RESUMABLE
    path = str(tmp_path / "ck.npz")

    def run(where, **kw):
        place = (dict(sharding=data_sharding(mesh8)) if where == "mesh"
                 else dict(device="cpu"))
        return tck.solve_batch_resumable(boards, spec_for_size(9), checkpoint_path=path,
                                         **place, **knobs, **kw)

    cut = run(first, max_iters=CUT)
    assert cut.iters == CUT and bool((cut.status == TS.RUNNING).any())
    snap = dict(np.load(path))
    # the snapshot is the JAX package's, key for key (board hashes aside)
    assert sorted(snap) == sorted(jsnap)
    for k in ("grid", "stack_grid", "status", "guesses", "validations", "depth", "iters"):
        assert np.array_equal(snap[k], jsnap[k]), k
    res = run(second)
    for f in ("grid", "status", "guesses", "validations"):
        assert np.array_equal(getattr(res, f).numpy(), np.asarray(getattr(ref, f))), f
    assert res.iters == int(ref.iters)


def test_engine_resumable_on_a_mesh_matches_jax(tmp_path, mesh8):
    boards = HARD9[:16]
    jeng, teng = _engines(mesh8, buckets=(16,), coalesce=False)
    try:
        js, jm, ji = jeng.solve_batch_resumable_np(boards, str(tmp_path / "j.npz"),
                                                   chunk_iters=16)
        ts_, tm, ti = teng.solve_batch_resumable_np(boards, str(tmp_path / "t.npz"),
                                                    chunk_iters=16)
        assert np.array_equal(ts_, js) and np.array_equal(tm, jm) and ti == ji
        # a batch that does not divide the mesh runs on the first shard
        ts2, tm2, _ = teng.solve_batch_resumable_np(boards[:5], str(tmp_path / "u.npz"))
        assert np.array_equal(ts2, ts_[:5]) and tm2.all()
    finally:
        jeng.close()
        teng.close()


# -- supervision over the mesh --------------------------------------------------------


def test_supervised_mesh_engine_probe_and_fallback(mesh8):
    """The supervised seam threads through the sharded dispatch: a probe
    round-trips the mesh program, and an injected device fault reroutes to
    the host-oracle fallback, as JAX ``test_mesh_serving.py``'s."""
    from sudoku_solver_distributed_tpu_torch.serving.health import (
        HEALTHY,
        EngineSupervisor,
    )
    from sudoku_solver_distributed_tpu_torch.utils.faults import EngineFaultInjector

    eng = SolverEngine(device="cpu", mesh=mesh8, buckets=(8,), coalesce=False)
    sup = EngineSupervisor(eng, watchdog_budget_s=5.0, probe_interval_s=0.05,
                           fallback_budget_s=10.0)
    try:
        eng.warmup()
        assert sup.probe()
        assert sup.state == HEALTHY
        inj = EngineFaultInjector()
        eng.fault_injector = inj
        inj.arm_fail_next(1)
        board = generate_batch(1, 40, seed=3)[0]
        sol, info = eng.solve_one(board.tolist())
        assert sol is not None and oracle_is_valid_solution(sol)
        assert info.get("routed") == "oracle-fallback"
        assert info.get("degraded")
        # once a half-open probe re-admits the device, calls ride the
        # mesh again
        deadline = time.monotonic() + 20
        while sup.state != HEALTHY and time.monotonic() < deadline:
            time.sleep(0.05)
        assert sup.state == HEALTHY
        sol2, info2 = eng.solve_one(board.tolist())
        assert sol2 == sol and info2.get("routed") != "oracle-fallback"
        assert eng.mesh_info()["dispatches"] >= 2
    finally:
        sup.close()
        eng.close()


# -- the node: --mesh-peers and the CLI flags ---------------------------------------


def _free_udp_port():
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return r.read()


def _post(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode())
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_mesh_nodes_answer_and_show_pseudo_peers_as_jax(mesh8):
    """A JAX mesh node and a port mesh node, each with --mesh-peers 8:
    /network lists the same ``{id}/tpu{k}`` pseudo-peers under the same
    ids, and /solve bodies are equal byte for byte."""
    servers, nodes = [], []
    udp = _free_udp_port()
    try:
        for Engine, Node, make in (
            (lambda: JaxEngine(mesh="auto", buckets=(8,)), JaxNode, jax_make_http_server),
            (lambda: SolverEngine(device="cpu", mesh=mesh8, buckets=(8,)), P2PNode,
             make_http_server),
        ):
            eng = Engine()
            eng.warmup()
            node = Node("127.0.0.1", udp, engine=eng, mesh_peer_count=8)
            httpd = make(node, "127.0.0.1", 0)
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            nodes.append(node)
            servers.append(httpd)
        ports = [h.server_address[1] for h in servers]
        views = [json.loads(_get(p, "/network")) for p in ports]
        assert views[0] == views[1]
        assert views[1][f"127.0.0.1:{udp}"] == sorted(
            f"127.0.0.1:{udp}/tpu{k}" for k in range(8))
        for board in (README, HARD9[7].tolist(), _unsat_board().tolist()):
            bodies = [_post(p, "/solve", {"sudoku": board}) for p in ports]
            assert bodies[0] == bodies[1]
    finally:
        for h in servers:
            h.shutdown()
            h.server_close()
        for n in nodes:
            n.engine.close()


def test_cli_mesh_flags_match_jax():
    from sudoku_solver_distributed_tpu.net.cli import build_parser as jax_build_parser

    argv = ["--mesh-peers", "3", "--no-mesh", "--coordinator", "h:1",
            "--num-hosts", "2", "--host-id", "1"]
    jargs = jax_build_parser().parse_args(argv)
    targs = cli.build_parser().parse_args(argv)
    for k in ("mesh_peers", "no_mesh", "coordinator", "num_hosts", "host_id"):
        assert getattr(targs, k) == getattr(jargs, k), k
    jd = jax_build_parser().parse_args([])
    td = cli.build_parser().parse_args([])
    for k in ("mesh_peers", "no_mesh", "coordinator", "num_hosts", "host_id"):
        assert getattr(td, k) == getattr(jd, k), k


def test_cli_node_on_a_virtual_mesh(monkeypatch, caplog):
    """A CPU node under SUDOKU_VIRTUAL_MESH serves on the mesh (the serving
    default, mesh="auto") and logs its shard count; --no-mesh keeps one
    device but still races across the shards."""
    monkeypatch.setenv("SUDOKU_VIRTUAL_MESH", "4@cpu")
    caplog.set_level("INFO")
    base = ["-p", "0", "-s", "0", "--platform", "cpu", "--no-warmup",
            "--no-autopilot", "--buckets", "1,8", "--frontier", "4"]
    for extra, mesh_size in (([], 4), (["--no-mesh"], None)):
        args = cli.build_parser().parse_args(base + extra)
        node, httpd = cli.build_node(args)
        try:
            eng = node.engine
            assert (eng.mesh.size if eng.mesh else None) == mesh_size
            assert eng.race_mesh.size == 4
            if mesh_size:
                assert eng.buckets == (4, 8)
            sol, info = eng.solve_one(README)
            assert oracle_is_valid_solution(sol)
        finally:
            httpd.server_close()
            node.shutdown()
            node.engine.close()
    assert "virtual mesh: 4 shards on cpu" in caplog.text
