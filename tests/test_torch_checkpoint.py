"""The port's checkpoint / resume (utils/checkpoint.py) against the JAX
package's on the CPU, at 9×9 and 16×16 in each size's serving
configuration: the same rows uninterrupted, the same snapshot key for key
and byte for byte when a run stops at its step budget, a snapshot written
by either package resumed by the other to the JAX package's uninterrupted
rows, the same refusals (stale batch, another geometry, another
configuration), and the engine's ``solve_batch_resumable_np`` folding a
resumed batch's whole effort into its counters once.
"""

import os

import numpy as np
import pytest
import torch

from sudoku_solver_distributed_tpu.engine import SolverEngine as JaxEngine
from sudoku_solver_distributed_tpu.utils import checkpoint as jck
from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import dfs_segment
from sudoku_solver_distributed_tpu_torch.utils import checkpoint as tck

BENCH = os.path.join(os.path.dirname(__file__), "..", "benchmarks")
CORPUS = {9: ("corpus_9x9_hard_64.npz", 6), 16: ("corpus_16x16_hard_2048.npz", 3)}
# each size's serving configuration (ops.SERVING_CONFIG), flat depth
KNOBS = {
    9: dict(locked=True, waves=3, naked_pairs=False),
    16: dict(locked=True, waves=1, naked_pairs=False),
}
CHUNK = 4
CUT = 6  # a step budget that leaves boards RUNNING at both sizes
FIELDS = ("grid", "solved", "status", "guesses", "validations")


def boards_of(size, offset=0):
    name, n = CORPUS[size]
    with np.load(os.path.join(BENCH, name)) as d:
        return d["boards"][offset: offset + n].astype(np.int32)


def jax_run(boards, path, **kw):
    size = boards.shape[-1]
    return jck.solve_batch_resumable(
        boards, checkpoint_path=str(path), chunk_iters=CHUNK, **{**KNOBS[size], **kw}
    )


def port_run(boards, path, **kw):
    size = boards.shape[-1]
    return tck.solve_batch_resumable(
        boards, checkpoint_path=str(path), chunk_iters=CHUNK, device="cpu",
        **{**KNOBS[size], **kw}
    )


def assert_rows_equal(want, got):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      np.asarray(getattr(got, f)), err_msg=f)
    assert int(want.iters) == int(got.iters)


@pytest.mark.parametrize("size", [9, 16])
def test_port_rows_and_snapshot_equal_the_jax_package(tmp_path, size):
    boards = boards_of(size)
    want = jax_run(boards, tmp_path / "jax.npz")
    got = port_run(boards, tmp_path / "port.npz")
    assert_rows_equal(want, got)
    assert int(want.status.min()) == 1  # every board solved
    assert not os.listdir(tmp_path)  # completed runs delete their snapshots
    # cut at the same step budget: both leave the same snapshot
    cut_j = jax_run(boards, tmp_path / "jax.npz", max_iters=CUT)
    cut_p = port_run(boards, tmp_path / "port.npz", max_iters=CUT)
    assert_rows_equal(cut_j, cut_p)
    assert int(cut_p.iters) == CUT and (np.asarray(cut_p.status) == 0).any()
    with np.load(tmp_path / "jax.npz") as zj, np.load(tmp_path / "port.npz") as zp:
        assert sorted(zj.files) == sorted(zp.files)
        for k in zj.files:
            assert zj[k].dtype == zp[k].dtype and zj[k].shape == zp[k].shape, k
            np.testing.assert_array_equal(zj[k], zp[k], err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("size", [9, 16])
def test_a_snapshot_resumes_across_packages(tmp_path, size, writer):
    """A run stopped at its budget by one package, resumed with a larger
    budget by the other: the JAX package's uninterrupted rows."""
    boards = boards_of(size)
    want = jax_run(boards, tmp_path / "ref.npz")
    path = tmp_path / "ck.npz"
    (jax_run if writer == "jax" else port_run)(boards, path, max_iters=CUT)
    assert path.exists()
    reader = port_run if writer == "jax" else jax_run
    assert_rows_equal(want, reader(boards, path))
    assert not path.exists()


def _refusal(run, boards, path, **kw):
    with pytest.raises(ValueError) as err:
        run(boards, path, **kw)
    return str(err.value)


@pytest.mark.parametrize("case", ["stale", "batch", "geometry", "config"])
def test_resume_refusals_match_the_jax_package(tmp_path, case):
    boards = boards_of(9)
    path = tmp_path / "ck.npz"
    for writer in (jax_run, port_run):
        writer(boards, path, max_iters=CUT)
        request, kw = boards, {}
        if case == "stale":
            request = boards_of(9, offset=10)
        elif case == "batch":
            request = boards[:-1]
        elif case == "geometry":
            request = boards_of(16)
        else:
            kw = dict(naked_pairs=True)
        msgs = [_refusal(reader, request, path, **kw) for reader in (jax_run, port_run)]
        assert msgs[0] == msgs[1]
        assert path.exists()  # a refused resume leaves the snapshot alone
        path.unlink()


def test_keep_checkpoint_sharding_and_the_default_device(tmp_path, monkeypatch):
    boards = boards_of(9)
    path = tmp_path / "ck.npz"
    port_run(boards, path, keep_checkpoint=True, max_iters=CUT)
    before = path.read_bytes()
    res = port_run(boards, path, keep_checkpoint=True)
    assert path.exists() and path.read_bytes() == before  # done: no new save
    assert int(res.status.min()) == 1
    with pytest.raises(NotImplementedError):
        tck.solve_batch_resumable(boards, checkpoint_path=str(tmp_path / "x.npz"),
                                  sharding=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tck.solve_batch_resumable(boards, checkpoint_path=str(tmp_path / "x.npz"))
    assert not (tmp_path / "x.npz").exists()


def test_each_chunk_is_one_segment_of_the_kernels_plain_version(tmp_path, monkeypatch):
    """A chunk goes through the segment kernels' wrapper (its plain
    version for a CPU pool): one ``dfs_segment`` call a chunk, every lane
    kept, the budget ``min(chunk_iters, max_iters - iters)``."""
    from sudoku_solver_distributed_tpu_torch.utils import checkpoint as mod

    calls = []

    def spy(pool, boards, src, seg_iters, **kw):
        calls.append((int(src.min()), int(src.max()), seg_iters))
        return dfs_segment(pool, boards, src, seg_iters, **kw)

    monkeypatch.setattr(mod, "dfs_segment", spy)
    res = port_run(boards_of(9), tmp_path / "ck.npz", max_iters=7)
    assert calls == [(-1, -1, 4), (-1, -1, 3)]
    assert int(res.iters) == 7 and (tmp_path / "ck.npz").exists()


def test_engine_folds_a_resumed_batch_once(tmp_path):
    """A batch cut at its budget, then resumed by a fresh engine (the
    process that was killed took its counters with it): the second engine
    counts the batch's whole effort once, equal to an uninterrupted run's,
    and answers the JAX engine's rows."""
    boards = boards_of(9)
    path = str(tmp_path / "ck.npz")
    jax_eng = JaxEngine(coalesce=False, buckets=(1, 8))
    want = jax_eng.solve_batch_resumable_np(boards, str(tmp_path / "j.npz"),
                                            chunk_iters=CHUNK)
    engines = [SolverEngine(device="cpu", buckets=(1, 8)) for _ in range(3)]
    try:
        killed, resumed, whole = engines
        killed.solve_batch_resumable_np(boards, path, chunk_iters=CHUNK, max_iters=CUT)
        assert os.path.exists(path)
        got = resumed.solve_batch_resumable_np(boards, path, chunk_iters=CHUNK)
        assert not os.path.exists(path)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
        assert resumed.validations == got[2]["validations"] == jax_eng.validations
        assert resumed.solved_puzzles == int(got[1].sum()) == jax_eng.solved_puzzles
        again = whole.solve_batch_resumable_np(boards, str(tmp_path / "w.npz"),
                                               chunk_iters=CHUNK)
        assert again[2] == got[2] and whole.validations == resumed.validations
    finally:
        for eng in engines:
            eng.close()
