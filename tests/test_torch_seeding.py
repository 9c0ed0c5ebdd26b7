"""The frontier race's seeding in the port held against the JAX package's,
on the CPU.

The seeding kernel's wrapper (``ops/cuda_solver.seed_frontier_cuda``, K5 on
a card) runs its plain version on a CPU tensor: the host rounds of
``ops/solver.seed_rounds``. Every case feeds the same numpy states
to it and to the JAX package's ``seed_frontier`` (its jitted seeding
programs on JAX's CPU backend) and compares the seeded states, their count
and the solution exactly (tolerance 0: integers): deep 9x9 corpus boards at
64, the README board at 512, 16x16, 25x25 and 4x4 boards, the probe's
handoff states, an UNSAT root, boards solved during seeding, locked
candidates on and off, and a round limit that runs out. ``seed_frontier``
itself (``device="cpu"``), its default device (CUDA: it raises here), and
``frontier_solve``'s ``info`` on the CPU beside JAX's. The kernel against
the plain version runs on the card (``tests/test_torch_isolation.py``'s
``cuda`` tests, ``chip_smoke.py`` phase 11 (e)).
"""

import jax
import numpy as np
import pytest
import torch

from sudoku_solver_distributed_tpu.models import generate_batch
from sudoku_solver_distributed_tpu.ops import spec_for_size as jax_spec_for_size
from sudoku_solver_distributed_tpu.parallel import frontier as JF
from sudoku_solver_distributed_tpu.parallel.mesh import default_mesh
from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
from sudoku_solver_distributed_tpu_torch.models import oracle_is_valid_solution
from sudoku_solver_distributed_tpu_torch.ops import spec_for_size
from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import seed_frontier_cuda
from sudoku_solver_distributed_tpu_torch.parallel import frontier as TF

README = np.array([
    [0, 0, 0, 1, 0, 0, 0, 0, 0],
    [0, 0, 0, 3, 2, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 9, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 7, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, 0, 9, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 9, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 3],
    [0, 0, 0, 0, 0, 0, 0, 0, 0],
], np.int32)


def _corpus(name):
    return np.load(f"benchmarks/{name}.npz")["boards"]


DEEP9 = _corpus("corpus_9x9_deep_128")
DEEP16 = _corpus("corpus_16x16_deep_anneal_64")
DEEP25 = _corpus("corpus_25x25_deep_anneal_32")


def _unsat_root():
    board = np.zeros((9, 9), np.int32)
    board[0, 0] = board[0, 1] = 5  # two clashing clues
    return board


def _unsat_after_singles():
    # no clash among the clues, but the forced singles leave a dead cell
    board = np.zeros((9, 9), np.int32)
    board[0] = [0, 0, 2, 3, 4, 5, 6, 7, 8]
    board[1, 0] = 1
    board[2, 1] = 1
    return board


def _one_clue_4x4():
    board = np.zeros((4, 4), np.int32)
    board[0, 0] = 1
    return board


def _wrapper(states, size, target, locked, max_rounds=None):
    """The wrapper on a CPU tensor: (states (K, N, N), solution, header)."""
    spec = spec_for_size(size)
    states = np.asarray(states, np.int32)
    flat = torch.from_numpy(np.ascontiguousarray(states.reshape(len(states), spec.cells)))
    rounds = spec.cells + 16 if max_rounds is None else max_rounds
    out, solved, header = seed_frontier_cuda(flat, spec, target, rounds, locked)
    assert out.dtype == torch.int32 and out.device.type == "cpu"
    solution = None if solved is None else solved.numpy().reshape(spec.size, spec.size)
    return out.numpy().reshape(-1, spec.size, spec.size), solution, header


def _assert_same_seeding(port, jax_out, board=None):
    (ts, te), (js, je) = port, jax_out
    assert ts.shape == js.shape  # the count: every seeded state, padding included
    assert np.array_equal(ts, js)
    assert (te is None) == (je is None)
    if je is not None:
        assert np.array_equal(te, np.asarray(je))
        assert oracle_is_valid_solution(te.tolist())
        if board is not None:
            clues = np.asarray(board) > 0
            assert (te[clues] == np.asarray(board)[clues]).all()


CASES = [
    # (name, size, board, target, locked)
    *[(f"deep9-{k}-locked", 9, DEEP9[k], 64, True) for k in range(4)],
    *[(f"deep9-{k}", 9, DEEP9[k], 64, False) for k in range(2)],
    ("readme-512-locked", 9, README, 512, True),
    ("readme-512", 9, README, 512, False),
    ("hexadoku-8", 16, DEEP16[0], 8, True),
    ("hexadoku-64-solved", 16, DEEP16[1], 64, True),
    ("25x25-8", 25, DEEP25[8], 8, True),
    ("4x4-one-clue", 4, _one_clue_4x4(), 8, True),
    ("4x4-empty", 4, np.zeros((4, 4), np.int32), 4, False),
    ("unsat-root", 9, _unsat_root(), 64, True),
    ("unsat-after-singles", 9, _unsat_after_singles(), 8, False),
    ("easy-solved", 9, generate_batch(1, 25, seed=4)[0], 64, False),
    ("deep9-5-512-solved", 9, DEEP9[5], 512, True),
]


@pytest.mark.parametrize("name, size, board, target, locked", CASES,
                         ids=[c[0] for c in CASES])
def test_wrapper_on_the_cpu_seeds_as_jax(name, size, board, target, locked):
    js, je = JF.seed_frontier(np.asarray(board), jax_spec_for_size(size),
                              target=target, locked=locked)
    ts, te, header = _wrapper(np.asarray(board)[None], size, target, locked)
    assert header is None  # the plain version has no kernel header
    _assert_same_seeding((ts, te), (js, je), board)
    if name.endswith("solved"):
        assert te is not None
    if name.startswith("unsat"):
        assert len(ts) == target and te is None


@pytest.mark.parametrize("locked", [False, True])
@pytest.mark.parametrize("board, iters", [(README, 4), (DEEP9[0], 64)],
                         ids=["readme-4", "deep9-0-64"])
def test_wrapper_from_handoff_states_seeds_as_jax(locked, board, iters):
    """The probe→race handoff: the states of a K3 probe's unexplored
    subtrees (``state_handoff_frontier``) are the first round's batch."""
    eng = SolverEngine(device="cpu", buckets=(1,), frontier_mesh="auto",
                       frontier_escalate_iters=iters)
    try:
        _, pool = eng._quick_state(np.asarray(board, np.int32))
        seeds = TF.state_handoff_frontier(pool.state, spec_for_size(9))
    finally:
        eng.close()
    assert len(seeds) > 1
    js, je = JF.seed_frontier(None, JF.SPEC_9, target=32, locked=locked,
                              initial_states=seeds)
    ts, te, _ = _wrapper(seeds, 9, 32, locked)
    _assert_same_seeding((ts, te), (js, je))
    tss, tse = TF.seed_frontier(None, spec_for_size(9), target=32, locked=locked,
                                initial_states=seeds, device="cpu")
    _assert_same_seeding((tss, tse), (js, je))


@pytest.mark.parametrize("max_rounds", [0, 1, 3])
def test_wrapper_pads_when_the_rounds_run_out_as_jax(max_rounds):
    js, je = JF.seed_frontier(README, JF.SPEC_9, target=64, locked=True,
                              max_rounds=max_rounds)
    ts, te, _ = _wrapper(README[None], 9, 64, True, max_rounds)
    _assert_same_seeding((ts, te), (js, je))
    assert len(ts) == 64


ENTRY_CASES = [c for c in CASES if c[0] in (
    "deep9-0-locked", "readme-512-locked", "hexadoku-8", "unsat-root", "easy-solved")]


@pytest.mark.parametrize("name, size, board, target, locked", ENTRY_CASES,
                         ids=[c[0] for c in ENTRY_CASES])
def test_seed_frontier_on_the_cpu_equals_jax(name, size, board, target, locked):
    js, je = JF.seed_frontier(np.asarray(board), jax_spec_for_size(size),
                              target=target, locked=locked)
    ts, te = TF.seed_frontier(np.asarray(board), spec_for_size(size), target=target,
                              locked=locked, device="cpu")
    assert isinstance(ts, np.ndarray) and ts.dtype == np.int32
    _assert_same_seeding((ts, te), (js, je), board)


def test_seed_frontier_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default would succeed")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TF.seed_frontier(README, spec_for_size(9), target=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TF.warm_seeding(spec_for_size(9), 8)


def test_seed_wrapper_rejects_what_the_kernel_does_not_take():
    spec = spec_for_size(9)
    ok = torch.zeros((1, 81), dtype=torch.int32)
    with pytest.raises(ValueError):
        seed_frontier_cuda(ok, spec, 0, 97)
    with pytest.raises(ValueError):
        seed_frontier_cuda(ok, spec, 8, -1)
    with pytest.raises(ValueError):
        seed_frontier_cuda(ok.reshape(1, 9, 9), spec, 8, 97)


@pytest.fixture(scope="module")
def mesh1():
    return default_mesh(jax.devices()[:1])


@pytest.mark.parametrize("name, board, kw", [
    ("deep9-0", DEEP9[0], dict(states_per_device=64, locked=True, waves=3,
                               naked_pairs=False)),
    ("seeding-solves", DEEP9[5], dict(states_per_device=512, locked=True,
                                      naked_pairs=False)),
    ("unsat", _unsat_root(), dict(states_per_device=8)),
], ids=["deep9-0", "seeding-solves", "unsat"])
def test_frontier_solve_info_on_the_cpu_equals_jax(mesh1, name, board, kw):
    """Seeding on the mesh's first device (the CPU here) leaves
    ``frontier_solve``'s answer and ``info`` (``seeded``, ``validations``,
    ``handoff``, ``capped``) those of the JAX package."""
    jsol, jinfo = JF.frontier_solve(board, mesh1, JF.SPEC_9, max_depth=(32, 81), **kw)
    tsol, tinfo = TF.frontier_solve(board, "cpu", spec_for_size(9), max_depth=(32, 81),
                                    **kw)
    assert tsol == jsol and tinfo == jinfo
    if name == "seeding-solves":
        assert tinfo["validations"] == 0 and tsol is not None


def test_bucket_states_pads_with_the_jax_pad_board():
    """The race's rung: the seeded states, then the JAX package's
    instantly-UNSAT pad board up to 64 × 2^k, as an int32 tensor where the
    states lie; an array pads the same, and a full rung is kept as it is."""
    spec = spec_for_size(9)
    states, _ = TF.seed_frontier(DEEP9[0], spec, target=64, locked=True, device="cpu")
    got = TF.bucket_states(torch.from_numpy(states), spec, 64)
    assert got.dtype == torch.int32 and len(got) == 128 > len(states)
    assert np.array_equal(got[:len(states)].numpy(), states)
    pad = np.broadcast_to(JF._unsat_pad(JF.SPEC_9), (128 - len(states), 9, 9))
    assert np.array_equal(got[len(states):].numpy(), pad)
    assert torch.equal(TF.bucket_states(states, spec, 64), got)
    assert torch.equal(TF.bucket_states(got, spec, 64), got)
