"""The port stands alone: it imports neither ``jax`` nor the JAX package, its
entry points default to the GPU and raise without one, and the kernel's
wrapper refuses what the kernel does not take. The tests that need the card
(kernel against its plain version) are marked ``cuda`` and skip without
one; on the card, ``python -m pytest --noconftest -m cuda
tests/test_torch_isolation.py`` runs them (the suite's conftest imports
JAX) and ``python3 chip_smoke.py`` runs the full comparison.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from sudoku_solver_distributed_tpu_torch.ops import spec_for_size
from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import (
    _dfs_solver_plain,
    dfs_race,
    dfs_solver,
    solve_batch_cuda,
)
from sudoku_solver_distributed_tpu_torch.ops.solver import solve_batch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(ROOT, "sudoku_solver_distributed_tpu_torch")

IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import sudoku_solver_distributed_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from sudoku_solver_distributed_tpu_torch.utils.profiling import (
    RequestMetrics, annotate, device_trace,
)
from sudoku_solver_distributed_tpu_torch.obs import RouteMetrics, Tracer
assert RequestMetrics is RouteMetrics
from sudoku_solver_distributed_tpu_torch import Sudoku, SudokuSolver
from sudoku_solver_distributed_tpu_torch.api import Sudoku as S2
from sudoku_solver_distributed_tpu_torch.net import FastHTTPServer
from sudoku_solver_distributed_tpu_torch.net import SudokuSolver as SS2
from sudoku_solver_distributed_tpu_torch.net.http_api import (
    CACHE_BATCH_MAX, MAX_BATCH, MAX_BATCH_BYTES, solve_batch_route,
)
from sudoku_solver_distributed_tpu_torch.utils import (
    render_board, render_board_highlight_zeros,
)
assert Sudoku is S2 and SudokuSolver is SS2
leaked = [n for n in sys.modules
          if n.split(".")[0] == "sudoku_solver_distributed_tpu"]
assert not leaked, leaked
assert sys.modules["jax"] is None
print(" ".join(names))
"""

# modules the import check must reach by name (walk_packages finds every
# module; these are the ones a later slice added and must not lose)
REQUIRED = (
    "cache", "cache.canonical", "cache.store", "serving.health",
    "utils.faults", "net.http_api", "engine", "utils.profiling", "obs",
    "obs.trace", "obs.histo", "obs.prom", "obs.flight", "obs.export",
    "obs.cost", "obs.slo", "net.fastserve", "net.solver_api", "api",
    "utils.render", "net.peermap", "cache.gossip", "obs.cluster",
    "serving.autopilot", "parallel.frontier", "compilecache",
    "compilecache.store", "utils.checkpoint", "native", "models.generator",
)

# the default transport without JAX, on the plain solver: a /solve_batch
# and two /solve requests on one keep-alive connection of a CLI node
SERVE_WITHOUT_JAX = r"""
import http.client, json, sys, time
sys.modules["jax"] = None
from sudoku_solver_distributed_tpu_torch.models import oracle_is_valid_solution
from sudoku_solver_distributed_tpu_torch.net import cli
from sudoku_solver_distributed_tpu_torch.net.fastserve import FastHTTPServer
import threading
board = [[0] * 9 for _ in range(9)]
board[0][0] = 5
args = cli.build_parser().parse_args(
    ["-p", "0", "-s", "0", "--platform", "cpu", "--buckets", "1,8",
     "--batch-api", "--no-answer-cache"])
node, httpd = cli.build_node(args)
assert isinstance(httpd, FastHTTPServer)
threading.Thread(target=httpd.serve_forever, daemon=True).start()
deadline = time.monotonic() + 60
while not node.engine.fully_warmed and time.monotonic() < deadline:
    time.sleep(0.05)
conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=60)
conn.request("POST", "/solve_batch", json.dumps({"sudokus": [board, board]}))
r = conn.getresponse()
body = json.loads(r.read())
assert r.status == 200 and body["solved"] == 2, body
assert all(oracle_is_valid_solution(s) for s in body["solutions"])
for _ in range(2):
    conn.request("POST", "/solve", json.dumps({"sudoku": board}))
    r = conn.getresponse()
    assert r.status == 200 and r.version == 11 and not r.will_close
    assert oracle_is_valid_solution(json.loads(r.read()))
httpd.shutdown()
node.autopilot.close()
node.shutdown()
node.engine.close()
leaked = [n for n in sys.modules
          if n.split(".")[0] == "sudoku_solver_distributed_tpu"]
assert not leaked, leaked
print("ok")
"""

# the observability plane without JAX: a span, a torch.profiler capture
# through utils/profiling.device_trace, and the Prometheus rendering
OBS_WITHOUT_JAX = r"""
import json, os, sys, tempfile
sys.modules["jax"] = None
import torch
from sudoku_solver_distributed_tpu_torch.obs import FlightRecorder, Tracer
from sudoku_solver_distributed_tpu_torch.obs.prom import render
from sudoku_solver_distributed_tpu_torch.utils.profiling import (
    annotate, device_trace,
)
tracer = Tracer(recorder=FlightRecorder())
t = tracer.start("/solve")
t.mark("device", 0.002)
rec = tracer.finish(t, 200)
assert rec["device_ms"] == 2.0
out = tempfile.mkdtemp()
with device_trace(out), annotate("probe"):
    torch.ones(8).sum()
(name,) = os.listdir(out)
doc = json.load(open(os.path.join(out, name)))
assert "probe" in {e.get("name") for e in doc["traceEvents"]}
text = render({"obs": tracer.snapshot()}, tracer.stages.histograms())
assert 'sudoku_stage_latency_ms_count{stage="device"} 1' in text
leaked = [n for n in sys.modules
          if n.split(".")[0] == "sudoku_solver_distributed_tpu"]
assert not leaked, leaked
print("ok")
"""


# the compile plane, a resumable batch and the generator without JAX, on
# the plain solver: the native oracle and the engine's store under one
# compile cache, a batch cut at its budget and resumed by a second engine
PLANE_WITHOUT_JAX = r"""
import os, sys, tempfile
sys.modules["jax"] = None
from sudoku_solver_distributed_tpu_torch import native
from sudoku_solver_distributed_tpu_torch.compilecache import enable_persistent_cache
from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
from sudoku_solver_distributed_tpu_torch.models import (
    generate_batch, oracle_is_valid_solution,
)
root = tempfile.mkdtemp()
assert enable_persistent_cache(root)
boards = generate_batch(4, 45, seed=3, unique=True)
assert str(native.native_store().root) == os.path.join(root, "native")
engines = [SolverEngine(device="cpu", buckets=(1, 8), compile_cache_dir=root)
           for _ in range(2)]
engines[0].warmup()
assert engines[0].warm_info()["aot"] == {"loaded": 0, "saved": 0, "errors": 0}
ck = os.path.join(root, "batch.npz")
engines[0].solve_batch_resumable_np(boards, ck, chunk_iters=1, max_iters=2)
assert os.path.exists(ck)
sols, mask, info = engines[1].solve_batch_resumable_np(boards, ck, chunk_iters=2)
assert mask.all() and not os.path.exists(ck)
assert all(oracle_is_valid_solution(s.tolist()) for s in sols)
assert engines[1].validations == info["validations"] > 0
for eng in engines:
    eng.close()
leaked = [n for n in sys.modules
          if n.split(".")[0] == "sudoku_solver_distributed_tpu"]
assert not leaked, leaked
print("ok")
"""


def test_port_and_chip_smoke_import_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", IMPORT_ALL], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 25  # every module of the port
    missing = [m for m in REQUIRED
               if f"sudoku_solver_distributed_tpu_torch.{m}" not in names]
    assert not missing


def test_obs_plane_and_device_trace_run_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", OBS_WITHOUT_JAX], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["ok"]


def test_batch_api_and_keepalive_serve_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", SERVE_WITHOUT_JAX], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["ok"]


def test_compile_plane_resumable_batch_and_generator_run_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", PLANE_WITHOUT_JAX], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["ok"]


def test_no_import_line_names_jax_or_the_jax_package():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|sudoku_solver_distributed_tpu)(\.|\s|$)"
    )
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tools", "dfs_solver_ab.py"),
             os.path.join(ROOT, "tools", "serving_ab.py"),
             os.path.join(ROOT, "tools", "profiler_edge.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    hits = [
        f"{path}:{i}"
        for path in files
        for i, line in enumerate(open(path, encoding="utf-8"), 1)
        if pattern.match(line)
    ]
    assert not hits


@pytest.mark.parametrize(
    "argv",
    [["chip_smoke.py"], ["tools/dfs_solver_ab.py", "_archive/parent_dfs_solver.cu"],
     ["tools/serving_ab.py", "_archive/parent"], ["tools/profiler_edge.py"]],
)
def test_chip_scripts_fail_without_a_card_and_print_no_result(argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the script would run")
    proc = subprocess.run(
        [sys.executable, *argv], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_solve_batch_cuda_defaults_to_the_gpu(monkeypatch):
    """An array (no device given) goes to CUDA; with no card that raises
    rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default would succeed")
    boards = np.zeros((1, 9, 9), np.int32)
    with pytest.raises((RuntimeError, AssertionError)):
        solve_batch_cuda(boards, spec_for_size(9))


@pytest.mark.parametrize(
    "boards, error",
    [
        (np.zeros((2, 81), np.int32), TypeError),            # not a tensor
        (torch.zeros((2, 81), dtype=torch.int64), TypeError),  # wrong dtype
        (torch.zeros((2, 80), dtype=torch.int32), ValueError),  # wrong cells
        (torch.zeros((2, 9, 9), dtype=torch.int32), ValueError),  # not flat
        (torch.zeros((2, 81), dtype=torch.int32, device="meta"), ValueError),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(boards, error):
    before = dfs_solver.launches
    with pytest.raises(error):
        dfs_solver(boards, spec_for_size(9), 32, 4096)
    assert dfs_solver.launches == before


def test_wrapper_rejects_bad_depth():
    with pytest.raises(ValueError):
        dfs_solver(torch.zeros((1, 81), dtype=torch.int32), spec_for_size(9), 0, 8)


@pytest.mark.parametrize(
    "states, error",
    [
        (np.zeros((2, 81), np.int32), TypeError),              # not a tensor
        (torch.zeros((2, 81), dtype=torch.int64), TypeError),  # wrong dtype
        (torch.zeros((2, 80), dtype=torch.int32), ValueError),  # wrong cells
        (torch.zeros((0, 81), dtype=torch.int32), ValueError),  # no state
        (torch.zeros((2, 81), dtype=torch.int32, device="meta"), ValueError),
    ],
)
def test_race_wrapper_rejects_what_the_kernel_does_not_take(states, error):
    before = dfs_race.launches
    with pytest.raises(error):
        dfs_race(states, spec_for_size(9), 81, 64)
    assert dfs_race.launches == before


class _FakeRaceLibrary:
    """Stands in for the kernel library in the race wrapper's launch: says
    where a box's stack lives, records each launch's arguments and returns
    ``error``."""

    def __init__(self, on_chip_max_box=3, error=0):
        self.on_chip_max_box = on_chip_max_box
        self.error = error
        self.calls = []

    def dfs_race_stack_on_chip(self, box):
        return int(box <= self.on_chip_max_box) if 2 <= box <= 5 else -1

    def dfs_race_launch(self, *args):
        self.calls.append(args)
        return self.error


@pytest.fixture
def fake_cuda_stream(monkeypatch):
    """The race wrapper's launch on CPU tensors: no device to enter, and a
    current stream whose handle the test sets."""
    import contextlib
    import types

    stream = types.SimpleNamespace(cuda_stream=101)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: stream)
    return stream


def test_race_scratch_is_one_idle_buffer_per_device_and_stream():
    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import (
        RACE_SCRATCH_IDLE,
        race_scratch,
    )

    cpu = torch.device("cpu")
    a = race_scratch(cpu, 7001)
    assert a.dtype == torch.int32 and a.tolist() == list(RACE_SCRATCH_IDLE)
    assert race_scratch(cpu, 7001) is a
    assert race_scratch(cpu, 7002) is not a
    assert race_scratch(torch.device("meta"), 7001) is not a
    # idle: no stop step posted (0xffffffff), no ticket taken
    assert a.view(torch.uint32)[0].item() == 0xFFFFFFFF and a[1].item() == 0


def test_race_stack_in_slab_asks_the_library():
    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import race_stack_in_slab

    lib = _FakeRaceLibrary(on_chip_max_box=3)
    assert [race_stack_in_slab(lib, b) for b in (2, 3, 4, 5)] == [False, False, True, True]
    lib = _FakeRaceLibrary(on_chip_max_box=4)
    assert race_stack_in_slab(lib, 4) is False
    with pytest.raises(ValueError):
        race_stack_in_slab(lib, 6)


@pytest.mark.parametrize("size, depth, slab", [(4, 16, False), (9, 81, False),
                                               (9, 200, False), (16, 256, True),
                                               (25, 700, True)])
def test_race_launch_passes_a_slab_only_off_chip_and_the_stream_scratch(
        fake_cuda_stream, size, depth, slab):
    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import (
        _launch_race,
        race_scratch,
    )

    spec = spec_for_size(size)
    states = torch.zeros((3, spec.cells), dtype=torch.int32)
    lib = _FakeRaceLibrary()
    before = dfs_race.launches
    row, fold, meta = _launch_race(lib, states, spec, depth, 64, 1, 1)
    assert dfs_race.launches == before + 1
    assert row.shape == (spec.cells + 3,) and fold.shape == (3, 2) and meta.shape == (3, 4)
    (args,) = lib.calls
    stack, stop = args[5:8], args[8]
    M, box, D = args[9:12]
    assert (M, box) == (3, spec.box)
    assert D == min(depth, spec.cells)  # no search holds C frames
    assert all(p is not None for p in stack) if slab else stack == (None,) * 3
    assert stop == race_scratch(states.device, 101).data_ptr()
    assert args[-1] == 101
    # another stream gets a scratch of its own; a given scratch is used as is
    fake_cuda_stream.cuda_stream = 102
    _launch_race(lib, states, spec, depth, 64, 1, 1)
    assert lib.calls[1][8] == race_scratch(states.device, 102).data_ptr() != stop
    own = torch.tensor([-1, 0], dtype=torch.int32)
    _launch_race(lib, states, spec, depth, 64, 1, 1, slab=True, scratch=own)
    assert lib.calls[2][8] == own.data_ptr() and None not in lib.calls[2][5:8]


def test_race_launch_error_raises_and_counts_nothing(fake_cuda_stream):
    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import (
        KernelLaunchError,
        _launch_race,
    )

    before = dfs_race.launches
    with pytest.raises(KernelLaunchError):
        _launch_race(_FakeRaceLibrary(error=1), torch.zeros((2, 81), dtype=torch.int32),
                     spec_for_size(9), 81, 64, 3, 1)
    assert dfs_race.launches == before


def _race_sets():
    """Seeded states of deep boards, as the frontier route races them:
    9x9 in its serving configuration at 64 states, 16x16 and 25x25 at 8,
    and a capped 9x9 race."""
    from sudoku_solver_distributed_tpu_torch.parallel import frontier as F

    deep9 = np.load(os.path.join(ROOT, "benchmarks", "corpus_9x9_deep_128.npz"))["boards"]
    deep16 = np.load(os.path.join(
        ROOT, "benchmarks", "corpus_16x16_deep_anneal_64.npz"))["boards"]
    deep25 = np.load(os.path.join(
        ROOT, "benchmarks", "corpus_25x25_deep_anneal_32.npz"))["boards"]
    out = []
    for size, board, target, waves, max_iters in (
        (9, deep9[0], 64, 3, 65536), (9, deep9[3], 64, 3, 65536),
        (9, deep9[0], 64, 3, 40), (16, deep16[0], 8, 1, 65536),
        (25, deep25[31], 8, 1, 65536),
    ):
        spec = spec_for_size(size)
        states, early = F.seed_frontier(board, spec, target=target, locked=True)
        assert early is None
        states = F.bucket_states(states, spec, target)
        out.append((spec, states.reshape(len(states), -1), waves, max_iters))
    return out


@pytest.mark.cuda
def test_race_kernel_matches_plain_on_the_card():
    """K4 (which folds in its last block) against the plain lockstep race
    on seeded deep states: the packed row and every state's status and
    validations exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import _dfs_race_plain
    from sudoku_solver_distributed_tpu_torch.ops.solver import fold_race

    for spec, states, waves, max_iters in _race_sets():
        knobs = dict(locked_candidates=True, waves=waves, naked_pairs=False)
        cpu = torch.as_tensor(states)
        row, fold, _ = _dfs_race_plain(cpu, spec, spec.max_depth, max_iters, **knobs)
        before = dfs_race.launches
        krow, kfold, kmeta = dfs_race(cpu.cuda(), spec, spec.max_depth, max_iters, **knobs)
        torch.cuda.synchronize()
        assert dfs_race.launches == before + 1
        assert torch.equal(krow.cpu(), row) and torch.equal(kfold.cpu(), fold)


@pytest.mark.cuda
def test_race_kernel_exits_early_on_the_card():
    """A race stops soon after its first solve: the steps K4's blocks ran
    in all fall short of the sum of each state's steps to its own end (K1
    over the same states, every state to its own end)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    spec, states, waves, max_iters = _race_sets()[0]
    knobs = dict(locked_candidates=True, waves=waves, naked_pairs=False)
    g = torch.as_tensor(states).cuda()
    row, _, meta = dfs_race(g, spec, spec.max_depth, max_iters, **knobs)
    _, own = dfs_solver(g, spec, spec.max_depth, max_iters, **knobs)
    torch.cuda.synchronize()
    assert int(row[spec.cells]) == 1
    raced, to_end = int(meta[:, 1].sum()), int(own[:, 3].sum())
    assert raced < to_end, (raced, to_end)


def _race_set_of_size(size):
    """One seeded race per box size, in the configuration a node of that
    size races with: a one-clue 4x4 board at 8 states (raced as 16), a
    deep 9x9 board at 64 (128), deep 16x16 and 25x25 boards at 8."""
    from sudoku_solver_distributed_tpu_torch.parallel import frontier as F

    if size == 4:
        board = np.zeros((4, 4), np.int32)
        board[0, 0] = 1
        target, knobs = 8, dict(locked_candidates=True, waves=1, naked_pairs=True)
    else:
        name, k, target = {9: ("corpus_9x9_deep_128", 0, 64),
                           16: ("corpus_16x16_deep_anneal_64", 0, 8),
                           25: ("corpus_25x25_deep_anneal_32", 31, 8)}[size]
        board = np.load(os.path.join(ROOT, "benchmarks", f"{name}.npz"))["boards"][k]
        knobs = dict(locked_candidates=True, waves=3 if size == 9 else 1,
                     naked_pairs=False)
    spec = spec_for_size(size)
    states, early = F.seed_frontier(board, spec, target=target, locked=True)
    assert early is None
    states = F.bucket_states(states, spec, target)
    return spec, torch.as_tensor(states.reshape(len(states), -1)), knobs


@pytest.mark.cuda
@pytest.mark.parametrize("size", [4, 9, 16, 25])
def test_race_kernel_matches_plain_and_k1_at_every_box_size(size):
    """K4 against the plain lockstep race at box edges 2-5, in one launch
    that leaves the stream's scratch idle; and every state whose K4 run
    ended (not RUNNING) by t* has the status, steps and validations K1
    gives it run to its own end."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import (
        RACE_SCRATCH_IDLE,
        _dfs_race_plain,
        race_scratch,
    )

    spec, cpu, knobs = _race_set_of_size(size)
    row, fold, meta = _dfs_race_plain(cpu, spec, spec.max_depth, 65536, **knobs)
    g = cpu.cuda()
    before = dfs_race.launches
    krow, kfold, kmeta = dfs_race(g, spec, spec.max_depth, 65536, **knobs)
    _, own = dfs_solver(g, spec, spec.max_depth, 65536, **knobs)
    torch.cuda.synchronize()
    assert dfs_race.launches == before + 1
    assert torch.equal(krow.cpu(), row) and torch.equal(kfold.cpu(), fold)
    scratch = race_scratch(g.device, torch.cuda.current_stream().cuda_stream)
    assert scratch.tolist() == list(RACE_SCRATCH_IDLE)
    t_star = int(meta[:, 1].max())
    kmeta, own = kmeta.cpu(), own.cpu()
    ended = (kmeta[:, 0] != 0) & (kmeta[:, 1] <= t_star)
    assert bool(ended.any())
    assert torch.equal(kmeta[ended][:, 0], own[ended][:, 0])
    assert torch.equal(kmeta[ended][:, 1], own[ended][:, 3])
    assert torch.equal(kmeta[ended][:, 2], own[ended][:, 2])


@pytest.mark.cuda
def test_races_back_to_back_and_on_two_streams_match_plain():
    """A race that posts an early stop, then on the same stream one that
    must run past it (the scratch was reset); then the two at once on two
    CUDA streams (each has a scratch of its own)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import _dfs_race_plain

    from sudoku_solver_distributed_tpu_torch.parallel import frontier as F

    spec, short, knobs = _race_set_of_size(9)  # t* 7
    readme = np.zeros((9, 9), np.int32)  # the README board: t* 31 at 64 states
    readme[0, 3], readme[1, 3], readme[1, 4], readme[2, 5] = 1, 3, 2, 9
    readme[3, 7], readme[5, 3], readme[6, 6], readme[7, 8] = 7, 9, 9, 3
    long_, early = F.seed_frontier(readme, spec, target=64, locked=True)
    assert early is None
    long_ = torch.as_tensor(F.bucket_states(long_, spec, 64).reshape(-1, spec.cells))
    plain = [_dfs_race_plain(s, spec, 81, 65536, **knobs) for s in (short, long_)]
    assert int(plain[0][2][:, 1].max()) < int(plain[1][2][:, 1].max())
    got = [dfs_race(s.cuda(), spec, 81, 65536, **knobs) for s in (short, long_)]
    torch.cuda.synchronize()
    for (krow, kfold, _), (row, fold, _) in zip(got, plain):
        assert torch.equal(krow.cpu(), row) and torch.equal(kfold.cpu(), fold)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    inputs = [s.cuda() for s in (short, long_)]
    got = []
    for st, g in zip(streams, inputs):
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            got.append(dfs_race(g, spec, 81, 65536, **knobs))
    torch.cuda.synchronize()
    for (krow, kfold, _), (row, fold, _) in zip(got, plain):
        assert torch.equal(krow.cpu(), row) and torch.equal(kfold.cpu(), fold)


@pytest.mark.cuda
def test_a_race_is_one_kernel_record():
    """torch.profiler sees one kernel a race, the race kernel: no fold
    kernel and no memset."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from torch.profiler import ProfilerActivity, profile

    spec, cpu, knobs = _race_set_of_size(9)
    g = cpu.cuda()
    dfs_race(g, spec, spec.max_depth, 65536, **knobs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(10_000_000)  # keeps the races clear of the window's edge
        for _ in range(4):
            dfs_race(g, spec, spec.max_depth, 65536, **knobs)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages() if e.device_time_total > 0}
    names = {n for n in names if "spin_kernel" not in n}
    assert len(names) == 1 and "dfs_race_kernel" in names.pop()


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    """Build the kernel, launch it on 256 hard boards and the degenerate
    shapes, and hold it against the plain version on the same CUDA
    tensors (the full set runs in chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    with np.load(os.path.join(ROOT, "benchmarks", "corpus_9x9_hard_4096.npz")) as d:
        boards = d["boards"][:256].astype(np.int32)
    boards[0] = 0                        # empty: overflows the 32-frame stage
    boards[1, 0, 0] = boards[1, 0, 1] = 0
    boards[1, 0, 0] = boards[1, 0, 2] = 5
    boards[2, 4, 4] = 36                 # out of range
    spec = spec_for_size(9)
    g = torch.as_tensor(boards, device="cuda")
    before = dfs_solver.launches
    k = solve_batch_cuda(g, spec, max_depth=(32, 81))
    p = solve_batch(g, spec, max_depth=(32, 81))
    torch.cuda.synchronize()
    assert dfs_solver.launches >= before + 2  # both stages launched
    for f in ("grid", "status", "guesses", "validations"):
        assert torch.equal(getattr(k, f), getattr(p, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 33])
def test_kernel_matches_plain_at_partial_block_widths(width):
    """The kernel runs one board per warp, four warps per block: B = 1 (the
    /solve bucket) leaves three warps of its block idle, and B = 33 ends in
    a block with one board. Both depth stages equal the plain version,
    the per-board step counts' maximum included."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from chip_smoke import README_PUZZLE

    with np.load(os.path.join(ROOT, "benchmarks", "corpus_9x9_hard_4096.npz")) as d:
        boards = d["boards"][:width].astype(np.int32)
    boards[0] = README_PUZZLE
    spec = spec_for_size(9)
    flat = torch.as_tensor(boards.reshape(width, -1), device="cuda").contiguous()
    for depth in (32, 81):
        before = dfs_solver.launches
        grid, meta = dfs_solver(flat, spec, depth, 4096)
        pgrid, pmeta = _dfs_solver_plain(flat, spec, depth, 4096)
        torch.cuda.synchronize()
        assert dfs_solver.launches == before + 1
        assert torch.equal(grid, pgrid)
        assert torch.equal(meta[:, :3], pmeta[:, :3])  # status, guesses, validations
        assert int(meta[:, 3].max()) == int(pmeta[0, 3])


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 33])
@pytest.mark.parametrize(
    "sweeps",
    [
        dict(locked_candidates=True, waves=3, naked_pairs=False),
        dict(locked_candidates=True, waves=3, naked_pairs=True),
        dict(locked_candidates=True, waves=3, light_waves=True,
             naked_pairs=False),
    ],
    ids=["serving", "pairs", "light"],
)
def test_serving_sweeps_match_plain_on_the_card(width, sweeps):
    """The kernel's locked-candidate pass, naked pairs and extra sweeps at
    the /solve width and at a partial block, against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from chip_smoke import README_PUZZLE

    with np.load(os.path.join(ROOT, "benchmarks", "corpus_9x9_hard_4096.npz")) as d:
        boards = d["boards"][:width].astype(np.int32)
    boards[0] = README_PUZZLE
    spec = spec_for_size(9)
    flat = torch.as_tensor(boards.reshape(width, -1), device="cuda").contiguous()
    for depth in (32, 81):
        grid, meta = dfs_solver(flat, spec, depth, 4096, **sweeps)
        pgrid, pmeta = _dfs_solver_plain(flat, spec, depth, 4096, **sweeps)
        torch.cuda.synchronize()
        assert torch.equal(grid, pgrid)
        assert torch.equal(meta[:, :3], pmeta[:, :3])
        assert int(meta[:, 3].max()) == int(pmeta[0, 3])


@pytest.mark.cuda
def test_golden_counters_on_the_card():
    """The kernel under ``serving_config(9)`` on all 256 deep-union boards
    meets tests/golden_counters.json exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    import json

    from sudoku_solver_distributed_tpu_torch.ops.config import serving_config

    with open(os.path.join(ROOT, "tests", "golden_counters.json")) as f:
        golden = json.load(f)
    with np.load(os.path.join(ROOT, "benchmarks", golden["corpus"])) as d:
        boards = d["boards"].astype(np.int32)
    cfg = {**serving_config(9), "max_iters": golden["config"]["max_iters"]}
    res = solve_batch_cuda(torch.as_tensor(boards, device="cuda"), spec_for_size(9), **cfg)
    assert int(res.solved.sum()) == golden["solved"] == len(boards)
    assert int(res.guesses.sum()) == golden["guesses"]
    assert int(res.validations.sum()) == golden["validations"]


@pytest.mark.cuda
@pytest.mark.parametrize("max_iters", [None, 6])
def test_engine_on_the_card_matches_the_cpu_engine(max_iters):
    """The engine's CUDA path — dispatch without a host sync, the OVERFLOW
    stage and (with ``max_iters=6``) the deep retry on the side stream,
    and a coalesced batch of fixed composition — gives the CPU engine's
    answers and counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from sudoku_solver_distributed_tpu_torch.engine import SolverEngine

    with np.load(os.path.join(ROOT, "benchmarks", "corpus_9x9_hard_4096.npz")) as d:
        boards = d["boards"][:14].astype(np.int32)
    boards[0] = 0                        # empty: overflows the 32-frame stage
    boards[1] = 0
    boards[1, 0, 0] = boards[1, 0, 1] = 4  # conflict
    kw = dict(buckets=(1, 8, 64), max_iters=max_iters, coalesce_max_wait_s=5.0,
              coalesce_max_batch=8, continuous=False)
    gpu = SolverEngine(device="cuda", **kw)
    cpu = SolverEngine(device="cpu", **kw)
    try:
        want, got = cpu.solve_batch_np(boards), gpu.solve_batch_np(boards)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
        want = [f.result(timeout=300) for f in [cpu.coalescer.submit(b) for b in boards[:8]]]
        got = [f.result(timeout=300) for f in [gpu.coalescer.submit(b) for b in boards[:8]]]
        assert got == want
        assert gpu.coalescer.stats()["batch_fill_max"] == 8
        assert gpu.validations == cpu.validations
    finally:
        gpu.close()
        cpu.close()


def _hard(n):
    with np.load(os.path.join(ROOT, "benchmarks", "corpus_9x9_hard_4096.npz")) as d:
        return d["boards"][:n].astype(np.int32)


@pytest.mark.cuda
def test_segment_kernels_match_plain_on_the_card():
    """The segment kernels (K3, K3b) against their plain version segment by
    segment on 64 lanes of hard boards, ragged budgets and seeded
    rotations, both block forms: state (stack frames below each lane's
    depth), digest and block. The full sets run in chip_smoke.py."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from sudoku_solver_distributed_tpu_torch.ops import solver as ts
    from sudoku_solver_distributed_tpu_torch.ops.config import serving_config
    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import (
        SegmentPool, _dfs_segment_plain, dfs_segment,
    )

    spec = spec_for_size(9)
    sweeps = {k: serving_config(9)[k]
              for k in ("locked_candidates", "waves", "naked_pairs")}
    rng = np.random.default_rng(11)
    stock = torch.as_tensor(_hard(96).reshape(96, -1), device="cuda")
    for prefix in (True, False):
        pool = SegmentPool.fresh(ts.pad_board(spec, "cuda").expand(64, 9, 9), spec, 81)
        plain = ts.SegmentState(*(t.clone() for t in pool.state))
        src = torch.arange(64, dtype=torch.int32, device="cuda")
        before = dfs_segment.launches
        for seg in range(40):
            k = (3, 7, 1, 13)[seg % 4]
            pool, kd, kb = dfs_segment(pool, stock, src, k, prefix_gather=prefix, **sweeps)
            plain, pd, pb = _dfs_segment_plain(plain, stock, src, k, spec, prefix, **sweeps)
            torch.cuda.synchronize()
            for f in ("grid", "depth", "status", "guesses", "validations", "board_iters"):
                assert torch.equal(getattr(pool.state, f), getattr(plain, f)), f
            live = torch.arange(81, device="cuda")[None, :] < plain.depth.long()[:, None]
            for f in ("stack_grid", "stack_cell", "stack_mask"):
                assert torch.equal(getattr(pool.state, f)[live], getattr(plain, f)[live]), f
            assert torch.equal(kd, pd) and torch.equal(kb, pb)
            src = torch.as_tensor(
                rng.choice([-1, -1, -1, -2, 5, 50, 90], size=64).astype(np.int32),
                device="cuda",
            )
        assert dfs_segment.launches == before + 40


@pytest.mark.cuda
@pytest.mark.parametrize("width, live", [(4096, 1), (4096, 16), (64, 5)],
                         ids=["4096-1-live", "4096-16-live", "64-idle-masked"])
def test_segment_kernels_with_idle_lanes_match_plain_on_the_card(width, live):
    """A pool whose other lanes have finished, as a lone /solve or a few
    concurrent clients leave the serving pool: the pad lanes finish in a
    first segment, then ``live`` lanes scattered over the pool board hard
    boards and run segments until they solve, every idle lane kept. The 4096 pools
    prefix-gather their block (the digest kernel copies it); the 64 pool
    masks it (the segment kernel writes every lane's row, zeros for the
    idle ones). State, digest and block must equal the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from sudoku_solver_distributed_tpu_torch.ops import solver as ts
    from sudoku_solver_distributed_tpu_torch.ops.config import (
        segment_prefix_gather, serving_config,
    )
    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import (
        SegmentPool, _dfs_segment_plain, dfs_segment,
    )

    spec = spec_for_size(9)
    sweeps = {k: serving_config(9)[k]
              for k in ("locked_candidates", "waves", "naked_pairs")}
    prefix = segment_prefix_gather(width, spec.cells)
    assert prefix == (width == 4096)
    stock = torch.as_tensor(_hard(64).reshape(64, -1), device="cuda")
    lanes = np.random.default_rng(width + live).choice(width, live, replace=False)
    pool = SegmentPool.fresh(ts.pad_board(spec, "cuda").expand(width, 9, 9), spec, 81)
    plain = ts.SegmentState(*(t.clone() for t in pool.state))
    keep = torch.full((width,), -1, dtype=torch.int32, device="cuda")
    inject = keep.clone()
    inject[torch.as_tensor(lanes, device="cuda")] = torch.arange(
        live, dtype=torch.int32, device="cuda")
    gathered = 0
    for seg, (src, k) in enumerate([(keep, 1), (inject, 8), (keep, 3), (keep, 512)]):
        pool, kd, kb = dfs_segment(pool, stock, src, k, prefix_gather=prefix, **sweeps)
        plain, pd, pb = _dfs_segment_plain(plain, stock, src, k, spec, prefix, **sweeps)
        torch.cuda.synchronize()
        for f in ("grid", "depth", "status", "guesses", "validations", "board_iters"):
            assert torch.equal(getattr(pool.state, f), getattr(plain, f)), (seg, f)
        below = torch.arange(81, device="cuda")[None, :] < plain.depth.long()[:, None]
        for f in ("stack_grid", "stack_cell", "stack_mask"):
            assert torch.equal(getattr(pool.state, f)[below],
                               getattr(plain, f)[below]), (seg, f)
        assert torch.equal(kd, pd) and torch.equal(kb, pb), seg
        gathered += int((kd[:, 5] >= 0).sum())
    assert gathered == live  # every live lane solved, and its row was placed


@pytest.mark.cuda
def test_continuous_engine_on_the_card_matches_the_cpu_engine():
    """The default engine on the card (continuous, pool 64, pipelined and
    full-row arms) answers as the CPU engine does, counters included."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from chip_smoke import README_PUZZLE
    from sudoku_solver_distributed_tpu_torch.engine import SolverEngine

    boards = np.concatenate([_hard(14), np.asarray(README_PUZZLE, np.int32)[None]])
    for pipeline in (True, False):
        kw = dict(buckets=(1, 8, 64), segment_pipeline=pipeline)
        gpu = SolverEngine(device="cuda", **kw)
        cpu = SolverEngine(device="cpu", **kw)
        try:
            got = [f.result(timeout=300) for f in [gpu.solve_one_async(b) for b in boards]]
            want = [f.result(timeout=300) for f in [cpu.solve_one_async(b) for b in boards]]
            assert got == want
            assert gpu.validations == cpu.validations
        finally:
            gpu.close()
            cpu.close()


@pytest.mark.cuda
def test_solve_batch_route_on_the_card_matches_solve_batch_np():
    """POST /solve_batch on a card node (default transport, continuous
    segment driver beside it) answers the rows ``solve_batch_np`` gives on
    a fresh card engine for the same boards."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    import http.client
    import json
    import threading
    import time

    from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
    from sudoku_solver_distributed_tpu_torch.net import cli

    boards = _hard(256)
    args = cli.build_parser().parse_args(
        ["-p", "0", "-s", "0", "--buckets", "1,8,64,512", "--batch-api",
         "--no-answer-cache"]
    )
    node, httpd = cli.build_node(args)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    fresh = SolverEngine(buckets=(1, 8, 64, 512))
    try:
        deadline = time.monotonic() + 300
        while not node.engine.fully_warmed and time.monotonic() < deadline:
            time.sleep(0.05)
        assert node.engine.fully_warmed
        conn = http.client.HTTPConnection(
            "127.0.0.1", httpd.server_address[1], timeout=300
        )
        conn.request("POST", "/solve_batch",
                     json.dumps({"sudokus": boards.tolist()}))
        resp = conn.getresponse()
        body = json.loads(resp.read())
        assert resp.status == 200
        sols, mask, info = fresh.solve_batch_np(boards)
        want = [s.tolist() if ok else None for s, ok in zip(sols, mask)]
        assert body["solutions"] == want
        assert body["solved"] == int(mask.sum())
        assert body["capped"] == info["capped"]
    finally:
        httpd.shutdown()
        node.shutdown()
        node.engine.close()
        fresh.close()


@pytest.mark.cuda
def test_two_node_cluster_on_the_card_farms_as_the_single_node_engine():
    """Two in-process port nodes on the card, the second joined through the
    first: a 9-hole board sent to the joiner is farmed cell by cell to the
    anchor, whose engine solves each on the card, and the answer equals the
    single-node engine's (the board has one solution)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    import socket
    import threading
    import time

    from chip_smoke import README_PUZZLE
    from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
    from sudoku_solver_distributed_tpu_torch.net.node import P2PNode

    cpu = SolverEngine(device="cpu", buckets=(1,))
    try:
        full, _ = cpu.solve_one(README_PUZZLE)
    finally:
        cpu.close()
    board = [list(r) for r in full]
    for k in range(9):
        board[(k * 7) % 9][(k * 4 + 1) % 9] = 0
    engines = [SolverEngine(buckets=(1, 8)) for _ in range(2)]
    nodes, threads, anchor = [], [], None
    try:
        for eng in engines:
            eng.warmup()
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            node = P2PNode("127.0.0.1", port, anchor_node=anchor,
                           handicap=0.0, engine=eng)
            anchor = anchor or node.id
            nodes.append(node)
            threads.append(threading.Thread(target=node.run, daemon=True))
            threads[-1].start()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not all(
                n.membership.total_peers() for n in nodes):
            time.sleep(0.05)
        assert all(n.membership.total_peers() for n in nodes)
        single, _ = engines[0].solve_one(board)
        before = engines[0].validations
        assert nodes[1].peer_sudoku_solve(board) == single == full
        assert engines[0].validations > before  # the anchor did the work
        assert engines[1].cost.snapshot()["farm"]["dispatches"] >= 9
    finally:
        for n in nodes:
            n.shutdown()
        for t in threads:
            t.join(timeout=10)
        for eng in engines:
            eng.close()


@pytest.mark.cuda
def test_resumable_batch_on_the_card_matches_the_plain_version(tmp_path):
    """Checkpointed chunks on the card (one K3 segment each) against their
    plain version on the CPU: cut at a budget, resumed with a larger one,
    and uninterrupted, every row and ``iters`` equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import dfs_segment
    from sudoku_solver_distributed_tpu_torch.utils.checkpoint import (
        solve_batch_resumable,
    )

    boards = _hard(64)
    knobs = dict(locked=True, waves=3, naked_pairs=False, chunk_iters=2)
    runs = {}
    for device in ("cpu", "cuda"):
        path = str(tmp_path / f"{device}.npz")
        before = dfs_segment.launches
        cut = solve_batch_resumable(boards, checkpoint_path=path, max_iters=3,
                                    device=device, **knobs)
        assert os.path.exists(path) and cut.iters == 3
        runs[device] = (cut, solve_batch_resumable(
            boards, checkpoint_path=path, device=device, **knobs))
        assert not os.path.exists(path)
        if device == "cuda":
            assert dfs_segment.launches > before + 2
    for got, want in zip(runs["cuda"], runs["cpu"]):
        for f in ("grid", "solved", "status", "guesses", "validations"):
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
        assert got.iters == want.iters
