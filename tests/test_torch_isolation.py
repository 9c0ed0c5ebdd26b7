"""The port stands alone: it imports neither ``jax`` nor the JAX package, its
entry points default to the GPU and raise without one, and the kernel's
wrapper refuses what the kernel does not take. The tests that need the card
(kernel against its plain version) are marked ``cuda`` and skip without
one; on the card, ``python -m pytest --noconftest -m cuda
tests/test_torch_isolation.py`` runs them (the suite's conftest imports
JAX) and ``python3 chip_smoke.py`` runs the full comparison.
"""

import json
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
from sudoku_solver_distributed_tpu_torch.parallel import (
    FrontierServingLoop, Mesh, data_sharding, default_mesh, make_packed_serving_program,
    make_sharded_solver, virtual_mesh,
)
from sudoku_solver_distributed_tpu_torch.parallel.sim import run_json, run_py
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
    "parallel.mesh", "parallel.shard", "parallel.serving_loop", "parallel.sim",
    "parallel.relay",
    "analysis", "analysis.__main__", "analysis.callgraph", "analysis.locks",
    "analysis.seams", "analysis.threadctx", "analysis.torch_hygiene",
    "analysis.wire_schema", "analysis.runner", "analysis.sarif",
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


# the port's static gate without JAX: `python -m ...analysis --strict
# --json` as the CLI runs it; the gate is pure stdlib-ast, so it imports
# neither the JAX package nor torch
GATE_WITHOUT_JAX = r"""
import runpy, sys
sys.modules["jax"] = None
sys.argv[1:] = ["--strict", "--json"]
try:
    runpy.run_module("sudoku_solver_distributed_tpu_torch.analysis",
                     run_name="__main__")
finally:
    leaked = sorted(n for n in sys.modules if n.split(".")[0] in
                    ("sudoku_solver_distributed_tpu", "torch", "jax"))
    print("LEAKED", leaked, file=sys.stderr)
"""


def test_static_gate_runs_strict_without_jax_or_torch():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", GATE_WITHOUT_JAX], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "LEAKED ['jax']" in proc.stderr  # only the None placeholder
    body = json.loads(proc.stdout)
    assert body["errors"] == [] and body["stale_baseline"] == []
    assert body["suppressed"]
    shapes = body["contract_matrix"]["shapes"]
    assert len(shapes) == 5 and all(all(s["covered"].values()) for s in shapes)


def test_static_gate_cli_strict_exit_codes():
    env = dict(os.environ, PYTHONPATH=ROOT)
    gate = [sys.executable, "-m", "sudoku_solver_distributed_tpu_torch.analysis",
            "--strict"]
    ok = subprocess.run(gate, cwd=ROOT, env=env, capture_output=True,
                        text=True, timeout=120)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "0 error(s)" in ok.stdout
    red = subprocess.run(gate + ["--baseline", "none"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert red.returncode == 1
    assert "LOCK102" in red.stdout


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
             os.path.join(ROOT, "tools", "profiler_edge.py"),
             os.path.join(ROOT, "tools", "mesh_multi_gpu.py")]
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
     ["tools/serving_ab.py", "_archive/parent"], ["tools/profiler_edge.py"],
     ["tools/mesh_multi_gpu.py"]],
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

    def dfs_race_shards_launch(self, *args):
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


class _FakeSeedLibrary:
    """Stands in for the kernel library in the seeding wrapper's launch:
    records each launch's arguments, writes ``header`` into the header
    buffer (a marker row into the output, and when a state solved another
    marker, ``SOLUTION_MARK`` above the first, after the header's words, as
    the kernel writes the solved row there), and returns ``error``.
    ``seed_clusters``: the clusters a box edge's kernel fits on the card,
    as ``load_library`` records them."""

    SOLUTION_MARK = 1000

    def __init__(self, header, error=0, clusters=1):
        self.header = header
        self.error = error
        self.calls = []
        self.seed_clusters = {box: clusters for box in (2, 3, 4, 5)}

    def seed_frontier_launch(self, *args):
        import ctypes

        self.calls.append(args)
        out, header = args[1], args[4]
        C = args[7] ** 4
        if self.error == 0:
            h = torch.tensor(self.header, dtype=torch.int32)
            ctypes.memmove(header, h.data_ptr(), h.numel() * 4)
            row = torch.arange(C, dtype=torch.int32)
            for k in range(self.header[0]):
                src = row + k
                ctypes.memmove(out + k * C * 4, src.data_ptr(), C * 4)
            if self.header[1] >= 0:
                src = row + self.header[1] + self.SOLUTION_MARK
                ctypes.memmove(header + h.numel() * 4, src.data_ptr(), C * 4)
        return self.error


@pytest.mark.parametrize("solved", [False, True])
def test_seed_launch_passes_its_buffers_and_reads_the_header(fake_cuda_stream, solved):
    """The seeding wrapper's launch on CPU tensors against a stand-in
    library: the state buffers hold ``max(M, target * N)`` rows rounded up
    to a power of two, the scratch is the stream's (``seed_scratch``: rows
    and 4-column state records), the header buffer holds the header's words
    and a row, the options carry naked pairs with locked candidates, and
    the header's count, solved index, rounds and states analyzed come back
    with the solution read from the header buffer's row (the one copy), not
    from the seeded states."""
    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import (
        OPT_LOCKED,
        OPT_PAIRS,
        _launch_seed,
        _seed_launch,
        seed_capacity,
        seed_frontier_cuda,
        seed_scratch,
    )

    spec = spec_for_size(9)
    states = torch.zeros((3, 81), dtype=torch.int32)
    header = [5, 2 if solved else -1, 9, 40, 1 if solved else 0]
    lib = _FakeSeedLibrary(header)
    before = seed_frontier_cuda.launches
    out, solution, info = _launch_seed(lib, states, spec, 64, 97, True)
    assert seed_frontier_cuda.launches == before + 1
    (args,) = lib.calls
    cap = seed_capacity(3, 64, spec)
    assert cap == 1024 and seed_capacity(2000, 8, spec) == 2048
    assert args[0] == states.data_ptr()
    nxt, records = seed_scratch(states.device, 101, 3, cap)
    assert args[2:4] == (nxt.data_ptr(), records.data_ptr())
    assert nxt.shape == (cap, 81) and records.shape == (cap, 4)
    assert args[5:11] == (3, cap, 3, 64, 97, OPT_LOCKED | OPT_PAIRS) and args[-1] == 101
    assert out.shape == (5, 81) and torch.equal(out[4], torch.arange(81) + 4)
    assert info == {"count": 5, "first": header[1], "rounds": 9, "analyzed": 40,
                    "outcome": "solved" if solved else "target"}
    if solved:
        assert torch.equal(solution, torch.arange(81, dtype=torch.int32) + 2
                           + _FakeSeedLibrary.SOLUTION_MARK)
    else:
        assert solution is None
    # unlocked: no option bit; another stream gets a scratch of its own
    fake_cuda_stream.cuda_stream = 102
    _launch_seed(lib, states, spec, 64, 97, False)
    assert lib.calls[1][10] == 0
    assert lib.calls[1][2] == seed_scratch(states.device, 102, 3, cap)[0].data_ptr()
    assert lib.calls[1][2] != nxt.data_ptr()
    # the launch step alone: the header buffer holds the header's words and a row
    seeded, head = _seed_launch(lib, states, spec, 64, 97, True)
    assert seeded.shape == (cap, 81) and head.shape == (5 + 81,)
    assert lib.calls[2][4] == head.data_ptr()


def test_seed_launch_error_raises_and_counts_nothing(fake_cuda_stream):
    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import (
        KernelLaunchError,
        _launch_seed,
        seed_frontier_cuda,
    )

    before = seed_frontier_cuda.launches
    with pytest.raises(KernelLaunchError):
        _launch_seed(_FakeSeedLibrary([0] * 5, error=1),
                     torch.zeros((1, 81), dtype=torch.int32), spec_for_size(9), 8, 97, True)
    assert seed_frontier_cuda.launches == before


@pytest.mark.parametrize("clusters", [
    pytest.param(0, id="no-cluster-fits"),
    pytest.param(-2, id="occupancy-query-error"),
])
def test_seed_launch_without_a_cluster_raises_and_launches_nothing(fake_cuda_stream,
                                                                   clusters):
    """A card that holds no cluster of the seeding kernel for the box edge
    (the occupancy recorded at library load is 0, or its query failed with
    a cudaError) raises ``KernelLaunchError`` before any launch: nothing is
    launched or counted, and nothing falls back to the host rounds."""
    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import (
        KernelLaunchError,
        _launch_seed,
        seed_frontier_cuda,
    )

    lib = _FakeSeedLibrary([1, -1, 1, 1, 0], clusters=clusters)
    before = seed_frontier_cuda.launches
    with pytest.raises(KernelLaunchError, match="cluster"):
        _launch_seed(lib, torch.zeros((1, 81), dtype=torch.int32), spec_for_size(9), 8, 97,
                     True)
    assert seed_frontier_cuda.launches == before and lib.calls == []


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
def test_seed_wrapper_rejects_what_the_kernel_does_not_take(states, error):
    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import seed_frontier_cuda

    before = seed_frontier_cuda.launches
    with pytest.raises(error):
        seed_frontier_cuda(states, spec_for_size(9), 8, 97)
    assert seed_frontier_cuda.launches == before


class _FakeStream:
    """A shard's stream for the shard launch on CPU tensors: its handle,
    and the streams it was made to wait for, in order."""

    def __init__(self, handle, log):
        self.cuda_stream = handle
        self.log = log

    def wait_stream(self, other):
        self.log.append((self.cuda_stream, other.cuda_stream))


@pytest.mark.parametrize("size, slab, layout", [
    pytest.param(size, slab, layout, id=f"{size}-{slab}" + ("" if layout == "device"
                                                            else f"-{layout}"))
    for layout in ("device", "peer", "host") for size, slab in ((9, False), (25, True))
])
def test_shard_race_launch_is_one_call_for_every_shard(monkeypatch, size, slab, layout):
    """The shard launches of a race across shards go to the library in one
    call: each shard's states, grids, records (rows of one (n M, 4) tensor
    on shard 0's device, except under the host layout), slab (off chip
    only), its stop words, the layout number and, under the host layout,
    the race's slots, device and stream; with ``fold`` the row and fold
    the last block writes, with ``clock`` its address. The library
    launches every shard's blocks at once under the device layout (one
    launch counted) and a launch a shard under the others (one each),
    none of K4's one-shard form; the streams join both ways after it; an
    error raises and counts none."""
    import contextlib
    import threading

    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import (
        RACE_SCRATCH_IDLE,
        KernelLaunchError,
        RaceSlots,
        _launch_race_shards,
        dfs_race_shards,
    )

    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    spec = spec_for_size(size)
    joins = []
    streams = [_FakeStream(201 + i, joins) for i in range(3)]
    states = [torch.zeros((2, spec.cells), dtype=torch.int32) for _ in range(3)]
    word = torch.tensor(RACE_SCRATCH_IDLE, dtype=torch.int32)
    words = (word,) * 3 if layout == "device" else tuple(
        torch.tensor(RACE_SCRATCH_IDLE, dtype=torch.int32) for _ in range(3))
    slots = RaceSlots(layout, words, threading.Lock(),
                      *((4242, 1) if layout == "host" else ()))
    lib = _FakeRaceLibrary()
    before, one_shard = dfs_race_shards.launches, dfs_race.launches
    outs = _launch_race_shards(lib, states, spec, spec.cells, 64, 1, 1, slots, streams,
                               False)
    launches = 1 if layout == "device" else 3
    assert dfs_race_shards.launches == before + launches and len(lib.calls) == 1
    assert dfs_race.launches == one_shard
    assert [(tuple(m.shape), tuple(g.shape)) for m, g in outs] == [((2, 4), (2, spec.cells))] * 3
    (args,) = lib.calls
    n, inputs, grids, metas, sg, sc, sm, stop, fold, row, slot_ptr, clock, code = args[:13]
    assert n == 3 and (fold, row, clock) == (None, None, None)
    assert code == ("device", "peer", "host").index(layout)
    assert slot_ptr == (4242 if layout == "host" else None)
    assert list(inputs) == [t.data_ptr() for t in states]
    assert list(metas) == [m.data_ptr() for m, _ in outs]
    if layout != "host":  # shard i's records: rows 2i.. of one tensor
        assert [m.data_ptr() - outs[0][0].data_ptr() for m, _ in outs] == [0, 32, 64]
    assert list(grids) == [g.data_ptr() for _, g in outs]
    assert all(p is not None for p in list(sg) + list(sc) + list(sm)) == slab
    assert list(stop) == [w.data_ptr() for w in words]
    assert list(args[14]) == [201, 202, 203]
    assert args[15:17] == (2, spec.box)
    # shard 0's stream waits for every other, then every other for it
    assert joins == [(201, 202), (201, 203), (202, 201), (203, 201)]
    if layout != "host":
        clock = torch.zeros((6, 3), dtype=torch.int64)
        row, fold, meta = _launch_race_shards(lib, states, spec, spec.cells, 64, 1, 1,
                                              slots, streams, True, clock)
        assert row.shape == (spec.cells + 3,) and fold.shape == (6, 2)
        assert meta.shape == (6, 4)
        assert lib.calls[1][8:10] == (fold.data_ptr(), row.data_ptr())
        assert lib.calls[1][11] == clock.data_ptr()
        assert lib.calls[1][3][0] == meta.data_ptr()
    else:
        # no launch folds under the host layout: the fold kernel does
        with pytest.raises(ValueError):
            dfs_race_shards(states, spec, spec.cells, 64, streams=streams, slots=slots,
                            fold=True)
    counted = dfs_race_shards.launches
    with pytest.raises(KernelLaunchError):
        _launch_race_shards(_FakeRaceLibrary(error=1), states, spec, spec.cells, 64, 1, 1,
                            slots, streams, False)
    assert dfs_race_shards.launches == counted


def test_race_slots_idle_writes_every_word_through_the_host_address():
    """``RaceSlots.idle`` sets each shard's stop words to the idle words
    (the one set once when the shards share it) and each of the race's
    slots to the idle word through their host address, and nothing past
    them."""
    import ctypes
    import threading

    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import (
        RACE_SCRATCH_IDLE,
        RACE_SLOT_IDLE,
        RaceSlots,
    )

    slots_words = (ctypes.c_uint32 * 5)(7, 3, 40, 9, 11)
    words = tuple(torch.tensor([5, 17, 9], dtype=torch.int32) for _ in range(4))
    slots = RaceSlots("host", words, threading.Lock(), address=1,
                      host=ctypes.addressof(slots_words))
    slots.idle()
    assert list(slots_words) == [RACE_SLOT_IDLE] * 4 + [11]
    assert all(w.tolist() == list(RACE_SCRATCH_IDLE) for w in words)
    shared = torch.tensor([2, 64, 7], dtype=torch.int32)
    RaceSlots("device", (shared,) * 4, threading.Lock()).idle()
    assert shared.tolist() == list(RACE_SCRATCH_IDLE)


@pytest.mark.parametrize("fail_sync", [False, True])
def test_a_race_that_raised_waits_for_its_shards_then_idles_its_slots(fail_sync):
    """``_idle_after``: every shard's end is waited for before the slots
    go idle, and they go idle even when a wait raises (a device fault)."""
    from sudoku_solver_distributed_tpu_torch.parallel.frontier import _idle_after

    seen = []

    class End:
        def __init__(self, k):
            self.k = k

        def synchronize(self):
            seen.append(self.k)
            if fail_sync and self.k == 1:
                raise RuntimeError("CUDA error: an illegal memory access")

    class Slots:
        def idle(self):
            seen.append("idle")

    if fail_sync:
        with pytest.raises(RuntimeError):
            _idle_after(Slots(), [End(0), End(1), End(2)])
        assert seen == [0, 1, "idle"]
    else:
        _idle_after(Slots(), [End(0), End(1), End(2)])
        assert seen == [0, 1, 2, "idle"]


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
        states = F.bucket_states(states, spec, target).numpy()
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


def _seeding_sets():
    """(spec, states, target, locked) of the seeding kernel's card test:
    deep 9x9 boards at 64 locked and not, the README board at 512, a
    handoff-like batch of three deep boards, 16x16 and 25x25 deep boards
    at 8, a 4x4 board with one clue, an UNSAT root, and a board the
    seeding solves."""
    def board(name, k):
        return np.load(os.path.join(ROOT, "benchmarks", name))["boards"][k]

    deep9 = [board("corpus_9x9_deep_128.npz", k) for k in range(6)]
    readme = np.zeros((9, 9), np.int32)
    readme[0, 3], readme[1, 3], readme[1, 4], readme[2, 5] = 1, 3, 2, 9
    readme[3, 7], readme[5, 3], readme[6, 6], readme[7, 8] = 7, 9, 9, 3
    unsat = np.zeros((9, 9), np.int32)
    unsat[0, 0] = unsat[0, 1] = 5
    one = np.zeros((4, 4), np.int32)
    one[0, 0] = 1
    sets = [(9, deep9[0][None], 64, True), (9, deep9[1][None], 64, False),
            (9, readme[None], 512, True), (9, np.stack(deep9[:3]), 16, True),
            (16, board("corpus_16x16_deep_anneal_64.npz", 0)[None], 8, True),
            (25, board("corpus_25x25_deep_anneal_32.npz", 8)[None], 8, True),
            (4, one[None], 8, True), (9, unsat[None], 64, True),
            (9, deep9[5][None], 512, True)]
    return [(spec_for_size(size), torch.as_tensor(states.reshape(len(states), -1)),
             target, locked) for size, states, target, locked in sets]


@pytest.mark.cuda
def test_seeding_kernel_matches_plain_on_the_card():
    """K5 (one launch a seeding) against the plain host rounds on the
    same states: the seeded states, their count and the solution exactly;
    then two threads seeding at once on two CUDA streams (each with a
    scratch of its own), every result equal to the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    import threading

    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import (
        _seed_frontier_plain,
        seed_frontier_cuda,
    )

    sets = _seeding_sets()
    plain = [_seed_frontier_plain(s, spec, target, spec.cells + 16, locked)[:2]
             for spec, s, target, locked in sets]
    outcomes = set()
    for (spec, s, target, locked), (pstates, psolved) in zip(sets, plain):
        before = seed_frontier_cuda.launches
        kstates, ksolved, header = seed_frontier_cuda(s.cuda(), spec, target,
                                                      spec.cells + 16, locked)
        assert seed_frontier_cuda.launches == before + 1
        assert kstates.is_cuda and torch.equal(kstates.cpu(), pstates)
        assert (ksolved is None) == (psolved is None)
        if psolved is not None:
            assert torch.equal(ksolved.cpu(), psolved)
        assert header["count"] == len(pstates) and header["rounds"] >= 1
        outcomes.add(header["outcome"])
    assert outcomes == {"target", "solved", "dead"}
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    results, errors = {}, []

    def seed_on(k):
        try:
            with torch.cuda.stream(streams[k]):
                for j in range(k, len(sets), 2):
                    spec, s, target, locked = sets[j]
                    results[j] = seed_frontier_cuda(s.cuda(), spec, target,
                                                    spec.cells + 16, locked)[:2]
        except BaseException as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=seed_on, args=(k,)) for k in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    assert not errors, errors
    for j, (pstates, psolved) in enumerate(plain):
        kstates, ksolved = results[j]
        assert torch.equal(kstates.cpu(), pstates)
        assert (ksolved is None) == (psolved is None)


def _seed_beside_a_segment(sets):
    """Each of ``sets`` seeded on the current stream while a K3 segment over
    4096 hard boards (512 steps, every lane busy) runs on another stream:
    the seeding cluster launched beside a card full of K3's warps. Returns
    the seedings' ``(states, solved)`` and whether the segment's pool and
    digest equal the same segment's run alone."""
    from sudoku_solver_distributed_tpu_torch.ops.config import (
        segment_prefix_gather, serving_config,
    )
    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import (
        SegmentPool, dfs_segment, seed_frontier_cuda,
    )

    spec9 = spec_for_size(9)
    sweeps = {k: serving_config(9)[k] for k in ("locked_candidates", "waves", "naked_pairs")}
    boards = torch.as_tensor(np.tile(_hard(64), (64, 1, 1)), device="cuda")
    keep = torch.full((len(boards),), -1, dtype=torch.int32, device="cuda")
    stock = boards[:1].reshape(1, -1)
    prefix = segment_prefix_gather(len(boards), spec9.cells)

    def segment():
        pool = SegmentPool.fresh(boards, spec9, 81)
        pool, digest, _ = dfs_segment(pool, stock, keep, 512, prefix_gather=prefix, **sweeps)
        return pool.state.grid, pool.state.status, digest

    alone = segment()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        beside = segment()
    seeded = [seed_frontier_cuda(s.cuda(), spec, target, spec.cells + 16, locked)[:2]
              for spec, s, target, locked in sets]
    torch.cuda.synchronize()
    return seeded, all(torch.equal(a, b) for a, b in zip(alone, beside))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["16x16 deep @1024", "beside a K3 segment"])
def test_seeding_kernel_matches_plain_wide_and_beside_a_segment(case):
    """K5 against the plain host rounds, exactly, where the cluster is
    stretched: a wide seeding (a 16x16 deep board at 1024 states, which the
    seeding solves, its rounds' ranges many states a block), and the
    seedings of ``_seeding_sets`` launched while a K3 segment fills the card
    from another stream (the segment's result unchanged by them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import (
        _seed_frontier_plain,
        seed_frontier_cuda,
    )

    if case == "16x16 deep @1024":
        board = np.load(os.path.join(ROOT, "benchmarks", "corpus_16x16_deep_anneal_64.npz"))
        sets = [(spec_for_size(16), torch.as_tensor(board["boards"][0].reshape(1, -1)),
                 1024, True)]
        got = [seed_frontier_cuda(s.cuda(), spec, target, spec.cells + 16, locked)[:2]
               for spec, s, target, locked in sets]
    else:
        sets = _seeding_sets()
        got, segment_same = _seed_beside_a_segment(sets)
        assert segment_same
    for (spec, s, target, locked), (kstates, ksolved) in zip(sets, got):
        pstates, psolved, _ = _seed_frontier_plain(s, spec, target, spec.cells + 16, locked)
        assert kstates.is_cuda and torch.equal(kstates.cpu(), pstates)
        assert (ksolved is None) == (psolved is None)
        if psolved is not None:
            assert torch.equal(ksolved.cpu(), psolved)


@pytest.mark.cuda
def test_seed_frontier_on_the_card_launches_the_kernel():
    """``seed_frontier`` with no device runs on the card: one K5 launch,
    the plain version's numpy states and solution."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import seed_frontier_cuda
    from sudoku_solver_distributed_tpu_torch.parallel import frontier as F

    for spec, s, target, locked in _seeding_sets()[:3]:
        board = s[0].reshape(spec.size, spec.size).numpy()
        before = seed_frontier_cuda.launches
        states, solved = F.seed_frontier(board, spec, target=target, locked=locked)
        assert seed_frontier_cuda.launches == before + 1
        want, wsolved = F.seed_frontier(board, spec, target=target, locked=locked,
                                        device="cpu")
        assert isinstance(states, np.ndarray) and np.array_equal(states, want)
        assert (solved is None) == (wsolved is None)


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
def test_a_seeding_is_one_kernel_record():
    """torch.profiler sees one kernel a seeding, the seeding kernel's one
    cluster launch: no copy, memset or other kernel beside it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from torch.profiler import ProfilerActivity, profile

    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import (
        _seed_launch,
        load_library,
    )

    spec, s, target, locked = _seeding_sets()[0]
    lib, g = load_library(), s.cuda()
    _seed_launch(lib, g, spec, target, spec.cells + 16, locked)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(10_000_000)  # keeps the seedings clear of the window's edge
        for _ in range(4):
            _seed_launch(lib, g, spec, target, spec.cells + 16, locked)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages() if e.device_time_total > 0}
    names = {n for n in names if "spin_kernel" not in n}
    assert len(names) == 1 and "seed_frontier_kernel" in names.pop()


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


# -- the mesh plane on the card: a 4-shard virtual mesh on cuda:0 --------------


def _mesh4():
    from sudoku_solver_distributed_tpu_torch.parallel.mesh import virtual_mesh

    return virtual_mesh("cuda:0", 4)


@pytest.mark.cuda
def test_virtual_mesh_bucket_program_matches_one_device_on_the_card():
    """The bucket program over 4 shards of cuda:0 (one K1 launch a shard,
    each on its own stream) against one K1 launch over the same batch:
    every per-board column of the packed rows, at the serving waves; and
    a shard's lockstep LoopStats from its boards' own steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import solve_stage_lockstep
    from sudoku_solver_distributed_tpu_torch.parallel.shard import (
        make_packed_serving_program,
    )

    spec = spec_for_size(9)
    boards = torch.as_tensor(_hard(256), device="cuda")
    program = make_packed_serving_program(_mesh4(), spec, max_depth=(32, 81),
                                          locked_candidates=True, waves=3,
                                          naked_pairs=False)
    before = dfs_solver.launches
    rows = program(boards, 4096)
    assert dfs_solver.launches >= before + 4
    assert program.last_split == {"devices": 4, "rows_per_device": 64}
    res = solve_batch_cuda(boards, spec, max_depth=(32, 81), locked_candidates=True,
                           waves=3, naked_pairs=False)
    C = spec.cells
    assert np.array_equal(rows[:, :C], res.grid.reshape(256, C).cpu().numpy())
    assert np.array_equal(rows[:, C + 1], res.status.cpu().numpy())
    assert np.array_equal(rows[:, C + 2], res.guesses.cpu().numpy())
    assert np.array_equal(rows[:, C + 3], res.validations.cpu().numpy())
    # the lockstep LoopStats: the shards' sums; each shard's lanes run
    # exactly the boards' own steps
    _, st = solve_stage_lockstep(boards[:64], spec, 32, 4096, locked_candidates=True,
                                 waves=3, naked_pairs=False)
    _, meta = dfs_solver(boards[:64].reshape(64, -1), spec, 32, 4096,
                         locked_candidates=True, waves=3, naked_pairs=False)
    steps = meta[:, 3].long()
    assert int(st.lane_steps) == 64 * int(steps.max())
    assert int(st.lane_steps) - int(st.idle_lane_steps) == int(steps.sum())


@pytest.mark.cuda
def test_virtual_mesh_segments_match_one_device_on_the_card():
    """The segment program over a 64-lane pool split into 4 shards of
    cuda:0 (one K3 + K3b launch a shard) against one segment launch over a
    64-lane pool: every lane's state and digest columns, segment by
    segment, with injections from the whole board stack."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from sudoku_solver_distributed_tpu_torch.ops import solver as ts
    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import SegmentPool, dfs_segment
    from sudoku_solver_distributed_tpu_torch.parallel.shard import (
        make_segment_serving_program,
    )

    spec = spec_for_size(9)
    sweeps = dict(locked_candidates=True, waves=3, naked_pairs=False)
    program = make_segment_serving_program(_mesh4(), spec, max_depth=81, **sweeps)
    mpool = program.new_pool(64)
    pool = SegmentPool.fresh(ts.pad_board(spec, "cuda").expand(64, 9, 9), spec, 81)
    stock = torch.as_tensor(_hard(96).reshape(96, -1), device="cuda")
    rng = np.random.default_rng(7)
    src = torch.arange(64, dtype=torch.int32, device="cuda")
    before = dfs_segment.launches
    for seg in range(24):
        k = (3, 7, 1, 13)[seg % 4]
        mpool, mdig, _ = program(mpool, stock, src, k, prefix_gather=False)
        pool, dig, _ = dfs_segment(pool, stock, src, k, prefix_gather=False, **sweeps)
        torch.cuda.synchronize()
        got = torch.cat(mdig)
        assert torch.equal(got[:, :5], dig[:, :5])
        # a shard's fetch slots index its own block: lane j of shard s
        # is the pool's lane 16 s + j
        local = got[:, 5].clone()
        offset = torch.arange(64, device="cuda") // 16 * 16
        assert torch.equal(torch.where(local >= 0, local + offset, -1), dig[:, 5])
        for f in ("grid", "status", "guesses", "validations", "board_iters"):
            assert torch.equal(torch.cat([getattr(p.state, f) for p in mpool.shards]),
                               getattr(pool.state, f)), f
        src = torch.as_tensor(
            rng.choice([-1, -1, -1, -2, 5, 50, 90], size=64).astype(np.int32),
            device="cuda",
        )
    assert dfs_segment.launches == before + 24 * 5


@pytest.mark.parametrize("layout", ["device", "host"])
def test_shard_race_launch_with_a_relay_passes_its_inbox_outbox_and_race(monkeypatch,
                                                                         layout):
    """A race across shards with a relay across hosts passes the library
    no fold, and the inbox's and the outbox's device addresses and the
    race's tag after the common arguments (a race without a relay passes
    null, null, 0 there). A fold with a relay raises: every host's records
    fold after the gather."""
    import contextlib
    import threading
    import types

    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import (
        RACE_SCRATCH_IDLE,
        RaceSlots,
        _launch_race_shards,
        dfs_race_shards,
    )

    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    spec = spec_for_size(9)
    joins = []
    streams = [_FakeStream(301 + i, joins) for i in range(2)]
    states = [torch.zeros((2, spec.cells), dtype=torch.int32) for _ in range(2)]
    words = tuple(torch.tensor(RACE_SCRATCH_IDLE, dtype=torch.int32) for _ in range(2))
    slots = RaceSlots(layout, words, threading.Lock(),
                      *((4242, 1) if layout == "host" else ()))
    relay = types.SimpleNamespace(race=7, tag=9, outbox=5151, inbox=6161)
    lib = _FakeRaceLibrary()
    before = dfs_race_shards.launches
    outs = _launch_race_shards(lib, states, spec, spec.cells, 64, 3, 1, slots, streams,
                               False, None, relay)
    assert len(outs) == 2 and dfs_race_shards.launches == before + (
        1 if layout == "device" else 2)
    (args,) = lib.calls
    n, inputs, grids, metas, sg, sc, sm, stop, fold, row, slot_ptr, clock, code = args[:13]
    assert n == 2 and (fold, row, clock) == (None, None, None)
    assert slot_ptr == (4242 if layout == "host" else None)
    assert code == ("device", "peer", "host").index(layout)
    assert list(stop) == [w.data_ptr() for w in words]
    assert list(args[14]) == [301, 302] and args[15:17] == (2, spec.box)
    assert args[21:] == (6161, 5151, 9)
    _launch_race_shards(lib, states, spec, spec.cells, 64, 3, 1, slots, streams, False)
    assert len(lib.calls) == 2 and lib.calls[1][21:] == (None, None, 0)
    with pytest.raises(ValueError, match="relay"):
        dfs_race_shards(states, spec, spec.cells, 64, relay=relay, fold=True)


def _shard_race_sets():
    """The race sets of the card tests, each padded for 4 shards."""
    from sudoku_solver_distributed_tpu_torch.parallel import frontier as F

    out = []
    for spec, states, waves, max_iters in _race_sets():
        boards = states.reshape(len(states), spec.size, spec.size)
        out.append((spec, F.bucket_states(boards, spec, len(states) // 4, 4).numpy(),
                    waves, max_iters))
    return out


@pytest.mark.cuda
def test_race_across_virtual_shards_and_its_fold_match_plain_on_the_card():
    """The race across 4 shards of cuda:0 (K4's shard form, one launch of
    every shard's states, stopping on the one stop word of the card, folded
    by the last block across every shard) against the plain lockstep race
    over every state: the row and every state's fold; no fold kernel runs;
    the words are idle again after each race, and races back to back stay
    exact. The fold kernel (the multi-host path's) over the same records
    equals the plain fold."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import (
        RACE_SCRATCH_IDLE,
        _dfs_race_plain,
        dfs_race_shards,
        race_fold,
    )
    from sudoku_solver_distributed_tpu_torch.ops.solver import fold_race
    from sudoku_solver_distributed_tpu_torch.parallel import frontier as F

    mesh = _mesh4()
    assert F.mesh_race_slots(mesh).layout == "device"
    for spec, states, waves, max_iters in _shard_race_sets() * 2:
        knobs = dict(locked_candidates=True, waves=waves, naked_pairs=False)
        cpu = torch.as_tensor(states.reshape(len(states), -1))
        row, fold, _ = _dfs_race_plain(cpu, spec, spec.max_depth, max_iters, **knobs)
        one, races, folds = dfs_race.launches, dfs_race_shards.launches, race_fold.launches
        krow, kfold, kmeta = F.race_on_mesh(states, mesh, spec, spec.max_depth,
                                            max_iters, **knobs)
        torch.cuda.synchronize()
        assert dfs_race_shards.launches == races + 1 and race_fold.launches == folds
        assert dfs_race.launches == one
        assert torch.equal(krow.cpu(), row) and torch.equal(kfold.cpu(), fold)
        assert F.mesh_race_slots(mesh).words[0].tolist() == list(RACE_SCRATCH_IDLE)
        grid = torch.zeros((len(states), spec.cells), dtype=torch.int32, device="cuda")
        frow, ffold = race_fold(kmeta, grid, spec, waves)
        prow, pfold = fold_race(kmeta.cpu(), grid.cpu(), spec, waves)
        torch.cuda.synchronize()
        assert torch.equal(frow.cpu(), prow) and torch.equal(ffold.cpu(), pfold)
        assert torch.equal(pfold, kfold.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("size", [9, 16])
def test_fused_race_across_virtual_shards_is_one_call_and_resets_its_words(size):
    """``dfs_race_shards(..., fold=True)`` over 4 shards of cuda:0 on a
    seeded 9x9 and 16x16 set: one library call, one launch of every
    shard's states, whose last block folds, equal to the plain race; each
    shard stopped at most 2 steps past t*, or within a step of one-shard
    K4's blocks; races back to back on one mesh, the later first solve
    after the earlier, stay exact (the last block set the words idle);
    ``fold_race`` over the kernel's own records equals the kernel's fold;
    and the race's clock holds, a state, start <= end of its search <=
    end."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import (
        RACE_SCRATCH_IDLE,
        _dfs_race_plain,
        dfs_race_shards,
        race_fold,
    )
    from sudoku_solver_distributed_tpu_torch.ops.solver import fold_race
    from sudoku_solver_distributed_tpu_torch.parallel import frontier as F

    mesh = _mesh4()
    slots = F.mesh_race_slots(mesh)
    sets = _shard_race_sets()
    pair = [sets[0], sets[1] if size == 9 else sets[3]]
    plain = []
    for spec, states, waves, max_iters in pair:
        knobs = dict(locked_candidates=True, waves=waves, naked_pairs=False)
        cpu = torch.as_tensor(states.reshape(len(states), -1))
        plain.append(_dfs_race_plain(cpu, spec, spec.max_depth, max_iters, **knobs))
    # the earlier first solve, then the later one, then the earlier again
    order = sorted(range(2), key=lambda k: int(plain[k][2][:, 1].max()))
    for k in (order[0], order[1], order[0]):
        spec, states, waves, max_iters = pair[k]
        prow, pfold, pmeta = plain[k]
        knobs = dict(locked_candidates=True, waves=waves, naked_pairs=False)
        M = len(states)
        cpu = torch.as_tensor(states.reshape(M, -1))
        parts = [cpu[i * M // 4:(i + 1) * M // 4].cuda() for i in range(4)]
        torch.cuda.synchronize()
        races, folds = dfs_race_shards.launches, race_fold.launches
        clock = torch.zeros((M, 3), dtype=torch.int64, device="cuda")
        row, fold, meta = dfs_race_shards(parts, spec, spec.max_depth, max_iters,
                                          streams=list(mesh.streams), slots=slots,
                                          fold=True, clock=clock, **knobs)
        torch.cuda.synchronize()
        assert dfs_race_shards.launches == races + 1 and race_fold.launches == folds
        assert torch.equal(row.cpu(), prow) and torch.equal(fold.cpu(), pfold)
        assert slots.words[0].tolist() == list(RACE_SCRATCH_IDLE)
        meta = meta.cpu()
        t_star = int(pmeta[:, 1].max())
        past = [int(meta[i * M // 4:(i + 1) * M // 4, 1].max()) - t_star for i in range(4)]
        # within a step of where one-shard K4's blocks stop on the same
        # states (2 or 3 past t* on 16x16, from one race to the next)
        k4_past = max(int(dfs_race(cpu.cuda(), spec, spec.max_depth, max_iters, **knobs)[2]
                          [:, 1].max()) - t_star for _ in range(3))
        assert max(past) <= max(2, k4_past + 1), (past, k4_past)
        grids = torch.zeros((M, spec.cells), dtype=torch.int32)
        _, pf = fold_race(meta, grids, spec, waves)
        assert torch.equal(pf, pfold)
        for start, searched, end in clock.cpu().tolist():
            assert 0 < start <= searched <= end, clock


@pytest.mark.cuda
@pytest.mark.parametrize("size", [9, 16])
def test_host_layout_race_across_virtual_shards_matches_plain_twice(size):
    """The ``"host"`` layout (cards without peer access: a launch a shard,
    each polling its own words and relaying the stop through slots in
    mapped host memory, then the fold kernel over the gathered records)
    forced on 4 shards of cuda:0, whose devices would choose ``"device"``:
    two races back to back equal the plain race, and every shard's words
    and every slot are idle after each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    import ctypes
    import threading

    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import (
        RACE_SLOT_IDLE,
        RACE_SCRATCH_IDLE,
        RaceSlots,
        _dfs_race_plain,
        dfs_race_shards,
        load_library,
        race_fold,
    )

    mesh = _mesh4()
    out, host = ctypes.c_void_p(), ctypes.c_void_p()
    assert load_library().dfs_race_slots_alloc(4, ctypes.byref(out), ctypes.byref(host)) == 0
    words = tuple(torch.tensor(RACE_SCRATCH_IDLE, dtype=torch.int32, device="cuda")
                  for _ in range(4))
    slots = RaceSlots("host", words, threading.Lock(), int(out.value), int(host.value))
    sets = _shard_race_sets()
    spec, states, waves, max_iters = sets[0] if size == 9 else sets[3]
    knobs = dict(locked_candidates=True, waves=waves, naked_pairs=False)
    M = len(states)
    cpu = torch.as_tensor(states.reshape(M, -1))
    prow, pfold, _ = _dfs_race_plain(cpu, spec, spec.max_depth, max_iters, **knobs)
    parts = [cpu[i * M // 4:(i + 1) * M // 4].cuda() for i in range(4)]
    torch.cuda.synchronize()
    for _ in range(2):
        races, folds = dfs_race_shards.launches, race_fold.launches
        runs = dfs_race_shards(parts, spec, spec.max_depth, max_iters,
                               streams=list(mesh.streams), slots=slots, **knobs)
        with torch.cuda.stream(mesh.streams[0]):
            row, fold = race_fold(torch.cat([m for m, _ in runs]),
                                  torch.cat([g for _, g in runs]), spec, waves,
                                  slots=slots.address, n_slots=4)
        torch.cuda.synchronize()
        assert dfs_race_shards.launches == races + 4 and race_fold.launches == folds + 1
        assert torch.equal(row.cpu(), prow) and torch.equal(fold.cpu(), pfold)
        assert all(w.tolist() == list(RACE_SCRATCH_IDLE) for w in words)
        assert list((ctypes.c_uint32 * 4).from_address(slots.host)) == [RACE_SLOT_IDLE] * 4


@pytest.mark.cuda
@pytest.mark.parametrize("size", [9, 16])
def test_peer_layout_race_across_virtual_shards_matches_plain_twice(size):
    """The ``"peer"`` layout (cards with peer access: a launch a shard,
    each polling its own words, a solve posted to every shard's words with
    system atomics, the last block across every shard folding) forced on
    4 shards of cuda:0, whose devices would choose ``"device"``: one
    library call of 4 launches and no fold kernel, two races back to back
    equal the plain race, and every shard's words are idle after each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    import threading

    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import (
        RACE_SCRATCH_IDLE,
        RaceSlots,
        _dfs_race_plain,
        dfs_race_shards,
        race_fold,
    )

    mesh = _mesh4()
    words = tuple(torch.tensor(RACE_SCRATCH_IDLE, dtype=torch.int32, device="cuda")
                  for _ in range(4))
    slots = RaceSlots("peer", words, threading.Lock())
    sets = _shard_race_sets()
    spec, states, waves, max_iters = sets[0] if size == 9 else sets[3]
    knobs = dict(locked_candidates=True, waves=waves, naked_pairs=False)
    M = len(states)
    cpu = torch.as_tensor(states.reshape(M, -1))
    prow, pfold, _ = _dfs_race_plain(cpu, spec, spec.max_depth, max_iters, **knobs)
    parts = [cpu[i * M // 4:(i + 1) * M // 4].cuda() for i in range(4)]
    torch.cuda.synchronize()
    for _ in range(2):
        races, folds = dfs_race_shards.launches, race_fold.launches
        row, fold, _ = dfs_race_shards(parts, spec, spec.max_depth, max_iters,
                                       streams=list(mesh.streams), slots=slots, fold=True,
                                       **knobs)
        torch.cuda.synchronize()
        assert dfs_race_shards.launches == races + 4 and race_fold.launches == folds
        assert torch.equal(row.cpu(), prow) and torch.equal(fold.cpu(), pfold)
        assert all(w.tolist() == list(RACE_SCRATCH_IDLE) for w in words)


@pytest.mark.cuda
def test_the_relay_inbox_halts_the_shard_race_at_a_host_posted_step_on_the_card():
    """The race across 2 shards of cuda:0 with a relay across hosts: a step
    written into the inbox (mapped host memory) before the launch, tagged
    with the race's tag, halts every state at exactly that step, the records
    equal to the plain race's halted there; a post tagged with another race
    is ignored (the records of the plain race's own runs); the words are
    idle after each race. A solving half posts its first solve into the
    outbox, tagged with its race, and the fold kernel over both halves'
    records equals the plain fold. The halves are deep board 12's in a
    2-host race of 8 states a shard: host 0's solve nothing in 106 steps,
    host 1's solve at 59."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    import ctypes

    import torch.distributed as dist

    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import (
        RACE_SCRATCH_IDLE,
        dfs_race_shards,
        race_fold,
        race_relay_words,
        sweep_knobs,
    )
    from sudoku_solver_distributed_tpu_torch.ops.solver import SOLVED, fold_race, race_runs
    from sudoku_solver_distributed_tpu_torch.parallel import frontier as F
    from sudoku_solver_distributed_tpu_torch.parallel.mesh import virtual_mesh
    from sudoku_solver_distributed_tpu_torch.parallel.relay import RaceRelay

    spec = spec_for_size(9)
    deep9 = np.load(os.path.join(ROOT, "benchmarks", "corpus_9x9_deep_128.npz"))["boards"]
    states, early = F.seed_frontier(deep9[12], spec, target=32, locked=True)
    assert early is None
    states = F.bucket_states(states, spec, 8, 4).numpy().reshape(-1, spec.cells)
    half = len(states) // 2
    quiet, solving = states[:half], states[half:]
    knobs = dict(locked_candidates=True, waves=3, naked_pairs=False)
    mesh = virtual_mesh("cuda:0", 2)
    slots = F.mesh_race_slots(mesh)
    relay = RaceRelay(dist.HashStore(), 0, 2)  # no thread: the test posts
    host = race_relay_words()[1]

    def plain(part, stop=None):
        n = len(part) // 2
        runs = [race_runs(torch.as_tensor(part[i * n:(i + 1) * n]).reshape(n, 9, 9), spec,
                          65536, spec.max_depth, stop=stop, **sweep_knobs(spec, **knobs))
                for i in (0, 1)]
        return torch.cat([m for m, _ in runs]), torch.cat([g for _, g in runs])

    def card(part, link):
        n = len(part) // 2
        parts = [torch.as_tensor(np.ascontiguousarray(part[i * n:(i + 1) * n])).cuda()
                 for i in (0, 1)]
        before = dfs_race_shards.launches
        out = dfs_race_shards(parts, spec, spec.max_depth, 65536, streams=list(mesh.streams),
                              slots=slots, relay=link, **knobs)
        torch.cuda.synchronize()
        assert dfs_race_shards.launches == before + 1
        assert slots.words[0].tolist() == list(RACE_SCRATCH_IDLE)
        return torch.cat([m for m, _ in out]).cpu(), torch.cat([g for _, g in out]).cpu()

    smeta, sgrid = plain(solving)
    t_star = int(smeta[smeta[:, 0] == SOLVED, 1].min())
    halted = None
    for race, tag, stop in ((5, 5, t_star), (6, 5, None), (8, 8, t_star + 7)):
        link = relay.begin(race)
        tag = link.tag if tag == race else link.tag - 1  # this race's, or another's
        ctypes.c_uint64.from_address(host + 8).value = \
            (t_star if stop is None else stop) << 32 | tag
        meta, grid = card(quiet, link)
        want = plain(quiet, None if stop is None else (lambda: stop))
        assert torch.equal(meta, want[0]), race
        if stop is not None:
            assert int(meta[:, 1].max()) == stop
        if race == 5:
            halted = (meta, grid)
        relay.finish(link)
    link = relay.begin(7)
    kmeta, kgrid = card(solving, link)
    relay.finish(link)
    word = ctypes.c_uint64.from_address(host).value
    assert (word & 0xFFFFFFFF, word >> 32) == (link.tag, t_star)
    meta = torch.cat([halted[0], kmeta]).cuda()
    grid = torch.cat([halted[1], kgrid]).cuda()
    row, fold = race_fold(meta, grid, spec, knobs["waves"])
    prow, pfold = fold_race(torch.cat([halted[0], smeta]), torch.cat([halted[1], sgrid]),
                            spec, knobs["waves"])
    torch.cuda.synchronize()
    assert torch.equal(row.cpu(), prow) and torch.equal(fold.cpu(), pfold)


@pytest.mark.cuda
def test_a_one_shard_race_is_still_one_launch():
    """A race over a one-shard mesh is one K4 launch that folds itself: no
    shard form, no fold kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import (
        dfs_race_shards,
        race_fold,
    )
    from sudoku_solver_distributed_tpu_torch.parallel import frontier as F
    from sudoku_solver_distributed_tpu_torch.parallel.mesh import Mesh

    spec, states, waves, max_iters = _race_sets()[0]
    knobs = dict(locked_candidates=True, waves=waves, naked_pairs=False)
    races, shards, folds = dfs_race.launches, dfs_race_shards.launches, race_fold.launches
    row, _, _ = F.race_on_mesh(states, Mesh(["cuda:0"]), spec, spec.max_depth,
                               max_iters, **knobs)
    torch.cuda.synchronize()
    assert dfs_race.launches == races + 1 and race_fold.launches == folds
    assert dfs_race_shards.launches == shards
    assert int(row[spec.cells]) == 1


@pytest.mark.cuda
def test_a_race_that_failed_before_its_fold_leaves_the_next_race_exact():
    """A race across 4 shards whose ``gather`` raises after the shard
    launches (a failed collective) never enqueues its fold, which is what
    sets the slots idle; the race sets them idle itself, so the next race
    over the same shards, whose first solve comes later than the failed
    race's, still equals the plain race."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import _dfs_race_plain
    from sudoku_solver_distributed_tpu_torch.parallel import frontier as F

    mesh = _mesh4()
    sets = _shard_race_sets()
    early, late = sets[0], sets[3]  # first solves at steps 7 and 44

    def plain(entry):
        spec, states, waves, max_iters = entry
        knobs = dict(locked_candidates=True, waves=waves, naked_pairs=False)
        cpu = torch.as_tensor(states.reshape(len(states), -1))
        return _dfs_race_plain(cpu, spec, spec.max_depth, max_iters, **knobs), knobs

    (_, _, emeta), eknobs = plain(early)
    (lrow, lfold, lmeta), lknobs = plain(late)
    assert int(emeta[:, 1].max()) < int(lmeta[:, 1].max())

    def failed_gather(meta, grid):
        raise TimeoutError("the record gather timed out")

    for _ in range(2):
        spec, states, _, max_iters = early
        with pytest.raises(TimeoutError):
            F.race_on_mesh(states, mesh, spec, spec.max_depth, max_iters,
                           gather=failed_gather, **eknobs)
        spec, states, _, max_iters = late
        krow, kfold, _ = F.race_on_mesh(states, mesh, spec, spec.max_depth, max_iters,
                                        **lknobs)
        torch.cuda.synchronize()
        assert torch.equal(krow.cpu(), lrow) and torch.equal(kfold.cpu(), lfold)
