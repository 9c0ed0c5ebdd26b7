"""POST /solve_batch on the port held against the JAX node: on both
transports (the default keep-alive one and the stdlib arm), valid batches
(the 64-board hard corpus with an unsolvable board and the README board),
the 400s, the ``X-Deadline-Ms: 0`` 429, the answer cache's strip of cached
boards and its ``CACHE_BATCH_MAX`` skip, the supervised degraded batch and
the ``/solve_batch`` span, each equal to the JAX node's; then the JAX
concurrency cases of single and batch solves on the port. The JAX engine
runs with its coalescer off and the port's in the closed loop, so the
counters match.
"""

import http.client
import json
import os
import socket
import threading

import numpy as np
import pytest
import torch

from sudoku_solver_distributed_tpu.cache import AnswerCache as JaxCache
from sudoku_solver_distributed_tpu.engine import SolverEngine as JaxEngine
from sudoku_solver_distributed_tpu.models import generate_batch
from sudoku_solver_distributed_tpu.net import http_api as jax_http_api
from sudoku_solver_distributed_tpu.net.node import P2PNode as JaxNode
from sudoku_solver_distributed_tpu.obs import FlightRecorder as JaxFlight
from sudoku_solver_distributed_tpu.obs import Tracer as JaxTracer
from sudoku_solver_distributed_tpu.serving.health import (
    EngineSupervisor as JaxSupervisor,
)
from sudoku_solver_distributed_tpu.utils.faults import (
    EngineFaultInjector as JaxInjector,
)
from sudoku_solver_distributed_tpu_torch.cache import AnswerCache
from sudoku_solver_distributed_tpu_torch.cache.canonical import random_symmetry
from sudoku_solver_distributed_tpu_torch.engine import SolverEngine, device_fault
from sudoku_solver_distributed_tpu_torch.models import oracle_is_valid_solution
from sudoku_solver_distributed_tpu_torch.net import http_api
from sudoku_solver_distributed_tpu_torch.net.node import P2PNode
from sudoku_solver_distributed_tpu_torch.obs import FlightRecorder, Tracer
from sudoku_solver_distributed_tpu_torch.serving.health import (
    DEGRADED,
    EngineSupervisor,
)
from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import KernelLaunchError
from sudoku_solver_distributed_tpu_torch.utils.faults import (
    EngineFaultInjector,
    InjectedEngineFault,
)

BENCH = os.path.join(os.path.dirname(__file__), "..", "benchmarks")
BUCKETS = (1, 8, 64)


def free_udp_port():
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def hard(n):
    with np.load(os.path.join(BENCH, "corpus_9x9_hard_64.npz")) as d:
        return d["boards"][:n].astype(np.int32)


def unsat_board():
    b = [[0] * 9 for _ in range(9)]
    b[0][0] = b[0][1] = 5
    return b


def post(port, path, body: bytes, headers=None):
    """(status, headers, body) of one POST on a fresh connection."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", path, body, headers or {})
        r = conn.getresponse()
        return r.status, r.headers, r.read()
    finally:
        conn.close()


def engines(**kw):
    jax_kw = {k: v for k, v in kw.items() if k != "coalesce"}
    return (
        JaxEngine(coalesce=False, buckets=BUCKETS, **jax_kw),
        SolverEngine(device="cpu", buckets=BUCKETS, continuous=False, **kw),
    )


@pytest.fixture(scope="module")
def engine_pair():
    jax_eng, eng = engines()
    yield jax_eng, eng
    eng.close()


@pytest.fixture(params=["fast", "legacy"])
def nodes(request, engine_pair):
    """A JAX node and a port node over the module's engines, each on its
    package's transport of the parameter, with /solve_batch."""
    legacy = request.param == "legacy"
    jax_eng, eng = engine_pair
    jax_node = JaxNode("127.0.0.1", free_udp_port(), engine=jax_eng)
    node = P2PNode("127.0.0.1", free_udp_port(), engine=eng)
    servers = [
        jax_http_api.make_http_server(jax_node, "127.0.0.1", 0,
                                      expose_batch=True,
                                      legacy_transport=legacy),
        http_api.make_http_server(node, "127.0.0.1", 0, expose_batch=True,
                                  legacy_transport=legacy),
    ]
    for s in servers:
        threading.Thread(target=s.serve_forever, daemon=True).start()
    yield (jax_node, node), [s.server_address[1] for s in servers]
    for s in servers:
        s.shutdown()
        s.server_close()


def both(ports, body: bytes, headers=None, path="/solve_batch"):
    (js, jh, jb), (ps, ph, pb) = (post(p, path, body, headers) for p in ports)
    assert (ps, pb) == (js, jb)
    assert jh.get("Retry-After") == ph.get("Retry-After")
    assert jh.get("Connection") == ph.get("Connection")
    return ps, pb


def test_valid_batches_match_jax(nodes, readme_puzzle):
    (jax_node, node), ports = nodes
    boards = [*hard(64).tolist(), unsat_board(), readme_puzzle]
    before = (jax_node.engine.validations, node.engine.validations)
    status, body = both(ports, json.dumps({"sudokus": boards}).encode())
    payload = json.loads(body)
    assert status == 200 and payload["solved"] == 65 and payload["capped"] == 0
    assert payload["solutions"][64] is None
    for board, sol in zip(boards, payload["solutions"]):
        if sol is not None:
            clues = np.asarray(board) > 0
            assert oracle_is_valid_solution(sol)
            assert (np.asarray(sol)[clues] == np.asarray(board)[clues]).all()
    grew = (jax_node.engine.validations - before[0],
            node.engine.validations - before[1])
    assert grew[0] == grew[1] > 0
    assert node.solved_puzzles == jax_node.solved_puzzles == 65


def test_bad_batches_answer_400_like_jax(nodes, readme_puzzle):
    _, ports = nodes
    ragged = [row[:] for row in readme_puzzle]
    ragged[3] = ragged[3][:4]
    bodies = [
        json.dumps({"sudokus": []}).encode(),
        json.dumps({"sudokus": [[[0] * 9] * 9] * (http_api.MAX_BATCH + 1)}).encode(),
        json.dumps({"sudokus": [[[0] * 4] * 4]}).encode(),
        json.dumps({"sudokus": [readme_puzzle, ragged]}).encode(),
        json.dumps({"sudoku": readme_puzzle}).encode(),
        b"{not json",
    ]
    for body in bodies:
        status, payload = both(ports, body)
        assert (status, json.loads(payload)) == (400, {"error": "Invalid request"})
    assert http_api.MAX_BATCH == jax_http_api.MAX_BATCH == 4096
    assert http_api.MAX_BATCH_BYTES == jax_http_api.MAX_BATCH_BYTES
    assert http_api.CACHE_BATCH_MAX == jax_http_api.CACHE_BATCH_MAX
    # over the byte cap: refused from the header, before the body is read
    got = []
    for port in ports:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.putrequest("POST", "/solve_batch")
        conn.putheader("Content-Length", str(http_api.MAX_BATCH_BYTES + 1))
        conn.endheaders()
        r = conn.getresponse()
        got.append((r.status, r.read(), r.will_close))
        conn.close()
    assert got[0] == got[1]
    assert got[1][0] == 400 and got[1][2]


def test_expired_deadline_sheds_429_like_jax(nodes, readme_puzzle):
    _, ports = nodes
    body = json.dumps({"sudokus": [readme_puzzle]}).encode()
    status, payload = both(ports, body, {"X-Deadline-Ms": "0"})
    assert status == 429
    assert json.loads(payload)["error"] == "Deadline exceeded"


def test_batch_route_strips_cached_boards_like_jax():
    """Cached boards never reach the engine: the node's batch call sees
    only the misses, the merged body keeps request order, an all-cached
    batch never calls the engine, and a batch over CACHE_BATCH_MAX skips
    the cache — each equal on the JAX node."""
    boards = generate_batch(3, 30, size=9, seed=1311, unique=True)
    twin = random_symmetry(boards[0], np.random.default_rng(7))
    big = generate_batch(http_api.CACHE_BATCH_MAX + 1, 20, size=9, seed=1312)
    big[0] = boards[0]
    runs = []
    jax_eng, eng = engines()
    try:
        for Node, cache, e in ((JaxNode, JaxCache, jax_eng),
                               (P2PNode, AnswerCache, eng)):
            node = Node("127.0.0.1", free_udp_port(), engine=e)
            node.answer_cache = cache(capacity=128)
            api = jax_http_api if Node is JaxNode else http_api
            status, _p, _e, _d, cached = api.solve_route(
                node, json.dumps({"sudoku": boards[0].tolist()}).encode()
            )
            assert status == 200 and not cached
            seen = []
            real = node.batch_sudoku_solve

            def spying(sudokus, real=real, seen=seen):
                seen.append(len(sudokus))
                return real(sudokus)

            node.batch_sudoku_solve = spying
            body = json.dumps(
                {"sudokus": [boards[1].tolist(), twin, boards[2].tolist()]}
            ).encode()
            out = [api.solve_batch_route(node, body)]
            out.append(api.solve_batch_route(node, body))
            hits = node.answer_cache.snapshot()["hits"]
            out.append(api.solve_batch_route(
                node, json.dumps({"sudokus": big.tolist()}).encode()
            ))
            runs.append((out, list(seen), hits,
                         node.answer_cache.snapshot()["hits"]))
    finally:
        eng.close()
    (want, want_seen, want_hits, want_after), (got, seen, hits, after) = runs
    assert got == want
    assert seen == want_seen == [2, http_api.CACHE_BATCH_MAX + 1]
    assert after == hits == want_hits == want_after
    status, payload, _e, _d, cached = got[0]
    assert status == 200 and cached is True and payload["solved"] == 3
    for i, b in enumerate([boards[1], np.asarray(twin), boards[2]]):
        sol = np.asarray(payload["solutions"][i])
        assert oracle_is_valid_solution(sol.tolist())
        assert (sol[b > 0] == b[b > 0]).all()
    assert got[2][4] is False and got[2][1]["solved"] == len(big)


def _degraded_run(Engine, Injector, Supervisor, Node, api, boards, **kw):
    """The JAX supervisor test's steps on one package: healthy, a device
    failure mid-batch, an open breaker, the HTTP body contract, and the
    recovery. Returns what each step answered."""
    eng = Engine(buckets=(1, 4), coalesce=False, **kw)
    eng.warmup()
    inj = Injector()
    eng.fault_injector = inj
    sup = Supervisor(eng, probe_interval_s=600.0)
    steps = []
    try:
        steps.append(eng.solve_batch_np_supervised(boards))
        inj.arm_fail_next(1)
        steps.append(eng.solve_batch_np_supervised(boards))
        steps.append(sup.state)
        calls = inj.counts()["calls"]
        steps.append(eng.solve_batch_np_supervised(boards))
        steps.append(inj.counts()["calls"] - calls)
        node = Node("127.0.0.1", 0, engine=eng, failure_timeout=0.0)
        body = json.dumps({"sudokus": [b.tolist() for b in boards]}).encode()
        steps.append(api.solve_batch_route(node, body))
        inj.clear()
        steps.append(sup.probe())
        steps.append(api.solve_batch_route(node, body))
    finally:
        sup.close()
        eng.supervisor = None
        eng.fault_injector = None
        eng.close()
    return [
        (s[0].tolist(), s[1].tolist(), s[2]) if isinstance(s, tuple) and len(s) == 3
        else s
        for s in steps
    ]


def test_supervised_degraded_batch_matches_jax():
    boards = generate_batch(3, 45, seed=83)
    want = _degraded_run(JaxEngine, JaxInjector, JaxSupervisor, JaxNode,
                         jax_http_api, boards)
    got = _degraded_run(SolverEngine, EngineFaultInjector, EngineSupervisor,
                        P2PNode, http_api, boards, device="cpu",
                        continuous=False)
    assert got == want
    healthy, failed, state, fallback, device_calls, route, probed, recovered = got
    assert healthy[2]["degraded"] is False
    assert healthy[2]["degraded_boards"] == [False] * 3
    assert failed[2]["degraded_boards"] == [True] * 3
    assert failed[2]["routed"] == "oracle-fallback" and all(failed[1])
    assert state == DEGRADED and device_calls == 0 and all(fallback[1])
    status, payload, error, degraded, _cached = route
    assert (status, error, degraded) == (200, False, True)
    assert payload["degraded"] == [True] * 3 and payload["solved"] == 3
    assert probed is True
    assert recovered[3] is False and "degraded" not in recovered[1]
    for i in range(3):
        sol = np.asarray(failed[0][i])
        assert oracle_is_valid_solution(sol.tolist())
        assert (sol[boards[i] > 0] == boards[i][boards[i] > 0]).all()


DEVICE_FAULTS = [
    (InjectedEngineFault("injected"), True),
    (KernelLaunchError("dfs_solver launch failed: cudaError 700"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), True),
    (torch.cuda.OutOfMemoryError("CUDA out of memory."), True),
    (RuntimeError("nvcc failed (1) building dfs_solver.cu"), False),
    (OSError("libdfs_solver.so: cannot open shared object file"), False),
    (ValueError("dfs_solver takes contiguous boards"), False),
]


@pytest.mark.parametrize("exc,fault", DEVICE_FAULTS,
                         ids=[type(e).__name__ + str(i)
                              for i, (e, _) in enumerate(DEVICE_FAULTS)])
def test_supervised_batch_falls_back_only_on_device_faults(exc, fault,
                                                          monkeypatch):
    """A supervised batch answers from the host fallback, flagged degraded,
    only when the device call failed with a device fault; a kernel library
    that does not build or load, or any other error, fails the batch."""
    assert device_fault(exc) is fault
    boards = generate_batch(2, 45, seed=84)
    eng = SolverEngine(device="cpu", buckets=(1, 4), coalesce=False,
                       continuous=False)
    eng.warmup()
    sup = EngineSupervisor(eng, probe_interval_s=600.0)
    try:
        assert eng.solve_batch_np_supervised(boards)[2]["degraded"] is False

        def failing(*args, **kw):
            raise exc

        monkeypatch.setattr(eng, "_launch", failing)
        if fault:
            sols, mask, info = eng.solve_batch_np_supervised(boards)
            assert info["degraded_boards"] == [True, True] and mask.all()
            assert info["routed"] == "oracle-fallback"
        else:
            with pytest.raises(type(exc)):
                eng.solve_batch_np_supervised(boards)
    finally:
        sup.close()
        eng.close()


def test_unsupervised_batch_is_solve_batch_np(engine_pair):
    _, eng = engine_pair
    boards = hard(9)
    a = eng.solve_batch_np_supervised(boards)
    b = eng.solve_batch_np(boards)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2] == b[2] and "degraded" not in a[2]


@pytest.mark.parametrize("legacy", [False, True], ids=["fast", "legacy"])
def test_solve_batch_span_matches_jax(legacy, engine_pair, readme_puzzle):
    """The /solve_batch request span: X-Timing with device time, and the
    span in the flight recorder's ring beside /solve's; the same X-Timing
    keys as the JAX node's."""
    jax_eng, eng = engine_pair
    timings, routes = [], []
    for Node, Trace, Flight, api, e in (
        (JaxNode, JaxTracer, JaxFlight, jax_http_api, jax_eng),
        (P2PNode, Tracer, FlightRecorder, http_api, eng),
    ):
        flight = Flight()
        tracer = Trace(recorder=flight)
        node = Node("127.0.0.1", free_udp_port(), engine=e,
                    metrics=tracer.routes)
        node.tracer, node.flight = tracer, flight
        httpd = api.make_http_server(node, "127.0.0.1", 0, expose_batch=True,
                                     legacy_transport=legacy)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            port = httpd.server_address[1]
            status, headers, body = post(
                port, "/solve_batch",
                json.dumps({"sudokus": [readme_puzzle, readme_puzzle]}).encode(),
                {"X-Timing": "1"},
            )
            assert status == 200 and json.loads(body)["solved"] == 2
            post(port, "/solve", json.dumps({"sudoku": readme_puzzle}).encode())
            timings.append(json.loads(headers["X-Timing"]))
            routes.append(sorted(
                s["route"] for s in flight.dump(reason="test")["payload"]["spans"]
            ))
        finally:
            httpd.shutdown()
            httpd.server_close()
    assert set(timings[1]) == set(timings[0])
    assert timings[1]["device_ms"] > 0 and timings[0]["device_ms"] > 0
    assert routes[1] == routes[0] == ["/solve", "/solve_batch"]


# -- the JAX concurrency cases (test_concurrency.py) on the port ---------------

def _run_threads(fns):
    errors = []

    def wrap(fn):
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=wrap, args=(fn,)) for fn in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if errors:
        raise errors[0]


@pytest.fixture(scope="module")
def coalescing_engine():
    eng = SolverEngine(device="cpu", buckets=(1, 4))
    yield eng
    eng.close()


def test_concurrent_single_and_batch_solves(coalescing_engine):
    node = P2PNode("127.0.0.1", 0, engine=coalescing_engine, failure_timeout=0.0)
    singles = generate_batch(4, 45, seed=72)
    batches = [generate_batch(8, 40, seed=73 + k) for k in range(3)]
    results = {}

    def solver(k):
        def run():
            results[f"s{k}"] = node.peer_sudoku_solve(singles[k].tolist())
        return run

    def batcher(k):
        def run():
            sols, mask, _ = node.batch_sudoku_solve(batches[k].tolist())
            assert mask.all()
            results[f"b{k}"] = sols
        return run

    _run_threads([solver(k) for k in range(4)] + [batcher(k) for k in range(3)])
    for k in range(4):
        sol = results[f"s{k}"]
        assert sol is not None and oracle_is_valid_solution(sol)
    for k in range(3):
        for i, sol in enumerate(results[f"b{k}"]):
            assert oracle_is_valid_solution(sol.tolist())
            mask = batches[k][i] > 0
            assert (np.asarray(sol)[mask] == batches[k][i][mask]).all()
    assert node.solved_puzzles == 4 + 3 * 8


def test_engine_counters_consistent_under_parallel_batches(coalescing_engine):
    engine = coalescing_engine
    before_v = engine.validations
    before_s = engine.solved_puzzles
    boards = generate_batch(16, 40, seed=72)
    infos = []

    def batch(lo):
        def run():
            _, solved, info = engine.solve_batch_np(boards[lo: lo + 4])
            assert bool(solved.all())
            infos.append(info)
        return run

    _run_threads([batch(lo) for lo in range(0, 16, 4)])
    assert engine.solved_puzzles - before_s == 16
    assert engine.validations - before_v == sum(i["validations"] for i in infos)
