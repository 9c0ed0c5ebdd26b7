"""The port's answer cache held against the JAX package's, exactly (integers
and bytes, tolerance 0): canonical keys, grids and transforms on generated
boards, corpus boards and degenerate boards; one scripted sequence of stores
and lookups on both stores; and a port node and a JAX node (stdlib HTTP
servers, cache attached, no gossip) answering a miss, a hit and a symmetric
twin with the same bodies, ``X-Cache`` headers, ``/stats`` and admission
counts, plus ``/healthz``, ``/readyz`` and ``POST /debug/faults``.
"""

import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from sudoku_solver_distributed_tpu.cache import AnswerCache as JaxCache
from sudoku_solver_distributed_tpu.cache import canonical as jax_canonical
from sudoku_solver_distributed_tpu.engine import SolverEngine as JaxEngine
from sudoku_solver_distributed_tpu.models import generate_batch, oracle_solve
from sudoku_solver_distributed_tpu.net.http_api import (
    make_http_server as jax_make_http_server,
)
from sudoku_solver_distributed_tpu.net.node import P2PNode as JaxNode
from sudoku_solver_distributed_tpu.serving.admission import (
    AdmissionController as JaxAdmission,
)
from sudoku_solver_distributed_tpu.serving.health import (
    EngineSupervisor as JaxSupervisor,
)
from sudoku_solver_distributed_tpu.utils.faults import (
    EngineFaultInjector as JaxInjector,
)
from sudoku_solver_distributed_tpu_torch.cache import AnswerCache
from sudoku_solver_distributed_tpu_torch.cache import canonical
from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
from sudoku_solver_distributed_tpu_torch.net.http_api import make_http_server
from sudoku_solver_distributed_tpu_torch.net.node import P2PNode
from sudoku_solver_distributed_tpu_torch.serving.admission import (
    AdmissionController,
)
from sudoku_solver_distributed_tpu_torch.serving.health import EngineSupervisor
from sudoku_solver_distributed_tpu_torch.utils.faults import EngineFaultInjector

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _corpus_25(n):
    with np.load(os.path.join(ROOT, "benchmarks", "corpus_25x25_hard_512.npz")) as d:
        return d["boards"][:n].astype(np.int32)


def _form_fields(form):
    t = form.transform
    return (form.key, form.grid.dtype, form.grid.tolist(),
            (t.size, t.transposed, t.rows, t.cols, t.digits))


def _same_forms(board):
    want = jax_canonical.canonicalize(board)
    got = canonical.canonicalize(board)
    assert _form_fields(got) == _form_fields(want)
    return got


def _degenerate_boards():
    full = np.asarray(oracle_solve([[0] * 9 for _ in range(9)]), np.int32)
    clash = np.zeros((9, 9), np.int32)
    clash[0, 0] = clash[0, 1] = 5
    one = np.zeros((9, 9), np.int32)
    one[0, 0] = 5
    return {
        "empty-9": np.zeros((9, 9), np.int32),
        "empty-4": np.zeros((4, 4), np.int32),
        "empty-16": np.zeros((16, 16), np.int32),
        "one-clue": one,
        "full": full,
        "all-fives": np.full((9, 9), 5, np.int32),
        "clash": clash,
        "one-cell-empty": np.zeros((1, 1), np.int32),
        "one-cell": np.ones((1, 1), np.int32),
    }


@pytest.mark.parametrize(
    "size,holes,count",
    [(9, 30, 12), (9, 64, 8), (16, 140, 4)],
    ids=["9x9", "9x9-deep", "16x16"],
)
def test_canonical_forms_and_twins_match_jax(size, holes, count):
    """Key, canonical grid and transform fields equal the JAX module's;
    apply/invert round-trips; seeded ``random_symmetry`` twins are the same
    boards in both packages and land on the original's key."""
    boards = generate_batch(count, holes, size=size, seed=1301)
    for i, board in enumerate(boards):
        form = _same_forms(board)
        assert np.array_equal(form.transform.apply(board), form.grid)
        assert np.array_equal(form.transform.invert(form.grid), board)
        for k in range(3):
            seed = 1302 + 10 * i + k
            twin = canonical.random_symmetry(board, np.random.default_rng(seed))
            assert twin == jax_canonical.random_symmetry(
                board, np.random.default_rng(seed)
            )
            tform = _same_forms(twin)
            assert tform.key == form.key
            assert np.array_equal(tform.transform.invert(tform.grid), twin)


def test_canonical_corpus_25x25_matches_jax():
    for board in _corpus_25(2):
        form = _same_forms(board)
        assert np.array_equal(form.transform.invert(form.grid), board)
        twin = canonical.random_symmetry(board, np.random.default_rng(25))
        assert _same_forms(twin).key == form.key


@pytest.mark.parametrize("name", list(_degenerate_boards()))
def test_canonical_degenerate_boards_match_jax(name):
    board = _degenerate_boards()[name]
    form = _same_forms(board)
    assert _same_forms(board.tolist()).key == form.key  # lists hash alike
    assert np.array_equal(form.transform.invert(form.grid), board)


@pytest.mark.parametrize(
    "bad",
    [
        [[1, 2], [3, 4], [5, 6]],                     # not square
        [[0] * 8 for _ in range(8)],                  # 8 is no square edge
        [[-1] + [0] * 8] + [[0] * 9] * 8,             # below range
        [[10] + [0] * 8] + [[0] * 9] * 8,             # above range
        np.zeros((2, 9, 9), np.int32),                # not 2-D
    ],
    ids=["not-square", "edge-8", "negative", "too-large", "3d"],
)
def test_canonical_raises_as_jax(bad):
    with pytest.raises(Exception) as want:
        jax_canonical.canonicalize(bad)
    with pytest.raises(type(want.value)) as got:
        canonical.canonicalize(bad)
    assert str(got.value) == str(want.value)


def _store_script(cache_cls, canonicalize, random_symmetry):
    """One sequence of writes and reads; returns everything observable."""
    boards = generate_batch(8, 30, size=9, seed=1308, unique=True)
    sols = [oracle_solve(b.tolist()) for b in boards]
    cache = cache_cls(capacity=4, shards=2)
    out = []
    for b, s in zip(boards[:6], sols[:6]):
        out.append(("store", cache.store(b, s)))
    out.append(("lru", [list(m.keys()) for m in cache._maps]))
    for b in boards[:6]:
        answer, form = cache.lookup(b)
        out.append(("lookup", answer, form.key))
    twin = random_symmetry(boards[5], np.random.default_rng(5))
    out.append(("twin", cache.lookup(twin)[0]))
    bad = [row[:] for row in sols[6]]
    bad[0][0], bad[0][1] = bad[0][1], bad[0][0]  # breaks the rules
    out.append(("wrong", cache.store(boards[6], bad)))
    out.append(("none", cache.store(boards[6], None)))
    key = canonicalize(boards[5]).key
    entry = cache._maps[cache._shard(key)][key]
    entry.solution = entry.solution.copy()
    entry.solution[0, 0] = entry.solution[0, 1]  # corrupted in place
    out.append(("corrupt", cache.lookup(boards[5])[0], cache.contains(key)))
    out.append(("miss-uncounted", cache.lookup(boards[7], count_miss=False)[0]))
    out.append(("hot", cache.hot_set(3)))
    out.append(("lru", [list(m.keys()) for m in cache._maps]))
    out.append(("snapshot", cache.snapshot(), len(cache)))
    canon = cache.get_canonical(cache.hot_set(1)[0][0])
    out.append(("canonical", canon))
    out.append(("peer", cache.store_canonical(*canon), cache.store_canonical(
        [[1, 2], [3, 4]], [[1, 2], [3, 4]])))
    out.append(("snapshot", cache.snapshot()))
    return out


def test_store_script_matches_jax():
    want = _store_script(JaxCache, jax_canonical.canonicalize,
                         jax_canonical.random_symmetry)
    got = _store_script(AnswerCache, canonical.canonicalize,
                        canonical.random_symmetry)
    assert got == want
    ops = dict((o[0], o) for o in got)
    assert ops["wrong"][1] is False and ops["none"][1] is False
    assert ops["corrupt"][1] is None and ops["corrupt"][2] is False
    snap = ops["snapshot"][1]
    assert snap["evictions"] >= 2 and snap["rejected_writes"] == 1
    assert snap["hit_mismatches"] == 1 and snap["hits"] >= 1


# -- HTTP: a port node and a JAX node side by side ------------------------------


def _udp_port():
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _request(base, path, body=None):
    req = urllib.request.Request(base + path, data=body)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read(), r.headers.get("X-Cache"), r.headers.get(
                "X-Degraded")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("X-Cache"), e.headers.get(
            "X-Degraded")


def _serve(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def nodes():
    """A JAX node and a port node, both on their stdlib HTTP server, each
    with an answer cache and an admission controller, width-1 engines."""
    jax_node = JaxNode(
        "127.0.0.1", _udp_port(),
        engine=JaxEngine(coalesce=False, buckets=(1,)),
        admission=JaxAdmission(capacity=16),
    )
    port_node = P2PNode(
        "127.0.0.1", _udp_port(),
        engine=SolverEngine(device="cpu", buckets=(1,), continuous=False),
        admission=AdmissionController(capacity=16),
    )
    jax_node.answer_cache = JaxCache(capacity=128)
    port_node.answer_cache = AnswerCache(capacity=128)
    servers = [
        jax_make_http_server(jax_node, "127.0.0.1", 0, legacy_transport=True),
        make_http_server(port_node, "127.0.0.1", 0, legacy_transport=True),
    ]
    bases = [_serve(s) for s in servers]
    yield (jax_node, port_node), bases
    for s in servers:
        s.shutdown()
        s.server_close()
    port_node.shutdown()
    for n in (jax_node, port_node):
        n.engine.close()


def _both(bases, path, body=None):
    want = _request(bases[0], path, body)
    got = _request(bases[1], path, body)
    assert got == want, path
    return got


def _stats_equal(nodes, bases):
    (jax_node, port_node) = nodes
    want = json.loads(_request(bases[0], "/stats")[1].decode().replace(
        jax_node.id, "NODE"))
    got = json.loads(_request(bases[1], "/stats")[1].decode().replace(
        port_node.id, "NODE"))
    assert got == want
    return got


def test_front_door_miss_hit_and_twin_match_jax_node(nodes):
    (jax_node, port_node), bases = nodes
    board = generate_batch(1, 30, size=9, seed=1310, unique=True)[0]
    twin = canonical.random_symmetry(board, np.random.default_rng(6))
    assert twin == jax_canonical.random_symmetry(board, np.random.default_rng(6))
    body = json.dumps({"sudoku": board.tolist()}).encode()
    status, miss, cached, degraded = _both(bases, "/solve", body)
    assert (status, cached, degraded) == (200, None, None)
    after_miss = _stats_equal((jax_node, port_node), bases)
    assert after_miss["all"]["solved"] == 1
    status, hit, cached, _ = _both(bases, "/solve", body)
    assert (status, cached) == (200, "hit") and hit == miss  # byte-identical
    status, twin_body, cached, _ = _both(
        bases, "/solve", json.dumps({"sudoku": twin}).encode())
    assert (status, cached) == (200, "hit")
    sol = np.asarray(json.loads(twin_body))
    tw = np.asarray(twin)
    assert (sol[tw > 0] == tw[tw > 0]).all()
    # hits count nothing in /stats
    assert _stats_equal((jax_node, port_node), bases) == after_miss
    status, _, cached, _ = _both(bases, "/solve", b"{not json")
    assert status == 400 and cached is None
    keys = ("admitted", "completed", "rejected", "cache_hits", "pending")
    jax_adm, port_adm = jax_node.admission.snapshot(), port_node.admission.snapshot()
    assert {k: port_adm[k] for k in keys} == {k: jax_adm[k] for k in keys}
    assert (port_adm["cache_hits"], port_adm["rejected"]) == (2, 1)
    assert port_node.answer_cache.snapshot() == jax_node.answer_cache.snapshot()


def test_healthz_readyz_and_faults_route_match_jax_node(nodes):
    (jax_node, port_node), bases = nodes
    assert _both(bases, "/healthz")[:2] == (200, b'{"ok": true}')
    status, body, _, _ = _both(bases, "/readyz")
    assert (status, json.loads(body)) == (503, {"ready": False, "warmed": False})
    # /debug/faults does not exist without --chaos-injector
    assert _both(bases, "/debug/faults", b"{}")[0] == 404
    sups = [
        JaxSupervisor(jax_node.engine, probe_interval_s=600.0),
        EngineSupervisor(port_node.engine, probe_interval_s=600.0),
    ]
    try:
        status, body, _, _ = _both(bases, "/readyz")
        assert json.loads(body)["health"] == "warming" and status == 503
        for node in (jax_node, port_node):
            node.engine.warmup()
        for sup in sups:
            assert wait_for(lambda s=sup: s.state == "healthy")
        status, body, _, _ = _both(bases, "/readyz")
        assert (status, json.loads(body)) == (
            200, {"ready": True, "warmed": True, "health": "healthy"})
        for sup in sups:
            for _ in range(3):
                sup.record_failure(None, "bad-result")
        status, body, _, _ = _both(bases, "/readyz")
        assert (status, json.loads(body)) == (
            503, {"ready": False, "warmed": True, "health": "lost"})
        assert _both(bases, "/healthz")[0] == 200
        # a LOST node answers from the oracle, flagged degraded
        board = generate_batch(1, 30, size=9, seed=1311, unique=True)[0]
        status, _, cached, degraded = _both(
            bases, "/solve", json.dumps({"sudoku": board.tolist()}).encode())
        assert (status, cached, degraded) == (200, None, "true")
        _stats_equal((jax_node, port_node), bases)
        # the injector's route, armed
        jax_node.engine.fault_injector = JaxInjector()
        port_node.engine.fault_injector = EngineFaultInjector()
        jax_node.chaos_routes = port_node.chaos_routes = True
        for cmd in (b'{"poison_bucket": 4, "fail_next": 2, "delay_s": 0.5}',
                    b'{"clear": true, "delay_s": 0.25}', b"[1]", b"{bad",
                    b'{"fail_next": "x"}', b""):
            _both(bases, "/debug/faults", cmd)
        status, body, _, _ = _both(bases, "/debug/faults", b'{"clear": true}')
        assert status == 200 and json.loads(body)["counts"]["calls"] == 0
    finally:
        for sup in sups:
            sup.close()
        for node in (jax_node, port_node):
            node.engine.supervisor = None
            node.engine.fault_injector = None
            node.chaos_routes = False


def wait_for(pred, timeout=10.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()
