"""Tiered warm-up on the port held against the JAX engine (cf.
tests/test_compileplane.py): tier order, ``warmed`` / ``fully_warmed``,
the budget's ``skipped`` widths and the tiling bucket choice while the
ladder is cold, background widening, and the ``/metrics`` ``engine.warm``
block. Then the CLI node: ``/readyz`` 503 until tier 0 ran and 200 after,
the GC freeze once fully warm, and ``--seed-serving`` (serialized solves,
the stdlib transport, no coalescer) beside the JAX node's seed arm.
"""

import gc
import http.client
import json
import socket
import threading
import time

import numpy as np
import pytest

from sudoku_solver_distributed_tpu.engine import SolverEngine as JaxEngine
from sudoku_solver_distributed_tpu.net.http_api import (
    make_http_server as jax_make_http_server,
)
from sudoku_solver_distributed_tpu.net.node import P2PNode as JaxNode
from sudoku_solver_distributed_tpu.serving.admission import (
    DeadlineExceeded as JaxDeadlineExceeded,
)
from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
from sudoku_solver_distributed_tpu_torch.models import oracle_is_valid_solution
from sudoku_solver_distributed_tpu_torch.net import cli
from sudoku_solver_distributed_tpu_torch.net.fastserve import FastHTTPServer
from sudoku_solver_distributed_tpu_torch.net.http_api import make_http_server
from sudoku_solver_distributed_tpu_torch.net.node import P2PNode
from sudoku_solver_distributed_tpu_torch.serving.admission import DeadlineExceeded

WARM_KEYS = ("warmed", "fully_warmed", "tier0", "order", "skipped")


def free_udp_port():
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def warm_view(eng):
    """The warm-up state both engines report alike: the keys of
    WARM_KEYS and each bucket's warm flag (the recorded times differ)."""
    info = eng.warm_info()
    out = {k: info[k] for k in WARM_KEYS}
    out["buckets"] = {b: st["warm"] for b, st in info["buckets"].items()}
    return out


def both(**kw):
    port_kw = dict(kw)
    if not kw.get("coalesce", True):
        port_kw["continuous"] = False
    return JaxEngine(**kw), SolverEngine(device="cpu", **port_kw)


def test_tiered_warmup_order_and_signals_match_jax():
    jax_eng, eng = both(buckets=(1, 8, 64), coalesce_max_batch=8)
    try:
        assert not eng.warmed and not eng.fully_warmed
        assert warm_view(eng) == warm_view(jax_eng)
        for e in (jax_eng, eng):
            e.warmup()
        view = warm_view(eng)
        assert view == warm_view(jax_eng)
        assert view["tier0"] == [1, 8]
        assert view["order"][:2] == [1, 8] and set(view["order"]) == {1, 8, 64}
        assert eng.warmed and eng.fully_warmed and not view["skipped"]
        assert eng.health()["fully_warmed"] is True
    finally:
        jax_eng.close()
        eng.close()


def test_warmup_budget_cuts_widening_and_serving_tiles_like_jax():
    jax_eng, eng = both(buckets=(1, 8, 64), coalesce=False)
    widths = []
    real = eng._launch

    def launch(boards, *a, **kw):
        widths.append(boards.shape[0])
        return real(boards, *a, **kw)

    eng._launch = launch
    try:
        for e in (jax_eng, eng):
            e.warmup(budget_s=0.0)
        view = warm_view(eng)
        assert view == warm_view(jax_eng)
        assert eng.warmed and not eng.fully_warmed
        assert view["skipped"] == [8, 64]
        assert eng.health()["fully_warmed"] is False
        # the bucket choice while the ladder is cold: the JAX engine's
        assert [eng._bucket_for(n) for n in range(1, 80)] == [
            jax_eng._bucket_for(n) for n in range(1, 80)
        ]
        boards = np.zeros((16, 9, 9), np.int32)
        widths.clear()
        want, got = (e.solve_batch_np(boards) for e in (jax_eng, eng))
        assert bool(got[1].all())
        np.testing.assert_array_equal(got[0], want[0])
        assert got[2] == want[2]
        assert widths == [1] * 16  # tiled over width 1, the one warm width
        assert jax_eng.program_count() == 1
        # a later unbudgeted warm-up resumes where the cut left off
        for e in (jax_eng, eng):
            e.warmup()
        assert warm_view(eng) == warm_view(jax_eng)
        assert eng.fully_warmed and eng.warm_info()["skipped"] == []
        widths.clear()
        eng.solve_batch_np(boards)
        assert widths == [64]
    finally:
        jax_eng.close()
        eng.close()


def test_background_warmup_serves_before_fully_warm(readme_puzzle):
    eng = SolverEngine(device="cpu", buckets=(1, 8), coalesce=False)
    eng.warmup(background=True)
    assert eng.warmed
    assert eng._warm_thread is not None and eng._warm_thread.name == "engine-warmup"
    sol, _ = eng.solve_one(readme_puzzle)
    assert sol is not None and oracle_is_valid_solution(sol)
    eng._warm_thread.join(timeout=120)
    assert eng.fully_warmed and eng.warm_info()["order"] == [1, 8]


def test_rebuild_warmup_relaunches_only_the_segment():
    """The supervisor's LOST rebuild calls warmup() with no arguments: it
    returns fully warm, and relaunches only the segment warm-up."""
    eng = SolverEngine(device="cpu", buckets=(1, 8))
    try:
        eng.warmup()
        launched = []
        real_launch, real_seg = eng._launch, eng._warm_segment_program
        eng._launch = lambda b, *a, **k: launched.append(b.shape[0]) or real_launch(b, *a, **k)
        eng._warm_segment_program = lambda: launched.append("segment") or real_seg()
        eng.warmup()
        assert launched == ["segment"] and eng.fully_warmed
    finally:
        eng.close()


def test_metrics_warm_state_before_fully_warm_matches_jax(readme_puzzle):
    """A node whose warm-up budget cut the ladder serves /solve while
    /metrics reports tier-0 warm but not fully warm, as the JAX node
    does."""
    blocks = []
    for Engine, Node, make in (
        (JaxEngine, JaxNode, jax_make_http_server),
        (lambda **k: SolverEngine(device="cpu", continuous=False, **k),
         P2PNode, make_http_server),
    ):
        eng = Engine(buckets=(1, 8, 64), coalesce=False)
        eng.warmup(budget_s=0.0)
        node = Node("127.0.0.1", free_udp_port(), engine=eng)
        httpd = make(node, "127.0.0.1", 0, expose_metrics=True)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            conn = http.client.HTTPConnection(
                "127.0.0.1", httpd.server_address[1], timeout=120
            )
            conn.request("POST", "/solve",
                         json.dumps({"sudoku": readme_puzzle}))
            resp = conn.getresponse()
            assert resp.status == 200
            assert oracle_is_valid_solution(json.loads(resp.read()))
            conn.request("GET", "/metrics")
            block = json.loads(conn.getresponse().read())["engine"]
            warm = block["warm"]
            blocks.append((
                block["warmed"], block["fully_warmed"],
                {k: warm[k] for k in WARM_KEYS},
                {b: st["warm"] for b, st in warm["buckets"].items()},
            ))
        finally:
            httpd.shutdown()
            if hasattr(eng, "close"):
                eng.close()
    assert blocks[1] == blocks[0]
    assert blocks[1][:2] == (True, False)
    assert blocks[1][3] == {"1": True, "8": False, "64": False}


# -- the CLI node -------------------------------------------------------------

def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def test_cli_node_readyz_503_until_tier0_then_200_and_gc_freeze(monkeypatch):
    """The CLI binds first and warms in the background: /readyz answers
    503 until tier 0 ran and 200 after; once fully warm the process's
    heap is frozen (gc.freeze)."""
    gate = threading.Event()
    real = SolverEngine._warm_segment_program

    def held(self):
        assert gate.wait(60)
        return real(self)

    monkeypatch.setattr(SolverEngine, "_warm_segment_program", held)
    # the CLI's gc.freeze() calls and their threads (an earlier node's
    # freeze thread may fire here too)
    real_freeze = gc.freeze
    froze = []

    def freeze():
        froze.append(threading.current_thread())
        real_freeze()

    monkeypatch.setattr(gc, "freeze", freeze)
    args = cli.build_parser().parse_args(
        ["-p", "0", "-s", str(free_udp_port()), "--platform", "cpu",
         "--buckets", "1,8,64", "--metrics"]
    )
    earlier = {t for t in threading.enumerate() if t.name == "gc-freeze"}
    node, httpd = cli.build_node(args)
    (freezer,) = [t for t in threading.enumerate()
                  if t.name == "gc-freeze" and t not in earlier]
    assert isinstance(httpd, FastHTTPServer)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    try:
        assert _get(port, "/readyz") == (503, {"ready": False, "warmed": False})
        assert _get(port, "/healthz") == (200, {"ok": True})
        assert freezer not in froze
        gate.set()
        deadline = time.monotonic() + 120
        while not node.engine.fully_warmed and time.monotonic() < deadline:
            time.sleep(0.02)
        assert node.engine.fully_warmed
        assert _get(port, "/readyz") == (200, {"ready": True, "warmed": True})
        status, metrics = _get(port, "/metrics")
        assert metrics["engine"]["warm"]["order"] == [1, 8, 64]
        freezer.join(timeout=60)
        assert not freezer.is_alive()
        assert froze.count(freezer) == 1 and gc.get_freeze_count() > 0
    finally:
        gate.set()
        httpd.shutdown()
        node.shutdown()
        node.engine.close()


def test_cli_warmup_budget_and_http_workers():
    args = cli.build_parser().parse_args(
        ["-p", "0", "-s", str(free_udp_port()), "--platform", "cpu",
         "--buckets", "1,8", "--warmup-budget-s", "0", "--http-workers", "5",
         "--no-coalesce"]
    )
    assert args.warmup_budget_s == 0.0
    node, httpd = cli.build_node(args)
    try:
        assert httpd.max_workers == 5
        deadline = time.monotonic() + 60
        while not node.engine.warmed and time.monotonic() < deadline:
            time.sleep(0.02)
        # --warmup-budget-s 0 means no budget (the JAX CLI's `or None`)
        while not node.engine.fully_warmed and time.monotonic() < deadline:
            time.sleep(0.02)
        assert node.engine.fully_warmed
    finally:
        httpd.server_close()
        node.shutdown()
        node.engine.close()
    defaults = cli.build_parser().parse_args([])
    assert (defaults.http_workers, defaults.warmup_budget_s) == (128, 0.0)
    assert not defaults.seed_serving and not defaults.batch_api


def test_seed_serving_matches_the_jax_seed_arm(readme_puzzle):
    """--seed-serving: no coalescer, solves serialized on the node's lock,
    the stdlib HTTP/1.0 transport; its bodies are the JAX seed arm's."""
    args = cli.build_parser().parse_args(
        ["-p", "0", "-s", str(free_udp_port()), "--platform", "cpu",
         "--buckets", "1", "--seed-serving", "--no-answer-cache"]
    )
    node, httpd = cli.build_node(args)
    assert not isinstance(httpd, FastHTTPServer)
    assert node.serialize_solves and not node.engine.coalesce
    jax_node = JaxNode("127.0.0.1", free_udp_port(),
                       engine=JaxEngine(coalesce=False, buckets=(1,)),
                       serialize_solves=True)
    jax_httpd = jax_make_http_server(jax_node, "127.0.0.1", 0,
                                     legacy_transport=True)
    servers = [jax_httpd, httpd]
    for s in servers:
        threading.Thread(target=s.serve_forever, daemon=True).start()
    try:
        deadline = time.monotonic() + 60
        while not node.engine.fully_warmed and time.monotonic() < deadline:
            time.sleep(0.02)
        unsat = [[0] * 9 for _ in range(9)]
        unsat[0][0] = unsat[0][1] = 5
        for board in (readme_puzzle, unsat):
            got = []
            for s in servers:
                conn = http.client.HTTPConnection(
                    "127.0.0.1", s.server_address[1], timeout=120
                )
                conn.request("POST", "/solve", json.dumps({"sudoku": board}))
                r = conn.getresponse()
                got.append((r.status, r.version, r.will_close, r.read()))
                conn.close()
            assert got[1] == got[0]
            assert got[1][1:3] == (10, True)
        want, mine = (_get(s.server_address[1], "/stats")[1] for s in servers)
        assert json.dumps(mine).replace(node.id, "N") == (
            json.dumps(want).replace(jax_node.id, "N")
        )
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        node.shutdown()
        node.engine.close()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_serialized_solve_sheds_a_deadline_passed_on_the_lock(pkg, readme_puzzle):
    if pkg == "jax":
        node = JaxNode("127.0.0.1", free_udp_port(),
                       engine=JaxEngine(coalesce=False, buckets=(1,)),
                       serialize_solves=True)
        expired = JaxDeadlineExceeded
    else:
        node = P2PNode("127.0.0.1", free_udp_port(),
                       engine=SolverEngine(device="cpu", buckets=(1,),
                                           coalesce=False),
                       serialize_solves=True)
        expired = DeadlineExceeded
    out = {}

    def solve():
        try:
            out["r"] = node.peer_sudoku_solve_info(
                readme_puzzle, deadline_s=time.monotonic() + 0.05
            )
        except BaseException as e:  # noqa: BLE001 — inspected below
            out["r"] = e

    with node._solve_lock:
        t = threading.Thread(target=solve)
        t.start()
        time.sleep(0.3)
    t.join(timeout=60)
    assert isinstance(out["r"], expired)
    assert node.solved_puzzles == 0
    sol, _ = node.peer_sudoku_solve_info(readme_puzzle)
    assert oracle_is_valid_solution(sol)
