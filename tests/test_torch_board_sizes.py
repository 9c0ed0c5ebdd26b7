"""4×4, 16×16 and 25×25 boards on the port held against the JAX engine:
``solve_one``, ``solve_batch_np``, the node (``/solve`` and
``/solve_batch`` cores) and ``/solve`` over HTTP give the same solutions,
statuses and counters (cf. tests/test_hexadoku_serving.py). The boards are
a few of the committed corpora (chosen so the plain solver answers in well
under a second), hand-made 4×4 boards and an unsolvable board of each size.
Then the CLI's ``--board-size``: a node built with it serves that size, and
answers a body of another size with 400.
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

from sudoku_solver_distributed_tpu.engine import SolverEngine as JaxEngine
from sudoku_solver_distributed_tpu.net.http_api import (
    make_http_server as jax_make_http_server,
)
from sudoku_solver_distributed_tpu.net.node import P2PNode as JaxNode
from sudoku_solver_distributed_tpu.ops import spec_for_size as jax_spec_for_size
from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
from sudoku_solver_distributed_tpu_torch.models import oracle_is_valid_solution
from sudoku_solver_distributed_tpu_torch.net import cli
from sudoku_solver_distributed_tpu_torch.net.http_api import make_http_server
from sudoku_solver_distributed_tpu_torch.net.node import P2PNode
from sudoku_solver_distributed_tpu_torch.ops import spec_for_size

BENCH = os.path.join(os.path.dirname(__file__), "..", "benchmarks")
SOLVED_4 = np.array([[1, 2, 3, 4], [3, 4, 1, 2], [2, 1, 4, 3], [4, 3, 2, 1]])


def free_udp_port():
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def boards_of(size):
    """A few boards of ``size`` and an unsolvable one, (n, N, N) int32."""
    if size == 4:
        holes = [[(0, 0), (1, 1), (2, 2), (3, 3)],
                 [(r, c) for r in range(4) for c in range(4) if (r + c) % 2],
                 [(r, c) for r in range(4) for c in range(4) if r != 0]]
        out = []
        for cells in holes:
            b = SOLVED_4.copy()
            for r, c in cells:
                b[r, c] = 0
            out.append(b)
        boards = np.stack(out)
    else:
        name, n = {16: ("corpus_16x16_hard_2048.npz", 4),
                   25: ("corpus_25x25_hard_512.npz", 2)}[size]
        with np.load(os.path.join(BENCH, name)) as d:
            boards = d["boards"][:n]
    unsat = np.zeros((1, size, size), np.int32)
    unsat[0, 0, 0] = unsat[0, 0, 1] = 1
    return np.concatenate([boards.astype(np.int32), unsat])


def check_answer(board, sol):
    clues = np.asarray(board) > 0
    assert oracle_is_valid_solution(sol)
    assert (np.asarray(sol)[clues] == np.asarray(board)[clues]).all()


@pytest.fixture(params=[4, 16, 25], ids=["4x4", "16x16", "25x25"])
def pair(request):
    size = request.param
    jax_eng = JaxEngine(jax_spec_for_size(size), coalesce=False, buckets=(1, 4))
    eng = SolverEngine(spec_for_size(size), device="cpu", buckets=(1, 4),
                       continuous=False)
    yield size, jax_eng, eng
    eng.close()


def test_solve_one_and_batch_match_jax(pair):
    size, jax_eng, eng = pair
    boards = boards_of(size)
    for board in boards:
        (jsol, jinfo), (sol, info) = (
            e.solve_one(board.tolist()) for e in (jax_eng, eng)
        )
        assert sol == jsol
        keys = ("validations", "guesses", "capped")
        assert {k: info[k] for k in keys} == {k: jinfo[k] for k in keys}
        if sol is not None:
            check_answer(board, sol)
    want, got = (e.solve_batch_np(boards) for e in (jax_eng, eng))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    assert got[1][:-1].all() and not got[1][-1]
    assert eng.validations == jax_eng.validations
    assert eng.solved_puzzles == jax_eng.solved_puzzles


def test_node_and_http_match_jax(pair):
    size, jax_eng, eng = pair
    boards = boards_of(size)
    jax_node = JaxNode("127.0.0.1", free_udp_port(), engine=jax_eng)
    node = P2PNode("127.0.0.1", free_udp_port(), engine=eng)
    for board in boards:
        want = jax_node.peer_sudoku_solve(board.tolist())
        assert node.peer_sudoku_solve(board.tolist()) == want
    want, got = (n.batch_sudoku_solve(boards.tolist()) for n in (jax_node, node))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    assert node.solved_puzzles == jax_node.solved_puzzles == 2 * (len(boards) - 1)
    servers = [jax_make_http_server(jax_node, "127.0.0.1", 0),
               make_http_server(node, "127.0.0.1", 0)]
    for s in servers:
        threading.Thread(target=s.serve_forever, daemon=True).start()
    wrong = [[0] * 9 for _ in range(9)] if size != 9 else [[0] * 4] * 4
    try:
        for board in [*boards.tolist(), wrong]:
            got = [_post(s.server_address[1], "/solve", {"sudoku": board})
                   for s in servers]
            assert got[1] == got[0]
        assert got[1][0] == 400
    finally:
        for s in servers:
            s.shutdown()


def _post(port, path, obj):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("size", [4, 16])
def test_cli_board_size_serves_that_size(size):
    args = cli.build_parser().parse_args(
        ["-p", "0", "-s", str(free_udp_port()), "--platform", "cpu",
         "--buckets", "1,8", "--board-size", str(size), "--batch-api",
         "--no-answer-cache"]
    )
    node, httpd = cli.build_node(args)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    try:
        assert node.engine.spec.size == size
        deadline = time.monotonic() + 120
        while not node.engine.fully_warmed and time.monotonic() < deadline:
            time.sleep(0.05)
        assert node.engine.fully_warmed
        boards = boards_of(size)[:-1]
        for board in boards:
            status, body = _post(port, "/solve", {"sudoku": board.tolist()})
            assert status == 200
            check_answer(board, json.loads(body))
        status, body = _post(port, "/solve_batch",
                             {"sudokus": boards.tolist()})
        payload = json.loads(body)
        assert status == 200 and payload["solved"] == len(boards)
        for board, sol in zip(boards, payload["solutions"]):
            check_answer(board, sol)
        for path, key in (("/solve", "sudoku"), ("/solve_batch", "sudokus")):
            nine = [[0] * 9 for _ in range(9)]
            status, body = _post(port, path,
                                 {key: nine if key == "sudoku" else [nine]})
            assert (status, json.loads(body)) == (400, {"error": "Invalid request"})
    finally:
        httpd.shutdown()
        node.shutdown()
        node.engine.close()
    assert cli.build_parser().parse_args([]).board_size == 9
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--board-size", "12"])
