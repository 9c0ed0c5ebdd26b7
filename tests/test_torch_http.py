"""The port's single node over HTTP held against the JAX package's node: both
get the same request sequence on localhost, and the /solve bodies (200, 400,
404 and 429 included) must be byte-identical, /stats equal once the node
address is normalized, and /network ``{id: []}``. Both nodes run their
default serving configuration (the JAX engine's coalescer off, the port's
closed loop, since the open loop's flat depth counts other validations);
one case runs both in the kernel's singles configuration.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

from sudoku_solver_distributed_tpu.engine import SolverEngine as JaxEngine
from sudoku_solver_distributed_tpu.net.http_api import (
    make_http_server as jax_make_http_server,
)
from sudoku_solver_distributed_tpu.net.node import P2PNode as JaxNode
from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
from sudoku_solver_distributed_tpu_torch.net import cli
from sudoku_solver_distributed_tpu_torch.net.http_api import make_http_server
from sudoku_solver_distributed_tpu_torch.net.node import P2PNode

README_PUZZLE = [
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


def free_port(kind=socket.SOCK_STREAM):
    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def request(base, path, body=None):
    req = urllib.request.Request(
        base + path, data=body,
        headers={"Content-Type": "application/json"} if body is not None else {},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def serve(httpd):
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return f"http://127.0.0.1:{httpd.server_address[1]}", t


def requests_sequence():
    unsolvable = [[0] * 9 for _ in range(9)]
    unsolvable[0][0] = unsolvable[0][1] = 5
    ragged = [row[:] for row in README_PUZZLE]
    ragged[2] = ragged[2][:5]
    out_of_range = [row[:] for row in README_PUZZLE]
    out_of_range[0][0] = 10
    return [
        ("POST", "/solve", json.dumps({"sudoku": README_PUZZLE}).encode()),
        ("POST", "/solve", json.dumps({"sudoku": unsolvable}).encode()),
        ("POST", "/solve", b"{not json"),
        ("POST", "/solve", json.dumps([1, 2, 3]).encode()),
        ("POST", "/solve", json.dumps({"sudoku": ragged}).encode()),
        ("POST", "/solve", json.dumps({"sudoku": out_of_range}).encode()),
        ("POST", "/nope", b"{}"),
        ("GET", "/nope", None),
        ("GET", "/stats", None),
        ("GET", "/network", None),
    ]


def _make_nodes(sweeps):
    jax_node = JaxNode(
        "127.0.0.1", free_port(socket.SOCK_DGRAM),
        engine=JaxEngine(coalesce=False, buckets=(1,), **sweeps),
    )
    port_node = P2PNode(
        "127.0.0.1", free_port(socket.SOCK_DGRAM),
        engine=SolverEngine(device="cpu", buckets=(1,), continuous=False,
                            **sweeps),
    )
    servers = [
        jax_make_http_server(jax_node, "127.0.0.1", 0, legacy_transport=True),
        make_http_server(port_node, "127.0.0.1", 0, legacy_transport=True),
    ]
    bases = [serve(s)[0] for s in servers]
    return (jax_node, port_node), bases, servers


@pytest.fixture(params=["serving", "singles"])
def nodes(request):
    sweeps = (
        {} if request.param == "serving"
        else dict(locked_candidates=False, waves=1, naked_pairs=False)
    )
    (jax_node, port_node), bases, servers = _make_nodes(sweeps)
    yield (jax_node, port_node), bases
    for s in servers:
        s.shutdown()
        s.server_close()
    port_node.shutdown()
    port_node.engine.close()


def test_http_bodies_match_jax_node(nodes):
    (jax_node, port_node), (jax_base, port_base) = nodes
    for method, path, body in requests_sequence():
        want = request(jax_base, path, body)
        got = request(port_base, path, body)
        if path == "/stats":
            want_stats = json.loads(want[1].decode().replace(jax_node.id, "NODE"))
            got_stats = json.loads(got[1].decode().replace(port_node.id, "NODE"))
            assert got[0] == want[0] == 200
            assert got_stats == want_stats
            assert got_stats["all"]["solved"] == 1
            assert got_stats["all"]["validations"] > 0
        elif path == "/network":
            assert got == (200, json.dumps({port_node.id: []}).encode())
            assert want == (200, json.dumps({jax_node.id: []}).encode())
        else:
            assert got == want, (method, path)
    assert port_node.solved_puzzles == jax_node.solved_puzzles == 1


def test_node_run_binds_udp_and_shuts_down():
    port = free_port(socket.SOCK_DGRAM)
    node = P2PNode("127.0.0.1", port, engine=SolverEngine(device="cpu", buckets=(1,)))
    t = threading.Thread(target=node.run, daemon=True)
    t.start()
    try:
        for _ in range(250):
            if node.sock.getsockname()[1] == port:
                break
            time.sleep(0.02)
        else:
            pytest.fail("node.run never bound its UDP port")
    finally:
        node.shutdown()
    t.join(timeout=10)
    assert not t.is_alive()


def test_cli_builds_a_serving_node():
    args = cli.build_parser().parse_args(
        ["-p", "0", "-s", str(free_port(socket.SOCK_DGRAM)), "-h", "1",
         "--platform", "cpu", "--buckets", "1,8", "--no-warmup"]
    )
    node, httpd = cli.build_node(args)
    base, _ = serve(httpd)
    try:
        status, body = request(
            base, "/solve", json.dumps({"sudoku": README_PUZZLE}).encode()
        )
        assert status == 200 and len(json.loads(body)) == 9
        assert node.engine.buckets == (1, 8)
        assert node.handicap == pytest.approx(0.01)
    finally:
        httpd.shutdown()
        httpd.server_close()
        node.shutdown()


def test_cli_refuses_anchor_join():
    """The CLI no longer refuses ``-a``: the node it builds joins through
    the anchor, and only a malformed anchor is refused, by the parser of
    the node's own wire format."""
    args = cli.build_parser().parse_args(
        ["-p", "0", "-s", str(free_port(socket.SOCK_DGRAM)), "--platform",
         "cpu", "--buckets", "1", "--no-warmup", "-a", "127.0.0.1:7000"]
    )
    node, httpd = cli.build_node(args)
    try:
        assert node.anchor_node == "127.0.0.1:7000"
        assert node.failure_timeout == 5.0
    finally:
        httpd.server_close()
        node.autopilot.close()
        node.shutdown()
        node.engine.close()


def test_cli_defaults_to_gpu():
    args = cli.build_parser().parse_args([])
    assert args.platform == "gpu" and args.p == 8001 and args.s == 7000
