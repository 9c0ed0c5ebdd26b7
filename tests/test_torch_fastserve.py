"""The port's default transport (net/fastserve.py) held against the JAX
package's: the keep-alive suite and the hardening cases of the JAX tests on
the port, then a JAX fastserve node beside a port fastserve node over one
raw-socket request sequence (200, 400, 404, 429 and 503; chunked, bad,
negative and oversize Content-Length; ``Expect: 100-continue`` on HTTP/1.1
and HTTP/1.0; an unknown POST; two requests on one connection). Status
lines, header names in order and bodies must be equal, ``X-Request-Id``
values being the only thing normalized. Both engines run on the CPU: the
JAX engine's coalescer off, the port's closed loop.
"""

import http.client
import inspect
import json
import re
import socket
import threading
import time

import pytest

from sudoku_solver_distributed_tpu.engine import SolverEngine as JaxEngine
from sudoku_solver_distributed_tpu.models import generate_batch
from sudoku_solver_distributed_tpu.net.http_api import (
    make_http_server as jax_make_http_server,
)
from sudoku_solver_distributed_tpu.net.node import P2PNode as JaxNode
from sudoku_solver_distributed_tpu.serving.admission import (
    AdmissionController as JaxAdmission,
)
from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
from sudoku_solver_distributed_tpu_torch.models import oracle_is_valid_solution
from sudoku_solver_distributed_tpu_torch.net import http_api
from sudoku_solver_distributed_tpu_torch.net.fastserve import FastHTTPServer
from sudoku_solver_distributed_tpu_torch.net.http_api import make_http_server
from sudoku_solver_distributed_tpu_torch.net.node import P2PNode
from sudoku_solver_distributed_tpu_torch.serving.admission import (
    AdmissionController,
)
from sudoku_solver_distributed_tpu_torch.utils.profiling import RequestMetrics


def free_udp_port():
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serve(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd.server_address[1]


@pytest.fixture(scope="module")
def engine():
    eng = SolverEngine(device="cpu", buckets=(1,), continuous=False)
    eng.warmup()
    yield eng
    eng.close()


# -- the JAX keep-alive suite (test_net_node.py) on the port -------------------

def test_http_keepalive_reuse_and_desync_guard(engine):
    """Two requests ride one connection; an unknown POST (body never read
    by the stock contract) closes; chunked and malformed Content-Length
    bodies answer 400 and close."""
    board = generate_batch(1, 5, seed=3)[0].tolist()
    body = json.dumps({"sudoku": board}).encode()
    node = P2PNode("127.0.0.1", free_udp_port(), engine=engine)
    httpd = make_http_server(node, "127.0.0.1", 0)
    assert isinstance(httpd, FastHTTPServer)
    port = serve(httpd)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        for _ in range(2):  # same socket both times
            conn.request("POST", "/solve", body,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200
            assert not resp.will_close
            solved = json.loads(resp.read())
            assert all(all(v != 0 for v in row) for row in solved)
        conn.request("POST", "/bogus", body, {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 404
        assert resp.will_close
        resp.read()
        conn.close()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("POST", "/solve", body, {"Content-Type": "application/json"})
        assert conn.getresponse().status == 200
        conn.close()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.putrequest("POST", "/solve")
        conn.putheader("Content-Type", "application/json")
        conn.putheader("Transfer-Encoding", "chunked")
        conn.endheaders()
        conn.send(b"%x\r\n%s\r\n0\r\n\r\n" % (len(body), body))
        resp = conn.getresponse()
        assert resp.status == 400
        assert resp.will_close
        resp.read()
        conn.close()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.putrequest("POST", "/solve")
        conn.putheader("Content-Type", "application/json")
        conn.putheader("Content-Length", "abc")
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 400
        assert resp.will_close
        resp.read()
        conn.close()
    finally:
        httpd.shutdown()
        node.shutdown()


# -- the JAX hardening suite (test_fastserve_hardening.py) on the port ---------

@pytest.fixture
def server(engine):
    node = P2PNode("127.0.0.1", free_udp_port(), engine=engine)
    threading.Thread(target=node.run, daemon=True).start()
    httpd = FastHTTPServer(node, "127.0.0.1", 0, expose_batch=True)
    serve(httpd)
    yield httpd
    httpd.shutdown()
    node.shutdown()


def _post(port, path, body: bytes, extra_headers=b"", timeout=60.0):
    """Raw-socket POST; every byte the server sent."""
    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    try:
        s.sendall(
            b"POST %s HTTP/1.1\r\nHost: x\r\nContent-Length: %d\r\n"
            b"%sConnection: close\r\n\r\n" % (path, len(body), extra_headers)
        )
        s.sendall(body)
        return _read_all(s)
    finally:
        s.close()


def _read_all(s) -> bytes:
    chunks = []
    while True:
        b = s.recv(65536)
        if not b:
            return b"".join(chunks)
        chunks.append(b)


def test_worker_pool_recovers_from_route_core_crash(server, monkeypatch,
                                                    readme_puzzle):
    port = server.server_address[1]
    body = json.dumps({"sudoku": readme_puzzle}).encode()
    real = http_api.solve_route
    crashes = {"n": 0}

    def crashing(node, raw, deadline_ms=None):
        crashes["n"] += 1
        raise RuntimeError("injected route-core fault")

    monkeypatch.setattr(http_api, "solve_route", crashing)
    for _ in range(3):
        assert _post(port, b"/solve", body, timeout=10.0) == b""
    assert crashes["n"] == 3
    monkeypatch.setattr(http_api, "solve_route", real)
    raw = _post(port, b"/solve", body)
    head, _, payload = raw.partition(b"\r\n\r\n")
    assert head.startswith(b"HTTP/1.1 200")
    assert oracle_is_valid_solution(json.loads(payload))
    with server._pool_lock:
        assert 0 < server._workers <= server.max_workers


def test_expect_100_continue_gets_interim_reply(server, readme_puzzle):
    port = server.server_address[1]
    body = json.dumps({"sudokus": [readme_puzzle]}).encode()
    s = socket.create_connection(("127.0.0.1", port), timeout=60.0)
    try:
        s.sendall(
            b"POST /solve_batch HTTP/1.1\r\nHost: x\r\n"
            b"Content-Length: %d\r\nExpect: 100-continue\r\n"
            b"Connection: close\r\n\r\n" % len(body)
        )
        s.settimeout(10.0)
        interim = s.recv(4096)
        assert interim.startswith(b"HTTP/1.1 100 Continue\r\n")
        s.sendall(body)
        raw = interim[len(b"HTTP/1.1 100 Continue\r\n\r\n"):] + _read_all(s)
    finally:
        s.close()
    assert b"HTTP/1.1 200" in raw
    assert json.loads(raw.partition(b"\r\n\r\n")[2])["solved"] == 1


def test_expect_ignored_on_http_1_0(server, readme_puzzle):
    port = server.server_address[1]
    body = json.dumps({"sudokus": [readme_puzzle]}).encode()
    s = socket.create_connection(("127.0.0.1", port), timeout=60.0)
    try:
        s.sendall(
            b"POST /solve_batch HTTP/1.0\r\nHost: x\r\n"
            b"Content-Length: %d\r\nExpect: 100-continue\r\n\r\n" % len(body)
        )
        s.sendall(body)
        raw = _read_all(s)
    finally:
        s.close()
    assert not raw.startswith(b"HTTP/1.1 100")
    assert raw.startswith(b"HTTP/1.1 200")
    assert json.loads(raw.partition(b"\r\n\r\n")[2])["solved"] == 1


def test_record_route_shared_by_both_transports(engine):
    node = P2PNode("127.0.0.1", free_udp_port(), engine=engine,
                   metrics=RequestMetrics())
    t0 = time.perf_counter()
    http_api.record_route(node, "/solve", t0)
    http_api.record_route(node, "/solve", t0, error=True)
    summary = node.metrics.summary()
    assert summary["/solve"]["count"] == 2
    assert summary["/solve"]["errors"] == 1
    assert "record_route" in inspect.getsource(FastHTTPServer._record)
    assert "record_route" in inspect.getsource(http_api.SudokuHTTPHandler)


def test_shutdown_returns_serve_forever_at_once(engine):
    """shutdown() wakes the accept loop: serve_forever returns without
    waiting for another connection."""
    node = P2PNode("127.0.0.1", free_udp_port(), engine=engine)
    httpd = FastHTTPServer(node, "127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    time.sleep(0.1)
    t0 = time.monotonic()
    httpd.shutdown()
    t.join(timeout=5)
    assert not t.is_alive() and time.monotonic() - t0 < 2.0
    httpd.server_close()  # idempotent


def test_default_transport_and_legacy_arm(engine):
    """make_http_server serves fastserve by default; the stdlib arm
    (HTTP/1.0, a connection per request) only with legacy_transport."""
    node = P2PNode("127.0.0.1", free_udp_port(), engine=engine)
    fast = make_http_server(node, "127.0.0.1", 0, max_workers=3)
    legacy = make_http_server(node, "127.0.0.1", 0, legacy_transport=True)
    try:
        assert isinstance(fast, FastHTTPServer) and fast.max_workers == 3
        assert not isinstance(legacy, FastHTTPServer)
        port = serve(legacy)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        assert (resp.status, resp.version, resp.will_close) == (200, 10, True)
        assert json.loads(resp.read()) == {"ok": True}
    finally:
        fast.server_close()
        legacy.shutdown()
        legacy.server_close()
    with pytest.raises(ValueError):
        FastHTTPServer(node, "127.0.0.1", 0, max_workers=0)


# -- a JAX fastserve node beside a port fastserve node --------------------------

def _request(method, path, body=b"", headers=(), version=b"HTTP/1.1",
             length=None):
    head = b"%s %s %s\r\nHost: x\r\n" % (method, path, version)
    for h in headers:
        head += h + b"\r\n"
    if length is None and (body or method == b"POST"):
        length = b"%d" % len(body)
    if length is not None:
        head += b"Content-Length: " + length + b"\r\n"
    return head + b"\r\n" + body


def _parse(raw: bytes):
    """The responses in ``raw``, each (status line, header names in order,
    header values without X-Request-Id, body)."""
    out = []
    while raw:
        head, sep, rest = raw.partition(b"\r\n\r\n")
        assert sep, raw
        lines = head.split(b"\r\n")
        headers = [ln.split(b":", 1) for ln in lines[1:]]
        names = [k for k, _ in headers]
        values = {k.lower(): v.strip() for k, v in headers}
        n = int(values.get(b"content-length", b"0"))
        assert re.fullmatch(rb"[0-9a-zA-Z._:-]{1,64}",
                            values.get(b"x-request-id", b"-")), values
        values.pop(b"x-request-id", None)
        out.append((lines[0], names, values, rest[:n]))
        raw = rest[n:]
    return out


def _exchange(port, *payloads, pause=0.0):
    """Send each raw request on one connection and read to EOF."""
    s = socket.create_connection(("127.0.0.1", port), timeout=60.0)
    try:
        for p in payloads:
            s.sendall(p)
            if pause:
                time.sleep(pause)
        return _read_all(s)
    finally:
        s.close()


@pytest.fixture
def pair():
    """A cold JAX node and a cold port node, each on its package's
    fastserve transport with /solve_batch, an admission controller and
    width-1 engines."""
    jax_node = JaxNode(
        "127.0.0.1", free_udp_port(),
        engine=JaxEngine(coalesce=False, buckets=(1,)),
        admission=JaxAdmission(capacity=16),
    )
    port_node = P2PNode(
        "127.0.0.1", free_udp_port(),
        engine=SolverEngine(device="cpu", buckets=(1,), continuous=False),
        admission=AdmissionController(capacity=16),
    )
    servers = [
        jax_make_http_server(jax_node, "127.0.0.1", 0, expose_batch=True),
        make_http_server(port_node, "127.0.0.1", 0, expose_batch=True),
    ]
    ports = [serve(s) for s in servers]
    yield (jax_node, port_node), ports
    for s in servers:
        s.shutdown()
    port_node.shutdown()
    port_node.engine.close()


def _same(ports, *payloads, nodes=None, **kw):
    want, got = (_parse(_exchange(p, *payloads, **kw)) for p in ports)
    if nodes is not None:
        # the node id is the one body difference: each node's own address
        want = [(s, n, v, b.replace(nodes[0].id.encode(), b"NODE"))
                for s, n, v, b in want]
        got = [(s, n, v, b.replace(nodes[1].id.encode(), b"NODE"))
               for s, n, v, b in got]
    assert got == want
    return got


def test_wire_bytes_match_jax_fastserve(pair, readme_puzzle):
    nodes, ports = pair
    solve = json.dumps({"sudoku": readme_puzzle}).encode()
    unsat = [[0] * 9 for _ in range(9)]
    unsat[0][0] = unsat[0][1] = 5
    close = b"Connection: close"
    # 503 while cold, then the shed (no completion measured yet, so the
    # retry hint is the same on both) and the framing 400s
    (r,) = _same(ports, _request(b"GET", b"/readyz", headers=(close,)))
    assert r[0] == b"HTTP/1.1 503 Service Unavailable"
    (r,) = _same(ports, _request(b"POST", b"/solve", solve,
                                 (b"X-Deadline-Ms: 0", close)))
    assert r[0].startswith(b"HTTP/1.1 429") and b"Retry-After" in r[1]
    (r,) = _same(ports, _request(b"POST", b"/solve", b"", (
        b"Transfer-Encoding: chunked",)))
    assert r[0].startswith(b"HTTP/1.1 400") and r[2][b"connection"] == b"close"
    for length in (b"abc", b"-1", b"%d" % (http_api.MAX_BATCH_BYTES + 1)):
        (r,) = _same(ports, _request(b"POST", b"/solve_batch", length=length))
        assert r[0].startswith(b"HTTP/1.1 400"), length
    for n in nodes:
        n.engine.warmup()
    (r,) = _same(ports, _request(b"GET", b"/readyz", headers=(close,)))
    assert r[0] == b"HTTP/1.1 200 OK"
    # two requests on one keep-alive connection, then 400s and a 404
    r = _same(ports, _request(b"POST", b"/solve", solve),
              _request(b"POST", b"/solve", json.dumps({"sudoku": unsat}).encode()),
              _request(b"POST", b"/solve", b"{not json"),
              _request(b"GET", b"/nope"),
              _request(b"GET", b"/healthz", headers=(close,)))
    assert [x[0][:12] for x in r] == [b"HTTP/1.1 200", b"HTTP/1.1 400",
                                      b"HTTP/1.1 400", b"HTTP/1.1 404",
                                      b"HTTP/1.1 200"]
    # an unknown POST closes the keep-alive connection
    (r,) = _same(ports, _request(b"POST", b"/nope", b"{}"))
    assert r[0].startswith(b"HTTP/1.1 404") and r[2][b"connection"] == b"close"
    # Expect: 100-continue gets its interim reply on HTTP/1.1 only
    batch = json.dumps({"sudokus": [readme_puzzle]}).encode()
    for version in (b"HTTP/1.1", b"HTTP/1.0"):
        raws = [
            _exchange(p, _request(b"POST", b"/solve_batch", b"",
                                  (b"Expect: 100-continue", close),
                                  version=version, length=b"%d" % len(batch)),
                      batch, pause=0.2)
            for p in ports
        ]
        interim = b"HTTP/1.1 100 Continue\r\n\r\n"
        assert [r.startswith(interim) for r in raws] == [version == b"HTTP/1.1"] * 2
        want, got = (_parse(r.removeprefix(interim)) for r in raws)
        assert got == want and got[0][0].startswith(b"HTTP/1.1 200")
    # HTTP/1.0 closes after one reply; /stats and /network with the node
    # address normalized
    for path in (b"/stats", b"/network"):
        _same(ports, _request(b"GET", path, version=b"HTTP/1.0"), nodes=nodes)


def test_cluster_view_is_a_404_on_the_port(engine):
    """/metrics/cluster and its Prometheus spellings are gated as /metrics:
    without ``expose_metrics`` the port's fastserve answers them as any
    unknown path; with it they answer 200 (the bodies are held against
    the JAX node's in tests/test_torch_p2p_planes.py)."""
    node = P2PNode("127.0.0.1", free_udp_port(), engine=engine,
                   metrics=RequestMetrics())
    paths = (b"/metrics/cluster", b"/metrics/cluster.prom",
             b"/metrics/cluster?format=prom")
    for expose in (False, True):
        httpd = make_http_server(node, "127.0.0.1", 0, expose_metrics=expose)
        port = serve(httpd)
        try:
            for path in paths:
                (r,) = _parse(_exchange(port, _request(b"GET", path,
                                                       version=b"HTTP/1.0")))
                if expose:
                    assert r[0] == b"HTTP/1.1 200 OK"
                else:
                    assert r[0] == b"HTTP/1.1 404 Not Found"
                    assert json.loads(r[3]) == {"error": "Invalid endpoint"}
            (r,) = _parse(_exchange(port, _request(b"GET", b"/metrics",
                                                   version=b"HTTP/1.0")))
            assert r[0] == (b"HTTP/1.1 200 OK" if expose
                            else b"HTTP/1.1 404 Not Found")
        finally:
            httpd.shutdown()
