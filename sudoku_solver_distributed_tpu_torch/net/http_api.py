"""HTTP API: POST /solve, GET /stats, GET /network — byte-identical bodies.

The port of the stock transport of ``sudoku_solver_distributed_tpu/net/
http_api.py`` (its ``legacy_transport`` arm: the stdlib
``ThreadingHTTPServer`` speaking HTTP/1.0). Response contract (reference
node.py:661-704):

  POST /solve  200 → the solved grid as a JSON array-of-arrays;
               400 → {"error": "No solution found", "solution": null};
               400 → {"error": "Invalid request"} for a malformed body
               429 → {"error": "Overloaded" | "Deadline exceeded",
                      "retry_after_ms": ...} with a Retry-After header, only
                      with admission control on (serving/admission.py)
  GET  /stats  200 → the merged all_stats shape (plus a "serving" block of
               coalescer counters when asked for: ``expose_serving``)
  GET  /network 200 → the all_peers dict, or {self_id: []} when alone
  anything else 404 → {"error": "Invalid endpoint"}

A request may carry ``X-Deadline-Ms``, its latency budget; it counts only
with admission control on.

Not in this slice: the answer cache, request tracing and /metrics,
/solve_batch, and the lean keep-alive transport.
"""

from __future__ import annotations

import json
import logging
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..serving.admission import DeadlineExceeded
from .stats import serving_snapshot

logger = logging.getLogger(__name__)


def _board_error(sudoku, size: int) -> str | None:
    """Semantic body validation: a reason string when ``sudoku`` is not a
    clean ``size``×``size`` grid of ints in 0..size, else None."""
    if not isinstance(sudoku, list) or len(sudoku) != size:
        return f"board must be a {size}x{size} array"
    for row in sudoku:
        if not isinstance(row, list) or len(row) != size:
            return f"board must be a {size}x{size} array"
        for v in row:
            if type(v) is not int or not 0 <= v <= size:
                return f"cells must be integers in 0..{size}"
    return None


def _parse_deadline_ms(raw):
    """``X-Deadline-Ms`` header → float ms (relative latency budget), or
    None when absent/garbage. Garbage is treated as no header rather than
    a 400: the header is advisory and must never break a client that
    would have succeeded without it. A non-positive value is meaningful —
    it is already expired at arrival and sheds immediately
    (serving/admission.py)."""
    if raw is None:
        return None
    if isinstance(raw, bytes):
        raw = raw.decode("latin-1", "replace")
    try:
        return float(raw)
    except (TypeError, ValueError):
        return None


def _shed_payload(error: str, retry_after_s) -> dict:
    """The 429 body shape (admission shed / expired deadline). Carries the
    retry hint in ms so the transport can derive the Retry-After header
    (integer seconds) from the payload without a side channel."""
    return {
        "error": error,
        "retry_after_ms": round(max(0.0, retry_after_s or 0.0) * 1e3, 1),
    }


def retry_after_header(payload) -> str | None:
    """Retry-After header value (integer seconds, floor 1) for a 429
    payload built by ``_shed_payload``; None for anything else."""
    if isinstance(payload, dict) and "retry_after_ms" in payload:
        return str(max(1, -(-int(payload["retry_after_ms"]) // 1000)))
    return None


def _parse_board(p2p_node, body: bytes):
    """Parse + validate a /solve body. Returns the board list, or None."""
    try:
        sudoku = json.loads(body.decode("utf-8"))["sudoku"]
    except (ValueError, KeyError, TypeError, UnicodeDecodeError):
        # TypeError: a JSON-valid non-object body ([1,2,3], "foo")
        return None
    reason = _board_error(sudoku, p2p_node.engine.spec.size)
    if reason is not None:
        logger.info("rejected /solve body: %s", reason)
        return None
    return sudoku


def solve_route(p2p_node, body: bytes, deadline_ms=None):
    """POST /solve: returns ``(status, payload, error_flag)``.

    ``deadline_ms`` is the request's relative latency budget (the
    ``X-Deadline-Ms`` header, parsed by the transport). With an admission
    controller on the node (``p2p_node.admission``; off by default),
    overload answers ``429`` here — shed at arrival when the projected
    queue wait already exceeds the budget or the pending capacity is
    full, or after the fact when the request expired waiting in the
    coalescer queue. Without one, the header is ignored."""
    adm = getattr(p2p_node, "admission", None)
    if adm is None:
        return _solve_core(p2p_node, body, None)
    decision = adm.try_admit(deadline_ms)
    if not decision.admitted:
        logger.debug("shed /solve at arrival (%s)", decision.reason)
        return 429, _shed_payload("Overloaded", decision.retry_after_s), True
    expired = False
    outcome = {"served": False}
    try:
        return _solve_core(p2p_node, body, decision.deadline_s, outcome)
    except DeadlineExceeded:
        # admitted in time, overtaken by load: dropped at batch formation
        # (parallel/coalescer.py) — the device never ran it
        expired = True
        return (
            429, _shed_payload("Deadline exceeded", adm.retry_hint_s()), True
        )
    finally:
        # served=False (a body rejected before the engine ran) must not
        # feed the completion-rate estimator
        adm.release(expired=expired, served=outcome["served"])


def _solve_core(p2p_node, body: bytes, deadline_s, outcome=None):
    """Parse, validate and solve one /solve body; ``outcome["served"]``
    turns True once the engine runs."""
    t_in = time.time()
    logger.debug("received /solve POST request")
    sudoku = _parse_board(p2p_node, body)
    if sudoku is None:
        return 400, {"error": "Invalid request"}, True
    if outcome is not None:
        outcome["served"] = True  # past validation: the engine runs now
    solution, _info = p2p_node.peer_sudoku_solve_info(
        sudoku, deadline_s=deadline_s
    )
    logger.debug("execution time: %s", time.time() - t_in)
    if solution:
        return 200, solution, False
    return 400, {"error": "No solution found", "solution": solution}, True


def stats_payload(p2p_node, expose_serving: bool):
    """GET /stats: the merged all_stats shape; the serving block
    (coalescer counters, net/stats.serving_snapshot) is an extension key
    next to the reference's "all"/"nodes", only when asked for."""
    body = p2p_node.get_stats()
    if expose_serving:
        body["serving"] = serving_snapshot(p2p_node.engine)
    return body


class SudokuHTTPHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.0"  # one connection per request, as the seed
    p2p_node = None  # set by make_http_server
    expose_serving = False  # opt-in "serving" block on GET /stats

    def _send_response(self, content, status: int = 200) -> None:
        body = json.dumps(content).encode()
        self.send_response(status)
        self.send_header("Content-type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if status == 429:
            retry = retry_after_header(content)
            if retry is not None:
                self.send_header("Retry-After", retry)
        if self.close_connection:
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self):
        """The request body, or None after answering 400 and closing the
        connection when it cannot be framed (chunked, bad Content-Length)."""
        te = (self.headers.get("Transfer-Encoding") or "").lower()
        try:
            content_length = int(self.headers.get("Content-Length", 0))
        except (ValueError, TypeError):
            content_length = -1
        if content_length < 0 or "chunked" in te:
            self.close_connection = True
            self._send_response({"error": "Invalid request"}, 400)
            return None
        return self.rfile.read(content_length)

    def do_POST(self):
        if self.path == "/solve":
            post_data = self._read_body()
            if post_data is None:
                return
            status, payload, _error = solve_route(
                self.p2p_node, post_data,
                deadline_ms=_parse_deadline_ms(self.headers.get("X-Deadline-Ms")),
            )
            self._send_response(payload, status)
        else:
            # the body was never read: close rather than desync keep-alive
            self.close_connection = True
            self._send_response({"error": "Invalid endpoint"}, 404)

    def do_GET(self):
        if self.path == "/stats":
            self._send_response(
                stats_payload(self.p2p_node, self.expose_serving)
            )
        elif self.path == "/network":
            self._send_response(self.p2p_node.network_view())
        else:
            self._send_response({"error": "Invalid endpoint"}, 404)

    def log_message(self, fmt, *args):  # route http.server chatter to logging
        logger.debug("%s - %s", self.address_string(), fmt % args)


class _ThreadingHTTPServer(ThreadingHTTPServer):
    # a deep accept queue, as the JAX package's transports have: the stock
    # 5-deep backlog drops or resets connections when concurrent clients
    # arrive together, which is the traffic the coalescer exists for
    request_queue_size = 1024


def make_http_server(p2p_node, host: str, http_port: int, *,
                     expose_serving: bool = False):
    """The stdlib threading HTTP server, one connection per request
    (HTTP/1.0). ``expose_serving`` adds the coalescer's "serving" block to
    GET /stats. Returns it unstarted: serve_forever() / shutdown() /
    server_address."""
    handler = type(
        "BoundHandler",
        (SudokuHTTPHandler,),
        {"p2p_node": p2p_node, "expose_serving": expose_serving},
    )
    httpd = _ThreadingHTTPServer((host, http_port), handler)
    logger.info("HTTP server on %s:%s", host, http_port)
    return httpd
