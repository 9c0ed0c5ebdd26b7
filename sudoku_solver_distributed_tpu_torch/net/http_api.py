"""HTTP API: POST /solve, GET /stats, GET /network — byte-identical bodies.

The port of the stock transport of ``sudoku_solver_distributed_tpu/net/
http_api.py`` (its ``legacy_transport`` arm: the stdlib
``ThreadingHTTPServer`` speaking HTTP/1.0). Response contract (reference
node.py:661-704):

  POST /solve  200 → the solved grid as a JSON array-of-arrays;
               400 → {"error": "No solution found", "solution": null};
               400 → {"error": "Invalid request"} for a malformed body
  GET  /stats  200 → the merged all_stats shape
  GET  /network 200 → the all_peers dict, or {self_id: []} when alone
  anything else 404 → {"error": "Invalid endpoint"}

Not in this slice: the answer cache, admission control (429s), request
tracing and /metrics, /solve_batch, and the lean keep-alive transport.
"""

from __future__ import annotations

import json
import logging
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

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


def solve_route(p2p_node, body: bytes):
    """POST /solve: returns ``(status, payload, error_flag)``. (The JAX
    package splits this into ``solve_route`` — cache and admission, not
    ported yet — and ``_solve_core``, which is this body.)"""
    t_in = time.time()
    logger.debug("received /solve POST request")
    sudoku = _parse_board(p2p_node, body)
    if sudoku is None:
        return 400, {"error": "Invalid request"}, True
    solution, _info = p2p_node.peer_sudoku_solve_info(sudoku)
    logger.debug("execution time: %s", time.time() - t_in)
    if solution:
        return 200, solution, False
    return 400, {"error": "No solution found", "solution": solution}, True


class SudokuHTTPHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.0"  # one connection per request, as the seed
    p2p_node = None  # set by make_http_server

    def _send_response(self, content, status: int = 200) -> None:
        body = json.dumps(content).encode()
        self.send_response(status)
        self.send_header("Content-type", "application/json")
        self.send_header("Content-Length", str(len(body)))
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
            status, payload, _error = solve_route(self.p2p_node, post_data)
            self._send_response(payload, status)
        else:
            # the body was never read: close rather than desync keep-alive
            self.close_connection = True
            self._send_response({"error": "Invalid endpoint"}, 404)

    def do_GET(self):
        if self.path == "/stats":
            self._send_response(self.p2p_node.get_stats())
        elif self.path == "/network":
            self._send_response(self.p2p_node.network_view())
        else:
            self._send_response({"error": "Invalid endpoint"}, 404)

    def log_message(self, fmt, *args):  # route http.server chatter to logging
        logger.debug("%s - %s", self.address_string(), fmt % args)


def make_http_server(p2p_node, host: str, http_port: int):
    """The stdlib threading HTTP server, one connection per request
    (HTTP/1.0). Returns it unstarted: serve_forever() / shutdown() /
    server_address."""
    handler = type(
        "BoundHandler",
        (SudokuHTTPHandler,),
        {"p2p_node": p2p_node},
    )
    httpd = ThreadingHTTPServer((host, http_port), handler)
    logger.info("HTTP server on %s:%s", host, http_port)
    return httpd
