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
               503 → {"error": "Degraded: fallback budget exceeded"} when a
                      supervised node's host-oracle fallback ran past its
                      budget (serving/health.py)
  GET  /stats  200 → the merged all_stats shape (plus a "serving" block of
               coalescer counters when asked for: ``expose_serving``)
  GET  /network 200 → the all_peers dict, or {self_id: []} when alone
  GET  /healthz 200 → {"ok": true} (liveness)
  GET  /readyz 200/503 → {"ready": ..., "warmed": ...[, "health": state]}
  POST /debug/faults → arms the engine-seam fault injector; only on a node
               built with ``--chaos-injector`` (404 otherwise)
  anything else 404 → {"error": "Invalid endpoint"}

A request may carry ``X-Deadline-Ms``, its latency budget; it counts only
with admission control on.

With an answer cache on the node (``p2p_node.answer_cache``, cache/; on by
default in the CLI) every /solve board is canonicalized at the front door,
before admission: a repeat, or any symmetric twin, of an answer already
verified is served from the cache with an ``X-Cache: hit`` header and
counts nothing in /stats. An answer from the supervisor's oracle fallback
carries ``X-Degraded: true``. Bodies stay byte-identical either way.

Not in this slice: cache gossip (peer fetch), request tracing and
/metrics, /solve_batch, and the lean keep-alive transport.
"""

from __future__ import annotations

import json
import logging
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..models.oracle import OracleBudgetExceeded
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


def _cache_lookup(p2p_node, sudoku):
    """Front-door cache consult: the local lookup only (cache gossip and
    its peer fetch are not in this package yet). Returns (answer | None,
    canonical form | None); exactly one hit or miss lands in the cache's
    counters."""
    cache = p2p_node.answer_cache
    answer, form = cache.lookup(sudoku, count_miss=False)
    if answer is None and form is not None:
        cache._count("misses")
    return answer, form


def solve_route(p2p_node, body: bytes, deadline_ms=None):
    """POST /solve: returns ``(status, payload, error_flag, degraded,
    cached)`` — ``degraded`` True when the answer came from the
    supervisor's host-oracle fallback (serving/health.py), ``cached`` True
    when it came from the answer cache (cache/). The transport turns them
    into the ``X-Degraded`` / ``X-Cache: hit`` headers; the body stays
    byte-identical.

    With a cache attached, the lookup runs BEFORE admission accounting: a
    hit never enters the pending budget, never feeds the completion-rate
    estimator, and is counted in the separate ``admission.cache_hits``
    gauge instead.

    ``deadline_ms`` is the request's relative latency budget (the
    ``X-Deadline-Ms`` header, parsed by the transport). With an admission
    controller on the node (``p2p_node.admission``; off by default),
    overload answers ``429`` here — shed at arrival when the projected
    queue wait already exceeds the budget or the pending capacity is
    full, or after the fact when the request expired waiting in the
    coalescer queue. Without one, the header is ignored."""
    adm = getattr(p2p_node, "admission", None)
    cache = getattr(p2p_node, "answer_cache", None)
    sudoku = None
    form = None
    already_expired = deadline_ms is not None and deadline_ms <= 0
    if cache is not None and not already_expired:
        # (an already-expired budget skips the consult: the admission
        # layer's 429 is the cheapest answer a dead-on-arrival request
        # can get)
        t_arrival = time.monotonic()
        sudoku = _parse_board(p2p_node, body)
        if sudoku is None:
            if adm is not None:
                # parsed (and failed) before try_admit ran: keep the
                # malformed-body flood visible to admission's arrival rate
                # and rejected counter
                adm.note_rejected()
            return 400, {"error": "Invalid request"}, True, False, False
        answer, form = _cache_lookup(p2p_node, sudoku)
        if answer is not None:
            if adm is not None:
                adm.note_cache_hit()
            return 200, answer, False, False, True
        if deadline_ms is not None:
            # the consult happened before admission: charge it against the
            # client's budget
            deadline_ms -= (time.monotonic() - t_arrival) * 1e3
    if adm is None:
        return _solve_core(p2p_node, body, None, sudoku=sudoku, form=form)
    decision = adm.try_admit(deadline_ms)
    if not decision.admitted:
        logger.debug("shed /solve at arrival (%s)", decision.reason)
        return (
            429, _shed_payload("Overloaded", decision.retry_after_s), True,
            False, False,
        )
    expired = False
    outcome = {"served": False}
    try:
        return _solve_core(
            p2p_node, body, decision.deadline_s, outcome,
            sudoku=sudoku, form=form,
        )
    except DeadlineExceeded:
        # admitted in time, overtaken by load: dropped at batch formation
        # (parallel/coalescer.py) — the device never ran it
        expired = True
        return (
            429, _shed_payload("Deadline exceeded", adm.retry_hint_s()), True,
            False, False,
        )
    finally:
        # served=False (a body rejected before the engine ran) must not
        # feed the completion-rate estimator
        adm.release(expired=expired, served=outcome["served"])


def _solve_core(p2p_node, body: bytes, deadline_s, outcome=None, *,
                sudoku=None, form=None):
    """Parse (unless the cache consult already did), validate and solve
    one /solve body; ``outcome["served"]`` turns True once the engine
    runs. A solved answer is offered to the cache, whose write gate
    verifies it, reusing the lookup's canonical form."""
    t_in = time.time()
    logger.debug("received /solve POST request")
    if sudoku is None:
        sudoku = _parse_board(p2p_node, body)
        if sudoku is None:
            return 400, {"error": "Invalid request"}, True, False, False
    if outcome is not None:
        outcome["served"] = True  # past validation: the engine runs now
    try:
        solution, info = p2p_node.peer_sudoku_solve_info(
            sudoku, deadline_s=deadline_s
        )
    except OracleBudgetExceeded:
        # the supervised node is in fallback AND this board's host solve
        # ran past the fallback budget: a clean 503 instead of a request
        # thread pinned on the oracle's exponential tail. 503, not 429:
        # the node is not overloaded, it cannot serve THIS board correctly
        # right now
        logger.warning("503: degraded and over the fallback budget")
        return (
            503, {"error": "Degraded: fallback budget exceeded"}, True,
            True, False,
        )
    degraded = bool(info.get("degraded"))
    logger.debug("execution time: %s", time.time() - t_in)
    if solution:
        cache = getattr(p2p_node, "answer_cache", None)
        if cache is not None:
            cache.store(sudoku, solution, form)
        return 200, solution, False, degraded, False
    return (
        400, {"error": "No solution found", "solution": solution}, True,
        degraded, False,
    )


def readyz_route(p2p_node):
    """GET /readyz — readiness, ``(status, payload)``: 200 when the node
    should receive traffic (``engine.ready()``: warm and, with a
    supervisor, not LOST), else 503. DEGRADED stays ready on purpose: the
    fallback serves correct answers."""
    eng = p2p_node.engine
    sup = eng.supervisor
    ready = eng.ready()
    body = {"ready": ready, "warmed": bool(eng.warmed)}
    if sup is not None:
        body["health"] = sup.state
    return (200 if ready else 503), body


def faults_route(p2p_node, body: bytes):
    """POST /debug/faults (only with ``--chaos-injector``): arm the
    engine-seam fault injector on a live node. Body: a JSON object with any
    of ``fail_next`` (int), ``delay_s`` (float), ``poison_bucket`` (int
    width), ``clear`` (bool — disarm everything, applied FIRST so
    {"clear": true, "delay_s": x} re-arms atomically). Returns (status,
    payload, error) with the injector's counters. Values are bounded at
    the boundary: a hostile caller can waste the node's time, which the
    flag opts into, but cannot crash the route."""
    inj = p2p_node.engine.fault_injector
    if inj is None or not getattr(p2p_node, "chaos_routes", False):
        return 404, {"error": "Invalid endpoint"}, True
    try:
        cmd = json.loads(body.decode("utf-8")) if body else {}
    except (ValueError, UnicodeDecodeError):
        return 400, {"error": "Invalid request"}, True
    if not isinstance(cmd, dict):
        return 400, {"error": "Invalid request"}, True
    try:
        if cmd.get("clear"):
            inj.clear()
        if "fail_next" in cmd:
            inj.arm_fail_next(max(0, min(1_000_000, int(cmd["fail_next"]))))
        if "delay_s" in cmd:
            inj.set_delay(max(0.0, min(3600.0, float(cmd["delay_s"]))))
        if "poison_bucket" in cmd:
            inj.poison_bucket(int(cmd["poison_bucket"]))
    except (TypeError, ValueError):
        return 400, {"error": "Invalid request"}, True
    return 200, {"ok": True, "counts": inj.counts()}, False


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

    def _send_response(self, content, status: int = 200,
                       degraded: bool = False, cached: bool = False) -> None:
        body = json.dumps(content).encode()
        self.send_response(status)
        self.send_header("Content-type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if degraded:
            # the answer came from the supervisor's host-oracle fallback:
            # a header, not a body key, so the body stays the reference's
            self.send_header("X-Degraded", "true")
        if cached:
            # the answer came from the answer cache: same header-not-body
            # contract
            self.send_header("X-Cache", "hit")
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
            status, payload, _error, degraded, cached = solve_route(
                self.p2p_node, post_data,
                deadline_ms=_parse_deadline_ms(self.headers.get("X-Deadline-Ms")),
            )
            self._send_response(payload, status, degraded=degraded,
                                cached=cached)
        elif self.path == "/debug/faults" and getattr(
            self.p2p_node, "chaos_routes", False
        ):
            post_data = self._read_body()
            if post_data is None:
                return
            status, payload, _error = faults_route(self.p2p_node, post_data)
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
        elif self.path == "/healthz":
            # liveness: a DEGRADED or LOST node still answers correctly from
            # the fallback and must not be restarted; /readyz tells them apart
            self._send_response({"ok": True})
        elif self.path == "/readyz":
            status, payload = readyz_route(self.p2p_node)
            self._send_response(payload, status)
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
