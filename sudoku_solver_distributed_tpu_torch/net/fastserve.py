"""Lean threaded HTTP/1.1 transport: the node's default front end.

A copy of ``sudoku_solver_distributed_tpu/net/fastserve.py`` over this
package's route cores (net/http_api.py): the port imports nothing from the
JAX package.

``http.server``'s BaseHTTPRequestHandler costs a millisecond or two of
pure-Python (and GIL-held) time per request: the request-line regex, an
email.parser pass over the headers, date formatting for every response.
This transport serves keep-alive connections from a BOUNDED worker pool
(lazily grown to ``max_workers``) off a shared accept queue: each worker
reads requests from one buffered socket file, parses just the request
line and the few headers that matter (Content-Length, Transfer-Encoding,
Connection, Expect, X-Deadline-Ms, X-Request-Id, X-Timing) and answers
from a pre-baked header template. The pool bound means a connection flood
exhausts a queue, not the process's thread table (serving/admission.py is
the request-level guard above it). Response BODIES come from the shared
cores in http_api.py (``solve_route``, ``solve_batch_route``,
``stats_payload``, ``metrics_payload``, ...), so they are byte-identical
whichever transport carried the request; ``--seed-serving`` keeps the
stdlib server and HTTP/1.0.

Framing rules match the stock handler's ``_read_body``: a request whose
body cannot be consumed (chunked transfer, malformed or negative
Content-Length, over the size cap) answers 400 and closes, since leftover
body bytes on a persistent connection would be parsed as the next
request's start line. Unknown POST paths also close, keeping the stock
handler's contract.

``shutdown`` returns ``serve_forever`` at once: it shuts the listening
socket down before closing it, which the JAX copy does not (there a
thread blocked in ``accept`` returns only at the next connection).
"""

from __future__ import annotations

import json
import logging
import queue
import socket
import threading
import time

from . import http_api

logger = logging.getLogger(__name__)

_REASONS = {
    200: b"OK",
    400: b"Bad Request",
    404: b"Not Found",
    429: b"Too Many Requests",
    503: b"Service Unavailable",
}
# generous cap for any route; /solve_batch's documented bound (http_api)
_MAX_BODY = http_api.MAX_BATCH_BYTES
_MAX_LINE = 65536
_MAX_HEADERS = 100
# accepted-but-unserved connections the pool will buffer before refusing:
# past this a connection flood is answered with an immediate close (one
# accept + one close per flood socket) instead of an unbounded fd pile.
# Kept SHORT relative to service rate on purpose — this queue sits AHEAD
# of the admission layer (serving/admission.py reads the request only
# once a worker picks the connection up), so its depth is invisible
# pre-admission queueing delay; a deep buffer here would quietly re-add
# the unbounded-lateness failure mode admission exists to remove
_CONN_BACKLOG = 256


class FastHTTPServer:
    """Drop-in for ThreadingHTTPServer's lifecycle surface:
    ``serve_forever()`` blocks (run it in a thread), ``shutdown()`` stops
    the accept loop, ``server_address`` carries the bound (host, port).

    Concurrency is a BOUNDED worker pool (``max_workers``, default 128),
    not a thread per connection: a connection flood cannot mint threads
    without limit. Workers are spawned lazily, one
    per accepted connection until the cap, and each then serves
    keep-alive connections off a shared queue for the server's lifetime —
    a quiet test server holds a handful of threads, a saturated node
    holds exactly ``max_workers``. Connections beyond workers+backlog are
    closed at accept. ``shutdown`` stops new accepts and lets live
    requests finish (workers are daemon threads polling the shutdown
    flag)."""

    def __init__(
        self,
        p2p_node,
        host: str,
        port: int,
        *,
        expose_metrics: bool = False,
        expose_batch: bool = False,
        expose_serving: bool = False,
        max_workers: int = 128,
        conn_backlog: int = _CONN_BACKLOG,
    ):
        if max_workers < 1:
            raise ValueError("max_workers must be >= 1")
        self.p2p_node = p2p_node
        self.expose_metrics = expose_metrics
        self.expose_batch = expose_batch
        self.expose_serving = expose_serving
        self.max_workers = max_workers
        # deep accept queue: the stock 5-deep backlog drops SYNs under a
        # 64-client burst and the overflow crawls through 1/3/7 s
        # retransmit backoff
        self._sock = socket.create_server(
            (host, port), backlog=1024, reuse_port=False
        )
        self.server_address = self._sock.getsockname()
        self._shutdown = False
        self._conns: "queue.Queue" = queue.Queue(maxsize=max(1, conn_backlog))
        self._workers = 0
        self._pool_lock = threading.Lock()
        self.conns_refused = 0  # flood-closed at accept (benign race on int)

    # -- lifecycle ---------------------------------------------------------
    def serve_forever(self) -> None:
        while not self._shutdown:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                break  # listener closed by shutdown()
            try:
                self._conns.put_nowait(conn)
            except queue.Full:
                # workers saturated AND the hand-off queue full: refuse
                # rather than buffer without bound — the client sees an
                # immediate close/RST and can back off, instead of a
                # socket that hangs until some keep-alive slot frees
                self.conns_refused += 1
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            self._maybe_spawn_worker()

    def _maybe_spawn_worker(self) -> None:
        with self._pool_lock:
            if self._workers >= self.max_workers:
                return
            self._workers += 1
        threading.Thread(
            target=self._worker_loop,
            name=f"fastserve-worker-{self._workers}",
            daemon=True,
        ).start()

    def _worker_loop(self) -> None:
        # the catch-all matters: _serve_connection absorbs (OSError,
        # ValueError), but any other exception escaping a route core would
        # kill this thread with _workers never decremented, and repeated
        # faults would wedge the pool while accepts kept queueing. A
        # faulting connection is logged and dropped, the worker lives on,
        # and the finally keeps the pool count honest if it does die.
        try:
            while not self._shutdown:
                try:
                    conn = self._conns.get(timeout=1.0)
                except queue.Empty:
                    continue  # poll the shutdown flag; workers live with the server
                try:
                    self._serve_connection(conn)
                except Exception:  # noqa: BLE001 — fail the connection, not the pool
                    logger.exception(
                        "connection handler crashed — connection dropped, "
                        "worker continues"
                    )
        finally:
            with self._pool_lock:
                self._workers -= 1

    def shutdown(self) -> None:
        self._shutdown = True
        try:
            # closing the listener alone does not wake an accept() blocked
            # in another thread: serve_forever would return only at the
            # next connection. Shutting it down first makes that accept
            # fail at once
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        # accepted-but-unserved connections must not leak past the
        # server's lifetime: close them instead of leaving clients
        # hanging on sockets no worker will ever pick up
        while True:
            try:
                conn = self._conns.get_nowait()
            except queue.Empty:
                break
            try:
                conn.close()
            except OSError:
                pass

    server_close = shutdown  # stock servers expose both

    # -- connection loop ---------------------------------------------------
    def _await_request_line(self, conn, rfile):
        """Block for the next request's first line in short slices.

        The between-requests idle wait is where a keep-alive connection
        can pin a worker: with the whole pool pinned by idle sessions, a
        newly accepted connection would otherwise starve in the hand-off
        queue for the full 300 s keep-alive allowance. Waiting in 5 s
        slices lets the worker yield (returning None closes this
        connection) as soon as another connection is queued, while a
        sole idle client still gets the full allowance. A timeout slice
        that fires with zero bytes buffered is safe; a client that
        stalls >5 s MID-line risks its connection (buffered-reader state
        after a timeout is undefined) — that trade replaces silent
        starvation of everyone else."""
        deadline = time.monotonic() + 300.0
        while not self._shutdown:
            conn.settimeout(5.0)
            try:
                line = rfile.readline(_MAX_LINE + 1)
            except TimeoutError:
                if not self._conns.empty() or time.monotonic() > deadline:
                    return None  # yield the worker / reap the idler
                continue
            conn.settimeout(30.0)  # per-read budget for the rest
            return line
        return None

    def _serve_connection(self, conn: socket.socket) -> None:
        rfile = conn.makefile("rb", -1)
        try:
            while not self._shutdown:
                line = self._await_request_line(conn, rfile)
                if line is None or not self._handle_one(conn, rfile, line):
                    break
        except (OSError, ValueError):
            pass  # client went away mid-request; nothing to answer
        finally:
            try:
                rfile.close()
            finally:
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                conn.close()

    def _handle_one(self, conn, rfile, line: bytes) -> bool:
        """Serve one request (whose first line the worker already read in
        ``_await_request_line``); returns False when the connection is
        done."""
        if not line:
            return False  # client closed cleanly between requests
        if line in (b"\r\n", b"\n"):
            return True  # tolerate a stray blank line (RFC 9112 §2.2)
        t0 = time.perf_counter()
        parts = line.split()
        if len(parts) != 3 or len(line) > _MAX_LINE:
            return False  # not HTTP; drop the connection
        method, path, version = parts
        headers = {}
        for _ in range(_MAX_HEADERS):
            h = rfile.readline(_MAX_LINE + 1)
            if h in (b"\r\n", b"\n", b""):
                break
            if len(h) > _MAX_LINE or not h.endswith(b"\n"):
                # oversize or truncated header line: readline returned a
                # fragment, and the NEXT readline would re-parse its tail
                # as a forged header (e.g. a smuggled content-length that
                # desyncs keep-alive framing) — drop the connection
                return False
            key, sep, value = h.partition(b":")
            if sep:
                headers[key.strip().lower()] = value.strip()
        else:
            return False  # header flood; drop

        close = version == b"HTTP/1.0" or (
            headers.get(b"connection", b"").lower() == b"close"
        )

        # per-request observability context: every response carries
        # X-Request-Id (client-echoed or minted); X-Timing is the
        # client's opt-in to the span's stage breakdown
        req_id = http_api.ensure_request_id(headers.get(b"x-request-id"))
        want_timing = b"x-timing" in headers

        # body framing (mirrors the stock handler's _read_body contract)
        te = headers.get(b"transfer-encoding", b"").lower()
        try:
            content_length = int(headers.get(b"content-length", 0))
        except ValueError:
            content_length = -1
        body = b""
        bad_frame = (
            content_length < 0
            or b"chunked" in te
            or content_length > _MAX_BODY
        )
        if (
            not bad_frame
            and version != b"HTTP/1.0"
            and headers.get(b"expect", b"").lower() == b"100-continue"
        ):
            # answer the interim reply like the stock handler
            # (http.server handle_expect_100): without it curl holds a
            # large /solve_batch body back for its ~1 s Expect timeout
            # before sending. Never
            # for HTTP/1.0 requests (RFC 7231 §5.1.1: ignore Expect
            # there — a 1.0 client would read the interim 100 as the
            # final response), matching the stock handler's version gate.
            conn.sendall(b"HTTP/1.1 100 Continue\r\n\r\n")
        if not bad_frame and content_length:
            body = rfile.read(content_length)
            if len(body) < content_length:
                return False  # client died mid-body
        if bad_frame:
            path_s = path.decode("latin-1")
            if path_s in ("/solve", "/solve_batch"):
                self._record(path_s, t0, error=True)
            self._reply(
                conn, 400, {"error": "Invalid request"}, close=True,
                request_id=req_id,
            )
            return False

        path_s = path.decode("latin-1")
        # open the request span at ingress for the traced routes; the
        # route core runs inside it (the coalescer picks the span up from
        # the thread-local at submit — obs/trace.py)
        trace = None
        if method == b"POST" and (
            path_s == "/solve"
            or (path_s == "/solve_batch" and self.expose_batch)
        ):
            trace = http_api.start_trace(self.p2p_node, path_s, req_id)
        try:
            status, payload, close_after, degraded, cached = self._route(
                method,
                path_s,
                body,
                t0,
                deadline_ms=http_api._parse_deadline_ms(
                    headers.get(b"x-deadline-ms")
                ),
            )
        except BaseException:
            # a route-core crash (the worker-pool catch-all drops the
            # connection) must still CLOSE the span: workers are reused,
            # so a leaked thread-local would attach this dead request's
            # trace to the next request on this thread — and the crashed
            # request is exactly the span an incident dump needs
            http_api.finish_trace(self.p2p_node, trace, 500)
            raise
        record = http_api.finish_trace(
            self.p2p_node, trace, status, degraded=degraded
        )
        self._reply(
            conn, status, payload, close=close or close_after,
            degraded=degraded, cached=cached,
            request_id=req_id,
            timing=http_api.timing_header_value(record)
            if record is not None and want_timing
            else None,
        )
        return not (close or close_after)

    # -- routing -----------------------------------------------------------
    def _route(
        self, method: bytes, path: str, body: bytes, t0: float,
        deadline_ms=None,
    ):
        """Returns (status, payload, close_after, degraded, cached).
        Bodies come from the shared route cores — byte-identical to the
        stock transport; ``degraded`` marks fallback-served /solve
        answers (the X-Degraded header), ``cached`` answers served from
        the canonical-form cache (the X-Cache: hit header)."""
        node = self.p2p_node
        if method == b"POST":
            if path == "/solve":
                status, payload, error, degraded, cached = (
                    http_api.solve_route(
                        node, body, deadline_ms=deadline_ms
                    )
                )
                shed = status == 429
                self._record(
                    "/solve", t0, error=error and not shed, shed=shed
                )
                return status, payload, False, degraded, cached
            if path == "/solve_batch" and self.expose_batch:
                status, payload, error, degraded, cached = (
                    http_api.solve_batch_route(
                        node, body, deadline_ms=deadline_ms
                    )
                )
                self._record("/solve_batch", t0, error=error)
                return status, payload, False, degraded, cached
            if (
                path == "/debug/flightrecord"
                and getattr(node, "flight", None) is not None
            ):
                status, payload, _error = http_api.flightrecord_route(node)
                return status, payload, False, False, False
            if path == "/debug/faults" and getattr(
                node, "chaos_routes", False
            ):
                # the engine-seam fault injector's arming — shared core
                status, payload, _error = http_api.faults_route(
                    node, body
                )
                return status, payload, False, False, False
            # unknown POST path: the stock handler never reads these
            # bodies and must close; this transport already consumed the
            # body, but it keeps the same observable contract
            return 404, {"error": "Invalid endpoint"}, True, False, False
        if method == b"GET":
            if path == "/stats":
                return (
                    200,
                    http_api.stats_payload(node, self.expose_serving),
                    False,
                    False,
                    False,
                )
            if path == "/network":
                return 200, node.network_view(), False, False, False
            if path == "/metrics" and self.expose_metrics:
                return (
                    200, http_api.metrics_payload(node), False, False,
                    False,
                )
            if path in http_api.PROM_PATHS and self.expose_metrics:
                # Prometheus exposition — the shared core renders it, so
                # the bytes match the stock transport's exactly
                return (
                    200, http_api.metrics_prom_payload(node), False,
                    False, False,
                )
            if path == http_api.CLUSTER_PATH and self.expose_metrics:
                # the gossip-aggregated fleet view (obs/cluster.py)
                return (
                    200, http_api.cluster_payload(node), False, False,
                    False,
                )
            if path in http_api.CLUSTER_PROM_PATHS and self.expose_metrics:
                return (
                    200, http_api.cluster_prom_payload(node), False,
                    False, False,
                )
            if (
                path == "/debug/trace"
                and getattr(node, "flight", None) is not None
            ):
                # the span ring as Perfetto-loadable trace-event JSON
                status, payload, _error = http_api.trace_export_route(node)
                return status, payload, False, False, False
            if path == "/healthz":
                return (
                    200, http_api.healthz_payload(node), False, False,
                    False,
                )
            if path == "/readyz":
                status, payload = http_api.readyz_route(node)
                return status, payload, False, False, False
        return 404, {"error": "Invalid endpoint"}, False, False, False

    def _record(
        self, route: str, t0: float, error: bool = False, shed: bool = False
    ) -> None:
        http_api.record_route(self.p2p_node, route, t0, error=error, shed=shed)

    # -- response ----------------------------------------------------------
    @staticmethod
    def _reply(
        conn, status: int, payload, *, close: bool, degraded: bool = False,
        cached: bool = False, request_id=None, timing=None,
    ) -> None:
        if isinstance(payload, bytes):
            # pre-rendered non-JSON body (the Prometheus exposition)
            body = payload
            ctype = http_api.PROM_CONTENT_TYPE.encode()
        else:
            body = json.dumps(payload).encode()
            ctype = b"application/json"
        extra = b"Connection: close\r\n" if close else b""
        if degraded:
            # fallback-served answer marker; body stays byte-identical
            # (see http_api.SudokuHTTPHandler._send_response)
            extra = b"X-Degraded: true\r\n" + extra
        if cached:
            # answer-cache marker (cache/); same contract
            extra = b"X-Cache: hit\r\n" + extra
        if timing is not None:
            # the opt-in span breakdown (client sent X-Timing)
            extra = b"X-Timing: %s\r\n%s" % (timing.encode(), extra)
        if request_id is not None:
            # every response correlates (ensure_request_id sanitized it)
            extra = b"X-Request-Id: %s\r\n%s" % (request_id.encode(), extra)
        if status == 429:
            retry = http_api.retry_after_header(payload)
            if retry is not None:
                extra = b"Retry-After: %s\r\n%s" % (retry.encode(), extra)
        head = (
            b"HTTP/1.1 %d %s\r\n"
            b"Content-type: %s\r\n"
            b"Content-Length: %d\r\n"
            b"%s\r\n"
            % (
                status,
                _REASONS.get(status, b"Unknown"),
                ctype,
                len(body),
                extra,
            )
        )
        conn.sendall(head + body)
