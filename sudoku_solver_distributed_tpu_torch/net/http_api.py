"""HTTP API: POST /solve, GET /stats, GET /network — byte-identical bodies.

The port of ``sudoku_solver_distributed_tpu/net/http_api.py``: the route
cores both transports share, and the stock transport.
``make_http_server`` returns the lean keep-alive transport
(net/fastserve.py: HTTP/1.1, a bounded worker pool) by default, as the
JAX package does; ``legacy_transport=True`` (the CLI's
``--seed-serving``) returns the stdlib ``ThreadingHTTPServer`` speaking
HTTP/1.0, a connection per request. Response contract (reference
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
               500 → {"error": "Internal error"} when the solve raised an
                      error that is not a device fault (engine.device_fault:
                      e.g. a kernel library that does not build or load).
                      The JAX node drops the connection there
  POST /solve_batch 200 → {"solutions": [grid | null, ...], "solved": n,
               "capped": n[, "degraded": [bool, ...]]} for {"sudokus":
               [grid, ...]} (1..MAX_BATCH boards, at most MAX_BATCH_BYTES);
               400 / 429 as /solve. Only with ``expose_batch`` (CLI
               ``--batch-api``; 404 otherwise)
  GET  /stats  200 → the merged all_stats shape (plus a "serving" block of
               coalescer counters when asked for: ``expose_serving``)
  GET  /network 200 → the all_peers dict, or {self_id: []} when alone
  GET  /healthz 200 → {"ok": true} (liveness)
  GET  /readyz 200/503 → {"ready": ..., "warmed": ...[, "health": state]}
  GET  /metrics 200 → per-route latency percentiles, the engine's health
               and cost plane, cache, admission, supervision, faults,
               tracer and SLO blocks; ``/metrics.prom`` and
               ``/metrics?format=prom`` render the same body as
               Prometheus text. Only with ``expose_metrics`` (CLI
               ``--metrics``; 404 otherwise)
  GET  /debug/trace 200 → the flight recorder's span ring as Chrome
               trace-event JSON; POST /debug/flightrecord → a flight
               record dump. Both only on a node with a flight recorder
               (404 otherwise)
  POST /debug/faults → arms the engine-seam fault injector; only on a node
               built with ``--chaos-injector`` (404 otherwise)
  anything else 404 → {"error": "Invalid endpoint"}

A request may carry ``X-Deadline-Ms``, its latency budget; it counts only
with admission control on.

Every response carries ``X-Request-Id``: the client's own when it sent a
well-formed one, else a fresh id. On a node with a tracer
(``p2p_node.tracer``, obs/trace.py) each /solve opens a request span; a
client that sends an ``X-Timing`` header gets the span's stage breakdown
back as an ``X-Timing`` JSON header. Bodies are the same either way.

With an answer cache on the node (``p2p_node.answer_cache``, cache/; on by
default in the CLI) every /solve board is canonicalized at the front door,
before admission: a repeat, or any symmetric twin, of an answer already
verified is served from the cache with an ``X-Cache: hit`` header and
counts nothing in /stats. An answer from the supervisor's oracle fallback
carries ``X-Degraded: true``. Bodies stay byte-identical either way.

With cache gossip on the node (``p2p_node.cache_gossip``, cache/gossip.py)
a miss on a key some fresh peer advertises waits a bounded beat for that
peer's verified answer before it reaches the engine.

  GET  /metrics/cluster 200 → the gossip-aggregated fleet view
               (obs/cluster.py); ``/metrics/cluster.prom`` and
               ``/metrics/cluster?format=prom`` render it as Prometheus
               text. Gated as /metrics.
"""

from __future__ import annotations

import json
import logging
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..models.oracle import OracleBudgetExceeded
from ..obs.prom import CONTENT_TYPE as PROM_CONTENT_TYPE
from ..obs.trace import current_trace, new_request_id, valid_request_id
from ..serving.admission import DeadlineExceeded
from .stats import serving_snapshot

logger = logging.getLogger(__name__)

# the two Prometheus spellings of the /metrics surface, matched exactly
# (no general query parsing: every other path keeps its 404)
PROM_PATHS = ("/metrics.prom", "/metrics?format=prom")

MAX_BATCH = 4096        # board-count guard for /solve_batch
MAX_BATCH_BYTES = 32 << 20  # body-size guard, checked before buffering
# the largest /solve_batch the answer cache consults and feeds: the
# per-board canonicalization is pure Python, a rounding error on a single
# request but seconds of handler-thread work on a MAX_BATCH bulk job,
# which is throughput traffic, not the repeated stream the cache serves.
# Larger batches skip the cache (lookup and store) entirely
CACHE_BATCH_MAX = 256


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


def record_route(
    p2p_node, route: str, t0: float, error: bool = False, shed: bool = False
) -> None:
    """Fold one request into the node's route recorder
    (``p2p_node.metrics``, obs/histo.RouteMetrics) when it has one."""
    m = getattr(p2p_node, "metrics", None)
    if m is not None:
        m.record(route, time.perf_counter() - t0, error=error, shed=shed)


def ensure_request_id(raw) -> str:
    """The response's ``X-Request-Id``: the client's own id when it sent
    a well-formed one (so retries correlate), else a fresh one. Every
    response carries it — 404s, 429 sheds and degraded answers included:
    the replies that went wrong are the ones an operator must find again
    in the flight record."""
    return valid_request_id(raw) or new_request_id()


def start_trace(p2p_node, route: str, request_id: str):
    """Open a request span (obs/trace.py) when the node carries a tracer;
    None otherwise. Called unconditionally at ingress of /solve."""
    tracer = getattr(p2p_node, "tracer", None)
    if tracer is None:
        return None
    return tracer.start(route, trace_id=request_id)


def finish_trace(p2p_node, trace, status: int, degraded: bool = False):
    """Close a span; returns the finished record (the ``X-Timing`` header
    source) or None. Takes trace=None so call sites stay branch-free."""
    if trace is None:
        return None
    tracer = getattr(p2p_node, "tracer", None)
    if tracer is None:
        return None
    return tracer.finish(trace, status, degraded=degraded)


def timing_header_value(record: dict) -> str:
    """The opt-in ``X-Timing`` response header (sent when the request
    carried an ``X-Timing`` header): the span's stage breakdown as
    compact JSON, the JAX node's key set."""
    return json.dumps(
        {
            "total_ms": record["total_ms"],
            # the front-door answer-cache consult: nonzero on hits AND
            # misses
            "cache_ms": record["cache_ms"],
            "queue_ms": record["queue_ms"],
            "coalesce_ms": record["coalesce_ms"],
            "device_ms": record["device_ms"],
            "verify_ms": record["verify_ms"],
            "fallback_ms": record["fallback_ms"],
            "bucket": record["bucket"],
            "batch_id": record["batch_id"],
            "degraded": record["degraded"],
            "fallback": record["fallback"],
            "farmed": record["farmed"],
            # the device segments this request's device stage covered (0
            # on the closed loop)
            "segments": record["segments"],
        },
        separators=(",", ":"),
    )


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


def _cache_lookup(p2p_node, sudoku, deadline_ms=None):
    """Front-door cache consult: the local lookup, then, on a miss for a
    key some fresh peer's hot-set gossip advertises, a bounded peer fetch
    (verified on arrival) before any dispatch. Returns (answer | None,
    canonical form | None); exactly one hit or miss lands in the cache's
    counters. The elapsed time is the request span's ``cache`` stage,
    hit or miss.

    ``deadline_ms`` (the request's relative budget) clamps the peer fetch
    wait: a request never parks past its own deadline for an answer it
    could no longer use."""
    cache = p2p_node.answer_cache
    t0 = time.monotonic()
    try:
        # miss accounting deferred (count_miss=False): the peer-fetch path
        # probes the store twice for one request, and exactly one outcome
        # may land in the counters
        answer, form = cache.lookup(sudoku, count_miss=False)
        if answer is None and form is not None:
            gossip = getattr(p2p_node, "cache_gossip", None)
            if gossip is not None:
                budget_s = None
                if deadline_ms is not None:
                    budget_s = deadline_ms / 1e3 - (time.monotonic() - t0)
                if gossip.try_peer_fetch(form.key, timeout_s=budget_s):
                    # a verified peer answer just landed under this key:
                    # re-run the lookup and serve it as a hit
                    answer, form = cache.lookup(sudoku, form, count_miss=False)
        if answer is None and form is not None:
            cache._count("misses")
    finally:
        tr = current_trace()
        if tr is not None:
            tr.mark("cache", time.monotonic() - t0)
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
        answer, form = _cache_lookup(p2p_node, sudoku, deadline_ms=deadline_ms)
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
    except DeadlineExceeded:
        raise  # solve_route's 429
    except Exception:
        # not a device fault (those the supervisor answers from the
        # fallback): a kernel library that does not build or load, or a
        # programming error. A clean 500 instead of the dropped connection
        # the JAX node's transports give; never an oracle answer
        logger.exception("500: the solve failed")
        return 500, {"error": "Internal error"}, True, False, False
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


def solve_batch_route(p2p_node, body: bytes, deadline_ms=None):
    """POST /solve_batch (opt-in): the engine's bucketed batch path over
    HTTP. Body {"sudokus": [grid, ...]} → {"solutions": [grid | null, ...],
    "solved": n, "capped": n}; a null row is not solved, and ``capped``
    counts rows whose search exhausted the step budget (not finished, not
    proven unsatisfiable). Returns ``(status, payload, error_flag,
    degraded, cached)`` like ``solve_route``.

    Under an open breaker or a device failure mid-batch the supervised
    engine answers every board from the host-oracle fallback; the body
    then carries per-board ``degraded`` flags and ``degraded`` is True
    (the ``X-Degraded`` header), instead of the whole batch erroring.

    With an answer cache on the node and at most ``CACHE_BATCH_MAX``
    boards, cached boards are stripped out before the engine runs and
    their answers merged back in request order; ``cached`` says any board
    hit (the ``X-Cache: hit`` header).

    ``deadline_ms`` (the ``X-Deadline-Ms`` header): a budget already
    spent on arrival, or by validation and the cache consult, answers 429
    before the engine runs. An all-hit batch never sheds."""
    t_arrival = time.monotonic()
    try:
        sudokus = json.loads(body.decode())["sudokus"]
    except (ValueError, KeyError, TypeError, UnicodeDecodeError):
        return 400, {"error": "Invalid request"}, True, False, False
    size = p2p_node.engine.spec.size
    if not isinstance(sudokus, list) or not 1 <= len(sudokus) <= MAX_BATCH:
        reason = f"need 1..{MAX_BATCH} boards"
    else:
        reason = next(
            filter(None, (_board_error(s, size) for s in sudokus)), None
        )
    if reason is not None:
        logger.info("rejected /solve_batch body: %s", reason)
        return 400, {"error": "Invalid request"}, True, False, False
    cache = getattr(p2p_node, "answer_cache", None)
    n = len(sudokus)
    if cache is not None and n > CACHE_BATCH_MAX:
        cache = None
    answers = [None] * n
    forms = [None] * n
    hit = [False] * n
    if cache is not None:
        t0 = time.monotonic()
        for i, s in enumerate(sudokus):
            answers[i], forms[i] = cache.lookup(s)
            hit[i] = answers[i] is not None
        tr = current_trace()
        if tr is not None:
            tr.mark("cache", time.monotonic() - t0)
    miss_idx = [i for i in range(n) if not hit[i]]
    degraded = False
    degraded_rows = [False] * n
    capped = 0
    solved = n - len(miss_idx)
    if miss_idx:
        if deadline_ms is not None:
            # validation and the cache consult are charged against the
            # budget; once the engine runs, the batch runs to its end
            remaining_ms = deadline_ms - (time.monotonic() - t_arrival) * 1e3
            if remaining_ms <= 0:
                adm = getattr(p2p_node, "admission", None)
                retry = adm.retry_hint_s() if adm is not None else None
                logger.debug("shed /solve_batch: deadline expired")
                return (
                    429, _shed_payload("Deadline exceeded", retry), True,
                    False, False,
                )
        solutions, mask, info = p2p_node.batch_sudoku_solve(
            [sudokus[i] for i in miss_idx]
        )
        capped = info["capped"]
        solved += int(mask.sum())
        degraded = bool(info.get("degraded"))
        for pos, i in enumerate(miss_idx):
            if mask[pos]:
                answers[i] = solutions[pos].tolist()
                if cache is not None:
                    # write-gated: store verifies host-side
                    cache.store(sudokus[i], answers[i], forms[i])
            if degraded:
                degraded_rows[i] = bool(info["degraded_boards"][pos])
    payload = {"solutions": answers, "solved": solved, "capped": capped}
    if degraded:
        # per-board flags only when the fallback served: a healthy body
        # keeps its shape (a cached answer reads False, it was verified
        # when it was written)
        payload["degraded"] = degraded_rows
    return 200, payload, False, degraded, any(hit)


def healthz_payload(p2p_node):
    """GET /healthz — liveness: 200 whenever the HTTP plane answers. A
    DEGRADED or LOST node still answers correctly from the fallback and
    must not be restarted; /readyz tells them apart."""
    return {"ok": True}


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


def metrics_payload(p2p_node):
    """GET /metrics (opt-in): per-route percentiles (route keys start
    with "/", so they cannot collide with the blocks) and the blocks of
    the planes this node has, as the JAX node builds them: ``engine``
    (health, warm state, the cost plane with the answer cache's and cache
    gossip's counters under ``engine.cost.cache``), ``membership``,
    ``admission``, ``health`` (the supervisor, and the peers' gossiped
    states), ``faults``, ``obs`` (tracer and flight recorder), ``slo`` and
    ``autopilot``."""
    m = getattr(p2p_node, "metrics", None)
    body = m.summary() if m is not None else {}
    eng = getattr(p2p_node, "engine", None)
    if eng is not None:
        body["engine"] = eng.health()
    answer_cache = getattr(p2p_node, "answer_cache", None)
    if answer_cache is not None and isinstance(
        body.get("engine", {}).get("cost"), dict
    ):
        # cache hits ARE device cost avoided: the cache's counters live
        # where an operator reads serving spend, with cache gossip's
        snap = answer_cache.snapshot()
        gossip = getattr(p2p_node, "cache_gossip", None)
        if gossip is not None:
            snap["gossip"] = gossip.snapshot()
        body["engine"]["cost"]["cache"] = snap
    m_health = getattr(getattr(p2p_node, "membership", None), "health", None)
    if m_health is not None:
        body["membership"] = m_health()
    adm = getattr(p2p_node, "admission", None)
    if adm is not None:
        body["admission"] = adm.snapshot()
    sup = getattr(eng, "supervisor", None)
    if sup is not None:
        # the supervisor's state machine, plus the gossip-carried view of
        # the peers' supervisor states the task farm routes around
        health = sup.snapshot()
        peers = getattr(p2p_node, "peer_health", None)
        if peers is not None:
            health["peers"] = peers.snapshot()
        body["health"] = health
    # armed chaos injectors: a chaos run is read from /metrics, not logs
    faults = {}
    wire_inj = getattr(p2p_node, "fault_injector", None)
    if wire_inj is not None:
        faults["wire"] = wire_inj.counts()
    eng_inj = getattr(eng, "fault_injector", None)
    if eng_inj is not None:
        faults["engine"] = eng_inj.counts()
    if faults:
        body["faults"] = faults
    tracer = getattr(p2p_node, "tracer", None)
    if tracer is not None:
        body["obs"] = tracer.snapshot()
    flight = getattr(p2p_node, "flight", None)
    if flight is not None:
        body.setdefault("obs", {})["flight"] = flight.stats()
    slo = getattr(p2p_node, "slo", None)
    if slo is not None:
        # a scrape gets a fresh evaluation (the tick is rate-limited)
        body["slo"] = slo.snapshot()
    # the fleet autopilot (serving/autopilot.py): every control loop's
    # enable flag, knobs and counters, scalar leaves only
    autopilot = getattr(p2p_node, "autopilot", None)
    if autopilot is not None:
        body["autopilot"] = autopilot.snapshot()
    return body


# the cluster view's spellings, matched exactly as PROM_PATHS
CLUSTER_PATH = "/metrics/cluster"
CLUSTER_PROM_PATHS = (
    "/metrics/cluster.prom",
    "/metrics/cluster?format=prom",
)


def cluster_payload(p2p_node) -> dict:
    """``GET /metrics/cluster``: the gossip-aggregated fleet view, this
    node's own telemetry digest, every unexpired peer digest (TTL'd,
    freshness-marked) and fleet rollups (obs/cluster.py). Both transports
    serve it through this one core, gated as /metrics."""
    from ..obs.cluster import cluster_snapshot

    return cluster_snapshot(p2p_node)


def cluster_prom_payload(p2p_node) -> bytes:
    """The Prometheus rendering of the same cluster snapshot: per-node
    gauges labeled ``{node="host:port"}`` plus flattened fleet rollups."""
    from ..obs.cluster import cluster_snapshot, render_cluster_prom

    return render_cluster_prom(cluster_snapshot(p2p_node)).encode()


def metrics_prom_payload(p2p_node) -> bytes:
    """``GET /metrics.prom`` / ``GET /metrics?format=prom``: the SAME
    dict the JSON body serializes, rendered as Prometheus text
    (obs/prom.py), plus the tracer's stage histograms as histogram
    families."""
    from ..obs.prom import render

    body = metrics_payload(p2p_node)
    tracer = getattr(p2p_node, "tracer", None)
    histograms = tracer.stages.histograms() if tracer is not None else None
    return render(body, histograms).encode()


def trace_export_route(p2p_node):
    """``GET /debug/trace``: the flight recorder's span ring as Chrome
    trace-event JSON (obs/export.py, Perfetto-loadable). Returns (status,
    payload, error); 404 on a node without a recorder."""
    flight = getattr(p2p_node, "flight", None)
    if flight is None:
        return 404, {"error": "Invalid endpoint"}, True
    from ..obs.export import build_trace

    return 200, build_trace(flight.spans()), False


def flightrecord_route(p2p_node):
    """POST /debug/flightrecord: an operator-triggered flight-recorder
    dump (obs/flight.py, the same black box the breaker-trip, shed-storm,
    SLO and SIGUSR2 triggers write). Returns (status, payload, error): a
    summary plus the dump's path when the recorder has a dump directory,
    else the whole record inline. 404 on a node without a recorder."""
    flight = getattr(p2p_node, "flight", None)
    if flight is None:
        return 404, {"error": "Invalid endpoint"}, True
    out = flight.dump(reason="http")
    body = {
        "dumped": True,
        "reason": out["reason"],
        "seq": out["seq"],
        "path": out["path"],
        "spans": out["spans"],
        "events": out["events"],
    }
    if out["path"] is None:
        body["record"] = out["payload"]
    return 200, body, False


class SudokuHTTPHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.0"  # one connection per request, as the seed
    p2p_node = None  # set by make_http_server
    expose_serving = False  # opt-in "serving" block on GET /stats
    expose_metrics = False  # opt-in /metrics routes (CLI --metrics)
    expose_batch = False  # opt-in POST /solve_batch (CLI --batch-api)
    _req_id = None  # this request's X-Request-Id, set by _begin_request
    _want_timing = False  # the client sent X-Timing: it gets the breakdown

    def _begin_request(self) -> None:
        """Echo or mint the X-Request-Id every response carries, and note
        whether the client asked for the X-Timing stage breakdown."""
        self._req_id = ensure_request_id(self.headers.get("X-Request-Id"))
        self._want_timing = self.headers.get("X-Timing") is not None

    def _send_response(self, content, status: int = 200,
                       degraded: bool = False, cached: bool = False,
                       timing=None) -> None:
        if isinstance(content, bytes):
            # a pre-rendered non-JSON body (the Prometheus exposition)
            body = content
            ctype = PROM_CONTENT_TYPE
        else:
            body = json.dumps(content).encode()
            ctype = "application/json"
        self.send_response(status)
        self.send_header("Content-type", ctype)
        self.send_header("Content-Length", str(len(body)))
        if self._req_id is not None:
            self.send_header("X-Request-Id", self._req_id)
        if timing is not None:
            self.send_header("X-Timing", timing)
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

    def _read_body(self, route: str, t0: float, max_bytes=None):
        """The request body, or None after answering 400 and closing the
        connection when it cannot be framed (chunked, bad Content-Length,
        over ``max_bytes``)."""
        te = (self.headers.get("Transfer-Encoding") or "").lower()
        try:
            content_length = int(self.headers.get("Content-Length", 0))
        except (ValueError, TypeError):
            content_length = -1
        if (
            content_length < 0
            or "chunked" in te
            or (max_bytes is not None and content_length > max_bytes)
        ):
            self.close_connection = True
            record_route(self.p2p_node, route, t0, error=True)
            self._send_response({"error": "Invalid request"}, 400)
            return None
        return self.rfile.read(content_length)

    def do_POST(self):
        t0 = time.perf_counter()
        self._begin_request()
        if self.path == "/solve":
            post_data = self._read_body("/solve", t0)
            if post_data is None:
                return
            trace = start_trace(self.p2p_node, "/solve", self._req_id)
            try:
                status, payload, error, degraded, cached = solve_route(
                    self.p2p_node, post_data,
                    deadline_ms=_parse_deadline_ms(
                        self.headers.get("X-Deadline-Ms")
                    ),
                )
            except BaseException:
                # a route-core crash still closes the span: the crashed
                # request is the span an incident dump needs
                finish_trace(self.p2p_node, trace, 500)
                raise
            record = finish_trace(self.p2p_node, trace, status, degraded=degraded)
            # recorded before replying: a client may read /metrics the
            # instant its response arrives
            shed = status == 429
            record_route(self.p2p_node, "/solve", t0,
                         error=error and not shed, shed=shed)
            self._send_response(
                payload, status, degraded=degraded, cached=cached,
                timing=timing_header_value(record)
                if record is not None and self._want_timing else None,
            )
        elif self.path == "/solve_batch" and self.expose_batch:
            post_data = self._read_body(
                "/solve_batch", t0, max_bytes=MAX_BATCH_BYTES
            )
            if post_data is None:
                return
            trace = start_trace(self.p2p_node, "/solve_batch", self._req_id)
            try:
                status, payload, error, degraded, cached = solve_batch_route(
                    self.p2p_node, post_data,
                    deadline_ms=_parse_deadline_ms(
                        self.headers.get("X-Deadline-Ms")
                    ),
                )
            except BaseException:
                finish_trace(self.p2p_node, trace, 500)
                raise
            record = finish_trace(self.p2p_node, trace, status, degraded=degraded)
            record_route(self.p2p_node, "/solve_batch", t0, error=error)
            self._send_response(
                payload, status, degraded=degraded, cached=cached,
                timing=timing_header_value(record)
                if record is not None and self._want_timing else None,
            )
        elif (
            self.path == "/debug/flightrecord"
            and getattr(self.p2p_node, "flight", None) is not None
        ):
            post_data = self._read_body("/debug/flightrecord", t0)
            if post_data is None:
                return
            status, payload, _error = flightrecord_route(self.p2p_node)
            self._send_response(payload, status)
        elif self.path == "/debug/faults" and getattr(
            self.p2p_node, "chaos_routes", False
        ):
            post_data = self._read_body("/debug/faults", t0)
            if post_data is None:
                return
            status, payload, _error = faults_route(self.p2p_node, post_data)
            self._send_response(payload, status)
        else:
            # the body was never read: close rather than desync keep-alive
            self.close_connection = True
            self._send_response({"error": "Invalid endpoint"}, 404)

    def do_GET(self):
        self._begin_request()
        if self.path == "/stats":
            self._send_response(
                stats_payload(self.p2p_node, self.expose_serving)
            )
        elif self.path == "/network":
            self._send_response(self.p2p_node.network_view())
        elif self.path == "/metrics" and self.expose_metrics:
            self._send_response(metrics_payload(self.p2p_node))
        elif self.path in PROM_PATHS and self.expose_metrics:
            self._send_response(metrics_prom_payload(self.p2p_node))
        elif self.path == CLUSTER_PATH and self.expose_metrics:
            self._send_response(cluster_payload(self.p2p_node))
        elif self.path in CLUSTER_PROM_PATHS and self.expose_metrics:
            self._send_response(cluster_prom_payload(self.p2p_node))
        elif (
            self.path == "/debug/trace"
            and getattr(self.p2p_node, "flight", None) is not None
        ):
            status, payload, _error = trace_export_route(self.p2p_node)
            self._send_response(payload, status)
        elif self.path == "/healthz":
            # liveness: a DEGRADED or LOST node still answers correctly from
            # the fallback and must not be restarted; /readyz tells them apart
            self._send_response(healthz_payload(self.p2p_node))
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


def make_http_server(
    p2p_node,
    host: str,
    http_port: int,
    *,
    expose_metrics: bool = False,
    expose_batch: bool = False,
    expose_serving: bool = False,
    legacy_transport: bool = False,
    max_workers: int = 128,
):
    """The node's HTTP server, unstarted: serve_forever() / shutdown() /
    server_close() / server_address. By default the lean keep-alive
    transport (net/fastserve.py), whose connection-worker pool
    ``max_workers`` bounds; ``legacy_transport=True`` gives the stdlib
    threading server, a connection per request (HTTP/1.0), the
    ``--seed-serving`` baseline. ``expose_metrics`` opens GET /metrics and
    its Prometheus spellings, ``expose_batch`` POST /solve_batch, and
    ``expose_serving`` adds the coalescer's "serving" block to GET
    /stats."""
    if legacy_transport:
        handler = type(
            "BoundHandler",
            (SudokuHTTPHandler,),
            {
                "p2p_node": p2p_node,
                "expose_serving": expose_serving,
                "expose_metrics": expose_metrics,
                "expose_batch": expose_batch,
            },
        )
        httpd = _ThreadingHTTPServer((host, http_port), handler)
    else:
        from .fastserve import FastHTTPServer

        httpd = FastHTTPServer(
            p2p_node, host, http_port,
            expose_metrics=expose_metrics,
            expose_batch=expose_batch,
            expose_serving=expose_serving,
            max_workers=max_workers,
        )
    logger.info("HTTP server on %s:%s", host, http_port)
    return httpd
