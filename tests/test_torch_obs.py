"""The port's request-lifecycle tracing plane held against the JAX package's.

The single-node cases of ``tests/test_obs.py`` run on the port (CPU): span
completeness and the ``X-Request-Id`` / ``X-Timing`` headers, the flight
recorder's dump on a breaker trip with the poisoned span in it, the
shed-storm and HTTP triggers, Prometheus exposition that parses and
agrees with the ``/metrics`` JSON, the ``RequestMetrics`` alias, the
``torch.profiler`` device-trace counters, and thread-local isolation.
The copied modules (obs/histo, obs/trace, obs/prom, obs/flight) get the
same seeded inputs as the JAX package's and must give identical outputs.
Then a JAX node and a port node side by side answer the README board and
seeded corpus boards: the same bodies with the tracing plane on and off,
the same ``X-Timing`` key set, the same ``/metrics`` key tree, and the
same continuous-batching segment totals in ``engine.cost.continuous``.
"""

import json
import os
import re
import socket
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from sudoku_solver_distributed_tpu.engine import SolverEngine as JaxEngine
from sudoku_solver_distributed_tpu.net.http_api import (
    make_http_server as jax_make_http_server,
)
from sudoku_solver_distributed_tpu.net.node import P2PNode as JaxNode
from sudoku_solver_distributed_tpu.obs import flight as jflight
from sudoku_solver_distributed_tpu.obs import histo as jhisto
from sudoku_solver_distributed_tpu.obs import prom as jprom
from sudoku_solver_distributed_tpu.obs import trace as jtrace
from sudoku_solver_distributed_tpu.utils.profiling import (
    RequestMetrics as JaxRequestMetrics,
)
from sudoku_solver_distributed_tpu_torch.cache import AnswerCache
from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
from sudoku_solver_distributed_tpu_torch.net.http_api import make_http_server
from sudoku_solver_distributed_tpu_torch.net.node import P2PNode
from sudoku_solver_distributed_tpu_torch.obs import (
    FlightRecorder,
    Tracer,
    current_trace,
    valid_request_id,
)
from sudoku_solver_distributed_tpu_torch.obs import cost as tcost
from sudoku_solver_distributed_tpu_torch.obs import flight as tflight
from sudoku_solver_distributed_tpu_torch.obs import histo as thisto
from sudoku_solver_distributed_tpu_torch.obs import prom as tprom
from sudoku_solver_distributed_tpu_torch.obs import trace as ttrace
from sudoku_solver_distributed_tpu_torch.serving.admission import (
    AdmissionController,
)
from sudoku_solver_distributed_tpu_torch.serving.health import (
    DEGRADED,
    HEALTHY,
    EngineSupervisor,
)
from sudoku_solver_distributed_tpu_torch.utils import EngineFaultInjector
from sudoku_solver_distributed_tpu_torch.utils.profiling import RequestMetrics

BOARD = [[0] * 9 for _ in range(9)]
BOARD[0][0] = 5

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

TIMING_KEYS = {
    "total_ms", "cache_ms", "queue_ms", "coalesce_ms", "device_ms",
    "verify_ms", "fallback_ms", "bucket", "batch_id", "degraded",
    "fallback", "farmed", "segments",
}


def free_udp_port():
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_for(pred, timeout=8.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def serve(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd.server_address[1]


def request(port, path, payload=None, headers=None, method=None, raw=None):
    """(status, headers, body bytes) of one request; HTTP errors included."""
    data = raw if raw is not None else (
        json.dumps(payload).encode() if payload is not None else None
    )
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, headers=headers or {},
        method=method,
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


@pytest.fixture(scope="module")
def engine():
    eng = SolverEngine(device="cpu", buckets=(1, 4))
    eng.warmup()
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def served(engine):
    """One traced port node with /metrics behind the port's transport."""
    flight = FlightRecorder(dump_dir=None)
    tracer = Tracer(recorder=flight)
    node = P2PNode(
        "127.0.0.1", free_udp_port(), engine=engine, metrics=tracer.routes
    )
    node.tracer = tracer
    node.flight = flight
    httpd = make_http_server(
        node, "127.0.0.1", 0, expose_metrics=True, legacy_transport=True,
    )
    port = serve(httpd)
    yield {"node": node, "tracer": tracer, "flight": flight, "port": port}
    httpd.shutdown()
    httpd.server_close()


# -- spans + headers ---------------------------------------------------------


def test_solve_span_complete_and_headers(served):
    """A traced /solve echoes X-Request-Id, answers the opt-in X-Timing
    with the JAX node's key set, and the span carries the segment loop's
    attribution: the pool width as bucket, a segment id, real device
    time."""
    status, headers, body = request(
        served["port"], "/solve", {"sudoku": BOARD},
        headers={"X-Timing": "1", "X-Request-Id": "corr-1"},
    )
    assert status == 200
    assert headers["X-Request-Id"] == "corr-1"
    timing = json.loads(headers["X-Timing"])
    assert set(timing) == TIMING_KEYS
    assert timing["total_ms"] > 0
    assert timing["device_ms"] > 0
    assert timing["bucket"] == 4  # the lane pool's width
    assert timing["batch_id"] >= 1 and timing["segments"] >= 1
    assert timing["degraded"] is False and timing["fallback"] is False
    assert timing["farmed"] is False


def test_solve_without_timing_header_gets_no_breakdown(served):
    status, headers, _ = request(served["port"], "/solve", {"sudoku": BOARD})
    assert status == 200
    assert "X-Timing" not in headers
    # the request id is always there (minted, well-formed)
    assert valid_request_id(headers["X-Request-Id"])


def test_request_id_on_every_route_and_status(served, engine):
    """Every response carries a well-formed X-Request-Id: 200s, the 400 of
    a malformed body, 404s (GET and POST), a 429 shed and a 503 (a cold
    node's /readyz); a hostile id is replaced, a valid one echoed."""
    port = served["port"]
    seen = []
    for path in ("/stats", "/network", "/healthz", "/readyz", "/metrics",
                 "/nope"):
        seen.append(request(port, path)[:2])
    seen.append(request(port, "/nope", {})[:2])
    seen.append(request(port, "/solve", raw=b"{not json")[:2])
    cold = P2PNode(
        "127.0.0.1", free_udp_port(), engine=SolverEngine(device="cpu"),
        admission=AdmissionController(capacity=4),
    )
    cold_httpd = make_http_server(cold, "127.0.0.1", 0, legacy_transport=True)
    cold_port = serve(cold_httpd)
    try:
        seen.append(request(cold_port, "/readyz")[:2])
        seen.append(request(cold_port, "/solve", {"sudoku": BOARD},
                            headers={"X-Deadline-Ms": "0"})[:2])
    finally:
        cold_httpd.shutdown()
        cold_httpd.server_close()
        cold.engine.close()
    assert sorted({s for s, _ in seen}) == [200, 400, 404, 429, 503]
    for status, headers in seen:
        assert valid_request_id(headers["X-Request-Id"]), status
    _s, headers, _ = request(port, "/stats", headers={"X-Request-Id": "bad id!"})
    assert headers["X-Request-Id"] != "bad id!"
    assert valid_request_id(headers["X-Request-Id"])
    _s, headers, _ = request(port, "/nope", headers={"X-Request-Id": "id-7.x"})
    assert headers["X-Request-Id"] == "id-7.x"


# -- degraded fallback + flight recorder -------------------------------------


def test_breaker_trip_dumps_flightrecord_with_poisoned_span(engine, tmp_path):
    """A poisoned kernel serves a silently-wrong answer, host verification
    catches it, the breaker trips, and the flight recorder's incident dump
    holds that request's span with its stage timings and the fallback
    flag."""
    flight = FlightRecorder(dump_dir=str(tmp_path), incident_delay_s=0.1)
    tracer = Tracer(recorder=flight)
    inj = EngineFaultInjector()
    engine.fault_injector = inj
    # a CPU probe of the plain solver takes ~0.5 s: a budget of seconds
    sup = EngineSupervisor(engine, watchdog_budget_s=3.0, probe_interval_s=600.0)
    flight.attach_supervisor(sup)
    try:
        assert sup.state == HEALTHY
        # the pool width (the open loop) and the lone-request bucket
        inj.poison_bucket(1)
        inj.poison_bucket(4)
        trace = tracer.start("/solve")
        solution, info = engine.solve_one_supervised(BOARD)
        tracer.finish(trace, 200, degraded=bool(info.get("degraded")))
        assert solution is not None  # the fallback answered correctly
        assert sup.state == DEGRADED
        assert wait_for(lambda: flight.stats()["dumps"] >= 1, timeout=5.0)
        path = flight.stats()["last_dump_path"]
        assert path and path.startswith(str(tmp_path))
        with open(path) as f:
            payload = json.load(f)
        assert payload["reason"] == "breaker-degraded"
        kinds = [e["kind"] for e in payload["events"]]
        assert "supervisor-transition" in kinds
        poisoned = [s for s in payload["spans"] if s["fallback"]]
        assert poisoned, payload["spans"]
        span = poisoned[-1]
        assert span["degraded"] is True
        assert span["device_ms"] > 0       # the poisoned device call ran
        assert span["verify_ms"] > 0       # verification caught it
        assert span["fallback_ms"] > 0     # the oracle answered
        assert span["bucket"] == 4 and span["batch_id"] >= 1
        assert span["segments"] >= 1
        # the dump embeds the Perfetto trace of its spans
        assert payload["trace"]["traceEvents"]
    finally:
        sup.close()
        engine.supervisor = None
        engine.fault_injector = None
        inj.clear()


def test_shed_storm_triggers_dump(tmp_path):
    flight = FlightRecorder(
        dump_dir=str(tmp_path),
        shed_storm_threshold=8,
        shed_storm_window_s=5.0,
        incident_delay_s=0.05,
    )
    tracer = Tracer(recorder=flight)
    for _ in range(8):
        tracer.finish(tracer.start("/solve"), 429)
    assert wait_for(lambda: flight.stats()["dumps"] >= 1, timeout=5.0)
    assert flight.stats()["last_dump_reason"] == "shed-storm"


def test_flightrecord_http_trigger(served):
    status, headers, raw = request(served["port"], "/debug/flightrecord", raw=b"")
    body = json.loads(raw)
    assert status == 200 and body["dumped"] is True
    assert valid_request_id(headers["X-Request-Id"])
    # a dir-less recorder serves the record inline
    assert body["path"] is None and "record" in body
    assert isinstance(body["record"]["spans"], list)


def test_flightrecord_and_trace_404_without_recorder(engine):
    node = P2PNode(
        "127.0.0.1", free_udp_port(), engine=engine, metrics=RequestMetrics()
    )
    httpd = make_http_server(
        node, "127.0.0.1", 0, expose_metrics=True, legacy_transport=True,
    )
    port = serve(httpd)
    try:
        status, _h, raw = request(port, "/debug/flightrecord", raw=b"")
        assert status == 404
        assert json.loads(raw) == {"error": "Invalid endpoint"}
        assert request(port, "/debug/trace")[0] == 404
    finally:
        httpd.shutdown()
        httpd.server_close()


# -- Prometheus exposition ---------------------------------------------------

_PROM_LINE = re.compile(
    r"^(?:# (?:TYPE|HELP) .*|"
    r"[a-zA-Z_:][a-zA-Z0-9_:]*(?:\{[^{}]*\})? "
    r"[-+]?(?:[0-9.]+(?:[eE][-+]?[0-9]+)?|Inf|NaN))$"
)


def _prom_values(text):
    out = {}
    for line in text.strip().splitlines():
        if line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        out[name] = float(value)
    return out


def _quiesce(engine, timeout_s=60.0):
    """Wait until the engine's ``health()`` block stops changing: the
    open loop's trailing speculative segment, dispatched after the last
    answer, has finalized and been billed."""
    deadline = time.monotonic() + timeout_s
    last = json.dumps(engine.health(), sort_keys=True, default=str)
    while time.monotonic() < deadline:
        time.sleep(0.25)
        now = json.dumps(engine.health(), sort_keys=True, default=str)
        if now == last:
            return
        last = now
    raise AssertionError("the engine did not go quiet")


def test_prom_exposition_parses_and_agrees_with_json(served, monkeypatch):
    request(served["port"], "/solve", {"sudoku": BOARD})
    # Both scrapes must read one state. The cost plane's recent-window
    # gauges (recent_pps, sustained_*, recent_segments) are computed from
    # the clock at every scrape, so a segment of an earlier test in this
    # module that ages past the 60 s horizon between the two scrapes moved
    # them (a slow, loaded run crosses it): pin the clock the cost plane
    # reads, then let the open loop's trailing segment finish.
    frozen = time.monotonic()
    monkeypatch.setattr(
        tcost, "time", types.SimpleNamespace(monotonic=lambda: frozen)
    )
    _quiesce(served["node"].engine)
    _s, _h, raw_json = request(served["port"], "/metrics")
    body = json.loads(raw_json)
    _s, headers, raw_prom = request(served["port"], "/metrics.prom")
    assert headers["Content-Type"].startswith("text/plain; version=0.0.4")
    text = raw_prom.decode()
    for line in text.strip().splitlines():
        assert _PROM_LINE.match(line), f"unparseable prom line: {line!r}"
    values = _prom_values(text)
    assert values['sudoku_route_count{route="/solve"}'] == body["/solve"]["count"]
    assert values["sudoku_obs_finished"] == body["obs"]["finished"]
    dev = body["obs"]["stages"]["device"]
    assert values['sudoku_stage_latency_ms_count{stage="device"}'] == dev["count"]
    assert values['sudoku_stage_latency_ms_sum{stage="device"}'] == (
        pytest.approx(dev["sum_ms"], abs=0.01)
    )
    assert values['sudoku_stage_latency_ms_bucket{stage="device",le="+Inf"}'] == (
        dev["count"]
    )
    cont = body["engine"]["cost"]["continuous"]
    assert values["sudoku_engine_cost_continuous_segments"] == cont["segments"]
    assert values["sudoku_engine_cost_lane_steps"] == body["engine"]["cost"]["lane_steps"]
    # every leaf of the JSON body is a gauge of the same value (the node
    # is quiescent between the two scrapes), walked by the JAX package's
    # renderer as the oracle
    lines = []
    for key, value in body.items():
        if not key.startswith("/"):
            jprom._walk(lines, ("sudoku", key), value)
    assert lines
    for line in lines:
        name, _, value = line.rpartition(" ")
        assert values[name] == float(value), name


def test_prom_both_spellings_equal(served):
    """``/metrics.prom`` and ``/metrics?format=prom`` are byte-identical on
    a quiescent node, and equal the renderer applied to the JSON body."""
    a = request(served["port"], "/metrics.prom")[2]
    b = request(served["port"], "/metrics?format=prom")[2]
    assert a == b
    assert a.endswith(b"\n")


def test_prom_404_without_metrics_flag(engine):
    httpd = make_http_server(
        P2PNode("127.0.0.1", free_udp_port(), engine=engine,
                metrics=RequestMetrics()),
        "127.0.0.1", 0, legacy_transport=True,
    )
    port = serve(httpd)
    try:
        for path in ("/metrics", "/metrics.prom", "/metrics?format=prom"):
            status, _h, raw = request(port, path)
            assert status == 404 and json.loads(raw) == {"error": "Invalid endpoint"}
    finally:
        httpd.shutdown()
        httpd.server_close()


# -- RequestMetrics alias + device-trace capture -----------------------------


def test_request_metrics_alias_shape_unchanged():
    from sudoku_solver_distributed_tpu_torch.obs.histo import RouteMetrics

    assert RequestMetrics is RouteMetrics
    m = RequestMetrics(window=8)
    m.record("/solve", 0.004)
    m.record("/solve", 0.001, error=True)
    m.record("/solve", 0.0001, shed=True)
    s = m.summary()["/solve"]
    assert set(s) == {
        "count", "errors", "shed", "p50_ms", "p95_ms", "p99_ms", "max_ms",
    }
    assert s["count"] == 3 and s["errors"] == 1 and s["shed"] == 1
    j = JaxRequestMetrics(window=8)
    for args, kw in (((0.004,), {}), ((0.001,), {"error": True}),
                     ((0.0001,), {"shed": True})):
        j.record("/solve", *args, **kw)
    assert j.summary() == m.summary()


def test_device_trace_capture_counters(tmp_path):
    """--device-trace-dir: one warm-up capture and the first N bucket calls,
    each a torch.profiler trace file, counted in warm_info()."""
    eng = SolverEngine(device="cpu", buckets=(1,), coalesce=False)
    try:
        eng.arm_device_trace(str(tmp_path), calls=1)
        eng.warmup()
        info = eng.warm_info()["device_trace"]
        assert info["warmup_traced"] is True
        assert info["calls_remaining"] == 1
        assert len(list(tmp_path.iterdir())) == 1
        eng.solve_one(BOARD)
        info = eng.warm_info()["device_trace"]
        assert info["captured_calls"] == 1 and info["calls_remaining"] == 0
        eng.solve_one(BOARD)  # budget spent: nothing more is traced
        assert eng.warm_info()["device_trace"]["captured_calls"] == 1
        files = sorted(tmp_path.iterdir())
        assert len(files) == 2
        for f in files:
            doc = json.loads(f.read_text())
            names = {e.get("name") for e in doc["traceEvents"]}
            assert names & {"warmup", "solve_bucket_1"}, names
    finally:
        eng.close()


def test_profile_dir_traces_every_bucket_call(tmp_path):
    eng = SolverEngine(device="cpu", buckets=(1,), coalesce=False)
    try:
        eng.warmup()
        eng.profile_dir = str(tmp_path)
        eng.solve_one(BOARD)
        eng.solve_one(BOARD)
        assert len(list(tmp_path.iterdir())) == 2
    finally:
        eng.close()


def test_tracer_thread_local_isolation():
    tracer = Tracer()
    t = tracer.start("/solve")
    seen = []
    other = threading.Thread(target=lambda: seen.append(current_trace()))
    other.start()
    other.join(timeout=10)
    assert not other.is_alive()
    assert seen == [None]
    assert current_trace() is t
    tracer.finish(t, 200)
    assert current_trace() is None


# -- the copied modules on the same seeded inputs as the JAX package's --------


def _seeded_latencies(seed, n=400):
    rng = np.random.default_rng(seed)
    return [float(x) for x in rng.lognormal(-6.0, 2.0, n)]


def test_histo_copy_matches_jax():
    vals = _seeded_latencies(1)
    routes = ("/solve", "/stats", "/solve_batch")
    outs = []
    for mod in (jhisto, thisto):
        rm = mod.RouteMetrics(window=64)
        sm = mod.StageMetrics(window=64)
        for i, v in enumerate(vals):
            rm.record(routes[i % 3], v, error=i % 7 == 0, shed=i % 11 == 0)
            sm.observe_span({"queue": v / 3, "device": v / 2}, v)
            sm.observe("verify", v / 5)
        h = mod.Histogram()
        for v in vals:
            h.add(v)
        outs.append((
            rm.summary(), rm.counts(), sm.summary(), sm.histograms(),
            sm.digest_quantiles("device", (0.5, 0.9, 0.99)),
            sm.digest_quantiles("nope"), h.snapshot(),
            [h.quantile_ms(q) for q in (0.0, 0.25, 0.5, 0.99, 1.0)],
            mod.pct(sorted(vals), 0.95), mod.DEFAULT_BOUNDS_MS,
        ))
    assert outs[0] == outs[1]


def test_trace_copy_matches_jax():
    """The same marks give the same finished records (wall anchor and
    total aside), the same stage summaries, and the same id checks."""
    rng = np.random.default_rng(2)
    raw_ids = ["ok-1", "a.b_c-D", "x" * 64, "x" * 65, "", "bad id",
               "new\nline", b"bytes-ok", b"\xff", 12, None]
    raw_ids += ["".join(map(chr, rng.integers(32, 127, 12))) for _ in range(50)]
    assert jtrace.STAGES == ttrace.STAGES
    assert jtrace.RECORD_FIELDS == ttrace.RECORD_FIELDS
    assert [jtrace.valid_request_id(r) for r in raw_ids] == [
        ttrace.valid_request_id(r) for r in raw_ids
    ]
    marks = [
        {s: float(rng.uniform(0, 0.01)) for s in ttrace.STAGES
         if rng.random() < 0.7}
        for _ in range(30)
    ]
    outs = []
    for mod in (jtrace, ttrace):
        tracer = mod.Tracer()
        recs = []
        for i, m in enumerate(marks):
            tr = tracer.start("/solve", trace_id=f"t{i}")
            for stage, sec in m.items():
                tr.mark(stage, sec)
                tr.mark(stage, -1.0)  # negative marks clamp to 0
            tr.bucket, tr.batch_id, tr.segments = 8, i, i % 5
            rec = tracer.finish(tr, 200 if i % 4 else 429, degraded=i % 6 == 0)
            rec.pop("t")
            rec.pop("total_ms")
            recs.append(rec)
        snap = tracer.snapshot()
        stages = {k: {f: v for f, v in e.items() if not f.endswith("ms")
                      or f == "sum_ms"} for k, e in snap["stages"].items()
                  if k != "total"}
        outs.append((recs, snap["started"], snap["finished"], stages))
    assert outs[0] == outs[1]
    assert ttrace.new_request_id() != ttrace.new_request_id()
    assert ttrace.valid_request_id(ttrace.new_request_id())


def test_prom_copy_matches_jax():
    """The renderer gives byte-identical text for the same body and
    histograms."""
    rng = np.random.default_rng(3)
    body = {
        "/solve": {"count": 12, "errors": 1, "shed": 0, "p50_ms": 1.5,
                   "p95_ms": 2.25, "p99_ms": 3.0, "max_ms": 9.0},
        "engine": {
            "backend": "x\"y\\z\nw", "coalesce": True, "warmed": False,
            "cost": {"boards": 7, "device_s": float(rng.random()),
                     "buckets": {"8": {"fill_pct": 12.5}}, "list": [1, 2]},
            "1bad key!": 3, "none": None,
        },
        "health": {"state": "degraded", "transitions": [{"a": 1}]},
    }
    sm = thisto.StageMetrics()
    for v in _seeded_latencies(4, 100):
        sm.observe_span({"device": v, "queue": v / 4}, v * 2)
    hists = sm.histograms()
    assert jprom.CONTENT_TYPE == tprom.CONTENT_TYPE
    assert jprom.render(body, hists) == tprom.render(body, hists)
    assert jprom.render(body, None, prefix="p") == tprom.render(body, None, prefix="p")


def test_flight_copy_matches_jax(tmp_path):
    """The same spans and events give the same ring, stats and dump (its
    timestamps aside), written atomically under the same name."""
    rng = np.random.default_rng(5)
    records = []
    for i in range(40):
        rec = {"trace_id": f"id{i}", "route": "/solve", "t": 1000.0 + i,
               "status": 200, "total_ms": float(rng.uniform(1, 9))}
        for stage in ttrace.STAGES:
            rec[f"{stage}_ms"] = float(rng.uniform(0, 1))
        rec.update(bucket=8, batch_id=i, degraded=False, fallback=i == 3,
                   farmed=False, segments=i % 4)
        records.append(rec)
    outs = []
    for mod, sub in ((jflight, "jax"), (tflight, "port")):
        fr = mod.FlightRecorder(capacity=16, event_capacity=4,
                                dump_dir=str(tmp_path / sub),
                                shed_storm_threshold=1000)
        for rec in records:
            fr.record_span(rec)
        for k in range(6):
            fr.note_event("kind", {"k": k})
        out = fr.dump(reason="test")
        with open(out["path"]) as f:
            on_disk = json.load(f)
        for d in (out["payload"], on_disk):
            d.pop("t")
            for e in d["events"]:
                e.pop("t")
        trace = out["payload"].pop("trace")
        on_disk.pop("trace")
        trace["otherData"].pop("source")
        stats = fr.stats()
        stats.pop("last_dump_path")
        stats.pop("dump_dir")
        outs.append((fr.spans(), out["payload"], on_disk, trace, stats,
                     out["spans"], out["events"],
                     (tmp_path / sub).joinpath("flightrecord-0001-test.json").exists()))
    assert outs[0] == outs[1]
    assert outs[1][-1] is True
    assert len(outs[1][0]) == 16  # the ring keeps the last capacity spans


# -- a JAX node and a port node side by side ----------------------------------


def _corpus_boards(n):
    path = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                        "corpus_9x9_hard_64.npz")
    with np.load(path) as d:
        return [b.tolist() for b in d["boards"][:n]]


def _key_tree(d, skip=()):
    """The nested key paths of a JSON body (values aside)."""
    out = set()

    def walk(node, path):
        if path in skip:
            return
        if isinstance(node, dict):
            for k, v in node.items():
                out.add(path + (k,))
                walk(v, path + (k,))

    walk(d, ())
    return out


def _side_by_side(obs: bool, cache: bool):
    """A JAX node and a port node, each with its package's tracer and
    flight recorder when ``obs``; closed loop off, quiescence 0 so the
    pipelined segment loop's speculation is deterministic in both."""
    kw = dict(buckets=(1, 8), coalesce_quiescence_s=0.0)
    nodes, servers = [], []
    for Engine, Node, make, pkg in (
        (JaxEngine, JaxNode,
         lambda n: jax_make_http_server(n, "127.0.0.1", 0, expose_metrics=True,
                                        legacy_transport=True), "jax"),
        (lambda **k: SolverEngine(device="cpu", **k), P2PNode,
         lambda n: make_http_server(n, "127.0.0.1", 0, expose_metrics=True,
                                    legacy_transport=True),
         "port"),
    ):
        eng = Engine(**kw)
        eng.warmup()
        if pkg == "jax":
            from sudoku_solver_distributed_tpu import obs as o
            from sudoku_solver_distributed_tpu.cache import AnswerCache as Cache
            metrics_cls = JaxRequestMetrics
        else:
            from sudoku_solver_distributed_tpu_torch import obs as o
            Cache = AnswerCache
            metrics_cls = RequestMetrics
        tracer = o.Tracer(recorder=o.FlightRecorder()) if obs else None
        node = Node("127.0.0.1", free_udp_port(), engine=eng,
                    metrics=tracer.routes if obs else metrics_cls())
        if obs:
            node.tracer = tracer
            node.flight = tracer.recorder
        if cache:
            node.answer_cache = Cache(capacity=64)
        httpd = make(node)
        nodes.append(node)
        servers.append((httpd, serve(httpd)))
    return nodes, servers


def _close(nodes, servers):
    for httpd, _ in servers:
        httpd.shutdown()
        httpd.server_close()
    for node in nodes:
        node.engine.close()


@pytest.mark.parametrize("obs", [True, False], ids=["obs", "no-obs"])
def test_side_by_side_bodies_headers_and_metrics_match_jax(obs):
    """The README board and seeded corpus boards, one at a time, then the
    README again (a cache hit): byte-identical /solve bodies, X-Request-Id
    on both, the same X-Timing key set (obs on) or none (obs off), and
    the same /metrics key tree."""
    nodes, servers = _side_by_side(obs, cache=True)
    try:
        boards = [README_PUZZLE] + _corpus_boards(3) + [README_PUZZLE]
        for i, board in enumerate(boards):
            got = [
                request(port, "/solve", {"sudoku": board},
                        headers={"X-Timing": "1", "X-Request-Id": f"r{i}"})
                for _, port in servers
            ]
            (js, jh, jb), (ps, ph, pb) = got
            assert (ps, pb) == (js, jb)
            assert jh["X-Request-Id"] == ph["X-Request-Id"] == f"r{i}"
            assert jh.get("X-Cache") == ph.get("X-Cache")
            if obs:
                jt, pt = json.loads(jh["X-Timing"]), json.loads(ph["X-Timing"])
                assert set(pt) == set(jt) == TIMING_KEYS
                assert pt["segments"] == jt["segments"]
                assert pt["bucket"] == jt["bucket"]
            else:
                assert "X-Timing" not in jh and "X-Timing" not in ph
        jm, pm = (json.loads(request(port, "/metrics")[2]) for _, port in servers)
        # the XLA hot loop's compaction schedule has no counterpart in the
        # kernels: that subtree is the one documented difference
        skip = {("engine", "warm", "solver_loop")}
        assert _key_tree(pm, skip) == _key_tree(jm, skip)
        assert pm["engine"]["warm"]["solver_loop"] == {"backend": "plain"}
        for block in ("/solve",):
            for k in ("count", "errors", "shed"):
                assert pm[block][k] == jm[block][k]
        assert pm["engine"]["cost"]["cache"] == jm["engine"]["cost"]["cache"]
        assert pm["membership"] == jm["membership"]
    finally:
        _close(nodes, servers)


def test_side_by_side_continuous_cost_totals_match_jax():
    """The same sequential workload through both nodes (answer cache
    off): ``engine.cost.continuous`` counts the same segments, injected
    and resolved boards and lane utilization, and the cost block the same
    lane_steps and idle_lane_steps (the JAX block keeps the segments' raw
    lane counts there and in the pool width's bucket entry; no closed-loop
    call runs here) and the same dispatches, boards and pad."""
    nodes, servers = _side_by_side(True, cache=False)
    try:
        boards = [README_PUZZLE] + _corpus_boards(4)
        for board in boards:
            bodies = [request(port, "/solve", {"sudoku": board})[2]
                      for _, port in servers]
            assert bodies[0] == bodies[1]
        jm, pm = (json.loads(request(port, "/metrics")[2]) for _, port in servers)
        jc, pc = jm["engine"]["cost"], pm["engine"]["cost"]
        for k in ("segments", "injected", "resolved", "pipelined",
                  "lane_util_pct"):
            assert pc["continuous"][k] == jc["continuous"][k], k
        for k in ("dispatches", "boards", "lane_steps", "idle_lane_steps",
                  "pad_coalesce_pct", "fill_pct"):
            assert pc["buckets"]["8"][k] == jc["buckets"]["8"][k], k
        assert pc["buckets"]["8"]["dispatches"] == pc["continuous"]["segments"]
        assert pc["continuous"]["segments"] > len(boards)
        assert pc["continuous"]["injected"] == pc["continuous"]["resolved"] == 5
        for k in ("dispatches", "boards", "fill_pct", "pad_coalesce_pct",
                  "pad_mesh_pct", "lane_steps", "idle_lane_steps"):
            assert pc[k] == jc[k], k
        assert pc["formation"]["batches"] == jc["formation"]["batches"]
        assert pc["formation"]["avg_fill"] == jc["formation"]["avg_fill"]
        # spans: every request got as many segments on both nodes
        jspans = nodes[0].flight.spans()
        pspans = nodes[1].flight.spans()
        assert [s["segments"] for s in pspans] == [s["segments"] for s in jspans]
        assert [s["bucket"] for s in pspans] == [8] * len(boards)
    finally:
        _close(nodes, servers)
