"""The port's overload control (serving/admission.py, serving/load.py) on the
CPU: the cases of tests/test_admission.py run on the port's classes, its
closed-loop coalescer (``continuous=False``; the open loop's deadline cases
are in tests/test_torch_continuous.py) and its stdlib HTTP node, and the 429 surface (body bytes and
``Retry-After``) held byte for byte against the JAX node's.
"""

import json
import socket
import statistics
import threading
import time
import urllib.error
import urllib.request

import pytest

from sudoku_solver_distributed_tpu.engine import SolverEngine as JaxEngine
from sudoku_solver_distributed_tpu.models import generate_batch
from sudoku_solver_distributed_tpu.net import http_api as jax_http_api
from sudoku_solver_distributed_tpu.net.node import P2PNode as JaxNode
from sudoku_solver_distributed_tpu.serving import (
    AdmissionController as JaxAdmissionController,
)
from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
from sudoku_solver_distributed_tpu_torch.net import cli
from sudoku_solver_distributed_tpu_torch.net import http_api
from sudoku_solver_distributed_tpu_torch.net.node import P2PNode
from sudoku_solver_distributed_tpu_torch.parallel.coalescer import BatchCoalescer
from sudoku_solver_distributed_tpu_torch.serving import (
    AdaptiveWaitPolicy,
    AdmissionController,
    DeadlineExceeded,
    EwmaRate,
    WindowRate,
)


def free_port(kind=socket.SOCK_DGRAM):
    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def engine():
    eng = SolverEngine(device="cpu", buckets=(1, 8), continuous=False)
    eng.warmup()
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def boards():
    return generate_batch(16, 40, seed=11)


# -- load estimation ----------------------------------------------------------

def test_ewma_rate_tracks_and_decays():
    r = EwmaRate(tau_s=1.0)
    assert r.rate(0.0) == 0.0
    t = 0.0
    for _ in range(50):
        t += 0.01  # steady 100 Hz
        r.observe(t)
    assert 80.0 <= r.rate(t) <= 120.0
    assert r.rate(t + 1.0) < 2.0  # a stopped stream reads as falling


def test_window_rate_is_burst_correct_and_freezes():
    w = WindowRate(window_s=2.0)
    t = 0.0
    while t < 4.0:  # 225/s arriving as bursts of 8
        for _ in range(8):
            w.observe(t)
        t += 8 / 225.0
    assert w.rate(t) == pytest.approx(225.0, rel=0.15)
    assert w.rate(t + 10.0) == 0.0
    assert w.rate(t + 10.0, frozen=True) == pytest.approx(225.0, rel=0.2)


def test_adaptive_wait_monotone_in_load():
    p = AdaptiveWaitPolicy(max_wait_s=0.002, quiescence_s=0.001)
    rates = [0.0, 10.0, 50.0, 200.0, 500.0, 2000.0, 1e6]
    factors = [p.load_factor(r) for r in rates]
    assert factors == sorted(factors)
    assert factors[0] == 0.0 and factors[-1] == 1.0
    t = time.monotonic() - 0.1
    for _ in range(100):
        t += 0.001  # 1 kHz -> factor 1.0
        p.arrivals.observe(t)
    mw, q, bw = p.budgets()
    assert mw == pytest.approx(0.002, rel=0.05)
    assert q == pytest.approx(0.001, rel=0.05)
    assert bw == pytest.approx(0.020, rel=0.05)
    assert p.current_max_wait_s == mw


# -- admission controller -----------------------------------------------------

def test_admission_capacity_shed_and_release():
    a = AdmissionController(capacity=2)
    d1, d2 = a.try_admit(), a.try_admit()
    assert d1.admitted and d2.admitted
    d3 = a.try_admit()
    assert not d3.admitted and d3.reason == "capacity"
    assert d3.retry_after_s >= 1.0
    a.release()
    assert a.try_admit().admitted
    snap = a.snapshot()
    assert snap["shed_capacity"] == 1 and snap["admitted"] == 3
    assert snap["pending"] == 2


def test_admission_deadline_shed_at_arrival():
    a = AdmissionController(capacity=0, default_deadline_ms=100)
    d = a.try_admit(-1.0)
    assert not d.admitted and d.reason == "deadline"
    t = time.monotonic() - 2.0
    for k in range(20):
        a.try_admit(10_000.0)
        a._completions.observe(t + k * 0.1)
    assert a._completions.rate(t + 2.0) == pytest.approx(10.0, rel=0.2)
    a.pending = 5  # projected wait 500 ms > the 100 ms default budget
    d = a.try_admit()
    assert not d.admitted and d.reason == "deadline"
    assert a.try_admit(10_000.0).admitted


def test_admission_expired_releases_do_not_inflate_capacity():
    a = AdmissionController(capacity=8)
    for _ in range(6):
        assert a.try_admit().admitted
        a.release(expired=True)
    snap = a.snapshot()
    assert snap["expired"] == 6 and snap["completed"] == 0
    assert snap["completion_rate_hz"] == 0.0


def test_admission_default_deadline_attached_to_admitted_requests():
    a = AdmissionController(default_deadline_ms=250)
    d = a.try_admit()
    assert d.admitted
    assert d.deadline_s == pytest.approx(time.monotonic() + 0.25, abs=0.05)
    assert AdmissionController().try_admit().deadline_s is None


def test_admission_snapshot_keys_are_the_jax_keys_it_has_planes_for():
    """The port's snapshot is the JAX snapshot: the supervision re-anchors,
    the answer cache's hits and the autopilot's budget scale (set, and
    clamped to [0.05, 1]) are there."""
    mine, theirs = AdmissionController(4), JaxAdmissionController(4)
    for a in (mine, theirs):
        a.try_admit(), a.try_admit(-1.0)
        a.release()
        a.note_cache_hit(), a.note_rejected(), a.reanchor()
        a.set_budget_scale(0.01)
        a.set_budget_scale(0.5)
    want = theirs.snapshot()
    got = mine.snapshot()
    assert got["budget_scale"] == 0.5
    assert sorted(got) == sorted(want)
    # the rates read the wall clock; every counter is equal
    timed = ("arrival_rate_hz", "completion_rate_hz", "projected_wait_ms")
    assert {k: v for k, v in got.items() if k not in timed} == {
        k: v for k, v in want.items() if k not in timed}


# -- coalescer deadline edge cases ---------------------------------------------

def test_coalescer_drops_already_expired_at_batch_formation(engine, boards):
    calls = []
    real = engine._dispatch_padded

    def spy(b):
        calls.append(b.shape[0])
        return real(b)

    co = BatchCoalescer(engine, max_wait_s=0.02)
    engine._dispatch_padded = spy
    try:
        fut = co.submit(boards[0], time.monotonic() - 0.1)
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=10)
        assert co.stats()["expired"] == 1
        assert calls == []
        solution, info = co.submit(boards[1]).result(timeout=60)
        assert solution is not None, info
    finally:
        engine._dispatch_padded = real
        co.close()


def test_coalescer_drops_request_that_expires_mid_queue(engine, boards):
    co = BatchCoalescer(engine, max_wait_s=0.25)  # long co-rider wait
    try:
        fut = co.submit(boards[0], time.monotonic() + 0.05)
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=10)
        assert co.stats()["expired"] == 1
    finally:
        co.close()


def test_coalescer_delivers_request_that_expires_mid_flight(engine, boards):
    real = engine._finalize_padded

    def slow_finalize(call):
        time.sleep(0.2)
        return real(call)

    engine._finalize_padded = slow_finalize
    co = BatchCoalescer(engine, max_wait_s=0.0)
    try:
        fut = co.submit(boards[0], time.monotonic() + 0.1)
        solution, info = fut.result(timeout=60)
        assert solution is not None, info
        assert co.stats()["expired"] == 0
    finally:
        engine._finalize_padded = real
        co.close()


def test_adaptive_lone_request_dispatch_wait_beats_fixed_budget(boards):
    """Adaptive mode cuts a lone request's dispatch wait below the fixed
    2 ms budget, under the JAX copy's bounds (tests/test_admission.py),
    read on every request's own wait: its median, and its upper quartile,
    so a policy that waits out the budget on a quarter of the stream fails.

    The solve is pinned: each board's rows are computed by the plain
    solver before the measured stream and replayed by the engine's solve
    stage, so the stream's host work is the coalescer's own. What is left
    is the host's: with the suite's workers busy, the dispatcher thread
    wakes from its wait ~10 ms late on one request in 16 or so, in either
    arm and whatever the policy, which moved a mean of 8 past the bound."""
    waits = {}
    for adaptive in (False, True):
        eng = SolverEngine(device="cpu", buckets=(1, 8),
                           coalesce_adaptive=adaptive, continuous=False)
        eng.warmup()
        solve_stage, pinned = eng._stage_rows, {}

        def replay(dev, *args):
            key = dev.numpy().tobytes()
            if key not in pinned:
                pinned[key] = solve_stage(dev, *args)
            return pinned[key]

        eng._stage_rows = replay
        try:
            stream = [boards[i % len(boards)] for i in range(16)]
            for board in stream:  # the rows to replay, off the coalescer
                eng._solve_padded(board[None])
            per_request, total = [], 0.0
            for board in stream:
                sol, _ = eng.solve_one(board.tolist())
                assert sol is not None
                st = eng.coalescer.stats()
                per_request.append(st["avg_wait_ms"] * st["boards"] - total)
                total = st["avg_wait_ms"] * st["boards"]
                time.sleep(0.05)  # idle spacing: no co-riders in sight
            assert st["boards"] == len(stream)
            assert len(pinned) == len({b.tobytes() for b in stream})  # all replayed
            waits[adaptive] = (statistics.median(per_request),
                               statistics.quantiles(per_request, n=4)[2])
        finally:
            eng.close()
    # fixed mode waits out the full 2 ms budget for co-riders that never
    # come; adaptive mode sees a ~20 Hz stream and waits a few percent of it
    fixed, adaptive_waits = waits[False][0], waits[True]
    assert fixed >= 1.5, waits
    for wait in adaptive_waits:  # median, upper quartile
        assert wait < 1.0, waits
        assert wait < fixed / 2, waits


# -- HTTP surface ----------------------------------------------------------------

def _serve(node, **kw):
    httpd = http_api.make_http_server(node, "127.0.0.1", 0,
                                      legacy_transport=True, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def _post(port, body_obj, headers=None, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/solve",
        data=json.dumps(body_obj).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    return urllib.request.urlopen(req, timeout=timeout)


def _post_raw(port, body_obj, headers=None):
    """(status, body bytes, Retry-After) of one POST /solve."""
    try:
        with _post(port, body_obj, headers) as r:
            return r.status, r.read(), r.headers.get("Retry-After")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Retry-After")


EMPTY = [[0] * 9 for _ in range(9)]


def test_http_shed_response_shape(engine):
    adm = AdmissionController(capacity=1, default_deadline_ms=500)
    node = P2PNode("127.0.0.1", free_port(), engine=engine, admission=adm)
    httpd = _serve(node)
    port = httpd.server_address[1]
    try:
        with _post(port, {"sudoku": EMPTY}) as r:
            assert r.status == 200
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, {"sudoku": EMPTY}, {"X-Deadline-Ms": "0"})
        assert e.value.code == 429
        retry = e.value.headers.get("Retry-After")
        assert retry is not None and int(retry) >= 1
        payload = json.loads(e.value.read())
        assert payload["error"] == "Overloaded"
        assert payload["retry_after_ms"] >= 0
        adm.pending = adm.capacity  # fill the only slot
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(port, {"sudoku": EMPTY})
            assert e.value.code == 429
        finally:
            adm.pending = 0
        snap = adm.snapshot()
        assert snap["shed_deadline"] == 1 and snap["shed_capacity"] == 1
        assert snap["completed"] == 1
        assert "arrival_rate_hz" in snap and "projected_wait_ms" in snap
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_http_deadline_ignored_without_admission(engine):
    node = P2PNode("127.0.0.1", free_port(), engine=engine)
    httpd = _serve(node)
    try:
        with _post(httpd.server_address[1], {"sudoku": EMPTY},
                   {"X-Deadline-Ms": "0"}) as r:
            assert r.status == 200
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_http_garbage_deadline_header_is_ignored(engine):
    adm = AdmissionController(capacity=4)
    node = P2PNode("127.0.0.1", free_port(), engine=engine, admission=adm)
    httpd = _serve(node)
    try:
        with _post(httpd.server_address[1], {"sudoku": EMPTY},
                   {"X-Deadline-Ms": "soon-ish"}) as r:
            assert r.status == 200
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_rejected_bodies_do_not_feed_the_capacity_estimate(engine):
    adm = AdmissionController(capacity=8)
    node = P2PNode("127.0.0.1", free_port(), engine=engine, admission=adm)
    httpd = _serve(node)
    try:
        for _ in range(5):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(httpd.server_address[1], {"sudoku": "not-a-grid"})
            assert e.value.code == 400
        snap = adm.snapshot()
        assert snap["rejected"] == 5 and snap["completed"] == 0
        assert snap["completion_rate_hz"] == 0.0
        assert snap["pending"] == 0
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_http_429_bytes_match_jax_node(engine):
    """The same requests to a JAX node (stdlib transport) and to the port's
    node, both with admission: status, body bytes and Retry-After equal for
    the arrival shed by deadline and by capacity, and for a served board."""
    jax_adm = JaxAdmissionController(capacity=1, default_deadline_ms=500)
    adm = AdmissionController(capacity=1, default_deadline_ms=500)
    jax_node = JaxNode(
        "127.0.0.1", free_port(),
        engine=JaxEngine(coalesce=False, buckets=(1,)), admission=jax_adm,
    )
    node = P2PNode("127.0.0.1", free_port(), engine=engine, admission=adm)
    servers = [
        jax_http_api.make_http_server(jax_node, "127.0.0.1", 0,
                                      legacy_transport=True),
        http_api.make_http_server(node, "127.0.0.1", 0, legacy_transport=True),
    ]
    for s in servers:
        threading.Thread(target=s.serve_forever, daemon=True).start()
    ports = [s.server_address[1] for s in servers]
    try:
        # sheds first: with no completion measured yet, the retry hint is
        # the same on both nodes whatever the clock reads
        for headers in ({"X-Deadline-Ms": "0"}, {"X-Deadline-Ms": "-5"}):
            want, got = (_post_raw(p, {"sudoku": EMPTY}, headers) for p in ports)
            assert got == want and got[0] == 429, headers
        for a in (jax_adm, adm):
            a.pending = a.capacity
        want, got = (_post_raw(p, {"sudoku": EMPTY}) for p in ports)
        assert got == want and got[0] == 429 and got[2] == "1"
        assert json.loads(got[1])["error"] == "Overloaded"
        for a in (jax_adm, adm):
            a.pending = 0
        want, got = (_post_raw(p, {"sudoku": EMPTY}) for p in ports)
        assert got == want and got[0] == 200
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()


@pytest.mark.parametrize("raw", [None, "12.5", b"7", "0", "-3", "soon", ""])
def test_deadline_header_parse_matches_jax(raw):
    assert http_api._parse_deadline_ms(raw) == jax_http_api._parse_deadline_ms(raw)


@pytest.mark.parametrize("retry_s", [None, 0.0, 0.0004, 0.9991, 1.0, 3.2])
def test_shed_payload_and_retry_after_match_jax(retry_s):
    for error in ("Overloaded", "Deadline exceeded"):
        mine = http_api._shed_payload(error, retry_s)
        assert mine == jax_http_api._shed_payload(error, retry_s)
        assert json.dumps(mine) == json.dumps(
            jax_http_api._shed_payload(error, retry_s)
        )
        assert http_api.retry_after_header(mine) == (
            jax_http_api.retry_after_header(mine)
        )
    assert http_api.retry_after_header({"error": "x"}) is None


def test_cli_flags_build_admission_and_coalescer():
    args = cli.build_parser().parse_args(
        ["-p", "0", "-s", str(free_port()), "--platform", "cpu",
         "--buckets", "1,8", "--no-warmup", "--admission-capacity", "3",
         "--default-deadline-ms", "250", "--coalesce-max-wait-ms", "4",
         "--coalesce-max-batch", "8", "--adaptive-coalesce",
         "--serving-stats", "--no-continuous"]
    )
    node, httpd = cli.build_node(args)
    try:
        eng = node.engine
        assert node.admission.capacity == 3
        assert node.admission.default_deadline_s == pytest.approx(0.25)
        assert eng.coalesce and eng.coalesce_adaptive
        assert eng.coalesce_max_wait_s == pytest.approx(0.004)
        assert eng.coalesce_max_batch == 8
        assert not eng.continuous
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        status, body, _ = _post_raw(httpd.server_address[1], {"sudoku": EMPTY})
        assert status == 200
        with urllib.request.urlopen(
            f"http://127.0.0.1:{httpd.server_address[1]}/stats", timeout=30
        ) as r:
            stats = json.loads(r.read())
        assert stats["serving"]["coalesce"] is True
        assert stats["serving"]["batches"] == 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        node.shutdown()
        node.engine.close()
    defaults = cli.build_parser().parse_args([])
    assert not defaults.no_coalesce and defaults.coalesce_max_wait_ms == 2.0
    assert defaults.admission_capacity == 0 and defaults.default_deadline_ms == 0
    assert not defaults.serving_stats and not defaults.adaptive_coalesce
    assert not defaults.no_continuous and not defaults.no_segment_pipeline
    assert defaults.segment_iters is None and defaults.deep_lane_cap == 0
    off = cli.build_parser().parse_args(
        ["-s", str(free_port()), "--platform", "cpu", "--no-coalesce",
         "--no-warmup", "-p", "0"]
    )
    node, httpd = cli.build_node(off)
    try:
        assert not node.engine.coalesce and node.admission is None
    finally:
        httpd.server_close()
        node.shutdown()
