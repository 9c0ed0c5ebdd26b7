"""Engine supervision in the port held against the JAX package's: one fault
script runs on a JAX engine and a port engine (``device="cpu"``), each with
its own ``EngineSupervisor`` and ``EngineFaultInjector``. After every step
the supervisor state, its ``snapshot()`` counters (time fields dropped), the
injector's counts, ``engine.ready()``, the answers and ``info["degraded"]``
must be equal (tolerance 0: integers and strings), and no answer served may
be wrong. The script runs on three serving arms: no coalescer, the
closed-loop coalescer and the default continuous engine (a pool of 4).
Probes are driven by hand (a huge probe interval). The watchdog budget is a
few seconds, past the plain solver's empty-board probe on the CPU; the hang
step lowers it to a fraction of a second on both supervisors while it runs.
"""

import socket
import threading
import time

import numpy as np
import pytest

from sudoku_solver_distributed_tpu.engine import SolverEngine as JaxEngine
from sudoku_solver_distributed_tpu.models import generate_batch
from sudoku_solver_distributed_tpu.serving import health as jax_health
from sudoku_solver_distributed_tpu.serving.admission import (
    AdmissionController as JaxAdmission,
)
from sudoku_solver_distributed_tpu.utils.faults import (
    EngineFaultInjector as JaxInjector,
)
from sudoku_solver_distributed_tpu_torch.engine import (
    SolveStarved,
    SolverEngine,
    device_fault,
)
from sudoku_solver_distributed_tpu_torch.models import oracle_is_valid_solution
from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import KernelLaunchError
from sudoku_solver_distributed_tpu_torch.net import cli
from sudoku_solver_distributed_tpu_torch.serving import health
from sudoku_solver_distributed_tpu_torch.serving.admission import (
    AdmissionController,
)
from sudoku_solver_distributed_tpu_torch.serving.load import WindowRate
from sudoku_solver_distributed_tpu_torch.utils.faults import (
    EngineFaultInjector,
    InjectedEngineFault,
)

# a generated board the plain solver answers in a few steps
BOARD = generate_batch(1, 30, size=9, seed=5)[0].tolist()
UNSAT = [[0] * 9 for _ in range(9)]
UNSAT[0][0] = UNSAT[0][1] = 5  # two clashing clues

BUDGET_S = 3.0        # watchdog budget of the script
HANG_BUDGET_S = 0.25  # the hang step's; a pipelined segment's token gets 2x
DELAY_S = 1.2         # injected fetch delay: past 2x HANG_BUDGET_S

ARMS = {
    "direct": dict(coalesce=False),
    "closed": dict(coalesce=True, continuous=False),
    "continuous": dict(coalesce=True),
}


def wait_for(pred, timeout=10.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def _valid_answer(board, solution) -> bool:
    clues = np.asarray(board) > 0
    return oracle_is_valid_solution(solution) and bool(
        (np.asarray(solution)[clues] == np.asarray(board)[clues]).all()
    )


class Side:
    """One package's engine under its own supervisor and injector."""

    def __init__(self, engine, supervisor_cls, injector_cls, *,
                 watchdog_budget_s=BUDGET_S, probe_interval_s=600.0):
        self.engine = engine
        self.inj = injector_cls()
        engine.fault_injector = self.inj
        self.sup = supervisor_cls(
            engine, watchdog_budget_s=watchdog_budget_s, breaker_threshold=3,
            probe_interval_s=probe_interval_s,
        )

    def close(self):
        self.sup.close()
        self.engine.supervisor = None
        self.engine.fault_injector = None

    def solve(self, board):
        return self.engine.solve_one_supervised(board)

    def settled(self) -> dict:
        """The comparable view once no supervised call is in flight (a
        speculative segment may still be finishing after its request
        answered)."""
        assert wait_for(lambda: self.sup.snapshot()["inflight_calls"] == 0)
        snap = self.sup.snapshot()
        snap.pop("since_s")
        snap["transitions"] = [
            (t["from"], t["to"], t["reason"]) for t in snap["transitions"]
        ]
        return {
            "state": self.sup.state,
            "snapshot": snap,
            "faults": self.inj.counts(),
            "ready": self.engine.ready(),
            "bucket_for_1": self.engine._bucket_for(1),
        }


@pytest.fixture(scope="module", params=list(ARMS))
def engines(request):
    kw = dict(buckets=(1, 4), coalesce_max_wait_s=0.0,
              coalesce_quiescence_s=0.0, **ARMS[request.param])
    jax_engine = JaxEngine(**kw)
    port_engine = SolverEngine(device="cpu", **kw)
    jax_engine.warmup()
    port_engine.warmup()
    yield request.param, jax_engine, port_engine
    jax_engine.close()
    port_engine.close()


def _hang(side: Side):
    """A fetch delayed past the watchdog budget while a request is in
    flight: declared hung (and quarantined) while it still sleeps, then it
    finishes late and its answer is served."""
    side.sup.watchdog_budget_s = HANG_BUDGET_S
    side.inj.set_delay(DELAY_S)
    out = {}
    t = threading.Thread(target=lambda: out.update(r=side.solve(BOARD)),
                         daemon=True)
    t.start()
    try:
        assert wait_for(lambda: side.sup.state == "degraded", timeout=5.0)
        quarantined = sorted(side.sup.quarantined_widths())
        side.inj.set_delay(0.0)  # only the calls already in flight are slow
        t.join(timeout=30)
        assert wait_for(lambda: side.sup.snapshot()["inflight_calls"] == 0)
    finally:
        side.sup.watchdog_budget_s = BUDGET_S
    return (*out["r"], quarantined)


def _false_unsat(side: Side):
    """A kernel that clears the solved flag claims UNSAT for a solvable
    board: the supervised answer cross-checks it against the oracle."""
    return side.engine._supervised_answer(
        side.sup, np.asarray(BOARD, np.int32), lambda: (None, {"validations": 0})
    )


def _probe(side: Side):
    return side.sup.probe()


def _clear_and_probe(side: Side):
    side.inj.clear()
    return side.sup.probe()


def test_fault_script_matches_jax_supervisor(engines):
    arm, jax_engine, port_engine = engines
    width = 4 if arm == "continuous" else 1  # the width a lone request runs at
    sides = [
        Side(jax_engine, jax_health.EngineSupervisor, JaxInjector),
        Side(port_engine, health.EngineSupervisor, EngineFaultInjector),
    ]

    def fail_next(side):
        side.inj.arm_fail_next(10)
        return side.solve(BOARD)

    def poison(side):
        side.inj.poison_bucket(width)
        return side.solve(BOARD)

    script = [
        ("healthy", lambda s: s.solve(BOARD), health.HEALTHY),
        ("fail-next", fail_next, health.DEGRADED),
        ("probe-fails", _probe, health.DEGRADED),
        ("probe-fails-to-lost", _probe, health.LOST),
        ("lost-still-answers", lambda s: s.solve(BOARD), health.LOST),
        ("clear-probe", _clear_and_probe, health.HEALTHY),
        ("hang", _hang, health.DEGRADED),
        ("clear-probe-after-hang", _clear_and_probe, health.HEALTHY),
        ("poison", poison, health.DEGRADED),
        ("probe-under-poison", _probe,
         health.HEALTHY if width == 4 else health.DEGRADED),
        ("clear-probe-after-poison", _clear_and_probe, health.HEALTHY),
        ("false-unsat", _false_unsat, health.DEGRADED),
        ("clear-probe-after-unsat", _clear_and_probe, health.HEALTHY),
        ("genuine-unsat", lambda s: s.solve(UNSAT), health.HEALTHY),
        ("healthy-again", lambda s: s.solve(BOARD), health.HEALTHY),
    ]
    try:
        for name, step, want_state in script:
            outs = []
            for side in sides:
                out = step(side)
                outs.append((out, side.settled()))
            (jax_out, jax_view), (port_out, port_view) = outs
            assert port_view == jax_view, name
            assert port_view["state"] == want_state, name
            if isinstance(port_out, tuple):
                solution, info = port_out[:2]
                assert solution == jax_out[0], name
                assert info.get("degraded") == jax_out[1].get("degraded"), name
                assert info.get("routed") == jax_out[1].get("routed"), name
                assert port_out[2:] == jax_out[2:], name
                board = UNSAT if name == "genuine-unsat" else BOARD
                if solution is not None:
                    assert _valid_answer(board, solution), name  # never wrong
                else:
                    assert name == "genuine-unsat"
            else:
                assert port_out == jax_out, name
        snap = sides[1].sup.snapshot()
        assert snap["hangs"] >= 1 and snap["late_successes"] >= 1
        assert snap["bad_results"] >= 2 and snap["fallback"]["served"] >= 3
        assert sides[1].inj.counts()["poisoned"] >= 1
    finally:
        for side in sides:
            side.close()


@pytest.mark.parametrize("delay_during_rebuild", [False, True],
                         ids=["armed-failures", "fetch-delay"])
def test_lost_rebuild_warms_outside_the_seam_as_jax(delay_during_rebuild,
                                                    monkeypatch):
    """The LOST rebuild (``_rebuild`` → ``warmup``) on a warmed engine:
    three supervised solves under five armed failures (the first fails,
    the fallback answers the others), then the rebuild, then half-open
    probes by hand until HEALTHY.
    The rebuild must consume no armed failure and relaunch no warm width,
    as the JAX engine's warm-up does not; with a fetch delay armed during
    the rebuild (past a lowered watchdog budget), no width may be declared
    hung or quarantined. Probe counts, settled views and the injector's
    counts must be equal."""
    launches = []  # the port's bucket launches
    real = SolverEngine._launch
    monkeypatch.setattr(
        SolverEngine, "_launch",
        lambda self, boards, *a, **kw: launches.append(boards.shape[0])
        or real(self, boards, *a, **kw),
    )
    views = []
    for engine_cls, sup_cls, inj_cls, kw in (
        (JaxEngine, jax_health.EngineSupervisor, JaxInjector, {}),
        (SolverEngine, health.EngineSupervisor, EngineFaultInjector,
         {"device": "cpu"}),
    ):
        eng = engine_cls(coalesce=False, buckets=(1, 4), **kw)
        eng.warmup()
        side = Side(eng, sup_cls, inj_cls, watchdog_budget_s=30.0,
                    probe_interval_s=3600.0)
        try:
            side.inj.arm_fail_next(5)
            answers = [side.solve(BOARD) for _ in range(3)]
            assert all(_valid_answer(BOARD, sol) for sol, _ in answers)
            if delay_during_rebuild:
                side.sup.watchdog_budget_s = HANG_BUDGET_S
                side.inj.set_delay(DELAY_S)
            launches.clear()
            side.sup._rebuild()
            assert launches == [], "the rebuild relaunched a warm bucket"
            side.inj.set_delay(0.0)
            side.sup.watchdog_budget_s = 30.0
            rebuilt = side.settled()
            probes = 0
            while side.sup.state != health.HEALTHY:
                assert probes < 10, "the probes never re-admitted the device"
                side.sup.probe()
                probes += 1
            views.append((rebuilt, probes, side.settled()))
        finally:
            side.close()
            eng.close()
    assert views[1] == views[0]
    rebuilt, probes, _ = views[1]
    # the rebuild consumed no armed failure and declared no hang; the
    # probes took the other four
    assert rebuilt["faults"]["calls"] == 1
    assert rebuilt["faults"]["armed_fail_next"] == 4
    assert rebuilt["snapshot"]["hangs"] == 0
    assert probes == 5


def test_lost_engine_rebuilds_and_reenters_healthy():
    """The LOST episode on the watchdog's own clock: the breaker opens, the
    rebuild re-warms the engine, the automatic probe (the DFS kernel at
    bucket 1) verifies a round trip, HEALTHY again; /readyz's predicate
    follows."""
    eng = SolverEngine(device="cpu", buckets=(1, 4), coalesce=False)
    eng.warmup()
    inj = EngineFaultInjector()
    eng.fault_injector = inj
    sup = health.EngineSupervisor(eng, watchdog_budget_s=5.0,
                                  breaker_threshold=1, probe_interval_s=0.1)
    try:
        inj.arm_fail_next(1)
        solution, info = eng.solve_one_supervised(BOARD)
        assert _valid_answer(BOARD, solution) and info["degraded"]
        assert sup.state == health.LOST and not eng.ready()
        assert wait_for(lambda: sup.state == health.HEALTHY, timeout=20.0)
        assert sup.rebuilds == 1 and sup.probes >= 1 and eng.ready()
        solution, info = eng.solve_one_supervised(BOARD)
        assert _valid_answer(BOARD, solution) and not info.get("degraded")
    finally:
        sup.close()
        eng.close()


def test_first_call_at_an_unwarmed_width_is_not_a_hang():
    """A cold engine's first call at a width may include the kernel build:
    the watchdog excuses it, and ``_watched_widths`` lists no width that
    has not run. Once the width has completed a call, the same delay is a
    hang."""
    eng = SolverEngine(device="cpu", buckets=(1,), coalesce=False)
    assert eng._warm_widths() == eng._watched_widths() == []
    inj = EngineFaultInjector()
    eng.fault_injector = inj
    sup = health.EngineSupervisor(eng, watchdog_budget_s=0.2,
                                  probe_interval_s=600.0)
    try:
        assert sup.state == health.WARMING
        inj.set_delay(0.8)
        solution, _ = eng.solve_one(BOARD)
        assert solution is not None
        assert sup.hangs == 0 and sup.state == health.HEALTHY
        t = threading.Thread(target=lambda: eng.solve_one(BOARD), daemon=True)
        t.start()
        assert wait_for(lambda: sup.hangs >= 1, timeout=5.0)
        t.join(timeout=10)
    finally:
        sup.close()
        eng.close()


def test_warm_widths_are_the_buckets_then_the_pool():
    """The watchdog's widths are the warm buckets and the segment pool's
    width; ``_warm_widths`` (the JAX engine's name, what tiling reads) is
    the warm buckets alone. A budget-cut warm-up tells the two apart: the
    pool's warm segment ran at 8, the bucket 8 did not."""
    eng = SolverEngine(device="cpu", buckets=(1, 8))
    try:
        eng.warmup()
        assert eng._warm_widths() == [1, 8]  # the pool is 8 wide
        assert eng._watched_widths() == [1, 8]
    finally:
        eng.close()
    eng = SolverEngine(device="cpu", buckets=(1, 8), coalesce_max_batch=2,
                       continuous=True)
    try:
        eng.warmup()
        assert eng.segment_pool_width() == 8
        assert eng._warm_widths() == [1, 8]
        assert eng._watched_widths() == [1, 8]
    finally:
        eng.close()
    eng = SolverEngine(device="cpu", buckets=(1, 8))
    try:
        eng.warmup(budget_s=0.0)
        assert eng.warm_info()["skipped"] == [8]
        assert eng._warm_widths() == [1]
        assert eng._watched_widths() == [1, 8]
    finally:
        eng.close()


@pytest.mark.parametrize("budget_scale, trips", [(1.0, True), (2.0, False)])
def test_token_budget_scale_and_abandon_match_jax(budget_scale, trips):
    """A speculative segment's token (``budget_scale=2``) outlives the plain
    budget without a trip, a plain one trips; an abandoned token feeds the
    breaker nothing. Both supervisors agree."""
    views = []
    for sup_cls in (jax_health.EngineSupervisor, health.EngineSupervisor):
        eng = SolverEngine(device="cpu", buckets=(4,), coalesce=False)
        sup = sup_cls(eng, watchdog_budget_s=0.3, breaker_threshold=99,
                      probe_interval_s=600.0)
        try:
            t0 = sup.call_started(4)
            sup.call_finished(t0, ok=True)  # the width is proven
            tok = sup.call_started(4, budget_scale=budget_scale)
            gone = sup.call_started(4)
            sup.call_abandoned(gone)
            time.sleep(0.45)
            tripped = sup.hangs
            sup.call_finished(tok, ok=True)
            snap = sup.snapshot()
            views.append((tripped, snap["failures"], snap["consecutive_failures"],
                          snap["late_successes"], snap["state"]))
        finally:
            sup.close()
    assert views[0] == views[1]
    assert views[1][0] == (1 if trips else 0)


def test_starved_future_falls_back_and_is_cancelled():
    from concurrent.futures import Future

    eng = SolverEngine(device="cpu", buckets=(1,), coalesce=False)
    sup = health.EngineSupervisor(eng, watchdog_budget_s=0.05,
                                  probe_interval_s=600.0)
    try:
        never = Future()  # a hung batch's future: nobody resolves it
        solution, info = eng._supervised_answer(
            sup, np.asarray(BOARD, np.int32), lambda: eng._await_result(never)
        )
        assert _valid_answer(BOARD, solution) and info["degraded"]
        assert never.cancelled()  # the coalescer's _resolve skips it
    finally:
        sup.close()


SEAM_ERRORS = [
    (InjectedEngineFault("injected"), True),
    (KernelLaunchError("dfs_segment launch failed: cudaError 700"), True),
    (SolveStarved("supervised solve starved past 11.0s"), True),
    (RuntimeError("nvcc failed (1) building dfs_solver.cu"), False),
    (OSError("libdfs_solver.so: cannot open shared object file"), False),
    (RuntimeError("a plain programming error"), False),
]


@pytest.mark.parametrize("arm", ["direct", "continuous"])
@pytest.mark.parametrize("exc,fault", SEAM_ERRORS,
                         ids=[f"{type(e).__name__}{i}"
                              for i, (e, _) in enumerate(SEAM_ERRORS)])
def test_single_board_seam_falls_back_only_on_device_faults(arm, exc, fault,
                                                           monkeypatch):
    """A supervised /solve whose device call raises answers from the host
    fallback, flagged degraded, only on a device fault; a kernel library
    that does not build or load, or a plain error, answers 500 without the
    degraded flag. The JAX engine falls back on any exception."""
    import json

    from sudoku_solver_distributed_tpu_torch.net.http_api import solve_route
    from sudoku_solver_distributed_tpu_torch.net.node import P2PNode

    assert device_fault(exc) is fault
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    eng = SolverEngine(device="cpu", buckets=(1,), **ARMS[arm])
    eng.warmup()
    node = P2PNode("127.0.0.1", port, engine=eng)
    sup = health.EngineSupervisor(eng, watchdog_budget_s=BUDGET_S,
                                  probe_interval_s=600.0)
    try:
        body = json.dumps({"sudoku": BOARD}).encode()
        status, sol, *_ = solve_route(node, body)
        assert status == 200 and _valid_answer(BOARD, sol)

        def failing(*args, **kw):
            raise exc

        hook = "_launch" if arm == "direct" else "dispatch_segment"
        monkeypatch.setattr(eng, hook, failing)
        status, payload, error, degraded, cached = solve_route(node, body)
        if fault:
            assert (status, error, degraded, cached) == (200, False, True, False)
            assert _valid_answer(BOARD, payload)
        else:
            assert (status, payload, error, degraded, cached) == (
                500, {"error": "Internal error"}, True, False, False)
    finally:
        sup.close()
        node.shutdown()
        eng.close()


def test_fallback_over_budget_answers_503():
    """A degraded node whose oracle fallback runs past its budget answers
    the JAX node's 503 body, flagged degraded."""
    from sudoku_solver_distributed_tpu_torch.net.http_api import solve_route
    from sudoku_solver_distributed_tpu_torch.net.node import P2PNode

    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    eng = SolverEngine(device="cpu", buckets=(1,), coalesce=False)
    node = P2PNode("127.0.0.1", port, engine=eng)
    sup = health.EngineSupervisor(eng, probe_interval_s=600.0,
                                  fallback_budget_s=1e-9)
    try:
        sup.record_failure(None, "bad-result")  # DEGRADED: fallback serves
        import json

        status, payload, error, degraded, cached = solve_route(
            node, json.dumps({"sudoku": BOARD}).encode()
        )
        assert (status, payload, error, degraded, cached) == (
            503, {"error": "Degraded: fallback budget exceeded"}, True, True,
            False,
        )
        assert sup.fallback_budget_trips == 1
    finally:
        sup.close()
        node.shutdown()


def test_injector_matches_jax_and_corrupts_packed_rows():
    """``corrupt`` poisons the port's packed rows [grid | solved | status |
    guesses | validations | ...] as the JAX injector poisons its own: the
    first two grid cells forced equal, the status fields untouched."""
    rng = np.random.default_rng(7)
    packed = rng.integers(1, 10, size=(4, 81 + 7)).astype(np.int32)
    outs = []
    for cls in (JaxInjector, EngineFaultInjector):
        inj = cls(fail_next=2)
        raised = 0
        for _ in range(3):
            try:
                inj.on_device_call(1)
            except Exception as e:  # noqa: BLE001 — the injected fault
                assert type(e).__name__ == "InjectedEngineFault"
                raised += 1
        same = inj.corrupt(4, packed)
        inj.poison_bucket(4)
        poisoned = inj.corrupt(4, packed)
        inj.set_delay(0.001)
        inj.on_fetch(4)
        outs.append((raised, same.copy(), poisoned, inj.counts()))
        inj.clear()
        outs[-1] += (inj.counts(),)
    (jr, js, jp, jc, jcl), (pr, ps, pp, pc, pcl) = outs
    assert (pr, pc, pcl) == (jr, jc, jcl)
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pp, jp)
    assert (pp[:, 0] == pp[:, 1]).all() and (pp[:, 2:] == packed[:, 2:]).all()
    assert (packed[:, 0] != packed[:, 1]).any()  # never mutated in place
    with pytest.raises(InjectedEngineFault):
        EngineFaultInjector(fail_next=1).on_device_call(1)


def test_admission_reanchor_and_cache_gauges_match_jax():
    outs = []
    for cls in (JaxAdmission, AdmissionController):
        adm = cls(capacity=4)
        d = adm.try_admit(None)
        adm.release(served=True)
        assert d.admitted
        adm.note_rejected()
        adm.note_cache_hit()
        adm.note_cache_hit()
        adm.reanchor()
        snap = adm.snapshot()
        outs.append({k: snap[k] for k in (
            "admitted", "completed", "rejected", "reanchors", "cache_hits",
            "pending", "completion_rate_hz")})
    assert outs[0] == outs[1]
    assert outs[1]["cache_hits"] == 2 and outs[1]["reanchors"] == 1
    rate = WindowRate(window_s=1.0)
    for _ in range(10):
        rate.observe()
    assert rate.rate(frozen=True) > 0
    rate.reanchor()
    assert rate.rate(frozen=True) == 0.0


def _udp_port():
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_defaults_cache_on_no_supervisor_no_injector():
    args = cli.build_parser().parse_args(
        ["-p", "0", "-s", str(_udp_port()), "--platform", "cpu",
         "--buckets", "1", "--no-warmup"]
    )
    assert (args.no_answer_cache, args.answer_cache_capacity) == (False, 4096)
    assert not args.supervise_engine and not args.chaos_injector
    assert (args.watchdog_budget_s, args.breaker_threshold,
            args.probe_interval_s, args.fallback_concurrency,
            args.fallback_budget_s) == (30.0, 3, 2.0, 2, 30.0)
    node, httpd = cli.build_node(args)
    try:
        assert node.answer_cache is not None
        assert node.answer_cache.capacity == 4096
        assert node.engine.supervisor is None
        assert node.engine.fault_injector is None and not node.chaos_routes
    finally:
        httpd.server_close()
        node.shutdown()
        node.engine.close()


def test_cli_every_new_flag():
    args = cli.build_parser().parse_args(
        ["-p", "0", "-s", str(_udp_port()), "--platform", "cpu",
         "--buckets", "1", "--no-warmup", "--answer-cache-capacity", "7",
         "--supervise-engine", "--watchdog-budget-s", "0.5",
         "--breaker-threshold", "5", "--probe-interval-s", "0.2",
         "--fallback-concurrency", "3", "--fallback-budget-s", "0",
         "--chaos-injector", "--admission-capacity", "8"]
    )
    node, httpd = cli.build_node(args)
    sup = node.engine.supervisor
    try:
        assert node.answer_cache.capacity == 7
        assert (sup.watchdog_budget_s, sup.breaker_threshold,
                sup.probe_interval_s, sup.fallback_concurrency,
                sup.fallback_budget_s) == (0.5, 5, 0.2, 3, None)
        assert sup.state == health.WARMING  # --no-warmup: not warm yet
        assert isinstance(node.engine.fault_injector, EngineFaultInjector)
        assert node.chaos_routes
        # the admission re-anchor rides every supervisor transition
        sup.record_failure(None, "bad-result")
        assert node.admission.snapshot()["reanchors"] == 1
    finally:
        httpd.server_close()
        node.shutdown()
        node.engine.close()
    args = cli.build_parser().parse_args(
        ["-p", "0", "-s", str(_udp_port()), "--platform", "cpu",
         "--buckets", "1", "--no-warmup", "--no-answer-cache"]
    )
    node, httpd = cli.build_node(args)
    try:
        assert node.answer_cache is None
    finally:
        httpd.server_close()
        node.shutdown()
        node.engine.close()
