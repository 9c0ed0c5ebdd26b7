"""The copied planes of the P2P slice held against the JAX modules, on the
CPU, with injected clocks (each module's ``time`` replaced by one fake
clock, so TTLs, ages and rates are equal by construction):

  * ``PeerHealth``, ``PeerTelemetry`` and ``PeerHotset`` on a seeded
    sequence of valid and hostile claims, clock steps, reads and
    departures (the flood bound included);
  * ``CacheGossip``: digests, ``cache_get`` / ``cache_answer``, the peer
    fetch and the joiner prewarm over two stores;
  * ``TelemetryPublisher`` / ``cluster_snapshot`` / ``render_cluster_prom``
    and ``Autopilot`` (ranking, the hedge threshold and budget, the
    admission loop, the join gate, its snapshot);
  * the node's datagrams: one scripted sequence (connect, connected,
    all_peers, stats with the health / telemetry / hotset keys, solve with
    and without ``hedge``, solution, the hedged farm, cache_get,
    cache_answer, disconnect mid-task) on a JAX node and a port node of
    the same id must send the same bytes;
  * ingress: every malformed datagram of ``tests/test_net_wire.py`` and
    ``tests/test_wire_fuzz.py`` leaves both nodes in the same state;
  * ``/metrics/cluster`` JSON and its two Prometheus spellings equal the
    JAX node's bodies on both transports;
  * the CLI's new flags parse to the JAX values, and ``build_node`` with
    ``-a`` wires what the JAX CLI wires.

Every comparison is exact (tolerance 0).
"""

import json
import queue
import random
import threading
import time
import urllib.request

import pytest

import sudoku_solver_distributed_tpu.cache.gossip as jax_gossip_mod
import sudoku_solver_distributed_tpu.net.peermap as jax_peermap_mod
import sudoku_solver_distributed_tpu.obs.cluster as jax_cluster_mod
import sudoku_solver_distributed_tpu.serving.autopilot as jax_autopilot_mod
import sudoku_solver_distributed_tpu_torch.cache.gossip as gossip_mod
import sudoku_solver_distributed_tpu_torch.net.peermap as peermap_mod
import sudoku_solver_distributed_tpu_torch.obs.cluster as cluster_mod
import sudoku_solver_distributed_tpu_torch.serving.autopilot as autopilot_mod
from sudoku_solver_distributed_tpu import cache as jax_cache
from sudoku_solver_distributed_tpu.models import generate_batch
from sudoku_solver_distributed_tpu.net import cli as jax_cli
from sudoku_solver_distributed_tpu.net import http_api as jax_http_api
from sudoku_solver_distributed_tpu.net import stats as jax_stats
from sudoku_solver_distributed_tpu.net import wire as jax_wire
from sudoku_solver_distributed_tpu.net.node import P2PNode as JaxNode
from sudoku_solver_distributed_tpu.obs import Tracer as JaxTracer
from sudoku_solver_distributed_tpu.obs.cost import CostAccounting as JaxCost
from sudoku_solver_distributed_tpu.serving.admission import (
    AdmissionController as JaxAdmission,
)
from sudoku_solver_distributed_tpu_torch import cache
from sudoku_solver_distributed_tpu_torch.models.oracle import oracle_solve
from sudoku_solver_distributed_tpu_torch.net import cli, http_api, stats, wire
from sudoku_solver_distributed_tpu_torch.net.node import P2PNode
from sudoku_solver_distributed_tpu_torch.obs import Tracer
from sudoku_solver_distributed_tpu_torch.obs.cost import CostAccounting
from sudoku_solver_distributed_tpu_torch.serving.admission import (
    AdmissionController,
)
from test_wire_fuzz import _hostile_datagrams

NODE_ID_PORT = 7990
SELF = f"127.0.0.1:{NODE_ID_PORT}"
PEER, PEER2 = "127.0.0.1:7001", "127.0.0.1:7002"
SRC, SRC2 = ("127.0.0.1", 7001), ("127.0.0.1", 7002)


class FakeTime:
    """The ``time`` module of a copied plane, on a clock the test moves."""

    def __init__(self, t=1000.0):
        self.t = t

    def monotonic(self):
        return self.t

    def time(self):
        return self.t

    def perf_counter(self):
        return self.t

    @staticmethod
    def sleep(s):
        # a real sleep that leaves the fake clock alone: a control thread
        # of another test still running in this process must not move it
        time.sleep(s)


SIDES = {
    "jax": dict(peermap=jax_peermap_mod, gossip=jax_gossip_mod,
                cluster=jax_cluster_mod, autopilot=jax_autopilot_mod,
                stats=jax_stats, cache=jax_cache, wire=jax_wire,
                node=JaxNode, tracer=JaxTracer, cost=JaxCost,
                admission=JaxAdmission, http=jax_http_api),
    "port": dict(peermap=peermap_mod, gossip=gossip_mod, cluster=cluster_mod,
                 autopilot=autopilot_mod, stats=stats, cache=cache,
                 wire=wire, node=P2PNode, tracer=Tracer, cost=CostAccounting,
                 admission=AdmissionController, http=http_api),
}


@pytest.fixture
def clock(monkeypatch):
    """One fake clock for the copied planes of both packages."""
    fake = FakeTime()
    for side in SIDES.values():
        for name in ("peermap", "gossip", "cluster", "autopilot"):
            monkeypatch.setattr(side[name], "time", fake)
    return fake


def _key(rng):
    return "".join(rng.choice("0123456789abcdef") for _ in range(64))


def _claim(kind, rng):
    """A seeded gossip claim for one map: mostly valid, some hostile."""
    r = rng.random()
    if kind == "PeerHealth":
        return rng.choice(["warming", "healthy", "degraded", "lost", "x",
                           5, None, {"a": 1}, ["lost"]])
    if kind == "PeerTelemetry":
        if r < 0.1:
            return {"nested": {"a": 1}}
        if r < 0.15:
            return {f"k{i}": i for i in range(40)}  # over MAX_KEYS
        if r < 0.2:
            return "digest"
        d = {"v": 1, "goodput_rps": round(rng.random() * 100, 3),
             "p99_ms": rng.choice([1.5, float("nan"), float("inf"), 20]),
             "supervisor": rng.choice(["healthy", "degraded", "lost"]),
             "ready": rng.random() < 0.8, "warm_frac": 1.0, "none": None}
        if r < 0.25:
            d["long"] = "x" * 80
        if r < 0.3:
            d["age_s"] = -5.0  # a spoofed age must not override ours
        return d
    # PeerHotset
    if r < 0.1:
        return {"v": 1, "keys": [[_key(rng), -1]]}
    if r < 0.15:
        return {"v": 1, "keys": [["notahash", 3]]}
    if r < 0.2:
        return {"v": 1, "keys": [[_key(rng), True]]}
    if r < 0.25:
        return {"v": 1, "keys": [[_key(rng), 1]] * 33}
    if r < 0.3:
        return [1, 2]
    return {"v": 1, "keys": [[_key(rng), rng.randrange(100)]
                             for _ in range(rng.randrange(1, 5))]}


def _maps(side, kind):
    mods = SIDES[side]
    if kind == "PeerHotset":
        return mods["gossip"].PeerHotset(ttl_s=15.0)
    return getattr(mods["stats"], kind)()


@pytest.mark.parametrize("kind", ["PeerHealth", "PeerTelemetry", "PeerHotset"])
def test_peer_maps_match_jax(kind, clock):
    traces = {}
    for side in ("jax", "port"):
        clock.t = 1000.0
        rng = random.Random(7)
        m = _maps(side, kind)
        out = []
        peers = [f"10.0.0.{i}:7000" for i in range(6)]
        for step in range(400):
            op = rng.random()
            peer = rng.choice(peers)
            if op < 0.5:
                out.append(("note", m.note(peer, _claim(kind, rng))))
            elif op < 0.6:
                clock.t += rng.choice([0.5, 3.0, 8.0, 16.0])
            elif op < 0.65:
                m.forget(peer)
            elif op < 0.75:
                out.append(("get", json.dumps(m.get(peer), sort_keys=True)))
            elif op < 0.85:
                out.append(("snap", json.dumps(m.snapshot(), sort_keys=True)))
            elif kind == "PeerHealth":
                out.append(("lost", m.is_lost(peer)))
            elif kind == "PeerHotset":
                snap = m.advertised()
                key = next(iter(next(iter(snap.values()), {})), "0" * 64)
                out.append(("holders", m.holders(key), sorted(snap)))
            out.append(("len", len(m)))
        # the flood bound: hundreds of spoofed origins exhaust a constant
        for i in range(300):
            m.note(f"10.1.{i // 250}.{i % 250}:9", _claim(kind, random.Random(i)))
            clock.t += 0.001
        out.append(("flood", len(m), sorted(m.items())[:3] and
                    json.dumps(sorted(m.items())[:3], sort_keys=True)))
        traces[side] = out
    assert traces["port"] == traces["jax"]


# -- stub engine and supervisor shared by the node-level cases -----------------

class _Sup:
    state = "healthy"
    is_lost = False

    def call_started(self, bucket, budget_scale=1.0):
        return 1

    def call_finished(self, token, ok=True):
        pass

    def call_abandoned(self, token):
        pass

    def should_fallback(self):
        return False


class _OracleEngine:
    """The engine surface the node, the digest and the autopilot read,
    answering with the host oracle (the same answers on both sides)."""

    frontier_enabled = False
    buckets = (1,)
    warmed = True

    def __init__(self, cost_cls):
        self.validations = 7
        self.supervisor = _Sup()
        self.cost = cost_cls()
        self._warm_state = {1: {"warm": True}}
        self.fault_injector = None

    def ready(self):
        return True

    def solve_one(self, board, frontier=None, deadline_s=None):
        return oracle_solve([list(r) for r in board]), {"validations": 0}

    def health(self):
        return {"backend": "stub", "cost": self.cost.snapshot()}


BOARD = generate_batch(1, 30, size=9, seed=77, unique=True)[0].tolist()
SOLUTION = oracle_solve(BOARD)


def _store(side, n=3):
    """An answer cache holding BOARD (looked up ``n`` times, so its key is
    hot) and its canonical key."""
    c = SIDES[side]["cache"].AnswerCache(capacity=64)
    assert c.store(BOARD, SOLUTION)
    for _ in range(n):
        c.lookup(BOARD)
    return c, c.hot_set(1)[0][0]


class _SendNode:
    """The node surface CacheGossip uses: an id and a send_to."""

    def __init__(self, side):
        self.id = SELF
        self.side = side
        self.sent = []
        self.reply = None

    def send_to(self, peer, msg):
        self.sent.append((peer, SIDES[self.side]["wire"].encode_msg(msg)))
        if self.reply is not None:
            self.reply(peer, msg)


def test_cache_gossip_matches_jax(clock):
    views = {}
    for side in ("jax", "port"):
        clock.t = 1000.0
        mods = SIDES[side]
        node = _SendNode(side)
        store, key = _store(side)
        g = mods["gossip"].CacheGossip(store, node, fetch_timeout_s=0.2)
        out = [("digest", g.digest())]
        clock.t += 0.5
        out.append(("cached", g.digest()))  # rebuilt at most once a second
        # a held key answers a matching source, not a spoofed one
        g.on_cache_get({"type": "cache_get", "hash": key, "address": PEER},
                       source=SRC)
        g.on_cache_get({"type": "cache_get", "hash": key, "address": PEER},
                       source=("10.9.9.9", 7001))
        g.on_cache_get({"type": "cache_get", "hash": "0" * 64,
                        "address": PEER}, source=SRC)
        # an unsolicited answer is dropped on arrival
        g.on_cache_answer({"hash": key, "board": BOARD, "solution": SOLUTION})
        # a peer advertises the key; a fresh store fetches it from that
        # peer's answer, delivered as the wire would deliver it
        empty = mods["cache"].AnswerCache(capacity=64)
        fetcher = mods["gossip"].CacheGossip(empty, node, fetch_timeout_s=0.2)
        fetcher.note_hotset(PEER, g.digest())
        fetcher.note_hotset(PEER2, {"v": 1, "keys": [[key, 1]]})
        pair = store.get_canonical(key)
        node.reply = lambda peer, msg: fetcher.on_cache_answer(
            mods["wire"].cache_answer_msg(msg["hash"], pair[0], pair[1], peer))
        out.append(("fetch", fetcher.try_peer_fetch(key)))
        out.append(("held", empty.contains(key), empty.lookup(BOARD)[0]))
        # the joiner prewarm over a second fresh store
        node.reply = None
        joiner_store = mods["cache"].AnswerCache(capacity=64)
        joiner = mods["gossip"].CacheGossip(joiner_store, node,
                                            fetch_timeout_s=0.2)
        joiner.note_hotset(PEER, g.digest())
        node.reply = lambda peer, msg: joiner.on_cache_answer(
            mods["wire"].cache_answer_msg(msg["hash"], pair[0], pair[1], peer))
        out.append(("prewarm", joiner.prewarm(budget_s=0.5)))
        clock.t += 20.0  # past the hot-set TTL: no holder left
        out.append(("expired", fetcher.peers.holders(key),
                    fetcher.try_peer_fetch(key)))
        fetcher.forget(PEER)
        out.append(("snapshots", g.snapshot(), fetcher.snapshot(),
                    joiner.snapshot(), store.snapshot(), empty.snapshot()))
        views[side] = (out, node.sent)
    assert views["port"][0] == views["jax"][0]
    assert views["port"][1] == views["jax"][1]  # the datagrams, as bytes


# -- the node-level cases ------------------------------------------------------

_MADE = []  # nodes of the running test, stopped by _stop_nodes


@pytest.fixture(autouse=True)
def _stop_nodes():
    yield
    while _MADE:
        node = _MADE.pop()
        node.shutdown_flag = True  # its worker thread leaves within 0.5 s
        node.sock.close()


def _node(side, **kw):
    mods = SIDES[side]
    node = mods["node"]("127.0.0.1", NODE_ID_PORT,
                        engine=_OracleEngine(mods["cost"]), **kw)
    _MADE.append(node)
    node.sent = []
    node._raw_send = lambda addr, msg: node.sent.append(
        (tuple(addr), mods["wire"].encode_msg(msg)))
    return node


def _attach_planes(node, side, answer_cache=True):
    """What the CLI wires by default: tracer, answer cache and gossip,
    telemetry publisher, autopilot (its thread not started)."""
    mods = SIDES[side]
    node.tracer = mods["tracer"]()
    node.metrics = node.tracer.routes
    if answer_cache:
        node.answer_cache, _key = _store(side)
        node.cache_gossip = mods["gossip"].CacheGossip(
            node.answer_cache, node, fetch_timeout_s=0.05)
    node.telemetry = mods["cluster"].TelemetryPublisher(node)
    node.autopilot = mods["autopilot"].Autopilot(node, join_loop=False)
    return node


def _drain_worker(node, n):
    """Wait for the worker thread's replies to ``n`` solve tasks."""
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if sum(b'"type": "solution"' in m for _a, m in node.sent) >= n:
            return
        time.sleep(0.01)
    raise AssertionError("the worker thread never answered")


def _script(side, clock):
    """The scripted datagram sequence; returns every datagram the node
    sent, as bytes, grouped by step."""
    mods = SIDES[side]
    w = mods["wire"]
    clock.t = 1000.0
    node = _attach_planes(_node(side, failure_timeout=0.0), side)
    steps = []

    def step(name, fn):
        node.sent.clear()
        fn()
        steps.append((name, list(node.sent)))

    def deliver(msg, source=SRC):
        node.handle_message(w.decode_msg(w.encode_msg(msg)), source=source)

    step("connect", lambda: deliver(w.connect_msg(PEER)))
    step("connected", lambda: deliver(w.connected_msg(PEER2), source=SRC2))
    step("all_peers", lambda: deliver(
        w.all_peers_msg({PEER: [SELF], PEER2: [SELF], SELF: [PEER, PEER2]})))
    hot = {"v": 1, "keys": [[_store(side)[1], 4]]}
    step("stats_in", lambda: deliver(w.stats_msg(
        PEER, 3, 11, {"all": {"solved": 3, "validations": 11}, "nodes": []},
        health="healthy", telemetry={"v": 1, "ready": True}, hotset=hot)))
    board = [list(r) for r in SOLUTION]
    board[0][0] = board[4][4] = 0

    def solve_in():
        deliver(w.solve_msg(board, 0, 0, PEER))
        _drain_worker(node, 1)

    def solve_hedge_in():
        deliver(w.solve_msg(board, 4, 4, PEER2, hedge=True), source=SRC2)
        _drain_worker(node, 1)

    step("solve", solve_in)
    step("solve_hedge", solve_hedge_in)
    assert node.hedge_tasks_received == 1

    # the master side: the primary goes to the best-ranked peer, which
    # never answers; the straggler is hedged to the other, which does
    one_hole = [list(r) for r in SOLUTION]
    one_hole[8][8] = 0
    node.autopilot.hedge_threshold_s = lambda: 0.0

    def respond(addr, msg):
        node.sent.append((tuple(addr), w.encode_msg(msg)))
        if msg.get("type") == "solve" and msg.get("hedge") is True:
            peer = f"{addr[0]}:{addr[1]}"
            threading.Thread(target=deliver, args=(w.solution_msg(
                msg["sudoku"], msg["row"], msg["col"],
                SOLUTION[msg["row"]][msg["col"]], peer),), kwargs={
                "source": tuple(addr)}, daemon=True).start()

    node._raw_send = respond
    step("farm", lambda: node.peer_sudoku_solve(one_hole))
    node._raw_send = lambda addr, msg: node.sent.append(
        (tuple(addr), w.encode_msg(msg)))
    step("cache_get_out", lambda: node.cache_gossip.try_peer_fetch(
        hot["keys"][0][0]))
    step("cache_get_in", lambda: deliver(
        w.cache_get_msg(_store(side)[1], PEER)))
    step("solution_in", lambda: deliver(w.solution_msg(board, 2, 3, 7, PEER)))

    def depart():
        node._current_task = (4, 8)
        node.shutdown()

    step("disconnect_mid_task", depart)
    return steps, node


def test_datagrams_match_jax_byte_for_byte(clock):
    out = {side: _script(side, clock) for side in ("jax", "port")}
    (jax_steps, jax_node), (port_steps, port_node) = out["jax"], out["port"]
    assert [s for s, _ in port_steps] == [s for s, _ in jax_steps]
    for (name, got), (_, want) in zip(port_steps, jax_steps):
        assert got == want, name
    sent = {name: [m for _a, m in got] for name, got in port_steps}
    types = {name: [json.loads(m)["type"] for m in ms]
             for name, ms in sent.items()}
    # every scripted kind went out
    assert "connected" in types["connect"]
    assert "all_peers" in types["connected"]
    assert "stats" in types["all_peers"]
    stats_msg = json.loads(next(m for m in sent["all_peers"]
                                if b'"stats"' in m))
    assert {"health", "telemetry", "hotset"} <= set(stats_msg)
    # the worker replies before its stats broadcast
    for name in ("solve", "solve_hedge"):
        assert types[name] == ["solution", "stats", "stats"], name
    farm = [json.loads(m) for m in sent["farm"]]
    solves = [m for m in farm if m["type"] == "solve"]
    assert [m.get("hedge") for m in solves] == [None, True]
    assert types["cache_get_out"] == ["cache_get"]
    assert types["cache_get_in"] == ["cache_answer"]
    assert set(types["disconnect_mid_task"]) == {"stats", "disconnect"}
    goodbye = json.loads(next(m for m in sent["disconnect_mid_task"]
                              if b'"disconnect"' in m))
    assert (goodbye["row"], goodbye["col"]) == (4, 8)
    assert list(port_node.solution_queue) == list(jax_node.solution_queue)
    # the farm's round trips run on the host's clock: that one key differs
    got, want = (n.autopilot.snapshot()["hedge"] for n in (port_node, jax_node))
    assert sorted(got) == sorted(want)
    assert {k: v for k, v in got.items() if k != "rtt_p99_ms"} == {
        k: v for k, v in want.items() if k != "rtt_p99_ms"}
    assert port_node.engine.cost.snapshot()["farm"] == \
        jax_node.engine.cost.snapshot()["farm"] == {
            "dispatches": 1, "hedges": 1, "dup_solutions": 0}


def _state(node):
    m = node.membership
    return {
        "all_peers": {k: sorted(v) for k, v in m.all_peers.items()},
        "peers_in": sorted(m.peers_in), "peers_out": sorted(m.peers_out),
        "tombstones": sorted(m._tombstones),
        "stats": node.get_stats(),
        "solutions": list(node.solution_queue),
        "last_seen": sorted(node._last_seen),
        "health": node.peer_health.snapshot(),
        "telemetry": sorted(node.peer_telemetry.snapshot()),
        "hotset": node.cache_gossip.peers.snapshot()
        if node.cache_gossip is not None else None,
        "hedges": node.hedge_tasks_received,
        "sent": sorted(node.sent),
    }


def _wire_cases():
    """The handler cases of tests/test_net_wire.py: every constructor's
    output and the malformed cache datagrams."""
    board9 = [[0] * 9 for _ in range(9)]
    w = jax_wire
    msgs = [
        w.connect_msg(PEER), w.connected_msg(PEER),
        w.all_peers_msg({PEER: ["127.0.0.1:7002"]}),
        w.solve_msg(board9, 0, 0, PEER), w.solve_msg(board9, 0, 0, PEER, hedge=True),
        w.solution_msg(board9, 2, 3, 7, PEER),
        w.stats_msg(PEER, 3, 11, {"all": {"solved": 3, "validations": 11},
                                  "nodes": []}),
        w.disconnect_msg(PEER, (4, 8)), w.disconnect_msg(PEER),
        {"type": "cache_get", "hash": 5, "address": PEER},
        {"type": "cache_get", "hash": "a" * 64, "address": None},
        {"type": "cache_answer", "hash": "a" * 64, "address": PEER},
        {"type": "cache_answer", "hash": [], "board": [], "solution": [],
         "address": PEER},
    ]
    return [json.dumps(m).encode() for m in msgs]


class _WorkerTasks(queue.Queue):
    """A node's worker queue that knows when the worker is done with every
    task it was given. Both packages' workers take a task off the queue,
    answer or shed it, and only then ``get`` again: so with the queue empty
    and the worker waiting in ``get``, every accepted task was answered or
    shed. The count of waits changes under the queue's own mutex, with the
    removal of the item the wait returns."""

    def __init__(self):
        super().__init__()
        self.waiting = 0

    def get(self, block=True, timeout=None):
        with self.mutex:
            self.waiting += 1
        try:
            return super().get(block, timeout)
        except queue.Empty:
            with self.mutex:
                self.waiting -= 1
            raise

    def _get(self):
        self.waiting -= 1  # under self.mutex, as the item leaves the queue
        return super()._get()

    def settled(self) -> bool:
        with self.mutex:
            return not self.queue and self.waiting > 0


@pytest.mark.parametrize("seed", [5, 17])
def test_ingress_cases_leave_the_same_state(seed, clock):
    states = {}
    for side in ("jax", "port"):
        w = SIDES[side]["wire"]
        node = _attach_planes(_node(side, failure_timeout=0.0), side)
        node.autopilot = None
        # the worker picks this queue up at its next get (within 0.5 s)
        tasks = node._worker_tasks = _WorkerTasks()
        datagrams = _wire_cases() + _hostile_datagrams(random.Random(seed))
        solves = 0
        for payload in datagrams:
            try:  # as the UDP loop: a bad datagram costs one log line
                msg = w.decode_msg(payload)
                if isinstance(msg, dict) and msg.get("type") == "solve":
                    solves += 1
                node.handle_message(msg, source=SRC)
            except Exception:  # noqa: BLE001
                pass
        # the worker thread has answered or shed every accepted task
        deadline = time.monotonic() + 10
        while not tasks.settled() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert tasks.settled(), f"{side}: the worker is still on a task"
        states[side] = _state(node)
    assert states["port"] == states["jax"]
    # the valid cases took effect
    assert states["port"]["solutions"][0] == (2, 3, 7, PEER)
    assert PEER in states["port"]["last_seen"]


# -- telemetry, the cluster view and the autopilot -----------------------------

def _telemetry_node(side, clock):
    node = _attach_planes(_node(side), side)
    node.admission = SIDES[side]["admission"](capacity=8)
    node.admission.try_admit()
    for k in range(5):
        node.metrics.record("/solve", 0.001 * (k + 1))
    node.metrics.record("/solve", 0.002, shed=True)
    node.peer_telemetry.note(PEER, {"v": 1, "goodput_rps": 3.0,
                                    "p99_ms": 12.5, "supervisor": "healthy",
                                    "ready": True, "warm_frac": 1.0,
                                    "cache_hits": 4, "cache_misses": 1})
    clock.t += 9.0  # PEER's digest is now in its TTL's back half
    node.peer_telemetry.note(PEER2, {"v": 1, "goodput_rps": 1.0,
                                     "supervisor": "degraded", "pps": 10.0,
                                     "slo_fast_burn": True})
    return node


def test_telemetry_and_cluster_view_match_jax(clock):
    out = {}
    for side in ("jax", "port"):
        clock.t = 1000.0
        node = _telemetry_node(side, clock)
        pub = node.telemetry
        first = pub.digest()
        node.metrics.record("/solve", 0.004)
        clock.t += 0.5
        cached = pub.digest()
        clock.t += 1.0
        rebuilt = pub.digest()
        snap = SIDES[side]["cluster"].cluster_snapshot(node)
        snap["self"]["id"] = "SELF"
        prom = SIDES[side]["cluster"].render_cluster_prom(snap)
        out[side] = (first, cached, rebuilt, snap, prom)
    assert out["port"] == out["jax"]
    assert out["port"][3]["fleet"]["nodes"] == 2  # self + the fresh peer


class _Slo:
    def __init__(self):
        self.burning = False
        self.listeners = []

    def add_burn_listener(self, fn):
        self.listeners.append(fn)

    def remove_burn_listener(self, fn):
        self.listeners.remove(fn)

    def maybe_tick(self, now=None):
        pass

    def fast_burn_active(self):
        return self.burning


def test_autopilot_matches_jax(clock):
    out = {}
    for side in ("jax", "port"):
        clock.t = 1000.0
        mods = SIDES[side]
        node = _node(side)
        slo, adm = _Slo(), mods["admission"](capacity=8)
        ap = mods["autopilot"].Autopilot(node, admission=adm, slo=slo,
                                         hedge_budget_frac=0.25)
        trace = [("cold", ap.hedge_threshold_s(), ap.farm_rtt_p99_ms())]
        peers = [f"10.0.0.{i}:7000" for i in range(5)]
        node.peer_telemetry.note(peers[0], {"v": 1, "supervisor": "degraded"})
        node.peer_telemetry.note(peers[1], {"v": 1, "ready": False})
        node.peer_telemetry.note(peers[2], {"v": 1, "farm_rtt_p99_ms": 40.0,
                                            "pending": 3, "goodput_rps": 9})
        node.peer_health.note(peers[3], "warming")
        clock.t += 4.0
        trace.append(("rank", ap.rank_farm_peers(peers),
                      ap.hedge_threshold_s()))
        rng = random.Random(3)
        for _ in range(40):
            ap.note_farm_rtt(rng.random() * 0.05)
        ap.note_primary_dispatch(6)
        trace.append(("warm", ap.hedge_threshold_s(), ap.farm_rtt_p99_ms(),
                      [ap.try_hedge() for _ in range(4)]))
        ap.note_hedge_result(True)
        ap.note_hedge_result(False)
        ap.note_late_dup()
        # law 1: a burn edge tightens, recovery relaxes after the hysteresis
        slo.burning = True
        for fn in list(slo.listeners):
            fn(True)
        trace.append(("tight", adm.snapshot()["budget_scale"]))
        slo.burning = False
        ap.tick(clock.t)
        ap.tick(clock.t + 1.0)
        ap.tick(clock.t + ap.relax_after_s + 2.0)
        trace.append(("relaxed", adm.snapshot()["budget_scale"]))
        trace.append(("join", ap.allow_join()))
        ap.note_deferred_dial()
        trace.append(("snap", ap.snapshot()))
        trace.append(("score", [mods["autopilot"].peer_score(d, h) for d, h in (
            (None, None), (None, "degraded"), ({"supervisor": "lost"}, None),
            ({"age_s": 7.5, "ttl_s": 15.0, "ready": True}, "warming"))]))
        ap.close()
        out[side] = trace
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("legacy", [False, True], ids=["fast", "legacy"])
def test_cluster_routes_match_jax_bodies(legacy, clock):
    """GET /metrics/cluster, /metrics/cluster.prom and
    /metrics/cluster?format=prom on a JAX node and a port node of the same
    id and state: equal status, content type and body bytes."""
    bodies = {}
    for side in ("jax", "port"):
        clock.t = 1000.0
        node = _telemetry_node(side, clock)
        httpd = SIDES[side]["http"].make_http_server(
            node, "127.0.0.1", 0, expose_metrics=True,
            legacy_transport=legacy)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            got = []
            for path in ("/metrics/cluster", "/metrics/cluster.prom",
                         "/metrics/cluster?format=prom"):
                with urllib.request.urlopen(base + path, timeout=10) as r:
                    got.append((r.status, r.headers["Content-Type"], r.read()))
            bodies[side] = got
        finally:
            httpd.shutdown()
            httpd.server_close()
    assert bodies["port"] == bodies["jax"]
    assert json.loads(bodies["port"][0][2])["fleet"]["nodes"] == 2
    assert bodies["port"][1][2] == bodies["port"][2][2]


# -- the CLI -------------------------------------------------------------------

NEW_FLAGS = ["--failure-timeout", "--cache-fetch-timeout-ms", "--no-autopilot",
             "--no-autopilot-admission", "--no-autopilot-farm",
             "--no-autopilot-hedge", "--no-autopilot-join",
             "--hedge-budget-pct"]


@pytest.mark.parametrize("argv", [
    [],
    ["-a", "127.0.0.1:7000", "--failure-timeout", "1.5",
     "--cache-fetch-timeout-ms", "0", "--hedge-budget-pct", "10"],
    ["--no-autopilot", "--no-autopilot-admission", "--no-autopilot-farm",
     "--no-autopilot-hedge", "--no-autopilot-join"],
])
def test_cli_new_flags_parse_to_jax_values(argv):
    mine = vars(cli.build_parser().parse_args(argv))
    theirs = vars(jax_cli.build_parser().parse_args(argv))
    for flag in NEW_FLAGS + ["-a"]:
        dest = flag.lstrip("-").replace("-", "_")
        assert mine[dest] == theirs[dest], flag


def _wiring(node):
    ap = node.autopilot
    g = node.cache_gossip
    return {
        "anchor": node.anchor_node,
        "failure_timeout": node.failure_timeout,
        "gossip": (type(g).__name__, g.fetch_timeout_s, g.top_k, g.fanout),
        "telemetry": type(node.telemetry).__name__,
        "autopilot": (type(ap).__name__, ap.admission_enabled, ap.farm_enabled,
                      ap.hedge_enabled, ap.join_enabled,
                      ap.hedge_budget_frac),
        "cache": type(node.answer_cache).__name__,
    }


def test_build_node_with_anchor_wires_jax_attributes(monkeypatch):
    argv = ["-p", "0", "-s", "0", "-a", "127.0.0.1:7000", "--no-warmup",
            "--buckets", "1", "--platform", "cpu", "--failure-timeout", "2",
            "--hedge-budget-pct", "10", "--no-autopilot-farm"]
    captured = []
    # the JAX CLI's main builds everything, then blocks in node.run
    monkeypatch.setattr(JaxNode, "run",
                        lambda self: captured.append(_wiring(self)))
    jax_cli.main(argv + ["--no-mesh"])
    node, httpd = cli.build_node(cli.build_parser().parse_args(argv))
    try:
        assert _wiring(node) == captured[0]
        assert node.autopilot._thread is not None  # started, as on JAX
    finally:
        httpd.server_close()
        node.autopilot.close()
        node.shutdown()
        node.engine.close()
