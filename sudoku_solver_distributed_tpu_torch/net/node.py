"""P2P node: UDP event loop, task farm, gossip.

The port of ``sudoku_solver_distributed_tpu/net/node.py``: one node is one
process exposing the UDP JSON peer protocol and the HTTP API
(net/http_api.py), sharing this object. The datagrams, the membership and
stats planes, the per-cell task farm (one cell per peer, deadlines and
requeue, hedged dispatch, the placement-checked merge, the
engine-authoritative fallbacks), the crash detector and the anti-entropy
loop are the JAX node's, line for line; the engine behind it is the
port's (K1 and the K3/K3b segment kernels on the card).

As on the JAX node, ``mesh_peer_count`` (``--mesh-peers N``) surfaces N
``{id}/tpu{k}`` pseudo-peers at ``/network``, one a mesh shard, under the
JAX node's names byte for byte (the bodies must equal the reference's);
and with the frontier race enabled (the engine's ``frontier_mesh``, one
device or a mesh) ``/solve`` answers from the node's own race and does not
farm, while per-cell tasks and the farm's closing solves pass
``frontier=False``.

One deviation from the JAX node: ``shutdown`` also stops the worker
thread at once (a sentinel on its queue) and closes the UDP socket once
``run`` returns, or at once when ``run`` never started; a second call
does nothing.
"""

from __future__ import annotations

import logging
import queue
import socket
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..engine import SolverEngine
from ..obs.trace import current_trace, valid_request_id
from ..serving.admission import DeadlineExceeded
from ..utils import HandicapLimiter
from . import wire
from .membership import Membership
from .stats import PeerHealth, PeerTelemetry, StatsGossip

logger = logging.getLogger(__name__)

TASK_DEADLINE_S = 5.0       # reassign a dispatched cell after this long
SOLVE_WAIT_SLICE_S = 0.05   # condition-wait granularity in the dispatch loop
GOSSIP_INTERVAL_S = 1.0     # periodic stats broadcast (see P2PNode.run)
ANTI_ENTROPY_S = 5.0        # periodic all_peers re-flood: bounds how long a
#                             missed deletion/join flood can leave views
#                             diverged (drop-lossy wire, test_churn_soak.py);
#                             same wire message, reference nodes merge it
#                             exactly like any change-triggered flood
FAILURE_TIMEOUT_S = 5.0     # declare a silent neighbor dead after this long


class P2PNode:
    def __init__(
        self,
        host: str,
        port: int,
        anchor_node: Optional[str] = None,
        handicap: float = 0.001,
        engine: Optional[SolverEngine] = None,
        mesh_peer_count: int = 0,
        failure_timeout: float = FAILURE_TIMEOUT_S,
        metrics=None,
        fault_injector=None,
        tombstone_ttl_s: Optional[float] = None,
        serialize_solves: bool = False,
        admission=None,
    ):
        self.host = host
        self.port = port
        self.id = f"{host}:{port}"
        self.anchor_node = anchor_node
        self.handicap = handicap

        self.engine = engine if engine is not None else SolverEngine()
        # the mesh's pseudo-peers at /network (--mesh-peers): one a shard,
        # named as the JAX node names its TPU cores
        self.mesh_peer_ids: List[str] = [
            f"{self.id}/tpu{k}" for k in range(mesh_peer_count)
        ]
        self.limiter = HandicapLimiter(base_delay=handicap)
        self._solved_count = 0
        if tombstone_ttl_s is None:
            # derived default: the tombstone must outlive flood convergence
            # (seconds) but a FALSE-POSITIVE death — a live peer declared
            # silent under load — should not exclude that peer from
            # distant views longer than a few detection periods (extended
            # churn soak, seed 101: a flat 30 s TTL held a live peer out
            # for the whole convergence window). Heartbeat off (0, the
            # reference's graceful-only model) keeps the flat default.
            tombstone_ttl_s = (
                max(6.0 * failure_timeout, 12.0) if failure_timeout else 30.0
            )
        self.membership = Membership(self.id, tombstone_ttl_s=tombstone_ttl_s)
        self.stats = StatsGossip(self.id, self._own_counters)
        # peers' engine-supervisor states, piggybacked on stats gossip
        # (wire.stats_msg "health"): the task farm skips LOST peers —
        # they still answer, but from a host-oracle fallback while an
        # engine rebuild runs, and a farmed cell should not wait on that
        self.peer_health = PeerHealth()
        # peers' fleet-observability digests, piggybacked the same way
        # (wire.stats_msg "telemetry"): TTL'd, bounded,
        # sanitized at ingress — the /metrics/cluster data plane
        self.peer_telemetry = PeerTelemetry()
        # this node's own digest publisher (obs/cluster.TelemetryPublisher,
        # wired by the CLI when the tracing plane is on): None — bare
        # library nodes — gossips reference-identical stats bytes
        self.telemetry = None
        # SLO burn-rate engine (obs/slo.py, CLI --slo); None costs nothing
        self.slo = None
        # canonical-form answer cache (cache/): the CLI wires
        # an AnswerCache (front-door lookup in net/http_api.py) and a
        # CacheGossip (hot-set piggyback on stats gossip + the
        # cache_get/cache_answer fetch pair). None — bare library
        # nodes — costs nothing and keeps wire bytes reference-identical
        self.answer_cache = None
        self.cache_gossip = None
        # fleet autopilot (serving/autopilot.py): the CLI wires
        # an Autopilot here (default ON, --no-autopilot turns it off).
        # When set it drives
        # telemetry-weighted farm ranking and hedged dispatch in
        # _farm_solve, and gates the join dial in run(); None — bare
        # library nodes — keeps every path exactly as before
        self.autopilot = None
        # chaos-harness gate: POST /debug/faults exists only
        # when the CLI armed it (--chaos-injector)
        self.chaos_routes = False
        # hedge-marked dispatches this WORKER served (wire solve
        # "hedge" flag) — the receiving end of the tail-at-scale race,
        # surfaced through the autopilot /metrics block
        self.hedge_tasks_received = 0

        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.shutdown_flag = False
        self._running = False
        self._life_lock = threading.Lock()
        self._departing = False
        self._goodbye_sent = threading.Event()

        # master-side task farm state (one solve in flight at a time, like the
        # reference; guarded properly here)
        self._solve_lock = threading.Lock()
        # seed-fidelity switch (CLI --seed-serving): serialize EVERY request
        # behind _solve_lock the way the seed did, instead of letting
        # engine-path requests ride the coalescer concurrently — the A/B
        # baseline for bench.py --mode concurrent
        self.serialize_solves = serialize_solves
        self._state_lock = threading.Lock()
        self._solution_event = threading.Condition(self._state_lock)
        self.task_queue: deque = deque()
        # peer -> (row, col, deadline, dispatch time): the dispatch
        # timestamp feeds the autopilot's farm-RTT window and the
        # hedge straggler test
        self.active_tasks: Dict[str, Tuple[int, int, float, float]] = {}
        self.solution_queue: deque = deque()

        # worker-side: dispatched cells are solved on a dedicated thread so
        # the UDP loop keeps handling gossip (and so keeps *sending* the
        # heartbeat) while the engine works — an inline solve that compiles
        # can block for tens of seconds, which the reference tolerates (its
        # loop has no liveness duty, reference node.py:384-406) but a
        # heartbeat-bearing loop cannot: peers would false-positive the busy
        # node as crashed. `_current_task` is the cell being computed, for
        # the disconnect message's row/col fields (reference node.py:651-654).
        self._current_task: Optional[Tuple[int, int]] = None
        self._worker_tasks: "queue.Queue" = queue.Queue()
        self._worker_thread = threading.Thread(
            target=self._worker_loop, daemon=True
        )
        self._worker_thread.start()

        # Crash-failure detector. The reference detects departures only via
        # the graceful `disconnect` message — a SIGKILL'd peer stays in every
        # view forever (SURVEY.md §3.5 [verified live]). The 1 Hz stats gossip
        # doubles as a heartbeat: any datagram from a neighbor refreshes
        # `_last_seen`; a neighbor silent past `failure_timeout` is treated
        # exactly as if it had sent `disconnect` (prune + re-flood + requeue),
        # reusing the existing wire surface. 0 disables (pure reference
        # semantics).
        self.failure_timeout = failure_timeout
        self._last_seen: Dict[str, float] = {}
        self._last_tick = time.monotonic()
        self._stale_pushback: Dict[str, float] = {}  # addr -> last relay time
        # request-latency recorder fed by the HTTP layer (utils/profiling.py);
        # optional so bare nodes pay nothing
        self.metrics = metrics
        # overload control plane (serving/admission.py): when set, the
        # HTTP route core sheds /solve arrivals past the pending budget or
        # whose deadline cannot be met (net/http_api.solve_route); None —
        # the default — accepts every request
        self.admission = admission
        # chaos-testing hook (utils/faults.FaultInjector): when set, every
        # outbound datagram is planned through it — dropped, delayed, or
        # duplicated deterministically. The fault tooling the reference
        # lacks (SURVEY.md §5); None costs nothing.
        self.fault_injector = fault_injector
        # request-lifecycle tracing plane (obs/): the CLI wires a
        # Tracer + FlightRecorder here (default on, --no-obs disables);
        # None — library/bare nodes — costs nothing and serves exactly
        # the pre-obs stack
        self.tracer = None
        self.flight = None

    # -- counters ----------------------------------------------------------
    # `solved` counts one per successful master solve (reference node.py:468
    # — minus its count-failures-as-solved defect); `validations` is the
    # engine's device sweep count, which naturally lands on whichever node
    # did the work (workers included), matching the reference's distributed
    # per-node validations accounting.
    def _own_counters(self) -> tuple:
        return self._solved_count, self.engine.validations

    @property
    def validations(self) -> int:
        return self.engine.validations

    @property
    def solved_puzzles(self) -> int:
        return self._solved_count

    # -- transport ---------------------------------------------------------
    def send(self, address, msg: wire.Msg) -> None:
        if self.fault_injector is not None:
            for planned, delay in self.fault_injector.plan(msg):
                if delay > 0:
                    t = threading.Timer(
                        delay, self._raw_send, (address, planned)
                    )
                    t.daemon = True
                    t.start()
                else:
                    self._raw_send(address, planned)
            return
        self._raw_send(address, msg)

    def _raw_send(self, address, msg: wire.Msg) -> None:
        try:
            self.sock.sendto(wire.encode_msg(msg), address)
        except OSError as e:
            logger.error("send to %s failed: %s", address, e)

    def send_to(self, peer_id: str, msg: wire.Msg) -> None:
        # defense in depth behind the handle_message ingress validation: a
        # malformed id that slipped into any iterated structure must cost
        # one dropped send, never an exception that aborts a periodic
        # pass (gossip / anti-entropy / deletion relays)
        if not wire.valid_address(peer_id):
            logger.warning("refusing send to invalid peer id %r", peer_id)
            return
        self.send(wire.parse_address(peer_id), msg)

    def recv(self):
        try:
            payload, addr = self.sock.recvfrom(wire.RECV_BUFFER)
            return (payload or None), addr
        except socket.timeout:
            return None, None
        except OSError:
            return None, None

    # -- gossip ------------------------------------------------------------
    def broadcast_all_peers(self) -> None:
        msg = wire.all_peers_msg(self.membership.network_view())
        for peer in self.membership.neighbors():
            self.send_to(peer, msg)

    def broadcast_stats(self) -> None:
        peers = self.membership.neighbors()
        if not peers:
            # nothing to gossip to — and this runs once per /solve, so the
            # snapshot (lock + fold + dict rebuild) is serving hot path
            return
        snap = self.stats.snapshot()
        sup = getattr(self.engine, "supervisor", None)
        # the telemetry digest rides every stats heartbeat but is rebuilt
        # at most once per second (TelemetryPublisher cache) — this runs
        # once per /solve on the serving path
        telemetry = (
            self.telemetry.digest() if self.telemetry is not None else None
        )
        # the answer-cache hot-set digest rides the same heartbeat
        # (cache/gossip.py, rebuilt at most 1/s); None — no cache, or an
        # empty one — keeps the key off the wire entirely
        hotset = (
            self.cache_gossip.digest()
            if self.cache_gossip is not None
            else None
        )
        msg = wire.stats_msg(
            self.id,
            self._solved_count,
            self.engine.validations,
            snap,
            health=sup.state if sup is not None else None,
            telemetry=telemetry,
            hotset=hotset,
        )
        for peer in peers:
            self.send_to(peer, msg)

    def get_stats(self) -> wire.Msg:
        return self.stats.snapshot()

    def network_view(self) -> wire.Msg:
        view = self.membership.network_view()
        if self.mesh_peer_ids:
            view.setdefault(self.id, [])
            view[self.id] = sorted(set(view[self.id]) | set(self.mesh_peer_ids))
        return view

    # -- message dispatch ---------------------------------------------------
    def handle_message(self, msg: wire.Msg, source=None) -> None:
        """``source`` is the datagram's UDP source (host, port) when known
        — nodes send from their bound socket, so a graceful goodbye's
        source equals the departing address itself, distinguishing it
        from third-party deletion relays (rumors)."""
        mtype = msg.get("type")
        # the reference logs every datagram at INFO (node.py:194) as its
        # observability-as-oracle; DEBUG here — /metrics supersedes it
        logger.debug("received message: %s", msg)
        # Heartbeat refresh, keyed by the peer's *self-reported* id — the same
        # key membership.neighbors() holds. (Keying by UDP source address
        # breaks when a peer binds e.g. "localhost" but datagrams arrive from
        # "127.0.0.1": the watched key would never refresh and a healthy
        # neighbor would be declared dead forever.)
        # Ingress validation FIRST (found by tests/test_wire_fuzz.py): an
        # address-bearing field that is not a well-formed "host:port"
        # string must never enter ANY node state — membership sets would
        # crash every periodic neighbor walk (gossip, anti-entropy,
        # deletion relays) each loop iteration BEFORE reaching recv,
        # leaving the node permanently deaf; and even _last_seen entries
        # for garbage senders would grow without bound under a hostile
        # flood. Dropped with a truncated log line; the
        # reference crashes its handler on the same inputs.
        if mtype in ("connect", "connected", "disconnect") and not (
            wire.valid_address(msg.get("address"))
        ):
            logger.warning(
                "dropping %s with invalid address: %.200r", mtype, msg
            )
            return
        if mtype in ("solve", "solution") and not (
            wire.valid_address(msg.get("address"))
            and type(msg.get("row")) is int      # bools index wrong cells
            and type(msg.get("col")) is int
            and "sudoku" in msg
            and (mtype != "solution" or "solution" in msg)
        ):
            logger.warning("dropping malformed %s: %.200r", mtype, msg)
            return
        if mtype == "stats" and not wire.valid_address(msg.get("origin")):
            logger.warning("dropping stats with invalid origin: %.200r", msg)
            return
        if mtype in ("cache_get", "cache_answer") and not (
            wire.valid_address(msg.get("address"))
            and isinstance(msg.get("hash"), str)
            and (
                mtype != "cache_answer"
                or ("board" in msg and "solution" in msg)
            )
        ):
            logger.warning("dropping malformed %s: %.200r", mtype, msg)
            return
        if mtype == "all_peers" and not isinstance(
            msg.get("all_peers"), dict
        ):
            logger.warning("dropping malformed all_peers: %.200r", msg)
            return

        sender = msg.get("address") or msg.get("origin")
        if wire.valid_address(sender) and mtype != "disconnect":
            # (a disconnect's "address" names the DEPARTED node, not the
            # sender — refreshing it would revive the peer being buried;
            # valid_address keeps unknown-type garbage senders out of the
            # map, and _reap_dead_neighbors GCs stale non-neighbor
            # entries so valid-formatted flood senders can't grow it
            # without bound either)
            self._last_seen[sender] = time.monotonic()
            # direct datagram = proof of life: clears any tombstone so a
            # false-positive death or a fast rejoin heals on first contact
            self.membership.mark_alive(sender)

        if mtype == "connect":
            if msg["address"] == self.id:
                return  # never handshake with ourselves
            self.membership.on_connect(msg["address"])
            self.send_to(msg["address"], wire.connected_msg(self.id))

        elif mtype == "connected":
            if msg["address"] == self.id:
                return
            self.membership.on_connected(msg["address"])
            self.broadcast_all_peers()

        elif mtype == "all_peers":
            self.broadcast_stats()  # same trigger as reference node.py:217
            if self.membership.merge_all_peers(msg["all_peers"]):
                self.broadcast_all_peers()
            # stale-flood pushback: the flood carried addresses we hold
            # tombstones for — some node still has the pre-death view, so
            # chase it with disconnect relays (rate-limited per address)
            now = time.monotonic()
            stale_addrs = self.membership.drain_stale()
            if stale_addrs:
                # prune rate-limit entries past the tombstone TTL — they
                # are useless once the tombstone expired, and high churn
                # would otherwise grow this map forever
                ttl = self.membership.tombstone_ttl_s
                for a in [
                    a
                    for a, t in self._stale_pushback.items()
                    if now - t > ttl
                ]:
                    del self._stale_pushback[a]
            for addr in stale_addrs:
                if now - self._stale_pushback.get(addr, 0.0) < 2.0:
                    continue
                self._stale_pushback[addr] = now
                for peer in self.membership.neighbors():
                    self.send_to(peer, wire.disconnect_msg(addr))
            target = self.membership.second_link_target()
            if target is not None:
                self.send_to(target, wire.connect_msg(self.id))

        elif mtype == "stats":
            self.stats.merge(msg)
            # supervisor-state piggyback (optional key — absent from
            # reference traffic and supervisor-less nodes); PeerHealth
            # validates at the boundary like every other wire field
            self.peer_health.note(msg["origin"], msg.get("health"))
            # fleet-telemetry piggyback (optional key):
            # PeerTelemetry sanitizes at the boundary — hostile digests
            # are dropped whole, never partially folded
            self.peer_telemetry.note(msg["origin"], msg.get("telemetry"))
            # answer-cache hot-set piggyback (optional key):
            # same boundary contract (cache/gossip.PeerHotset.sanitize)
            if self.cache_gossip is not None:
                self.cache_gossip.note_hotset(
                    msg["origin"], msg.get("hotset")
                )

        elif mtype == "disconnect":
            if msg["address"] == self.id:
                # Mirror the connect/connected self-guards above: a spoofed
                # disconnect naming OUR id would make us prune+tombstone
                # ourselves and flood disconnect(self.id) to every neighbor
                # — and since that relay leaves our own socket, it matches
                # the port-only goodbye exemption and every neighbor honors
                # it, evicting a live node network-wide for up to 6x
                # tombstone TTL. One hostile datagram, minutes of flapping
                #. Nothing legitimate ever names us: we
                # only send our own goodbye at shutdown, after recv stops.
                logger.warning(
                    "dropping spoofed self-disconnect from %r", source
                )
                return
            self._on_disconnect(msg, source=source)

        elif mtype == "cache_get":
            # a peer's answer-cache fetch: answered from our
            # store when we hold the key, silently ignored otherwise
            # (the sender's bounded wait is the negative reply) — and
            # ignored entirely on cache-less nodes. The datagram source
            # rides along so the reply cannot be reflected at a spoofed
            # address (cache/gossip.py on_cache_get)
            if self.cache_gossip is not None:
                self.cache_gossip.on_cache_get(msg, source=source)

        elif mtype == "cache_answer":
            # a peer's fetch reply: verified through the store's write
            # gate on arrival (re-canonicalized + rule-checked) before
            # any waiter is woken — hostile answers are dropped whole
            if self.cache_gossip is not None:
                self.cache_gossip.on_cache_answer(msg)

        elif mtype == "solve":
            self._on_solve_task(msg)

        elif mtype == "solution":
            with self._state_lock:
                self.solution_queue.append(
                    (msg["row"], msg["col"], msg["solution"], msg["address"])
                )
                self._solution_event.notify_all()

        else:
            logger.warning("unknown message type: %r", mtype)

    def _on_disconnect(self, msg: wire.Msg, source=None) -> None:
        address = msg["address"]
        # Rumor rejection: a THIRD-PARTY deletion relay
        # about a peer we heard directly within the last half
        # failure-timeout is stale — e.g. a rejoined same-address peer
        # being chased by another node's tombstone re-broadcast. A
        # graceful GOODBYE is exempt: nodes send from their bound socket,
        # so the goodbye's UDP source equals the departing address and
        # must prune immediately (reference semantics). Refusing a true
        # third-party report costs nothing real: our own heartbeat
        # re-declares the death within failure_timeout.
        if self.failure_timeout and source is not None:
            try:
                # (host, port) match with loopback/alias normalization
                # (wire.canonical_host): a "localhost"-bound node's
                # datagrams arrive from "127.0.0.1" and must still read as
                # its own goodbye. A port-only comparison would misclassify
                # a THIRD-PARTY deletion relay from a same-port peer on
                # another host as a goodbye, bypassing rumor rejection —
                # same-port fleets are the normal multi-host deployment
                # shape (every host runs the same CLI with the same -s).
                self_announced = wire.same_endpoint(
                    (source[0], source[1]), wire.parse_address(address)
                )
            except (ValueError, TypeError, IndexError):
                self_announced = False
            if not self_announced:
                heard = self._last_seen.get(address)
                if (
                    heard is not None
                    and time.monotonic() - heard < self.failure_timeout / 2
                ):
                    logger.info(
                        "ignoring deletion rumor for recently-heard %s",
                        address,
                    )
                    return
        # a departed peer's health claim — and its telemetry digest and
        # hot-set advertisements — die with it (a rejoin at the same
        # address starts with a clean slate); unconditional — a goodbye
        # is authoritative about the peer whether or not it changed OUR
        # membership view
        self.peer_health.forget(address)
        self.peer_telemetry.forget(address)
        if self.cache_gossip is not None:
            self.cache_gossip.forget(address)
        changed, redial = self.membership.on_disconnect(address)
        if changed:
            if self.membership.all_peers:
                self.broadcast_all_peers()
            # Relay the departure to our other neighbors. The reference only
            # tells a departed peer's direct neighbors, and its grow-only
            # all_peers merge cannot carry deletions, so every other node
            # lists the dead peer forever (SURVEY.md §3.5 [verified live]).
            # Flooding the same wire message (minus the row/col task fields,
            # which only the direct master may requeue) propagates the
            # deletion; a second receipt changes nothing, so the flood
            # terminates.
            for peer in self.membership.neighbors():
                if peer != address:
                    self.send_to(peer, wire.disconnect_msg(address))
        if redial is not None:
            self.send_to(redial, wire.connect_msg(self.id))
        # Requeue whatever WE had assigned to the departed peer — our
        # active_tasks map is the ground truth. The wire message's optional
        # row/col (reference node.py:651-654, still sent on our shutdown for
        # reference interop) is deliberately ignored on receive: with the
        # departure flooded to all neighbors, that cell belongs to whichever
        # master assigned it, and every other master trusting it would
        # poison its own queue with a foreign cell while dropping its own.
        with self._state_lock:
            if address in self.active_tasks:
                row, col = self.active_tasks.pop(address)[:2]
                # one copy per cell in the queue: the departed peer may
                # have held the hedged arm of a cell another peer is
                # still solving (see the reap loop's same guard)
                if (row, col) not in self.task_queue and not any(
                    (c[0], c[1]) == (row, col)
                    for c in self.active_tasks.values()
                ):
                    self.task_queue.appendleft((row, col))
                self._solution_event.notify_all()

    # -- worker side -------------------------------------------------------
    def _on_solve_task(self, msg: wire.Msg) -> None:
        """Enqueue a dispatched cell for the worker thread (FIFO)."""
        self._worker_tasks.put((time.monotonic(), msg))

    def _worker_loop(self) -> None:
        while not self.shutdown_flag:
            try:
                item = self._worker_tasks.get(timeout=0.5)
            except queue.Empty:
                continue
            if item is None:  # shutdown's sentinel
                return
            enqueued, msg = item
            # Staleness shedding: past the master's reassignment deadline the
            # cell has been requeued and answered by someone else — a slow
            # start (first-compile) would otherwise grind through a backlog
            # of duplicate full-board solves.
            if time.monotonic() - enqueued > TASK_DEADLINE_S:
                continue
            try:
                self._solve_task(msg)
            except Exception as e:  # a bad task must not kill the worker
                logger.error("worker task failed: %s", e)
                # Reply value=None anyway: the master's engine-authoritative
                # fallback then takes over. Silence would make it requeue the
                # cell every deadline forever (e.g. a board-size mismatch
                # between nodes fails deterministically on every retry).
                try:
                    self.send_to(
                        msg["address"],
                        wire.solution_msg(
                            msg["sudoku"], msg["row"], msg["col"], None,
                            self.id,
                            trace=valid_request_id(msg.get("trace")),
                        ),
                    )
                except Exception:
                    pass

    def _solve_task(self, msg: wire.Msg) -> None:
        """Answer one cell of a dispatched board (reference node.py:384-406).

        The reference worker probes greedily for the first non-conflicting
        value (node.py:76-80) — often wrong, forcing the master into repair
        churn. This worker solves the *whole* board on the engine and
        returns the cell's value from an actual solution: correct by
        construction, None only if the dispatched board is unsatisfiable.
        """
        row, col, board, origin = msg["row"], msg["col"], msg["sudoku"], msg["address"]
        if msg.get("hedge") is True:
            # a tail-at-scale duplicate dispatch (wire solve "hedge",
            #): served exactly like a primary — the master's
            # merge fold dedups whichever answer arrives second — but
            # counted, so hedge volume is observable on the worker too
            self.hedge_tasks_received += 1
        # wire-propagated trace context: a traced master
        # piggybacks its request's trace id on the dispatch (optional
        # trailing key, validated at this ingress like every other wire
        # field); the worker opens its OWN span under that id so the
        # farmed cell's latency is attributable cross-node, and echoes
        # the id on the solution
        trace_id = valid_request_id(msg.get("trace"))
        tracer = self.tracer
        wtrace = (
            tracer.start("farm-task", trace_id=trace_id)
            if tracer is not None
            else None
        )
        if wtrace is not None:
            wtrace.farmed = True
        self._current_task = (row, col)
        status = 200
        try:
            self.limiter.tick()  # the handicap contract, one tick per task
            # bucket path always: a farmed per-cell task must not occupy the
            # whole mesh the way a frontier-routed serving request does
            solution, _ = self.engine.solve_one(board, frontier=False)
            value = solution[row][col] if solution is not None else None
            if value is None:
                status = 400
            # close the span BEFORE the reply datagram: the solution
            # message is the task's observable completion, and a master
            # (or a test) acting on it must find the farm-task span
            # already in the ring — finishing after send_to raced that
            # read (the send itself is ~µs, not worth a span stage)
            if tracer is not None:
                tracer.finish(wtrace, status)
                wtrace = None
            self.send_to(
                origin,
                wire.solution_msg(
                    board, row, col, value, self.id, trace=trace_id
                ),
            )
        except BaseException:
            status = 500
            raise
        finally:
            self._current_task = None
            if tracer is not None and wtrace is not None:
                # the exception path's backstop — the success path
                # already finished (and cleared) the span above
                tracer.finish(wtrace, status)
        self.broadcast_stats()  # same trigger as reference node.py:406

    # -- master side -------------------------------------------------------
    def peer_sudoku_solve(self, sudoku, deadline_s=None) -> Optional[list]:
        """Solve a request board; returns the solved grid or None (the
        reference surface). ``peer_sudoku_solve_info`` is the same call
        returning (solution, info) — the HTTP route core uses it for the
        degraded-serving marker."""
        solution, _ = self.peer_sudoku_solve_info(
            sudoku, deadline_s=deadline_s
        )
        return solution

    def peer_sudoku_solve_info(self, sudoku, deadline_s=None):
        """Solve a request board, farming cells to peers when there are any
        (reference node.py:534-557). Returns (solution | None, info) —
        ``info`` carries the engine path's routing detail, including the
        supervisor's ``degraded`` flag when the answer came from the
        host-oracle fallback (serving/health.py).

        ``deadline_s`` (absolute monotonic, from the admission layer) rides
        the engine path into the coalescer, where an expired request is
        dropped at batch formation (DeadlineExceeded propagates to the
        HTTP layer's 429). The peer task farm inherits it too:
        dispatched cells carry the sooner of the task deadline and the
        request's remaining budget, and a request that expires mid-farm
        stops consuming peer work (DeadlineExceeded) instead of farming
        cells nobody is waiting for.

        With the frontier engine enabled the mesh race *is* the distributed
        path — it replaces the per-cell peer farm for the request (P2P peers
        still carry membership/stats), the same way the reference's
        distributed dispatch is its serving path.

        Engine-path requests (no peers, or frontier engine) do NOT
        serialize behind ``_solve_lock`` anymore: each handler thread
        enqueues on the engine (whose coalescer merges concurrent requests
        into one bucketed device call — parallel/coalescer.py) and awaits
        its future. Only the peer task farm still takes the lock — its
        master-side queue/active-task state is one-solve-at-a-time by
        construction (reference semantics)."""
        peers = [p for p in self.membership.total_peers()]
        if not peers or self.engine.frontier_enabled:
            if self.serialize_solves:
                with self._solve_lock:
                    if deadline_s is not None and (
                        time.monotonic() > deadline_s
                    ):
                        # the seed-fidelity path queues ON the lock: a
                        # request whose deadline passed while it waited
                        # there is the same expired-in-queue case the
                        # coalescer drops at batch formation
                        raise DeadlineExceeded(
                            "deadline expired waiting for the solve lock"
                        )
                    solution, info = self.engine.solve_one(sudoku)
            else:
                solution, info = self.engine.solve_one_supervised(
                    sudoku, deadline_s=deadline_s
                )
            if solution is not None:
                with self._state_lock:
                    self._solved_count += 1
            self.broadcast_stats()
            return solution, info

        sup = getattr(self.engine, "supervisor", None)
        # the farm shape's supervision leg (analysis/seams.py SEAM101):
        # a watchdog token over the whole farm round, under the sentinel
        # width -1 (a farm is not a bucket program) with a scaled budget
        # — peer round trips legitimately outlast a device call, but a
        # farm stuck requeueing dead peers forever must still be
        # declared hung and feed the breaker like any other dispatch
        token = (
            sup.call_started(-1, budget_scale=8.0)
            if sup is not None
            else None
        )
        try:
            with self._solve_lock:
                solution, info = self._farm_solve(
                    sudoku, peers, deadline_s=deadline_s
                )
        except DeadlineExceeded:
            # a policy abort proves nothing about the peers or the
            # device: discard without feeding the breaker either way
            if sup is not None:
                sup.call_abandoned(token)
            raise
        except BaseException:
            if sup is not None:
                sup.call_finished(token, ok=False)
            raise
        if sup is not None:
            sup.call_finished(token, ok=True)
        # counter + gossip OUTSIDE _solve_lock (same discipline as the
        # engine-path branch above — broadcast_stats sends datagrams,
        # and a sendto under the solve lock is the LOCK102 class)
        if solution is not None:
            with self._state_lock:
                self._solved_count += 1
        self.broadcast_stats()
        return solution, info

    def batch_sudoku_solve(self, sudokus):
        """Solve many boards in one engine batch (the opt-in
        POST /solve_batch extension, http_api.py). Counters and stats
        gossip behave exactly as len(sudokus) sequential solves would:
        solved boards add to this node's solved count, the engine bills
        its validation sweeps, and one stats broadcast follows."""
        # solve_batch_np is thread-safe (engine-internal counter lock); the
        # node-side counter shares _state_lock with the engine-path solves
        # now that /solve requests no longer serialize behind _solve_lock.
        # The supervised wrapper answers degraded-mode
        # boards from the host-oracle fallback under an open breaker or a
        # device failure, instead of erroring the whole batch — the same
        # contract /solve has.
        solutions, mask, info = self.engine.solve_batch_np_supervised(sudokus)
        with self._state_lock:
            self._solved_count += int(mask.sum())
        self.broadcast_stats()
        return solutions, mask, info

    def _farm_solve(
        self, sudoku, peers: List[str], deadline_s=None
    ) -> Tuple[Optional[list], dict]:
        # the requesting thread's span (obs/trace.py): its trace id rides
        # every dispatched cell so peers' farmed-task spans correlate with
        # this request's timeline, and the span is tagged as farmed
        req_trace = current_trace()
        trace_id = req_trace.trace_id if req_trace is not None else None
        if req_trace is not None:
            req_trace.farmed = True
        board = [list(r) for r in sudoku]
        with self._state_lock:
            self.task_queue.clear()
            self.solution_queue.clear()
            self.active_tasks.clear()
            for i in range(len(board)):
                for j in range(len(board)):
                    if board[i][j] == 0:
                        self.task_queue.append((i, j))

        # fleet-autopilot wiring (serving/autopilot.py): with
        # no autopilot — or its loops disabled — every branch below is
        # the plain farm (sorted dispatch order, no hedging, dup
        # datagrams skipped but counted in the cost plane either way)
        ap = self.autopilot
        rank_farm = ap is not None and ap.farm_enabled
        hedge_on = ap is not None and ap.hedge_enabled
        # this request's hedge ledger: cell -> {"primary", "hedge"} peer
        hedged: Dict[Tuple[int, int], Dict[str, str]] = {}

        while True:
            # planned dispatches leave the lock region and send after it:
            # a UDP sendto under _state_lock stalls every thread touching
            # task state (the UDP loop's solution fold, worker requeues)
            # for the send's syscall time — the exact blocking-under-lock
            # class (analysis/locks.py LOCK102). The
            # board is snapshotted at planning time so the fold below
            # can't mutate a message already planned.
            to_send: List[Tuple[str, wire.Msg]] = []
            expired = False
            # per-round autopilot bookkeeping, flushed AFTER the lock
            # region (the counters take their own leaf locks, and the
            # lock discipline here is already the LOCK102 story above)
            primaries = 0
            hedges_fired = 0
            dup_answers = 0
            rtts: List[float] = []
            hedge_results: List[bool] = []
            with self._state_lock:
                # reap deadlined assignments (dead/slow peers: the failure
                # mode the reference cannot detect, SURVEY.md §3.5)
                now = time.monotonic()
                if deadline_s is not None and now > deadline_s:
                    # the originating /solve's deadline expired mid-farm:
                    # nobody is waiting for this board anymore, so stop
                    # consuming peer work (the re-
                    # dispatch loop would otherwise requeue dying cells
                    # every TASK_DEADLINE_S forever on a slow cluster).
                    # Late `solution` datagrams for the abandoned cells
                    # are absorbed by the existing stale-answer guards.
                    self.task_queue.clear()
                    self.active_tasks.clear()
                    expired = True
                for peer in list(self.active_tasks):
                    row, col, deadline, _t0 = self.active_tasks[peer]
                    if now > deadline:
                        logger.warning(
                            "task (%d,%d) on %s timed out; requeueing", row, col, peer
                        )
                        del self.active_tasks[peer]
                        # requeue at most ONE copy of a cell: with
                        # hedging a cell can have two assignments, and
                        # both expiring in one pass (or one expiring
                        # while the other arm still runs) must not
                        # duplicate the queue entry — untracked extra
                        # dispatches outside the hedge ledger/budget
                        if (row, col) not in self.task_queue and not any(
                            (c[0], c[1]) == (row, col)
                            for c in self.active_tasks.values()
                        ):
                            self.task_queue.appendleft((row, col))

                # dispatch one cell per idle peer (reference node.py:433-442).
                # Membership is re-read each round so departures (graceful or
                # detected crashes) shrink the pool mid-solve. Peers whose
                # gossiped supervisor state is LOST are skipped — they
                # would answer from a slow oracle fallback while their
                # engine rebuilds, and a requeued cell re-dispatches to a
                # healthy peer instead (gossip TTL un-skips them if the
                # claim goes stale). With the autopilot's farm loop on,
                # the binary skip generalizes into a continuous
                # preference: candidates are ordered by freshness-decayed
                # load score from the gossip telemetry digests
                # instead of plain sorted order, so when there are more
                # idle peers than cells, the loaded/degraded/stale ones
                # go last.
                live = set(self.membership.total_peers())
                usable = {
                    p for p in live if not self.peer_health.is_lost(p)
                }
                all_workers_gone = not expired and not usable and (
                    self.task_queue or self.active_tasks
                )
                # ranked only when a dispatch can actually happen: most
                # rounds are 50 ms wait slices with an empty queue, and
                # the telemetry snapshot + sort (autopilot + peer-map
                # leaf locks, acyclic under _state_lock) should not run
                # there
                order = ()
                if self.task_queue:
                    order = (
                        ap.rank_farm_peers(usable)
                        if rank_farm
                        else sorted(usable)
                    )
                for peer in order:
                    if not self.task_queue:
                        break
                    if peer in self.active_tasks:
                        continue
                    i, j = self.task_queue.popleft()
                    # a dispatched cell inherits the originating request's
                    # remaining budget: past it the MASTER stops waiting
                    # (above), so assigning a later per-task deadline
                    # would only delay the requeue-or-abandon decision
                    task_deadline = now + TASK_DEADLINE_S
                    if deadline_s is not None:
                        task_deadline = min(task_deadline, deadline_s)
                    self.active_tasks[peer] = (i, j, task_deadline, now)
                    primaries += 1
                    to_send.append(
                        (
                            peer,
                            wire.solve_msg(
                                [list(r) for r in board], i, j, self.id,
                                trace=trace_id,
                            ),
                        )
                    )

                # hedged dispatch (Dean & Barroso's tail at
                # scale): only once the queue is drained (fresh cells
                # always outrank duplicates), a cell straggling past the
                # measured farm-task p99 is raced on the best-ranked
                # IDLE peer. First verified answer wins; the merge fold
                # below dedups the loser's late reply; the autopilot's
                # budget bounds lifetime hedges to a fraction of primary
                # dispatches so tail-chasing can never amplify overload.
                if (
                    hedge_on
                    and not expired
                    and not self.task_queue
                    and self.active_tasks
                ):
                    idle = [
                        p for p in usable if p not in self.active_tasks
                    ]
                    # oldest stragglers past the threshold, unhedged —
                    # found BEFORE any ranking work so the common
                    # nothing-to-hedge round costs a list scan only
                    thr = ap.hedge_threshold_s() if idle else None
                    stragglers = (
                        [
                            (peer, task)
                            for peer, task in sorted(
                                self.active_tasks.items(),
                                key=lambda kv: kv[1][3],
                            )
                            if (task[0], task[1]) not in hedged
                            and now - task[3] >= thr
                        ]
                        if idle
                        else []
                    )
                    if stragglers:
                        idle = (
                            ap.rank_farm_peers(idle)
                            if rank_farm
                            else sorted(idle)
                        )
                        for peer, task in stragglers:
                            if not idle:
                                break
                            i, j, task_deadline, t0 = task
                            if not ap.try_hedge():
                                break  # budget spent this round
                            target = idle.pop(0)
                            hedged[(i, j)] = {
                                "primary": peer, "hedge": target,
                            }
                            self.active_tasks[target] = (
                                i, j, task_deadline, now,
                            )
                            hedges_fired += 1
                            to_send.append(
                                (
                                    target,
                                    wire.solve_msg(
                                        [list(r) for r in board], i, j,
                                        self.id, trace=trace_id,
                                        hedge=True,
                                    ),
                                )
                            )

                # fold in any arrived solutions — the master's MERGE
                # step: each answer is placement-checked against the
                # merged board before it lands. Billed to the request
                # span's verify stage below
                t_fold = time.monotonic()
                folded = 0
                requeued_none = False
                while self.solution_queue:
                    folded += 1
                    row, col, value, peer = self.solution_queue.popleft()
                    # Retire the peer's assignment only if this answer is
                    # for it: a duplicated or deadline-late datagram about
                    # an older cell must not knock the peer's *current*
                    # in-flight task out of active_tasks (that silently
                    # loses the cell and fails the solve — caught by
                    # tests/test_faults.py duplicate-injection).
                    cur = self.active_tasks.get(peer)
                    if cur is not None and (cur[0], cur[1]) == (row, col):
                        del self.active_tasks[peer]
                        # dispatch→fold round trip: the sample stream
                        # the hedge threshold's p99 is read from
                        rtts.append(time.monotonic() - cur[3])
                    if value is None:
                        requeued_none = True
                        continue
                    if board[row][col] != 0:
                        # late duplicate ``solution`` — a hedged loser's
                        # reply or a UDP retransmit. Deduped (the winner
                        # already merged) and counted EXACTLY ONCE per
                        # datagram here, in the cost plane and the
                        # autopilot block; it never touches any
                        # completion accounting, so hedging cannot
                        # inflate a measured completion rate
                        dup_answers += 1
                        continue
                    if self._placement_ok(board, row, col, value):
                        board[row][col] = value
                        h = hedged.get((row, col))
                        if h is not None and peer in (
                            h["primary"], h["hedge"]
                        ):
                            # first verified answer wins the race
                            hedge_results.append(peer == h["hedge"])
                        # retire every OTHER copy of this cell (the
                        # losing hedge arm / a requeued duplicate): the
                        # cell is answered, so its straggling copies
                        # must neither requeue it at their deadline nor
                        # hold their peers out of fresh dispatches
                        for loser in [
                            p
                            for p, c in self.active_tasks.items()
                            if (c[0], c[1]) == (row, col)
                        ]:
                            del self.active_tasks[loser]
                    else:
                        self.task_queue.appendleft((row, col))

                fold_s = time.monotonic() - t_fold
                done = not self.task_queue and not self.active_tasks
                if not done and not to_send:
                    # with dispatches planned, skip the wait this round:
                    # the sends below must not sit on a held lock, and the
                    # next iteration (nothing new to send) waits as before
                    self._solution_event.wait(timeout=SOLVE_WAIT_SLICE_S)

            if folded and req_trace is not None:
                # merge-step verify time, stamped outside the lock
                req_trace.mark("verify", fold_s)

            # autopilot + cost-plane bookkeeping, outside _state_lock
            # (each takes its own leaf lock)
            if ap is not None:
                if primaries:
                    ap.note_primary_dispatch(primaries)
                for s in rtts:
                    ap.note_farm_rtt(s)
                for won in hedge_results:
                    ap.note_hedge_result(won)
                for _ in range(dup_answers):
                    ap.note_late_dup()
            if primaries or hedges_fired or dup_answers:
                cost = getattr(self.engine, "cost", None)
                if cost is not None:
                    cost.note_farm(
                        dispatches=primaries,
                        hedges=hedges_fired,
                        dup_solutions=dup_answers,
                    )

            for peer, msg in to_send:
                self.send_to(peer, msg)

            if expired:
                raise DeadlineExceeded(
                    "request deadline expired mid-farm — peer work stopped"
                )

            if requeued_none or all_workers_gone:
                # Fall back to the authoritative engine on the original
                # request when (a) a worker proved its (possibly mixed-merge)
                # board unsat — replaces the reference's swap-repair
                # (node.py:487-532) — or (b) every worker departed mid-solve
                # (the reference would dispatch to dead peers forever).
                # Under an open breaker the supervised host-oracle
                # fallback answers instead — the terminal solve of a
                # degraded master must not touch the quarantined device
                # (the farm shape's fallback leg, analysis/seams.py)
                sup = getattr(self.engine, "supervisor", None)
                if sup is not None and sup.should_fallback():
                    solution, info = sup.fallback_solve(
                        sudoku, deadline_s=deadline_s
                    )
                else:
                    solution, info = self.engine.solve_one(
                        sudoku, frontier=False
                    )
                return solution, dict(info, farmed=True)

            if done:
                break

        if any(0 in row for row in board):
            return None, {"routed": "farm"}
        # strict final check on the engine (reference runs its weak check,
        # node.py:466); its info rides back so a supervised fallback
        # answer keeps its degraded flag through the farm path. Open
        # breaker → the host oracle verifies/solves instead (same
        # fallback-leg contract as the unsat-retry branch above)
        sup = getattr(self.engine, "supervisor", None)
        if sup is not None and sup.should_fallback():
            solution, info = sup.fallback_solve(
                board, deadline_s=deadline_s
            )
        else:
            solution, info = self.engine.solve_one(board, frontier=False)
        return solution, dict(info, farmed=True)

    @staticmethod
    def _placement_ok(board, row, col, value) -> bool:
        n = len(board)
        box = int(round(n ** 0.5))
        if not 1 <= value <= n:
            return False
        for k in range(n):
            if board[row][k] == value or board[k][col] == value:
                return False
        bi, bj = (row // box) * box, (col // box) * box
        for i in range(bi, bi + box):
            for j in range(bj, bj + box):
                if board[i][j] == value:
                    return False
        return True

    # -- lifecycle ---------------------------------------------------------
    def connect_to_anchor_node(self) -> None:
        logger.info("connecting to anchor node %s", self.anchor_node)
        self.send(wire.parse_address(self.anchor_node), wire.connect_msg(self.id))

    def run(self) -> None:
        """UDP event loop (main thread, reference node.py:623-644). Returns
        within one receive timeout of ``shutdown`` and closes the socket."""
        with self._life_lock:
            if self.shutdown_flag:
                return  # shut down before it started: shutdown closed it
            self._running = True
        try:
            self._loop()
        finally:
            # the goodbye leaves from this socket: close it only once a
            # shutdown in progress has sent it
            if self._departing:
                self._goodbye_sent.wait(timeout=5.0)
            self.sock.close()

    def _loop(self) -> None:
        self.sock.bind((self.host, self.port))
        self.sock.settimeout(0.5)  # periodic wake: anchor retry & clean shutdown
        logger.info("P2P node %s listening on %s:%s", self.id, self.host, self.port)
        last_anchor_try = 0.0
        last_gossip = 0.0
        last_anti_entropy = time.monotonic()
        while not self.shutdown_flag:
            try:
                # Periodic stats gossip. The reference only gossips on events
                # (join / task / solve / shutdown, node.py:217, 406, 556, 647)
                # so counters stall on quiet networks; a time trigger keeps
                # /stats eventually consistent everywhere using the same
                # message type, and doubles as a liveness heartbeat.
                if (
                    time.monotonic() - last_gossip > GOSSIP_INTERVAL_S
                    and self.membership.neighbors()
                ):
                    self.broadcast_stats()
                    last_gossip = time.monotonic()
                # periodic anti-entropy: re-flood the membership view even
                # without a change, so a node that MISSED a deletion/join
                # flood (lossy wire) converges within a bounded window —
                # its stale re-flood also triggers the tombstone pushback
                if (
                    time.monotonic() - last_anti_entropy > ANTI_ENTROPY_S
                    and self.membership.neighbors()
                ):
                    self.broadcast_all_peers()
                    # deletion anti-entropy: re-relay disconnect for every
                    # live tombstone so nodes that joined after a death
                    # (tombstones are local state — a joiner has none)
                    # and stale holders both get re-killed copies; without
                    # this, one stale view + one fresh joiner resurrects
                    # a dead peer permanently once everyone's TTL expires
                    # (extended churn soak, seed 101)
                    # only with the heartbeat ON: in reference-semantics
                    # mode (failure_timeout=0) rumor rejection is also
                    # off, so re-broadcast deletions would repeatedly
                    # prune a live same-address rejoiner at its own
                    # neighbors; with graceful-only
                    # departures every holder prunes on the goodbye and
                    # stale views don't arise
                    if self.failure_timeout:
                        flood_peers = self.membership.neighbors()
                        for addr in self.membership.live_tombstones():
                            for peer in flood_peers:
                                self.send_to(peer, wire.disconnect_msg(addr))
                    last_anti_entropy = time.monotonic()
                # retry the anchor until the join took (the reference blocks
                # forever if the anchor isn't up yet, node.py:559-568); a
                # node with NO anchor (the original anchor itself) re-dials
                # remembered peers instead — churn can orphan it when every
                # neighbor dies, and the reference's peers_to_reconnect is
                # populated but never dialed from (SURVEY.md §5)
                if (
                    not self.membership.neighbors()
                    and time.monotonic() - last_anchor_try > 2.0
                ):
                    if (
                        self.autopilot is not None
                        and not self.autopilot.allow_join()
                        and (
                            self.anchor_node
                            or self.membership.reconnect_candidate()
                            is not None
                        )
                    ):
                        # elastic membership: defer the join
                        # dial until /readyz would pass — the engine is
                        # prewarming tier 0 (from the shared AOT store
                        # when a compile plane is configured), and
                        # advertising now would draw farm tasks this
                        # node can only time out. Bounded: allow_join
                        # opens past the defer horizon regardless, so a
                        # node that can never warm still joins.
                        self.autopilot.note_deferred_dial()
                        last_anchor_try = time.monotonic()
                    else:
                        if self.anchor_node:
                            self.connect_to_anchor_node()
                            last_anchor_try = time.monotonic()
                        # a dead (or absent) anchor must not strand us:
                        # after each unanswered dial window, also try a
                        # remembered peer when we know any (the joiner
                        # whose anchor died mid-handshake — extended
                        # soak; ONE shared redial site)
                        target = self.membership.reconnect_candidate()
                        if (
                            target is not None
                            and target != self.anchor_node
                        ):
                            logger.info(
                                "no neighbors: dialing remembered peer "
                                "%s",
                                target,
                            )
                            self.send_to(
                                target, wire.connect_msg(self.id)
                            )
                            last_anchor_try = time.monotonic()
                elif (
                    self.membership.neighbors()
                    and time.monotonic() - last_anchor_try > 2 * ANTI_ENTROPY_S
                ):
                    # partition repair: a bridge death can split the overlay
                    # into internally-content camps (everyone keeps
                    # neighbors, so the orphan branch never fires); dialing
                    # a remembered address missing from the view re-merges
                    # them (extended churn soak, seed 101). Dead absentees
                    # cost one ignored datagram per rotation turn.
                    target = self.membership.missing_candidate()
                    if target is not None:
                        logger.info(
                            "view missing remembered peer %s — dialing",
                            target,
                        )
                        self.send_to(target, wire.connect_msg(self.id))
                    last_anchor_try = time.monotonic()
                self._reap_dead_neighbors()
                payload, _addr = self.recv()
                if payload is None:
                    continue
                self.handle_message(wire.decode_msg(payload), source=_addr)
            except KeyboardInterrupt:
                self.shutdown()
            except Exception as e:  # a malformed datagram must not kill the node
                logger.error("error handling datagram: %s", e)

    def _reap_dead_neighbors(self) -> None:
        """Declare neighbors silent past the failure timeout dead.

        Detection is the periodic gossip's absence; the response path is the
        same as a received ``disconnect`` (prune, re-flood the deletion,
        requeue any in-flight assignment), so crash recovery and graceful
        departure are one code path.
        """
        if not self.failure_timeout:
            return
        now = time.monotonic()
        # Stall grace: if this loop itself was blocked (engine compile, a
        # long inline task, GC) past the heartbeat cadence, neighbors' gossip
        # sat unread in the socket buffer and every timestamp is stale through
        # no fault of the peers. SHIFT every timestamp by the stall duration
        # instead of resetting to now: the watcher's blind time is excused,
        # but a genuinely dead peer keeps accumulating silence across stalls
        # — a full reset under recurring load meant dead peers were NEVER
        # reaped (extended churn soak, seed 101: perpetual grace on a
        # contended core left a dead bridge in every view forever).
        gap = now - self._last_tick
        threshold = min(1.0, self.failure_timeout / 2)
        if gap > threshold:
            # excuse only the stall BEYOND the expected loop cadence: a
            # loop that consistently ticks just over the threshold under
            # load would otherwise excuse every gap in full and never
            # accumulate silence for a dead peer; a
            # genuinely long stall (engine compile) is still excused
            # almost entirely
            for peer in list(self._last_seen):
                self._last_seen[peer] += gap - threshold
        self._last_tick = now
        neighbors = set(self.membership.neighbors())
        for peer in neighbors:
            seen = self._last_seen.setdefault(peer, now)  # grace on first sight
            if now - seen > self.failure_timeout:
                logger.warning(
                    "peer %s silent for %.1fs — declaring it failed",
                    peer,
                    now - seen,
                )
                self._last_seen.pop(peer, None)
                self._on_disconnect(wire.disconnect_msg(peer))
        # GC stale non-neighbor entries: senders that never became (or no
        # longer are) neighbors would otherwise accumulate forever under
        # a valid-formatted hostile flood
        horizon = 10 * self.failure_timeout
        for addr in [
            a
            for a, t in self._last_seen.items()
            if a not in neighbors and now - t > horizon
        ]:
            del self._last_seen[addr]

    def shutdown(self) -> None:
        """Graceful departure (reference node.py:646-658): final stats
        gossip and a disconnect, carrying the in-flight task, to every
        neighbor; then the UDP loop and the worker thread stop."""
        if self.shutdown_flag:
            return
        self._departing = True
        self.broadcast_stats()
        self.shutdown_flag = True
        for peer in self.membership.neighbors():
            self.send_to(peer, wire.disconnect_msg(self.id, self._current_task))
            logger.info("sent disconnect message to %s", peer)
        logger.info("shutting down P2P node %s", self.id)
        self._goodbye_sent.set()
        self._worker_tasks.put(None)
        if threading.current_thread() is not self._worker_thread:
            self._worker_thread.join(timeout=5.0)
        with self._life_lock:
            close_now = not self._running
        if close_now:
            # run() never started: nothing else will close the socket
            self.sock.close()
