"""A single-node P2P node: the object the HTTP API serves from.

The port of the single-node part of ``sudoku_solver_distributed_tpu/net/
node.py``: the constructor and counters, the ``/stats`` and ``/network``
bodies, the no-peers branch of ``peer_sudoku_solve(_info)`` (the request
goes straight to the engine's supervised serving entry point, with its
admission deadline; with ``serialize_solves``, the ``--seed-serving``
baseline, behind one lock on the engine's ``solve_one``), the
``/solve_batch`` core ``batch_sudoku_solve``, and the graceful
``shutdown``. The node carries the
front door's answer cache (``answer_cache``, None unless attached), the
chaos route's switch (``chaos_routes``) and the observability plane's
``metrics``, ``tracer``, ``flight`` and ``slo`` (obs/; None unless
attached, as net/cli.py does by default). ``run`` binds
the UDP socket like the original and then waits for shutdown: the UDP
event loop, the anchor join and the per-cell task farm come with the P2P
slice, so a node here never has peers.
"""

from __future__ import annotations

import logging
import socket
import threading
import time
from typing import Optional

from ..engine import SolverEngine
from ..serving.admission import DeadlineExceeded
from ..utils import HandicapLimiter
from . import wire
from .membership import Membership
from .stats import StatsGossip

logger = logging.getLogger(__name__)

FAILURE_TIMEOUT_S = 5.0     # the JAX node's crash-detector default


class P2PNode:
    def __init__(
        self,
        host: str,
        port: int,
        anchor_node: Optional[str] = None,
        handicap: float = 0.001,
        engine: Optional[SolverEngine] = None,
        failure_timeout: float = FAILURE_TIMEOUT_S,
        tombstone_ttl_s: Optional[float] = None,
        admission=None,
        metrics=None,
        serialize_solves: bool = False,
    ):
        if anchor_node is not None:
            raise NotImplementedError(
                "joining a network (anchor_node) comes with the P2P slice"
            )
        self.host = host
        self.port = port
        self.id = f"{host}:{port}"
        self.handicap = handicap

        self.engine = engine if engine is not None else SolverEngine()
        # the --seed-serving baseline: /solve requests take turns on one
        # lock around the engine's solve_one, as the seed served them
        self.serialize_solves = serialize_solves
        self._solve_lock = threading.Lock()
        # overload control (serving/admission.py): when set, /solve sheds
        # 429 at arrival and expired queued requests answer 429
        # (net/http_api.solve_route); None serves every request
        self.admission = admission
        # the canonical-form answer cache (cache/) the /solve front door
        # consults before admission; None answers every request on the
        # engine
        self.answer_cache = None
        # POST /debug/faults exists only when set (CLI --chaos-injector)
        self.chaos_routes = False
        # the observability plane (obs/), each None when off: the per-route
        # recorder behind the /metrics route blocks (the tracer's own
        # RouteMetrics when tracing is on), the request tracer, the
        # incident flight recorder and the SLO burn-rate engine
        self.metrics = metrics
        self.tracer = None
        self.flight = None
        self.slo = None
        # ticks once per farmed task, as in the JAX node: the task farm
        # comes with the P2P slice, so a single node never ticks it
        self.limiter = HandicapLimiter(base_delay=handicap)
        self._solved_count = 0
        if tombstone_ttl_s is None:
            # the JAX node's derived default: tombstones outlive flood
            # convergence but not a few failure-detection periods
            tombstone_ttl_s = (
                max(6.0 * failure_timeout, 12.0) if failure_timeout else 30.0
            )
        self.failure_timeout = failure_timeout
        self.membership = Membership(self.id, tombstone_ttl_s=tombstone_ttl_s)
        self.stats = StatsGossip(self.id, self._own_counters)

        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._shutdown = threading.Event()
        self._state_lock = threading.Lock()

    # -- counters ----------------------------------------------------------
    # `solved` counts one per successful solve; `validations` is the
    # engine's sweep count
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
        try:
            self.sock.sendto(wire.encode_msg(msg), address)
        except OSError as e:
            logger.error("send to %s failed: %s", address, e)

    def send_to(self, peer_id: str, msg: wire.Msg) -> None:
        if not wire.valid_address(peer_id):
            logger.warning("refusing send to invalid peer id %r", peer_id)
            return
        self.send(wire.parse_address(peer_id), msg)

    # -- gossip ------------------------------------------------------------
    def broadcast_stats(self) -> None:
        peers = self.membership.neighbors()
        if not peers:
            return
        sup = self.engine.supervisor
        msg = wire.stats_msg(
            self.id, self._solved_count, self.engine.validations,
            self.stats.snapshot(),
            health=sup.state if sup is not None else None,
        )
        for peer in peers:
            self.send_to(peer, msg)

    def get_stats(self) -> wire.Msg:
        return self.stats.snapshot()

    def network_view(self) -> wire.Msg:
        return self.membership.network_view()

    # -- solving -----------------------------------------------------------
    def peer_sudoku_solve(self, sudoku, deadline_s=None) -> Optional[list]:
        """Solve a request board; returns the solved grid or None."""
        solution, _ = self.peer_sudoku_solve_info(sudoku, deadline_s=deadline_s)
        return solution

    def peer_sudoku_solve_info(self, sudoku, deadline_s=None):
        """Solve a request board; returns (solution | None, info). With no
        peers (always, in this slice) the engine answers it. ``info``
        carries the supervisor's ``degraded`` flag when the answer came
        from the host-oracle fallback (serving/health.py).

        ``deadline_s`` (absolute monotonic, from the admission layer) rides
        into the engine's coalescer, where a request still queued past it
        is dropped at batch formation (DeadlineExceeded propagates to the
        HTTP layer's 429). Concurrent requests do not serialize here: each
        handler thread enqueues on the engine and awaits its future —
        unless ``serialize_solves`` is set, which queues them on one lock
        around ``engine.solve_one``; a request whose deadline passed while
        it waited there raises ``DeadlineExceeded``."""
        if self.membership.total_peers():
            raise NotImplementedError("the task farm comes with the P2P slice")
        if self.serialize_solves:
            with self._solve_lock:
                if deadline_s is not None and time.monotonic() > deadline_s:
                    # expired while queued on the lock: the same case the
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

    def batch_sudoku_solve(self, sudokus):
        """Solve many boards in one engine batch (``POST /solve_batch``).
        The counters move as ``len(sudokus)`` sequential solves would:
        solved boards add to this node's solved count, the engine bills
        its validation sweeps, and one stats broadcast follows. The
        supervised batch answers degraded-mode boards from the host-oracle
        fallback under an open breaker or a device failure."""
        solutions, mask, info = self.engine.solve_batch_np_supervised(sudokus)
        with self._state_lock:
            self._solved_count += int(mask.sum())
        self.broadcast_stats()
        return solutions, mask, info

    # -- lifecycle ---------------------------------------------------------
    def run(self) -> None:
        """Bind the UDP socket, then block until ``shutdown``."""
        self.sock.bind((self.host, self.port))
        logger.info("P2P node %s listening on %s:%s", self.id, self.host, self.port)
        self._shutdown.wait()

    def shutdown(self) -> None:
        """Graceful departure: final stats gossip, disconnect to every
        neighbor, then release ``run``."""
        self.broadcast_stats()
        for peer in self.membership.neighbors():
            self.send_to(peer, wire.disconnect_msg(self.id))
            logger.info("sent disconnect message to %s", peer)
        logger.info("shutting down P2P node %s", self.id)
        self._shutdown.set()
        self.sock.close()
